"""Qwen2-72B [arXiv:2407.10671; hf] — GQA kv=8, QKV bias."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, qkv_bias=True,
    rope_theta=1e6,
    source="arXiv:2407.10671; hf",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=384, vocab_size=512)
