"""Llama-3-8B — the paper's own LLM evaluation model (Table 2)."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    rope_theta=5e5,
    source="arXiv:2407.21783 (paper's Table 2 model)",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=384, vocab_size=512)
