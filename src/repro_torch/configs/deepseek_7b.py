"""DeepSeek-7B [arXiv:2401.02954; hf] — dense llama-arch, MHA."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab_size=102400,
    source="arXiv:2401.02954; hf",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=352, vocab_size=512)
