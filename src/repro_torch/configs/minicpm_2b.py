"""MiniCPM-2B [arXiv:2404.06395; hf] — dense llama-like, MHA, WSD schedule."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122753,
    schedule="wsd", tie_embeddings=True,
    source="arXiv:2404.06395; hf",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=320, vocab_size=512)
