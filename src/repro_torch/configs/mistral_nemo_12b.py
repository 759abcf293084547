"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407; hf] — GQA kv=8,
head_dim=128 (q_dim 4096 != d_model 5120), 128k context."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=131072,
    rope_theta=1e6,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=160, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=448, vocab_size=512)
