"""PixArt-Sigma-like DiT backbone — the paper's LVM evaluation model
(Table 1): its transformer blocks on a flattened 2-D latent grid, served
as a plain dense stack with a stub head (vocabulary 8).  At full width its
head_dim is 1152 / 16 = 72."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixart-sigma", family="dense",
    num_layers=28, d_model=1152, num_heads=16, num_kv_heads=16,
    d_ff=4608, vocab_size=8,          # DiT: no vocab; stub for the LM head
    source="arXiv:2403.04692 (paper's Table 1 model)",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256)
