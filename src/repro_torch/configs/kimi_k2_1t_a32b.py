"""Kimi-K2 1T-A32B [arXiv:2501.kimi2; unverified] — trillion-param MoE:
61 layers, 384 experts top-8 with per-expert d_ff=2048, first layer dense."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=112, d_ff=18432, vocab_size=163840,
    num_experts=384, experts_per_token=8, moe_d_ff=2048,
    first_layer_dense=True,
    source="arXiv:2501.kimi2; unverified",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=384, vocab_size=512, num_experts=8,
        experts_per_token=2, moe_d_ff=64)
