"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] — 128 experts
top-2 with a dense residual MLP in parallel."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    head_dim=128, d_ff=4864, vocab_size=32000,
    num_experts=128, experts_per_token=2, moe_d_ff=4864,
    dense_residual=True,
    source="hf:Snowflake/snowflake-arctic-base",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, num_experts=8,
        experts_per_token=2, moe_d_ff=128)
