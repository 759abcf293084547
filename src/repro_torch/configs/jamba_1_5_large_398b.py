"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] — hybrid Mamba+attention
1:7 interleave (1 attention layer per period of 8), MoE 16e top-2 every
other layer; the Mamba branch is Mamba2 / SSD (state 128, head dim 64), as
in the reference.  Served by the paged engine: paged mixed-precision K/V
for the attention layers and the slot-dense SSM state pool for the Mamba
layers."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536,
    num_experts=16, experts_per_token=2, moe_period=2,
    attn_period=8, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    sub_quadratic=True,
    source="arXiv:2403.19887; hf",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=8, d_model=128, num_heads=4, num_kv_heads=2,
        d_ff=256, vocab_size=512, num_experts=4, experts_per_token=2,
        ssm_state=16, ssm_head_dim=16)
