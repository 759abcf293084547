"""Mamba2-1.3B [arXiv:2405.21060; unverified] — attention-free SSD
(state-space duality), ssm_state=128.  Served by the paged engine
pageless: the slot-dense SSM state pool is the whole cache, so slots are
the only capacity dimension (no page reservation, no preemption)."""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    sub_quadratic=True, tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)


def reduced():
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=128, vocab_size=512,
        ssm_state=16, ssm_head_dim=16)
