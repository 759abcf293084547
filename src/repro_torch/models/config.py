"""Model configuration for the dense GQA decoders the port serves (a copy of
the dense subset of ``repro.models.config``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # attn (the port's only mixer so far)
    ffn: str = "mlp"           # mlp (the port's only ffn so far)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense (the port's only family so far)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    source: str = ""

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (as the reference pads it)."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def layer_plan(self) -> tuple[Tuple[LayerSpec, ...],
                                  Tuple[LayerSpec, ...], int]:
        """Returns (prologue, period_pattern, num_periods).  Only dense
        stacks are ported: one attention + MLP layer per period."""
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.name}: the port serves dense stacks only "
                f"(family={self.family!r})")
        return (), (LayerSpec("attn", "mlp"),), self.num_layers
