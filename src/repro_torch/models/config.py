"""Model configuration for the stacks the port serves: dense GQA,
capacity-routed MoE, hybrid Mamba + attention (Jamba), pure Mamba2 / SSD,
encoder-decoder (Seamless) and backbones behind a stubbed modality frontend
(LLaVA's patches, Seamless's frames) — a copy of ``repro.models.config``
less the training-shape cells."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"        # attn | mamba
    ffn: str = "mlp"           # mlp | moe | moe_dense (Arctic residual) | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None        # default d_model // num_heads
    qkv_bias: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                     # expert hidden size (if != d_ff)
    dense_residual: bool = False          # Arctic: FFN = dense MLP + MoE
    moe_period: int = 1                   # MoE every k-th layer (hybrid)
    first_layer_dense: bool = False       # Kimi-K2: layer 0 is dense MLP
    capacity_factor: float = 1.25
    moe_group_size: int = 1024            # routing group (GShard-style)
    # --- hybrid / ssm ---
    attn_period: int = 0                  # Jamba: 1 attention per 8 layers
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # --- encoder-decoder ---
    encoder_layers: int = 0               # >0 => enc-dec (Seamless)
    # --- modality frontend stubs ---
    frontend: Optional[str] = None        # 'patch' (VLM) | 'frames' (audio)
    num_patches: int = 576                # LLaVA anyres merged patches
    frame_ratio: int = 4                  # audio frames = seq // frame_ratio
    # --- misc ---
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    schedule: str = "cosine"              # 'wsd' for MiniCPM (training only)
    sub_quadratic: bool = False           # True for ssm/hybrid (long_500k ok)
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

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def layer_plan(self) -> tuple[Tuple[LayerSpec, ...],
                                  Tuple[LayerSpec, ...], int]:
        """Returns (prologue, period_pattern, num_periods).  Dense stacks
        are one attention + MLP layer per period; MoE stacks one attention
        + MoE layer (``moe_dense`` with the dense residual), after a dense
        first layer when ``first_layer_dense``; pure SSM stacks one Mamba
        layer without an FFN; hybrid stacks a period of ``attn_period``
        layers with attention at ``p // 2`` and Mamba elsewhere, MoE every
        ``moe_period``-th layer; dense, VLM and audio backbones one
        attention + MLP layer (an encoder's layers are the same spec, held
        apart: ``encoder_layers``)."""
        n = self.num_layers
        if self.family == "ssm":
            return (), (LayerSpec("mamba", "none"),), n
        if self.family == "hybrid":
            period = []
            p = self.attn_period or 8
            for i in range(p):
                mixer = "attn" if i == (p // 2) else "mamba"
                ffn = "moe" if (self.num_experts and i % self.moe_period ==
                                (self.moe_period - 1)) else "mlp"
                period.append(LayerSpec(mixer, ffn))
            if n % p:
                raise ValueError(
                    f"{self.name}: {n} layers not divisible by period {p}")
            return (), tuple(period), n // p
        if self.family == "moe":
            spec = LayerSpec("attn",
                             "moe_dense" if self.dense_residual else "moe")
            if self.first_layer_dense:
                return (LayerSpec("attn", "mlp"),), (spec,), n - 1
            return (), (spec,), n
        return (), (LayerSpec("attn", "mlp"),), n

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Every layer's spec in stack order: the prologue, then the
        period pattern repeated (the port keeps layers unrolled)."""
        pro, period, nper = self.layer_plan()
        return pro + period * nper
