"""Model configuration for the stacks the port serves: dense GQA,
capacity-routed MoE, hybrid Mamba + attention (Jamba), pure Mamba2 / SSD,
encoder-decoder (Seamless) and backbones behind a stubbed modality frontend
(LLaVA's patches, Seamless's frames), and the dry run's input-shape cells
(``ShapeConfig``, ``SHAPES``, ``shape_applicable``) — a copy of
``repro.models.config``."""

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

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks), for 6·N·D."""
        d = self.d_model
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        mlp = 3 * d * self.d_ff
        moe = 0
        if self.num_experts:
            moe = (self.num_experts * 3 * d * self.expert_d_ff
                   + d * self.num_experts)
        di, ns, nh = self.d_inner, self.ssm_state, self.ssm_heads
        groups_dim = 2 * ns  # B and C projections (single group)
        mamba = (d * (2 * di + groups_dim + nh)   # in_proj (x, z, B, C, dt)
                 + di * d                          # out_proj
                 + di * self.conv_width + nh * 2 + di)  # conv, A/dt bias, D
        total = 0
        for spec in self.layer_specs():
            if spec.mixer == "attn":
                total += attn
            elif spec.mixer == "mamba":
                total += mamba
            if spec.ffn == "mlp":
                total += mlp
            elif spec.ffn == "moe":
                total += moe
            elif spec.ffn == "moe_dense":
                total += moe + mlp
            total += 2 * d  # norms
        if self.encoder_layers:
            # encoder self-attn + ffn, and decoder cross-attn blocks
            total += self.encoder_layers * (attn + mlp + 2 * d)
            total += self.num_layers * (attn + d)  # cross-attn + norm
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params, for MoE MODEL_FLOPS = 6·N_active·D."""
        if not self.num_experts:
            return self.param_count()
        full_moe = self.num_experts * 3 * self.d_model * self.expert_d_ff
        active_moe = (self.experts_per_token * 3 * self.d_model
                      * self.expert_d_ff)
        n_moe_layers = sum(1 for s in self.layer_specs()
                           if s.ffn in ("moe", "moe_dense"))
        return self.param_count() - n_moe_layers * (full_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig
                     ) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped (pure full-attention arch; long_500k needs "
                       "sub-quadratic)")
    return True, ""
