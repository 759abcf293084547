"""STaMP: the sequence-transformed, mixed-precision linear layer (Fig. 2a),
ported from ``repro.core.stamp``.

    1.  ``T = L · X``            (sequence transform, §3)
    2.  ``Tq = Q(T)``            (mixed-precision quantize, first ``num_hi``
                                  tokens at ``hi_bits``)
    3.  ``Y = Tq · W``
    4.  ``y = L⁻¹ · Y + 1βᵀ``    (inverse transform, then bias — Eq. 7)

``execution="reference"`` runs these as separate PyTorch ops on float
weights; ``execution="fused"`` runs them on prepared int8 weights through
`repro_torch.kernels.ops` (the Hopper kernels on a CUDA tensor, their plain
versions on a CPU tensor).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.core import quant as Q
from repro_torch.core import transforms as T
from repro_torch.obs import quantstats as QS

# transforms the fused kernels run; the rest stay on the reference path
FUSABLE_TRANSFORMS = ("none", "dwt", "wht")


@dataclasses.dataclass(frozen=True)
class StampConfig:
    """STaMP activation quantization (defaults: the paper's headline
    setting — Haar DWT, 64 tokens at 8 bits, the rest at 4 bits, the
    first-token exception on)."""

    seq_transform: str = "dwt"       # none | dwt | wht
    levels: Optional[int] = None     # None = auto: log2(seq / num_hi)
    num_hi_tokens: int = 64
    hi_bits: int = 8
    lo_bits: int = 4
    skip_first_token: bool = True    # attention-sink exception (§B.2)
    granularity: str = "token"
    enabled: bool = True
    execution: str = "reference"     # reference | fused
    fused_weight_bits: int = 8

    def bits_vector(self, seq_len: int, device=None) -> torch.Tensor:
        return Q.mixed_precision_bits(seq_len, self.num_hi_tokens,
                                      self.hi_bits, self.lo_bits,
                                      device=device)

    def resolved_levels(self, seq_len: int) -> int:
        if self.levels is not None:
            return self.levels
        ratio = max(seq_len / max(self.num_hi_tokens, 1), 2)
        return max(1, int(math.ceil(math.log2(ratio))))


def fold_segments(x: torch.Tensor, seg_len: int) -> torch.Tensor:
    """View a flattened ``(b, n·seg_len, …)`` ragged batch as ``(b·n,
    seg_len, …)`` so sequence-axis ops apply per span."""
    b, t = x.shape[0], x.shape[1]
    if t % seg_len:
        raise ValueError(f"flattened length {t} is not a whole number of "
                         f"{seg_len}-token segments")
    return x.reshape(b * (t // seg_len), seg_len, *x.shape[2:])


def unfold_segments(y: torch.Tensor, batch: int) -> torch.Tensor:
    """Inverse of :func:`fold_segments`."""
    bn, seg_len = y.shape[0], y.shape[1]
    return y.reshape(batch, (bn // batch) * seg_len, *y.shape[2:])


def apply_seq_transform(x: torch.Tensor, cfg: StampConfig,
                        axis: int = -2) -> torch.Tensor:
    if not cfg.enabled:
        return x
    return T.sequence_transform(
        x, cfg.seq_transform, axis=axis,
        levels=cfg.resolved_levels(x.shape[axis]),
        skip_first=cfg.skip_first_token)


def invert_seq_transform(y: torch.Tensor, cfg: StampConfig,
                         axis: int = -2) -> torch.Tensor:
    if not cfg.enabled:
        return y
    return T.inverse_sequence_transform(
        y, cfg.seq_transform, axis=axis,
        levels=cfg.resolved_levels(y.shape[axis]),
        skip_first=cfg.skip_first_token)


def _reference_quantize(x: torch.Tensor, cfg: StampConfig,
                        site: Optional[str] = None) -> torch.Tensor:
    """Transformed + mixed-precision fake-quantized activation, in f32
    (bf16 butterflies would move the min/max scales and flip codes).  With
    a telemetry scope open, ``site``'s quant-health stats are recorded."""
    tx = apply_seq_transform(x.float(), cfg)
    bits = cfg.bits_vector(tx.shape[-2], device=x.device)
    QS.record(site, tx, bits, cfg.hi_bits)
    return Q.fake_quant(tx, bits, axis=-1)


def _record_fused(x: torch.Tensor, cfg: StampConfig,
                  site: Optional[str]) -> None:
    """Quant-health telemetry of a fused site: the kernels fuse transform,
    quantize and GEMM, so the transform and the per-token statistics are
    recomputed here with plain PyTorch beside them (nothing when no scope
    is open, so a step without telemetry runs exactly its kernels)."""
    if not QS.active() or site is None or not cfg.enabled:
        return
    tx = apply_seq_transform(x.float(), cfg)
    QS.record(site, tx, cfg.bits_vector(tx.shape[-2], device=x.device),
              cfg.hi_bits)


def stamp_fake_quant(x: torch.Tensor, cfg: StampConfig,
                     seg_len: Optional[int] = None,
                     site: Optional[str] = None) -> torch.Tensor:
    """Full round trip ``L⁻¹ Q(L X)`` along the sequence axis ``-2``;
    ``seg_len`` marks a flattened batch of uniform spans along axis 1;
    ``site`` names the telemetry site."""
    if not cfg.enabled:
        return x
    if seg_len is not None and seg_len != x.shape[1]:
        return unfold_segments(
            stamp_fake_quant(fold_segments(x, seg_len), cfg, site=site),
            x.shape[0])
    return invert_seq_transform(_reference_quantize(x, cfg, site),
                                cfg).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class PreparedLinear:
    """Deployment weight buffers for the fused path: signed int8 codes plus
    per-output-channel f32 scale, (identically shifted) zero point and the
    codes' column sums, which the kernels' zero-point epilogue reads."""

    qw: torch.Tensor               # (din, dout) int8
    sw: torch.Tensor               # (1, dout) f32
    zw: torch.Tensor               # (1, dout) f32
    qw_sum: torch.Tensor           # (1, dout) int32, Σ over din of qw
    bias: Optional[torch.Tensor]   # (dout,) or None

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return ((self.qw.float() - self.zw) * self.sw).to(dtype)


def prepare_linear(w: torch.Tensor, b: Optional[torch.Tensor] = None,
                   bits: int = 8) -> PreparedLinear:
    """Per-output-channel min-max quantization of ``w`` (``(…, din,
    dout)``, reduced over ``din``) into signed int8 codes.  The range is
    anchored at zero so the shifted zero point is a small integer."""
    if bits > 8:
        raise ValueError("fused path stores weight codes in int8")
    n = float(2 ** bits - 1)
    shift = float(1 << (bits - 1))
    wf = w.float()
    mn = torch.clamp_max(wf.amin(dim=-2, keepdim=True), 0.0)
    mx = torch.clamp_min(wf.amax(dim=-2, keepdim=True), 0.0)
    sw = torch.clamp_min(Q.fdiv(mx - mn, n), Q.EPS)
    zp = torch.round(-mn / sw)
    q = torch.clamp(torch.round(wf / sw) + zp, 0.0, n)
    # contiguous codes whatever ``w``'s strides (a dequantized packed weight
    # is a transposed view): the kernels read them row-major
    qw = (q - shift).to(torch.int8).contiguous()
    return PreparedLinear(qw=qw, sw=sw, zw=zp - shift,
                          qw_sum=qw.sum(dim=-2, keepdim=True,
                                        dtype=torch.int32), bias=b)


def token_quantize(x: torch.Tensor, bits: int = 8) -> tuple:
    """Per-token asymmetric min-max quantize in the token domain — the
    grouped MoE path's dispatch-buffer format: each token is coded once,
    before dispatch, however many expert buckets it lands in.  Returns
    signed int8 codes plus ``(..., 1)`` f32 scale and identically shifted
    zero point.  The range divides by the constant ``2^bits - 1`` as the
    compiled reference does (:func:`~repro_torch.core.quant.div_const`);
    ``-mn / s`` and ``x / s`` stay true divisions."""
    n = float(2 ** bits - 1)
    shift = float(1 << (bits - 1))
    xf = x.float()
    mn = xf.amin(dim=-1, keepdim=True)
    mx = xf.amax(dim=-1, keepdim=True)
    s = torch.clamp_min(Q.div_const(mx - mn, n), Q.EPS)
    z = torch.round(-mn / s)
    q = (torch.clamp(torch.round(xf / s) + z, 0.0, n) - shift).to(torch.int8)
    return q, s, z - shift


def fused_ineligibility(cfg: StampConfig) -> tuple:
    """Why ``cfg`` cannot run the fused kernels (empty = eligible)."""
    reasons = []
    if not cfg.enabled:
        reasons.append("stamp_disabled")
    if cfg.execution != "fused":
        reasons.append("execution_reference")
    if cfg.granularity != "token":
        reasons.append(f"granularity_{cfg.granularity}")
    if cfg.seq_transform not in FUSABLE_TRANSFORMS:
        reasons.append(f"transform_not_fusable:{cfg.seq_transform}")
    if max(cfg.hi_bits, cfg.lo_bits, cfg.fused_weight_bits) > 8:
        reasons.append("bits_exceed_int8")
    return tuple(reasons)


def fused_eligible(cfg: StampConfig) -> bool:
    return not fused_ineligibility(cfg)


def _kernel_kwargs(cfg: StampConfig, s: int) -> dict:
    return dict(transform=cfg.seq_transform, levels=cfg.resolved_levels(s),
                skip_first=cfg.skip_first_token, num_hi=cfg.num_hi_tokens,
                hi_bits=cfg.hi_bits, lo_bits=cfg.lo_bits)


def stamp_linear(x: torch.Tensor, w: Optional[torch.Tensor],
                 b: Optional[torch.Tensor], cfg: StampConfig, *,
                 prepared: Optional[PreparedLinear] = None,
                 merge_heads: bool = False,
                 seg_len: Optional[int] = None,
                 site: Optional[str] = None) -> torch.Tensor:
    """STaMP linear layer (Fig. 2a).

    ``merge_heads`` marks ``x`` as the raw head-split ``(…, s, nh, hd)``
    attention output (out-proj site).  ``seg_len`` marks a flattened batch
    of uniform ``seg_len``-token spans: the transform applies per span.
    With ``cfg.execution == "fused"`` the chain runs on int8 weights
    (``prepared``, or prepared on the fly from ``w``).  ``site`` names the
    quant-telemetry site."""
    if seg_len is not None and x.ndim >= 3 and seg_len != x.shape[1]:
        y = stamp_linear(fold_segments(x, seg_len), w, b, cfg,
                         prepared=prepared, merge_heads=merge_heads,
                         site=site)
        return unfold_segments(y, x.shape[0])
    if merge_heads:
        x = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if fused_eligible(cfg):
        from repro_torch.kernels import ops
        _record_fused(x, cfg, site)
        prep = prepared if prepared is not None else \
            prepare_linear(w, b, bits=cfg.fused_weight_bits)
        bias = b if b is not None else prep.bias
        *lead, s, d = x.shape
        y = ops.stamp_quant_matmul(x.reshape(-1, s, d), prep.qw, prep.sw,
                                   prep.zw, prep.qw_sum, bias,
                                   out_dtype=x.dtype,
                                   **_kernel_kwargs(cfg, s))
        return y.reshape(*lead, s, y.shape[-1])
    if w is None and prepared is not None:
        w = prepared.dequant(x.dtype)
        b = prepared.bias if b is None else b
    if not cfg.enabled:
        y = x @ w.to(x.dtype)
    else:
        tq = _reference_quantize(x, cfg, site)
        y = invert_seq_transform(tq.to(x.dtype) @ w.to(x.dtype), cfg)
    return y + b.to(y.dtype) if b is not None else y


def stamp_dual_linear(x: torch.Tensor, w_gate: Optional[torch.Tensor],
                      w_up: Optional[torch.Tensor], cfg: StampConfig, *,
                      prepared_gate: Optional[PreparedLinear] = None,
                      prepared_up: Optional[PreparedLinear] = None,
                      seg_len: Optional[int] = None,
                      site: Optional[str] = None) -> torch.Tensor:
    """``silu(x·Wg)·(x·Wu)`` with ONE transform + quantize of ``x`` shared
    by both products (the SwiGLU front half).  The fused path is one
    quantize launch feeding a dual-output GEMM whose epilogue combines the
    inverse-transformed pair."""
    if seg_len is not None and seg_len != x.shape[1]:
        y = stamp_dual_linear(fold_segments(x, seg_len), w_gate, w_up, cfg,
                              prepared_gate=prepared_gate,
                              prepared_up=prepared_up, site=site)
        return unfold_segments(y, x.shape[0])
    if fused_eligible(cfg):
        from repro_torch.kernels import ops
        _record_fused(x, cfg, site)
        pg = prepared_gate if prepared_gate is not None else \
            prepare_linear(w_gate, bits=cfg.fused_weight_bits)
        pu = prepared_up if prepared_up is not None else \
            prepare_linear(w_up, bits=cfg.fused_weight_bits)
        *lead, s, d = x.shape
        y = ops.stamp_quant_dual_matmul(
            x.reshape(-1, s, d), pg.qw, pg.sw, pg.zw, pg.qw_sum, pu.qw,
            pu.sw, pu.zw, pu.qw_sum, pg.bias, pu.bias, out_dtype=x.dtype,
            **_kernel_kwargs(cfg, s))
        return y.reshape(*lead, s, y.shape[-1])
    bg = bu = None
    if w_gate is None:
        w_gate, bg = prepared_gate.dequant(x.dtype), prepared_gate.bias
        w_up, bu = prepared_up.dequant(x.dtype), prepared_up.bias
    if not cfg.enabled:
        g, u = x @ w_gate.to(x.dtype), x @ w_up.to(x.dtype)
    else:
        tq = _reference_quantize(x, cfg, site).to(x.dtype)
        g = invert_seq_transform(tq @ w_gate.to(x.dtype), cfg)
        u = invert_seq_transform(tq @ w_up.to(x.dtype), cfg)
    if bg is not None:
        g = g + bg.to(g.dtype)
    if bu is not None:
        u = u + bu.to(u.dtype)
    from repro_torch.kernels.stamp_matmul import silu
    return silu(g) * u
