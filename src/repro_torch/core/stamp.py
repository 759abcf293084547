"""STaMP: the sequence-transformed, mixed-precision linear layer (Fig. 2a),
ported from ``repro.core.stamp``.

    1.  ``T = L · X``            (sequence transform, §3)
    2.  ``T = T · R``            (optional feature transform; ``R⁻¹`` is
                                  folded into W by the caller)
    3.  ``Tq = Q(T)``            (mixed-precision quantize, first ``num_hi``
                                  tokens at ``hi_bits``; per token, or per
                                  (token, feature block))
    4.  ``Y = Tq · W``           (W, or its RTN codes dequantized)
    5.  ``y = L⁻¹ · Y + 1βᵀ``    (inverse transform, then bias — Eq. 7)

``execution="reference"`` runs these as separate PyTorch ops on float
weights; ``execution="fused"`` runs them on prepared int8 weights through
`repro_torch.kernels.ops` (the Hopper kernels on a CUDA tensor, their plain
versions on a CPU tensor).  The dense bases (``dct``, ``klt``), the 2-D
DWT, per-block scales and feature rotations have no fused kernel in the
reference either: they stay on the reference path
(:func:`fused_ineligibility`).
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

    seq_transform: str = "dwt"       # none | dwt | dwt2d | dct | wht | klt
    levels: Optional[int] = None     # None = auto: log2(seq / num_hi)
    num_hi_tokens: int = 64
    hi_bits: int = 8
    lo_bits: int = 4
    skip_first_token: bool = True    # attention-sink exception (§B.2)
    granularity: str = "token"       # token | block
    block_size: int = 64
    hw: Optional[tuple] = None       # (H, W) latent grid for dwt2d
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

    def average_bits(self, seq_len: int) -> float:
        return Q.average_bits(self.bits_vector(seq_len))


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
                        axis: int = -2, basis=None) -> torch.Tensor:
    """``L · x`` along ``axis`` (``basis``: the KLT's calibrated rows)."""
    if not cfg.enabled:
        return x
    return T.sequence_transform(
        x, cfg.seq_transform, axis=axis,
        levels=cfg.resolved_levels(x.shape[axis]),
        skip_first=cfg.skip_first_token, hw=cfg.hw, basis=basis)


def invert_seq_transform(y: torch.Tensor, cfg: StampConfig,
                         axis: int = -2, basis=None) -> torch.Tensor:
    if not cfg.enabled:
        return y
    return T.inverse_sequence_transform(
        y, cfg.seq_transform, axis=axis,
        levels=cfg.resolved_levels(y.shape[axis]),
        skip_first=cfg.skip_first_token, hw=cfg.hw, basis=basis)


def blockwise_mixed(tx: torch.Tensor, bits: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """Per-(token, feature block) min-max fake quantization with per-token
    ``bits`` (``granularity="block"``); a feature width that is no whole
    number of blocks falls back to per-token scales, as in the
    reference."""
    *lead, s, d = tx.shape
    if d % block_size:
        return Q.fake_quant(tx, bits, axis=-1)
    xb = tx.reshape(*lead, s, d // block_size, block_size)
    n = (2.0 ** bits[:, None] - 1.0)[..., None]
    mn = xb.amin(dim=-1, keepdim=True)
    mx = xb.amax(dim=-1, keepdim=True)
    scale = torch.clamp_min((mx - mn) / n, Q.EPS)
    zp = torch.round(-mn / scale)
    q = torch.minimum(torch.clamp_min(torch.round(xb / scale) + zp, 0.0), n)
    return ((q - zp) * scale).to(tx.dtype).reshape(*lead, s, d)


def _row_minmax(tx: torch.Tensor, split) -> tuple:
    """The whole rows' ``(min, max)`` (kept dim) of a row-parallel block
    ``tx``: its own, all-reduced over the model ranks."""
    return split.minmax(tx.amin(dim=-1, keepdim=True),
                        tx.amax(dim=-1, keepdim=True))


def _record(site: Optional[str], tx: torch.Tensor, cfg: StampConfig,
            split=None) -> None:
    """Quant-health stats of ``site``'s transformed activation; a
    row-parallel block's with the whole rows' scales
    (:func:`~repro_torch.obs.quantstats.record`)."""
    if not QS.active() or site is None:
        return
    bits = cfg.bits_vector(tx.shape[-2], device=tx.device)
    if split is None:
        QS.record(site, tx, bits, cfg.hi_bits)
        return
    scale, zp = Q.minmax_scale_offset(tx, bits, axis=-1,
                                      minmax=_row_minmax(tx, split))
    QS.record(site, tx, bits, cfg.hi_bits, scale, zp, split)


def _reference_quantize(x: torch.Tensor, cfg: StampConfig,
                        site: Optional[str] = None, basis=None,
                        feature_rot: Optional[torch.Tensor] = None,
                        axis: int = -2, split=None) -> torch.Tensor:
    """Transformed (and feature-rotated) mixed-precision fake-quantized
    activation, in f32 (bf16 butterflies would move the min/max scales and
    flip codes).  With a telemetry scope open, ``site``'s quant-health
    stats are recorded (for the ``(…, s, d)`` layout only).  Under a model
    ``split`` ``x`` is a row-parallel block: the sequence transform is per
    feature, so its transformed values are the whole rows' block, and
    each row's min / max is all-reduced over the model ranks before the
    quantize (per-(token, feature block) scales need no exchange where
    the block holds whole feature blocks)."""
    tx = apply_seq_transform(x.float(), cfg, axis=axis, basis=basis)
    if feature_rot is not None:
        tx = tx @ feature_rot.to(tx.dtype)
    bits = cfg.bits_vector(tx.shape[axis], device=x.device)
    if split is not None and (feature_rot is not None or
                              axis not in (-2, x.ndim - 2)):
        raise NotImplementedError("a row-parallel STaMP block takes no "
                                  "feature rotation and quantizes rows")
    if axis in (-2, x.ndim - 2):
        _record(site, tx, cfg, split)
    if cfg.granularity == "block":
        if split is not None and tx.shape[-1] % cfg.block_size:
            raise NotImplementedError(
                f"a row-parallel block of {tx.shape[-1]} features does not "
                f"hold whole {cfg.block_size}-feature quantizer blocks")
        return blockwise_mixed(tx, bits, cfg.block_size)
    minmax = None if split is None else _row_minmax(tx, split)
    return Q.fake_quant(tx, bits, axis=-1, minmax=minmax)


def _record_fused(x: torch.Tensor, cfg: StampConfig,
                  site: Optional[str], split=None) -> None:
    """Quant-health telemetry of a fused site: the kernels fuse transform,
    quantize and GEMM, so the transform and the per-token statistics are
    recomputed here with plain PyTorch beside them (nothing when no scope
    is open, so a step without telemetry runs exactly its kernels)."""
    if not QS.active() or site is None or not cfg.enabled:
        return
    _record(site, apply_seq_transform(x.float(), cfg), cfg, split)


def stamp_fake_quant(x: torch.Tensor, cfg: StampConfig, axis: int = -2,
                     basis=None, seg_len: Optional[int] = None,
                     site: Optional[str] = None, split=None) -> torch.Tensor:
    """Full round trip ``L⁻¹ Q(L X)`` along ``axis`` (``basis``: the KLT's
    rows); ``seg_len`` marks a flattened batch of uniform spans along axis
    1; ``site`` names the telemetry site; under a model ``split`` ``x`` is
    a row-parallel block quantized with the whole rows' statistics
    (:func:`_reference_quantize`), its round trip the whole one's
    block."""
    if not cfg.enabled:
        return x
    if seg_len is not None and seg_len != x.shape[1]:
        if axis not in (-2, x.ndim - 2):
            raise ValueError("segments fold along axis 1")
        return unfold_segments(
            stamp_fake_quant(fold_segments(x, seg_len), cfg, basis=basis,
                             site=site, split=split), x.shape[0])
    tq = _reference_quantize(x, cfg, site, basis=basis, axis=axis,
                             split=split)
    return invert_seq_transform(tq, cfg, axis=axis, basis=basis).to(x.dtype)


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


def _prepared(qw: torch.Tensor, sw, zw, b) -> PreparedLinear:
    # contiguous codes whatever their strides (a dequantized packed weight
    # is a transposed view): the kernels read them row-major
    qw = qw.contiguous()
    return PreparedLinear(qw=qw, sw=sw, zw=zw,
                          qw_sum=qw.sum(dim=-2, keepdim=True,
                                        dtype=torch.int32), bias=b)


def prepare_linear(w: Optional[torch.Tensor] = None,
                   b: Optional[torch.Tensor] = None, bits: int = 8, *,
                   w_quant: Optional[Q.QuantizedWeight] = None
                   ) -> PreparedLinear:
    """The fused path's weight buffers.  From ``w_quant`` its integer codes
    are reused bit for bit, shifted into signed storage with the zero
    point shifted alike; from a raw ``w`` (``(…, din, dout)``, reduced over
    ``din``) a per-output-channel min-max quantization at ``bits``, its
    range anchored at zero so the shifted zero point is a small
    integer."""
    if w_quant is not None:
        if w_quant.bits > 8:
            raise ValueError("fused path stores weight codes in int8")
        shift = 1 << (w_quant.bits - 1)
        return _prepared((w_quant.q.int() - shift).to(torch.int8),
                         w_quant.scale.float(),
                         (w_quant.zero_point - shift).float(), b)
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
    return _prepared((q - shift).to(torch.int8), sw, zp - shift, b)


def token_quantize(x: torch.Tensor, bits: int = 8, minmax=None) -> tuple:
    """Per-token asymmetric min-max quantize in the token domain — the
    grouped MoE path's dispatch-buffer format: each token is coded once,
    before dispatch, however many expert buckets it lands in.  Returns
    signed int8 codes plus ``(..., 1)`` f32 scale and identically shifted
    zero point.  The range divides by the constant ``2^bits - 1`` as the
    compiled reference does (:func:`~repro_torch.core.quant.div_const`);
    ``-mn / s`` and ``x / s`` stay true divisions.  ``minmax``: the
    ``(min, max)`` (kept dim) to take in place of the rows' own."""
    n = float(2 ** bits - 1)
    shift = float(1 << (bits - 1))
    xf = x.float()
    if minmax is None:
        mn = xf.amin(dim=-1, keepdim=True)
        mx = xf.amax(dim=-1, keepdim=True)
    else:
        mn, mx = (t.float() for t in minmax)
    s = torch.clamp_min(Q.div_const(mx - mn, n), Q.EPS)
    z = torch.round(-mn / s)
    q = (torch.clamp(torch.round(xf / s) + z, 0.0, n) - shift).to(torch.int8)
    return q, s, z - shift


def fused_ineligibility(cfg: StampConfig,
                        feature_rot: Optional[torch.Tensor] = None) -> tuple:
    """Why ``cfg`` (with a feature rotation, if given) cannot run the fused
    kernels (empty = eligible)."""
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
    if feature_rot is not None:
        reasons.append("feature_rotation")
    return tuple(reasons)


def fused_eligible(cfg: StampConfig,
                   feature_rot: Optional[torch.Tensor] = None) -> bool:
    return not fused_ineligibility(cfg, feature_rot)


def _kernel_kwargs(cfg: StampConfig, s: int) -> dict:
    return dict(transform=cfg.seq_transform, levels=cfg.resolved_levels(s),
                skip_first=cfg.skip_first_token, num_hi=cfg.num_hi_tokens,
                hi_bits=cfg.hi_bits, lo_bits=cfg.lo_bits)


def stamp_linear(x: torch.Tensor, w: Optional[torch.Tensor],
                 b: Optional[torch.Tensor], cfg: StampConfig, *,
                 w_quant: Optional[Q.QuantizedWeight] = None,
                 basis=None, feature_rot: Optional[torch.Tensor] = None,
                 prepared: Optional[PreparedLinear] = None,
                 merge_heads: bool = False,
                 seg_len: Optional[int] = None,
                 site: Optional[str] = None, split=None) -> torch.Tensor:
    """STaMP linear layer (Fig. 2a).

    ``w_quant`` replaces ``w`` by its RTN codes (dequantized on the
    reference path, taken as they are by the fused path when ``bits ≤
    8``).  ``basis`` is the KLT's calibrated rows.  ``feature_rot`` is the
    feature transform ``R`` applied to the transformed activation; the
    caller folds ``R⁻¹`` into ``w``.  ``merge_heads`` marks ``x`` as the
    raw head-split ``(…, s, nh, hd)`` attention output (out-proj site).
    ``seg_len`` marks a flattened batch of uniform ``seg_len``-token spans:
    the transform applies per span.  With ``cfg.execution == "fused"`` the
    chain runs on int8 weights (``prepared``, or prepared on the fly from
    ``w_quant`` or ``w``).  ``site`` names the quant-telemetry site.
    Under a model ``split`` the fused layer is row-parallel: ``x`` is this
    rank's block of the input features and the weight its rows; the
    block is quantized with the whole rows' statistics (K1's statistics
    mode, their all-reduce, K1 with them), K2 writes the block's int32
    products and row sums, and their integer all-reduce is finished by
    K2's epilogue on every rank: one device's output, bit for bit."""
    if seg_len is not None and x.ndim >= 3 and seg_len != x.shape[1]:
        y = stamp_linear(fold_segments(x, seg_len), w, b, cfg,
                         w_quant=w_quant, basis=basis,
                         feature_rot=feature_rot, prepared=prepared,
                         merge_heads=merge_heads, site=site, split=split)
        return unfold_segments(y, x.shape[0])
    if merge_heads:
        x = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    if fused_eligible(cfg, feature_rot) and \
            (w_quant is None or w_quant.bits <= 8):
        from repro_torch.kernels import ops
        _record_fused(x, cfg, site, split)
        prep = prepared if prepared is not None else \
            prepare_linear(w, b, bits=cfg.fused_weight_bits,
                           w_quant=w_quant)
        bias = b if b is not None else prep.bias
        *lead, s, d = x.shape
        if split is None:
            y = ops.stamp_quant_matmul(x.reshape(-1, s, d), prep.qw,
                                       prep.sw, prep.zw, prep.qw_sum, bias,
                                       out_dtype=x.dtype,
                                       **_kernel_kwargs(cfg, s))
        else:
            y = ops.stamp_quant_matmul(
                x.reshape(-1, s, d), prep.qw, prep.sw, prep.zw, prep.qw_sum,
                bias, out_dtype=x.dtype, row_minmax=split.minmax,
                sum_parts=split.sum, **_kernel_kwargs(cfg, s))
        return y.reshape(*lead, s, y.shape[-1])
    if split is not None:
        raise NotImplementedError("a row-parallel STaMP linear runs the "
                                  "fused chain (the reference execution "
                                  "quantizes with stamp_fake_quant)")
    if w_quant is not None:
        w = w_quant.dequant(x.dtype)
    elif w is None and prepared is not None:
        w = prepared.dequant(x.dtype)
        b = prepared.bias if b is None else b
    if not cfg.enabled:
        y = x @ w.to(x.dtype)
    else:
        tq = _reference_quantize(x, cfg, site, basis=basis,
                                 feature_rot=feature_rot)
        y = invert_seq_transform(tq.to(x.dtype) @ w.to(x.dtype), cfg,
                                 basis=basis)
    return y + b.to(y.dtype) if b is not None else y


def stamp_dual_linear(x: torch.Tensor, w_gate: Optional[torch.Tensor],
                      w_up: Optional[torch.Tensor], cfg: StampConfig, *,
                      basis=None,
                      prepared_gate: Optional[PreparedLinear] = None,
                      prepared_up: Optional[PreparedLinear] = None,
                      seg_len: Optional[int] = None,
                      site: Optional[str] = None) -> torch.Tensor:
    """``silu(x·Wg)·(x·Wu)`` with ONE transform + quantize of ``x`` shared
    by both products (the SwiGLU front half; ``basis``: the KLT's rows).
    The fused path is one quantize launch feeding a dual-output GEMM whose
    epilogue combines the inverse-transformed pair."""
    if seg_len is not None and seg_len != x.shape[1]:
        y = stamp_dual_linear(fold_segments(x, seg_len), w_gate, w_up, cfg,
                              basis=basis, prepared_gate=prepared_gate,
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
        tq = _reference_quantize(x, cfg, site, basis=basis).to(x.dtype)
        g = invert_seq_transform(tq @ w_gate.to(x.dtype), cfg, basis=basis)
        u = invert_seq_transform(tq @ w_up.to(x.dtype), cfg, basis=basis)
    if bg is not None:
        g = g + bg.to(g.dtype)
    if bu is not None:
        u = u + bu.to(u.dtype)
    from repro_torch.kernels.stamp_matmul import silu
    return silu(g) * u
