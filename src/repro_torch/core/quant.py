"""Integer activation quantization (paper §2.1, Eq. 1) — the port of
``repro.core.quant``'s quantizers.

Activations are ``(..., s, d)``: sequence axis ``-2``, feature axis ``-1``.
``bits`` is a scalar or a per-token ``(s,)`` tensor (STaMP's mixed
precision).  Every quantizer here must give the reference's codes bit for
bit: min-max scales with a ``1e-8`` floor, round half to even
(``torch.round``) and true division (:func:`fdiv`) — except where the
reference divides by a constant inside a compiled program, which the port
evaluates as that program does (:func:`div_const`).

The fake-quant paths round through :func:`round_ste`, whose gradient is
the identity (a straight-through estimator), so a calibration-time learned
transform (FlatQuant-lite) can backpropagate through them as in the
reference.  The weight quantizer (RTN with a clip-range search, §B.2) and
the error metrics (Eq. 2, SQNR) close the module."""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

Bits = Union[int, float, torch.Tensor]

EPS = 1e-8


class RoundSTE(torch.autograd.Function):
    """Round half to even forward, identity backward (the reference's
    ``_round_ste``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return torch.round(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return g


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """``torch.round`` with a straight-through gradient."""
    return RoundSTE.apply(x)


def fdiv(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by true division on every device.  On CUDA, PyTorch turns
    a Python-scalar divisor into a multiplication by its reciprocal, which
    can differ from the division in the last bit and flip a quantizer code
    on a tie; a 0-dim tensor on ``x``'s device keeps the IEEE division the
    reference (and the CUDA kernels) perform."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def recip32(c: float) -> float:
    """The f32 reciprocal of ``f32(c)``, rounded as f32 division rounds."""
    return float(np.float32(1.0) / np.float32(c))


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a constant ``c`` as the reference's compiled programs
    evaluate it.  XLA rewrites a division by a constant into a
    multiplication by the constant's f32 reciprocal (``jax.jit`` of ``x /
    255.0`` computes ``x * f32(1/255)``), which can differ from the IEEE
    quotient in the last bit.  The reference runs its serving steps and
    kernels compiled, so the port's transforms and cache quantizers take
    the same product and their codes match the reference engine's."""
    return x * torch.tensor(recip32(c), dtype=x.dtype, device=x.device)


def levels(bits: Bits, device=None) -> torch.Tensor:
    """Number of representable steps ``2**b - 1`` as f32 (arrays too)."""
    b = torch.as_tensor(bits, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(2.0, device=device), b) - 1.0


def _align_token_axis(v: torch.Tensor, ndim: int,
                      reduced_axis: int) -> torch.Tensor:
    """Reshape a per-token ``(s,)`` vector to broadcast against a keepdims
    tensor of rank ``ndim`` whose ``reduced_axis`` was the feature axis."""
    reduced_axis = reduced_axis % ndim
    shape = [1] * ndim
    shape[reduced_axis - 1] = v.shape[0]
    return v.reshape(shape)


def minmax_scale_offset(x: torch.Tensor, bits: Bits, axis: int = -1,
                        compiled: bool = False, minmax=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric min-max ``(scale, zero_point)`` with ``axis`` kept.  The
    range divides by the level count truly; with ``compiled`` (a constant
    int ``bits``) by its f32 reciprocal's product (:func:`div_const`).
    ``minmax``: the ``(min, max)`` over ``axis`` (kept) to use in place of
    ``x``'s own — a row-parallel block's, all-reduced into the whole
    rows'."""
    xf = x.float()
    if minmax is None:
        mn = xf.amin(dim=axis, keepdim=True)
        mx = xf.amax(dim=axis, keepdim=True)
    else:
        mn, mx = (t.float() for t in minmax)
    if compiled:
        scale = div_const(mx - mn, float(2 ** bits - 1))
    else:
        n = levels(bits, device=x.device)
        if n.ndim:
            n = _align_token_axis(n, mn.ndim, axis)
        scale = (mx - mn) / n
    scale = torch.clamp_min(scale, EPS)
    zero_point = round_ste(-mn / scale)
    return scale, zero_point


def quantize(x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
             bits: Bits) -> torch.Tensor:
    """Eq. 1: ``clamp(round(x / s) + z, 0, 2^b - 1)``, kept in float."""
    n = levels(bits, device=x.device)
    if n.ndim:
        n = _align_token_axis(n, x.ndim, -1)
    q = round_ste(x.float() / scale) + zero_point
    # ``maximum`` / ``minimum`` split the gradient of a code on a bound as
    # the reference's clip does (``clamp`` passes all of it)
    return torch.minimum(torch.maximum(q, torch.zeros_like(n)), n)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero_point: torch.Tensor) -> torch.Tensor:
    return (q - zero_point) * scale


def saturate_int8(q: torch.Tensor) -> torch.Tensor:
    """``q.astype(int8)`` as the reference's conversion computes it: values
    out of range saturate at -128 / 127 (PyTorch's cast wraps them)."""
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def to_int(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Cast a float-held quantized tensor to its integer storage dtype."""
    return saturate_int8(q) if bits <= 8 else q.to(torch.int32)


def fake_quant(x: torch.Tensor, bits: Bits, axis: int = -1,
               out_dtype: Optional[torch.dtype] = None,
               compiled: bool = False, minmax=None) -> torch.Tensor:
    """Quantize-dequantize with per-``axis`` min-max scales.  Each site
    takes the form its twin in the reference computes: STaMP's per-token
    bit vector (``stamp_fake_quant``, the kernels' plain versions) divides
    the range by the level count truly; ``compiled`` is for a constant int
    ``bits`` inside one of the reference's compiled programs (the
    cross-attention's per-token ``lo_bits``), where XLA folds that
    division into a product with the reciprocal (:func:`div_const`) — a
    true division there flips a code on a tie now and then.  ``minmax``:
    the ``(min, max)`` to take in place of ``x``'s own (:func:`
    minmax_scale_offset`)."""
    scale, zp = minmax_scale_offset(x, bits, axis=axis, compiled=compiled,
                                    minmax=minmax)
    out = dequantize(quantize(x, scale, zp, bits), scale, zp)
    return out.to(out_dtype or x.dtype)


def fake_quant_per_block(x: torch.Tensor, bits: Bits, block_size: int,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """Per-(token, feature-block) quantization (the SVDQuant setting of
    Table 1): the feature axis splits into ``d // block_size`` groups, each
    with its own min-max scale."""
    *lead, d = x.shape
    if d % block_size:
        raise ValueError(f"feature dim {d} not divisible by block "
                         f"{block_size}")
    xb = x.reshape(*lead, d // block_size, block_size)
    return fake_quant(xb, bits, axis=-1,
                      out_dtype=out_dtype).reshape(*lead, d)


def mixed_precision_bits(seq_len: int, num_hi: int, hi_bits: int = 8,
                         lo_bits: int = 4, device=None) -> torch.Tensor:
    """STaMP's two-level bit vector: first ``num_hi`` tokens at ``hi_bits``,
    the rest at ``lo_bits`` (§3.3)."""
    idx = torch.arange(seq_len, device=device)
    return torch.where(idx < num_hi, float(hi_bits),
                       float(lo_bits)).float()


def average_bits(bits: torch.Tensor) -> float:
    return float(torch.as_tensor(bits, dtype=torch.float32).mean())


# ---------------------------------------------------------------------------
# weight quantization (RTN with clip-range search, paper §B.2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantizedWeight:
    """Integer weight codes plus their affine dequantization parameters
    (per output channel)."""

    q: torch.Tensor            # int8 storage (int4 values occupy [0, 15])
    scale: torch.Tensor        # f32, broadcastable against q
    zero_point: torch.Tensor
    bits: int

    def dequant(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequantize(self.q.float(), self.scale,
                          self.zero_point).to(dtype)


def shrink_candidates(num: int, min_shrink: float) -> np.ndarray:
    """``jnp.linspace(min_shrink, 1.0, num)`` in f32, by its formula
    (``start·(1 − i/(num−1)) + stop·i/(num−1)``, the endpoint appended);
    ``torch.linspace`` computes two of the 17 default values one bit
    apart."""
    div = num - 1
    step = np.arange(div, dtype=np.float32) / np.float32(div)
    out = np.float32(min_shrink) * (np.float32(1.0) - step) + \
        np.float32(1.0) * step
    return np.concatenate([out, [np.float32(1.0)]]).astype(np.float32)


def rtn_quantize_weight(w: torch.Tensor, bits: int = 4, axis: int = 0,
                        num_candidates: int = 17,
                        min_shrink: float = 0.6) -> QuantizedWeight:
    """Round-to-nearest weight quantization with a min-max range search:
    the range shrinks by each factor of ``[min_shrink, 1]`` and each
    channel keeps the candidate of least squared error (the first on a
    tie).  ``axis`` is reduced (the input features for per-output-channel
    scales).  The reference runs this eagerly, so every division is a true
    one; its int8 storage saturates, so 8-bit codes above 127 store as 127
    as in the reference (:func:`saturate_int8`)."""
    wf = w.float()
    mn = wf.amin(dim=axis, keepdim=True)
    mx = wf.amax(dim=axis, keepdim=True)
    n = float(2 ** bits - 1)
    shrinks = torch.from_numpy(shrink_candidates(num_candidates,
                                                 min_shrink)).to(wf.device)
    shape = (-1,) + (1,) * wf.ndim
    smn, smx = mn[None] * shrinks.view(shape), mx[None] * shrinks.view(shape)
    scales = torch.clamp_min(fdiv(smx - smn, n), EPS)
    zps = torch.round(-smn / scales)
    q = torch.clamp(torch.round(wf[None] / scales) + zps, 0.0, n)
    # the candidates lead, so a non-negative reduced axis moves up by one
    err = (((q - zps) * scales - wf[None]) ** 2).sum(
        dim=axis + 1 if axis >= 0 else axis, keepdim=True)
    best = torch.argmin(err, dim=0, keepdim=True)
    scale = torch.take_along_dim(scales, best, dim=0)[0]
    zp = torch.take_along_dim(zps, best, dim=0)[0]
    q = torch.clamp(torch.round(wf / scale) + zp, 0.0, n)
    return QuantizedWeight(q=saturate_int8(q), scale=scale, zero_point=zp,
                           bits=bits)


def quant_error(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Squared quantization error ``‖Q(x) − x‖²`` (Eq. 2)."""
    d = q.float() - x.float()
    return torch.sum(d * d)


def sqnr_db(orig: torch.Tensor, quant: torch.Tensor) -> torch.Tensor:
    """Signal-to-quantized-noise ratio in dB (§5.1)."""
    orig = orig.float()
    noise = orig - quant.float()
    num = torch.sum(orig ** 2)
    den = torch.clamp_min(torch.sum(noise ** 2), EPS)
    return 10.0 * torch.log10(num / den)
