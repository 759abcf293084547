"""Integer activation quantization (paper §2.1, Eq. 1) — the port of
``repro.core.quant``'s quantizers.

Activations are ``(..., s, d)``: sequence axis ``-2``, feature axis ``-1``.
``bits`` is a scalar or a per-token ``(s,)`` tensor (STaMP's mixed
precision).  Every quantizer here must give the reference's codes bit for
bit: min-max scales with a ``1e-8`` floor, round half to even
(``torch.round``) and true division (:func:`fdiv`) — except where the
reference divides by a constant inside a compiled program, which the port
evaluates as that program does (:func:`div_const`)."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

Bits = Union[int, float, torch.Tensor]

EPS = 1e-8


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
                        compiled: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Asymmetric min-max ``(scale, zero_point)`` with ``axis`` kept.  The
    range divides by the level count truly; with ``compiled`` (a constant
    int ``bits``) by its f32 reciprocal's product (:func:`div_const`)."""
    xf = x.float()
    mn = xf.amin(dim=axis, keepdim=True)
    mx = xf.amax(dim=axis, keepdim=True)
    if compiled:
        scale = div_const(mx - mn, float(2 ** bits - 1))
    else:
        n = levels(bits, device=x.device)
        if n.ndim:
            n = _align_token_axis(n, mn.ndim, axis)
        scale = (mx - mn) / n
    scale = torch.clamp_min(scale, EPS)
    zero_point = torch.round(-mn / scale)
    return scale, zero_point


def quantize(x: torch.Tensor, scale: torch.Tensor, zero_point: torch.Tensor,
             bits: Bits) -> torch.Tensor:
    """Eq. 1: ``clamp(round(x / s) + z, 0, 2^b - 1)``, kept in float."""
    n = levels(bits, device=x.device)
    if n.ndim:
        n = _align_token_axis(n, x.ndim, -1)
    q = torch.round(x.float() / scale) + zero_point
    return torch.minimum(torch.clamp_min(q, 0.0), n)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               zero_point: torch.Tensor) -> torch.Tensor:
    return (q - zero_point) * scale


def fake_quant(x: torch.Tensor, bits: Bits, axis: int = -1,
               out_dtype: Optional[torch.dtype] = None,
               compiled: bool = False) -> torch.Tensor:
    """Quantize-dequantize with per-``axis`` min-max scales.  Each site
    takes the form its twin in the reference computes: STaMP's per-token
    bit vector (``stamp_fake_quant``, the kernels' plain versions) divides
    the range by the level count truly; ``compiled`` is for a constant int
    ``bits`` inside one of the reference's compiled programs (the
    cross-attention's per-token ``lo_bits``), where XLA folds that
    division into a product with the reciprocal (:func:`div_const`) — a
    true division there flips a code on a tie now and then."""
    scale, zp = minmax_scale_offset(x, bits, axis=axis, compiled=compiled)
    out = dequantize(quantize(x, scale, zp, bits), scale, zp)
    return out.to(out_dtype or x.dtype)


def mixed_precision_bits(seq_len: int, num_hi: int, hi_bits: int = 8,
                         lo_bits: int = 4, device=None) -> torch.Tensor:
    """STaMP's two-level bit vector: first ``num_hi`` tokens at ``hi_bits``,
    the rest at ``lo_bits`` (§3.3)."""
    idx = torch.arange(seq_len, device=device)
    return torch.where(idx < num_hi, float(hi_bits),
                       float(lo_bits)).float()


def average_bits(bits: torch.Tensor) -> float:
    return float(torch.as_tensor(bits, dtype=torch.float32).mean())
