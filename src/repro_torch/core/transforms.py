"""Orthonormal sequence transforms (paper §3, §3.2): the Haar DWT and the
Walsh–Hadamard transform of ``repro.core.transforms``.

Both act along ``axis`` (default ``-2``, the sequence axis of ``(..., s,
d)`` activations).  Non-power-of-two lengths keep an identity tail, and
``skip_first`` keeps the first (attention-sink) token out of the transform,
so every operator stays square and orthonormal.  The operation order is the
reference's — the Haar butterflies scale each sum and difference by 1/√2,
the WHT scales by 1/√p once at the end — and each division by those
constants is the product with their f32 reciprocals, as the reference's
compiled kernels evaluate it (:func:`~repro_torch.core.quant.div_const`).
So the quantizer codes computed from these outputs equal the reference's
bit for bit; the CUDA kernels repeat the same order."""

from __future__ import annotations

import math

import torch

from repro_torch.core.quant import div_const

SQRT2 = math.sqrt(2.0)


def _haar_level(x: torch.Tensor) -> torch.Tensor:
    """One orthonormal Haar pass along the last axis; an odd tail element
    passes through."""
    n = x.shape[-1]
    pairs = n // 2
    even = x[..., 0:2 * pairs:2]
    odd = x[..., 1:2 * pairs:2]
    parts = [div_const(even + odd, SQRT2), div_const(even - odd, SQRT2)]
    if n % 2:
        parts.append(x[..., -1:])
    return torch.cat(parts, dim=-1)


def _haar_level_inv(y: torch.Tensor) -> torch.Tensor:
    n = y.shape[-1]
    pairs = n // 2
    approx = y[..., :pairs]
    detail = y[..., pairs:2 * pairs]
    even = div_const(approx + detail, SQRT2)
    odd = div_const(approx - detail, SQRT2)
    out = torch.stack([even, odd], dim=-1).reshape(*y.shape[:-1], 2 * pairs)
    if n % 2:
        out = torch.cat([out, y[..., -1:]], dim=-1)
    return out


def haar_band_sizes(n: int, levels: int) -> list[int]:
    """Low-pass band length before each level: ``[n, ceil(n/2), …]``,
    stopping once a band is shorter than 2."""
    sizes = [n]
    lo = n
    for _ in range(levels):
        if lo < 2:
            break
        lo = (lo + 1) // 2
        sizes.append(lo)
    return sizes


def _split_head(x: torch.Tensor, skip_first: bool):
    return (x[..., :1], x[..., 1:]) if skip_first else (None, x)


def _join_head(head, out: torch.Tensor) -> torch.Tensor:
    return out if head is None else torch.cat([head, out], dim=-1)


def haar_dwt(x: torch.Tensor, levels: int = 3, axis: int = -2,
             skip_first: bool = False) -> torch.Tensor:
    """Multi-level Haar DWT along ``axis``: each level transforms only the
    low-pass band of the previous one."""
    x = x.movedim(axis, -1)
    head, out = _split_head(x, skip_first)
    for lo in haar_band_sizes(out.shape[-1], levels)[:-1]:
        out = torch.cat([_haar_level(out[..., :lo]), out[..., lo:]], dim=-1)
    return _join_head(head, out).movedim(-1, axis)


def haar_idwt(y: torch.Tensor, levels: int = 3, axis: int = -2,
              skip_first: bool = False) -> torch.Tensor:
    """Inverse of :func:`haar_dwt` (same ``levels`` / ``skip_first``)."""
    y = y.movedim(axis, -1)
    head, out = _split_head(y, skip_first)
    for lo in reversed(haar_band_sizes(out.shape[-1], levels)[:-1]):
        out = torch.cat([_haar_level_inv(out[..., :lo]), out[..., lo:]],
                        dim=-1)
    return _join_head(head, out).movedim(-1, axis)


def largest_pow2(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n else 0


def wht(x: torch.Tensor, axis: int = -2,
        skip_first: bool = False) -> torch.Tensor:
    """Fast Walsh–Hadamard transform over the largest power-of-two prefix;
    the remainder passes through."""
    x = x.movedim(axis, -1)
    head, x0 = _split_head(x, skip_first)
    p = largest_pow2(x0.shape[-1])
    body, tail = x0[..., :p], x0[..., p:]
    h = 1
    while h < p:
        shaped = body.reshape(*body.shape[:-1], p // (2 * h), 2, h)
        a, b = shaped[..., 0, :], shaped[..., 1, :]
        body = torch.stack([a + b, a - b], dim=-2).reshape(
            *body.shape[:-1], p)
        h *= 2
    body = div_const(body, math.sqrt(p)) if p else body
    out = torch.cat([body, tail], dim=-1)
    return _join_head(head, out).movedim(-1, axis)


def iwht(y: torch.Tensor, axis: int = -2,
         skip_first: bool = False) -> torch.Tensor:
    """The orthonormal WHT is its own inverse on the power-of-two block."""
    return wht(y, axis=axis, skip_first=skip_first)


def sequence_transform(x: torch.Tensor, kind: str, axis: int = -2,
                       levels: int = 3,
                       skip_first: bool = False) -> torch.Tensor:
    if kind in ("none", "identity"):
        return x
    if kind == "dwt":
        return haar_dwt(x, levels=levels, axis=axis, skip_first=skip_first)
    if kind == "wht":
        return wht(x, axis=axis, skip_first=skip_first)
    raise ValueError(f"sequence transform {kind!r} is not ported "
                     f"(ported: none, dwt, wht)")


def inverse_sequence_transform(y: torch.Tensor, kind: str, axis: int = -2,
                               levels: int = 3,
                               skip_first: bool = False) -> torch.Tensor:
    if kind in ("none", "identity"):
        return y
    if kind == "dwt":
        return haar_idwt(y, levels=levels, axis=axis, skip_first=skip_first)
    if kind == "wht":
        return iwht(y, axis=axis, skip_first=skip_first)
    raise ValueError(f"sequence transform {kind!r} is not ported "
                     f"(ported: none, dwt, wht)")
