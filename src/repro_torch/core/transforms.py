"""Orthonormal sequence transforms (paper §3, §3.2), the port of
``repro.core.transforms``: the Haar DWT, its 2-D form over a latent grid,
the orthonormal DCT-II, the Walsh–Hadamard transform and the calibrated
KLT.

All act along ``axis`` (default ``-2``, the sequence axis of ``(..., s,
d)`` activations).  Non-power-of-two lengths keep an identity tail, and
``skip_first`` keeps the first (attention-sink) token out of the transform,
so every operator stays square and orthonormal.  The operation order is the
reference's — the Haar butterflies scale each sum and difference by 1/√2,
the WHT scales by 1/√p once at the end — and each division by those
constants is the product with their f32 reciprocals, as the reference's
compiled kernels evaluate it (:func:`~repro_torch.core.quant.div_const`).
So the quantizer codes computed from these outputs equal the reference's
bit for bit; the CUDA kernels repeat the same order.  The DCT and the KLT
are dense ``(s, s)`` bases applied as one matrix product, whose summation
order is the BLAS's: their outputs agree with the reference's to f32
rounding, not bit for bit."""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
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


@functools.lru_cache(maxsize=32)
def subband_order(h: int, w: int, levels: int) -> np.ndarray:
    """The permutation that reads a 2-D Haar output in subband order: the
    last LL quadrant first, then each level's LH, HL and HH bands, the
    coarsest first — so the first tokens carry the most energy."""
    sizes = _quad_sizes(h, w, levels)
    lh, lw = (sizes[-1][0] // 2, sizes[-1][1] // 2) if sizes else (h, w)
    grid = np.arange(h * w).reshape(h, w)
    order = [grid[:lh, :lw].ravel()]
    for ph, pw in sizes[::-1]:
        hh, hw_ = ph // 2, pw // 2
        order.append(grid[:hh, hw_:pw].ravel())
        order.append(grid[hh:ph, :hw_].ravel())
        order.append(grid[hh:ph, hw_:pw].ravel())
    return np.concatenate(order)


def _quad_sizes(h: int, w: int, levels: int) -> list:
    sizes = []
    for _ in range(levels):
        if h < 2 or w < 2:
            break
        sizes.append((h, w))
        h, w = h // 2, w // 2
    return sizes


def _cols(fn, quad: torch.Tensor) -> torch.Tensor:
    return fn(quad.transpose(-1, -2)).transpose(-1, -2)


def haar_dwt_2d(x: torch.Tensor, hw: tuple, levels: int = 3,
                axis: int = -2) -> torch.Tensor:
    """2-D Haar DWT of a sequence that flattens an ``H × W`` latent grid:
    each level transforms the rows, then the columns, of the current
    low-pass quadrant; the result is read out in :func:`subband_order`."""
    h, w = hw
    x = x.movedim(axis, -1)
    if x.shape[-1] != h * w:
        raise ValueError(f"sequence {x.shape[-1]} != H*W {h * w}")
    img = x.reshape(*x.shape[:-1], h, w)
    for lh, lw in _quad_sizes(h, w, levels):
        quad = _cols(_haar_level, _haar_level(img[..., :lh, :lw]))
        img = img.clone()
        img[..., :lh, :lw] = quad
    perm = torch.from_numpy(subband_order(h, w, levels)).to(x.device)
    out = img.reshape(*x.shape[:-1], h * w).index_select(-1, perm)
    return out.movedim(-1, axis)


def haar_idwt_2d(y: torch.Tensor, hw: tuple, levels: int = 3,
                 axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`haar_dwt_2d`."""
    h, w = hw
    y = y.movedim(axis, -1)
    inv = torch.from_numpy(np.argsort(subband_order(h, w, levels))).to(
        y.device)
    img = y.index_select(-1, inv).reshape(*y.shape[:-1], h, w)
    for lh, lw in reversed(_quad_sizes(h, w, levels)):
        quad = _haar_level_inv(_cols(_haar_level_inv, img[..., :lh, :lw]))
        img = img.clone()
        img[..., :lh, :lw] = quad
    return img.reshape(*y.shape[:-1], h * w).movedim(-1, axis)


@functools.lru_cache(maxsize=32)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis, rows = basis vectors (row 0 = DC)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n))
    m[0] *= np.sqrt(1.0 / n)
    m[1:] *= np.sqrt(2.0 / n)
    return m.astype(np.float32)


def _dense(x: torch.Tensor, axis: int, skip_first: bool,
           inverse: bool) -> torch.Tensor:
    x = x.movedim(axis, -1)
    head, x0 = _split_head(x, skip_first)
    m = torch.from_numpy(dct_matrix(x0.shape[-1])).to(x0.device, x0.dtype)
    out = x0 @ (m if inverse else m.T)
    return _join_head(head, out).movedim(-1, axis)


def dct(x: torch.Tensor, axis: int = -2,
        skip_first: bool = False) -> torch.Tensor:
    return _dense(x, axis, skip_first, inverse=False)


def idct(y: torch.Tensor, axis: int = -2,
         skip_first: bool = False) -> torch.Tensor:
    return _dense(y, axis, skip_first, inverse=True)


def klt_basis(autocorr: np.ndarray) -> np.ndarray:
    """Rows = eigenvectors of the (s, s) autocorrelation ``S`` sorted by
    descending eigenvalue (§3.2: the optimal ``L`` is ``Uᵀ``)."""
    s = np.asarray(autocorr, np.float64)
    s = (s + s.T) / 2
    vals, vecs = np.linalg.eigh(s)
    order = np.argsort(vals)[::-1]
    return vecs[:, order].T.astype(np.float32)


def apply_matrix(x: torch.Tensor, m, axis: int = -2,
                 inverse: bool = False) -> torch.Tensor:
    """Apply an orthonormal basis ``m`` (rows = basis vectors) along
    ``axis``; ``inverse=True`` applies ``mᵀ``."""
    x = x.movedim(axis, -1)
    m = torch.as_tensor(m, dtype=x.dtype, device=x.device)
    out = x @ (m if inverse else m.T)
    return out.movedim(-1, axis)


def sequence_transform(x: torch.Tensor, kind: str, axis: int = -2,
                       levels: int = 3, skip_first: bool = False,
                       hw: Optional[tuple] = None,
                       basis=None) -> torch.Tensor:
    """Dispatch on the paper's transform names (``dwt2d`` needs the latent
    grid ``hw``, ``klt`` its calibrated ``basis``)."""
    if kind in ("none", "identity"):
        return x
    if kind == "dwt":
        return haar_dwt(x, levels=levels, axis=axis, skip_first=skip_first)
    if kind == "dwt2d":
        if hw is None:
            raise ValueError("dwt2d needs the (H, W) latent grid")
        return haar_dwt_2d(x, hw, levels=levels, axis=axis)
    if kind == "dct":
        return dct(x, axis=axis, skip_first=skip_first)
    if kind == "wht":
        return wht(x, axis=axis, skip_first=skip_first)
    if kind == "klt":
        if basis is None:
            raise ValueError("klt needs a calibrated basis")
        return apply_matrix(x, basis, axis=axis)
    raise ValueError(f"unknown sequence transform {kind!r}")


def inverse_sequence_transform(y: torch.Tensor, kind: str, axis: int = -2,
                               levels: int = 3, skip_first: bool = False,
                               hw: Optional[tuple] = None,
                               basis=None) -> torch.Tensor:
    if kind in ("none", "identity"):
        return y
    if kind == "dwt":
        return haar_idwt(y, levels=levels, axis=axis, skip_first=skip_first)
    if kind == "dwt2d":
        if hw is None:
            raise ValueError("dwt2d needs the (H, W) latent grid")
        return haar_idwt_2d(y, hw, levels=levels, axis=axis)
    if kind == "dct":
        return idct(y, axis=axis, skip_first=skip_first)
    if kind == "wht":
        return iwht(y, axis=axis, skip_first=skip_first)
    if kind == "klt":
        if basis is None:
            raise ValueError("klt needs a calibrated basis")
        return apply_matrix(y, basis, axis=axis, inverse=True)
    raise ValueError(f"unknown sequence transform {kind!r}")
