"""Orthonormal Walsh–Hadamard transform: K10 ``walsh_hadamard`` (CUDA
source: ``csrc/wht.cu``).

Replaces ``wht_pallas`` (``src/repro/kernels/wht.py``): the WHT of ``(b,
s, d)`` activations along the sequence (axis -2) or the features (axis
-1), butterfly stages h = 1, 2, 4, … in f32 and one scale by f32(1/√n).
A K10 block stages a tile of ``w`` transform vectors of ``T`` elements in
shared memory and runs the tile's stages.  Where the whole transform fits
one tile that is one launch; otherwise :func:`plan` splits the stages over
two launches through an f32 scratch (see the source note), which keeps
every output's tree of additions the plain version's.

Bound on the H100: bytes — one read and one write of the activation (two of
each, through the scratch, when split).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import transforms as T
from repro_torch.core.quant import recip32
from repro_torch.kernels import cuda

BLOCK = 128                  # the reference's tile: its shape checks
SMEM_BYTES = 200 * 1024      # one block's f32 tile at most
SEQ_SMEM_BYTES = 100 * 1024  # sequence tiles: two or more blocks an SM
FEATURE_SMEM_BYTES = 48 * 1024   # feature tiles: smaller, more blocks an SM
MAX_WIDTH = 32               # transform vectors a block
MIN_SEQ_WIDTH = 8            # sequence mode: columns one row read covers

_SIGNATURES = {"wht_tiles": [
    cuda.VP, cuda.INT, cuda.VP, cuda.INT, cuda.INT, cuda.LL, cuda.INT,
    cuda.INT, cuda.INT, cuda.INT, cuda.LL, cuda.INT, cuda.LL, cuda.INT,
    cuda.INT, cuda.FLT, cuda.VP]}


class Launch(NamedTuple):
    """One K10 launch: ``tiles`` tiles of ``T`` elements along the
    transform axis, tile ``t``'s element ``j`` at index ``t·tmul +
    j·istride``, ``w`` vectors a block; ``last`` scales and writes the
    output (else an f32 scratch)."""
    T: int
    tiles: int
    tmul: int
    istride: int
    w: int
    last: bool


def _width(t: int, budget: int) -> int:
    """The most vectors (a power of two, at most ``MAX_WIDTH``) whose
    padded f32 tiles of ``t`` elements fit ``budget`` bytes; 0 if none."""
    fit = budget // (4 * (t + 1))
    return min(1 << (fit.bit_length() - 1), MAX_WIDTH) if fit else 0


def plan(n: int, feature: bool) -> list:
    """K10's launches for a transform of length ``n`` (a power of two):
    one whole-vector tile where it fits (sequence mode: at least
    ``MIN_SEQ_WIDTH`` columns), as many vectors as a smaller budget allows
    so that several blocks share an SM, else the stages ``h < 2^a`` on
    contiguous tiles of ``2^a`` and the stages ``h >= 2^a`` on tiles spaced
    ``2^a`` apart, ``a = ceil(log2(n) / 2)``."""
    wmin = 1 if feature else MIN_SEQ_WIDTH
    w = _width(n, FEATURE_SMEM_BYTES if feature else SEQ_SMEM_BYTES)
    if w < wmin:
        w = _width(n, SMEM_BYTES)
    if w >= wmin:
        return [Launch(n, 1, n, 1, w, True)]
    t1 = 1 << ((n.bit_length() - 1 + 1) // 2)
    t2 = n // t1
    w1, w2 = _width(t1, SMEM_BYTES), _width(t2, SMEM_BYTES)
    if min(w1, w2) < wmin:
        raise ValueError(f"K10 transforms up to 2^24 elements, not {n}")
    return [Launch(t1, t2, t1, 1, w1, False), Launch(t2, t1, 1, t1, w2, True)]


def _is_seq(axis: int) -> bool:
    return axis in (-2, 1)


def wht_plain(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Plain version of K10 (the Pallas ``_wht_seq_kernel`` /
    ``_wht_feat_kernel``): the port's WHT on ``x.float()`` along the
    sequence or the features, then one cast back."""
    return T.wht(x.float(), axis=-2 if _is_seq(axis) else -1).to(x.dtype)


def walsh_hadamard(x: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """K10.  ``x``: (b, s, d) f32, bf16 or f16; ``axis`` -2 (or 1)
    transforms the sequence, any other value the features, as in the
    reference.  The transformed length must be a power of two."""
    if x.dim() != 3:
        raise ValueError(f"walsh_hadamard takes (b, s, d), got "
                         f"{tuple(x.shape)}")
    b, s, d = x.shape
    seq = _is_seq(axis)
    if seq:
        n = s
        if n & (n - 1):
            raise ValueError(f"seq {n} not a power of two")
        if d % BLOCK:
            raise ValueError(f"d={d} not divisible by block={BLOCK}")
    else:
        n = d
        if n & (n - 1):
            raise ValueError(f"feature dim {n} not a power of two")
        if s % BLOCK and s >= BLOCK:
            raise ValueError(f"seq {s} not divisible by block={BLOCK}")
    if x.device.type == "cpu":
        return wht_plain(x, axis)
    code = cuda.float_code(x.dtype, "K10")
    cuda.require_cuda(x)
    # sequence mode: vectors are the d columns of each batch; feature
    # mode: the b·s rows
    geo = (b, s * d, d, d, 1) if seq else (1, 0, 1, b * s, d)
    batches, bstride, ax, nvec, vstride = geo
    lib = cuda.library("wht", _SIGNATURES)
    r = recip32(math.sqrt(n)) if n else 1.0
    src, src_code = x, code
    for st in plan(max(n, 1), not seq):
        dst = torch.empty(x.shape, dtype=x.dtype if st.last else torch.float32,
                          device=x.device)
        dst_code = code if st.last else 0
        err = lib.wht_tiles(
            src.data_ptr(), src_code, dst.data_ptr(), dst_code, batches,
            bstride, st.T, st.tiles, st.tmul, st.istride, ax, nvec, vstride,
            st.w, int(st.last), r, cuda.stream_ptr(x))
        cuda.check(err, "walsh_hadamard")
        walsh_hadamard.launches += 1
        src, src_code = dst, dst_code
    return src


walsh_hadamard.launches = 0
