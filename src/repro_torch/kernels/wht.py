"""Orthonormal Walsh–Hadamard transform: K10 ``walsh_hadamard`` (CUDA
source: ``csrc/wht.cu``).

Replaces ``wht_pallas`` (``src/repro/kernels/wht.py``): the WHT of ``(b,
s, d)`` activations along the sequence (axis -2) or the features (axis
-1), butterfly stages h = 1, 2, 4, … in f32 and one scale by f32(1/√n).
A K10 block takes a tile of ``w`` transform vectors of ``T`` elements and
runs its stages three or four at a time in registers, with one pass through
shared memory between them (see the source note).  Where the whole
transform fits one tile that is one launch; otherwise :func:`plan` splits
the stages over two launches through an f32 scratch, which keeps every
output's tree of additions the plain version's.

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
SMEM_BYTES = 64 * 1024       # a block's f32 tile: three blocks an SM
MAX_SMEM_BYTES = 128 * 1024  # one block an SM, for the longest tiles
SECTOR = 32                  # bytes a row piece of a sequence tile spans
FEATURE_TILE = 32768         # the longest feature vector one launch takes
THREADS = 256                # a block's threads aimed at (1024 at most)
MAX_WIDTH = 1024             # vectors a block

_SIGNATURES = {"wht_tiles": [
    cuda.VP, cuda.INT, cuda.VP, cuda.INT, cuda.INT, cuda.LL, cuda.INT,
    cuda.INT, cuda.INT, cuda.INT, cuda.LL, cuda.INT, cuda.LL, cuda.INT,
    cuda.INT, cuda.FLT, cuda.VP]}


class Launch(NamedTuple):
    """One K10 launch: ``batches`` batches ``bstride`` elements apart, each
    ``tiles`` tiles of ``T`` elements along the transform axis over ``nvec``
    vectors ``vstride`` apart, ``w`` vectors a block; element ``j`` of
    vector ``c`` of tile ``t`` at ``c·vstride + (t·tmul + j·istride)·ax``.
    ``last`` scales and writes the output (else an f32 scratch)."""
    batches: int
    bstride: int
    T: int
    tiles: int
    tmul: int
    istride: int
    ax: int
    nvec: int
    vstride: int
    w: int
    last: bool


def _pow2_floor(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


def _pow2_ceil(v: int) -> int:
    return 1 << max(v - 1, 0).bit_length()


def _width(t: int, nvec: int, chunk_vectors: bool, itemsize: int = 4
           ) -> int:
    """Vectors a block for tiles of ``t`` elements: as many as keep the f32
    tile within ``SMEM_BYTES`` (no shared memory is used when the stages
    all fit one thread's registers: at most 8 chunk positions) and give a
    block about ``THREADS`` threads of 8 chunks, but no more than the
    vectors there are.  Sequence tiles hold whole chunks of 4 vectors and
    rows of at least ``SECTOR`` bytes of ``itemsize``-byte elements, so
    that no write leaves part of a memory sector to another block."""
    positions = t if chunk_vectors else t // 4
    # a block's threads: positions · (w / 4 or w) chunks over 8 a thread
    w = (32 if chunk_vectors else 8) * THREADS // positions
    if positions > 8:
        w = min(w, SMEM_BYTES // (4 * t))
    w = min(_pow2_floor(w), MAX_WIDTH, _pow2_ceil(nvec))
    return max(w, 4, SECTOR // itemsize) if chunk_vectors else max(w, 1)


def plan(b: int, s: int, d: int, seq: bool, itemsize: int = 4) -> list:
    """K10's launches for a (b, s, d) transform along the sequence (``seq``)
    or the features of ``itemsize``-byte elements; the transformed length
    ``n`` is a power of two.  One launch where one tile holds a whole
    vector (sequence mode: ``SECTOR``-byte rows within ``MAX_SMEM_BYTES``);
    else the stages h < T1 on contiguous tiles of T1 and the stages h >= T1
    on tiles spaced T1 apart (sequence mode: the longest tile that fits;
    feature mode: T1 = 16384, the second launch seeing each row as (n / T1,
    T1) and transforming its sequence axis)."""
    if seq:
        n, geo = s, (b, s * d, d, d, 1)
        longest = MAX_SMEM_BYTES // (4 * max(SECTOR // itemsize, 4))
        if n <= longest:
            return [Launch(*geo[:2], n, 1, n, 1, *geo[2:],
                           _width(n, d, True, itemsize), True)]
        t1 = longest
        t2 = n // t1
        return [Launch(*geo[:2], t1, t2, t1, 1, *geo[2:],
                       _width(t1, d, True, 4), False),
                Launch(*geo[:2], t2, t1, 1, t1, *geo[2:],
                       _width(t2, d, True, itemsize), True)]
    n, rows = d, b * s
    if n < 4 or n <= FEATURE_TILE:
        w = 1 if n < 4 else _width(n, rows, False)
        return [Launch(1, 0, n, 1, n, 1, 1, rows, n, w, True)]
    t1 = 16384
    t2 = n // t1
    return [Launch(1, 0, t1, 1, t1, 1, 1, rows * t2, t1,
                   _width(t1, rows * t2, False), False),
            Launch(rows, n, t2, 1, t2, 1, t1, t1, 1,
                   _width(t2, t1, True, itemsize), True)]


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
    if x.data_ptr() % 16:          # chunks load as 8- or 16-byte vectors
        x = x.clone()
    if not x.numel():
        return torch.empty_like(x)
    lib = cuda.library("wht", _SIGNATURES)
    r = recip32(math.sqrt(n))
    src, src_code = x, code
    for st in plan(b, s, d, seq, x.element_size()):
        dst = torch.empty(x.shape, dtype=x.dtype if st.last else torch.float32,
                          device=x.device)
        dst_code = code if st.last else 0
        err = lib.wht_tiles(
            src.data_ptr(), src_code, dst.data_ptr(), dst_code, st.batches,
            st.bstride, st.T, st.tiles, st.tmul, st.istride, st.ax, st.nvec,
            st.vstride, st.w, int(st.last), r, cuda.stream_ptr(x))
        cuda.check(err, "walsh_hadamard")
        walsh_hadamard.launches += 1
        src, src_code = dst, dst_code
    return src


walsh_hadamard.launches = 0
