"""Decode attention over the contiguous packed KV cache: K6
``cache_decode_attention`` (CUDA source: ``csrc/cache_attention.cu``).

Replaces ``cache_decode_attention`` (``src/repro/kernels/cache_attention.py``),
the bucketed engine's fused decode attention: one query token per batch row
over that row's int8 hi region (the first ``hi_len`` tokens) and int4-nibble
lo region, with f16 per-(token, head) scale / zero point, under the mask
``pos < length``.  The kernel splits each row's tiles (``TILE_HI`` hi and
``TILE_LO`` lo positions) into ranges over several blocks (flash-decoding,
:func:`launch_plan`) and merges their partial softmax states in a second
launch, in a fixed order; its plain version
(``ref.cache_decode_attention_ref``) keeps the Pallas kernel's block order,
so the two agree to rounding.

Bound on the H100: bytes — the packed cache, its scales and zero points.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import (cache_block_attention_ref,
                                     cache_decode_attention_ref,
                                     merge_states_ref)

# every config's head_dim (Kimi-K2: 112, PixArt-Σ: 72)
_HEAD_DIMS = (16, 32, 64, 72, 112, 128)
_MAX_REP = 8
_CODES = ("k_hi", "v_hi", "k_lo", "v_lo")
_PARAMS = ("k_scale", "k_zp", "v_scale", "v_zp")

TILE_HI, TILE_LO = 64, 128   # a tile's positions (csrc/cache_attention.cu)
FILL = 8                     # blocks an SM the ranges aim at, rows full

_SIGNATURES = {
    "cache_attention": [cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT,
                        cuda.INT, cuda.INT, cuda.INT, *([cuda.VP] * 8),
                        cuda.VP, cuda.INT, cuda.INT, cuda.FLT, cuda.VP,
                        cuda.VP, cuda.INT, cuda.INT, cuda.VP, cuda.VP],
    "cache_attention_merge_states": [cuda.VP, cuda.INT, cuda.INT, cuda.INT,
                                     cuda.INT, cuda.INT, cuda.INT, cuda.VP,
                                     cuda.VP]}
#: a block's first position for a region the rank does not read: past
#: every length
NEVER = 1 << 30


def tiles(hi_len: int, s_total: int) -> list:
    """A row's tiles as (first position, positions, hi): the hi region in
    tiles of ``TILE_HI``, then the lo region in tiles of ``TILE_LO``."""
    out = [(t, min(TILE_HI, hi_len - t), True)
           for t in range(0, hi_len, TILE_HI)]
    return out + [(t, min(TILE_LO, s_total - t), False)
                  for t in range(hi_len, s_total, TILE_LO)]


def launch_plan(b: int, g: int, hi_len: int, s_total: int,
                sms: int) -> tuple:
    """``(tiles_per_range, n_split)``: each (b, g) row's tiles cut into
    ``n_split`` ranges of whole tiles, enough for about ``FILL`` blocks on
    each of the card's ``sms`` multiprocessors when every row is full."""
    n_tiles = len(tiles(hi_len, s_total))
    splits = min(max(-(-FILL * max(sms, 1) // (b * g)), 1), n_tiles)
    per = -(-n_tiles // splits)
    return per, -(-n_tiles // per)


def cache_decode_attention(entry: dict, q: torch.Tensor,
                           length: torch.Tensor,
                           block: Optional[tuple] = None) -> torch.Tensor:
    """K6.  ``entry``: one layer's contiguous cache (``k_hi / v_hi`` (b, hi,
    g, hd) int8, ``k_lo / v_lo`` (b, S − hi, g, hd/2) uint8, ``*_scale /
    *_zp`` (b, S, g) f16); ``q``: (b, 1, h, hd) bf16 or f32; ``length``:
    (b,) or (1,) int32, at least 1 per row.  Returns (b, 1, h, hd) in q's
    dtype.  CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise.

    Block mode, ``block = (hi0, lo0)``: ``entry`` is one rank's block of a
    sequence-split cache, its hi positions at global ``hi0 + i`` and its lo
    positions at ``lo0 + i`` (:data:`NEVER` for a region this rank does
    not read), ``length`` global; returns the block's merged partial state
    ``(b, g, h / g, hd + 2)`` f32 (``m``, ``-inf`` where no position is
    valid; ``l``; the unnormalised sum) for :func:`merge_states`.  Counted
    also in ``block_launches``."""
    if q.device.type == "cpu":
        if block is not None:
            return cache_block_attention_ref(entry, q, length, *block)
        return cache_decode_attention_ref(entry, q, length)
    b, one, h, hd = q.shape
    hi_len, g = entry["k_hi"].shape[1], entry["k_hi"].shape[2]
    s_total = entry["k_scale"].shape[1]
    if one != 1 or hd not in _HEAD_DIMS or h % g or h // g > _MAX_REP:
        raise ValueError(f"K6 takes one query token, head_dim in "
                         f"{_HEAD_DIMS} and whole GQA groups of at most "
                         f"{_MAX_REP} heads; got q {tuple(q.shape)}, g={g}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("K6 takes bf16 or f32 queries")
    if entry["k_lo"].shape[1] != s_total - hi_len:
        raise ValueError("cache regions do not add up to its length")
    q = q.contiguous()
    length = length.to(torch.int32).reshape(-1).expand(b).contiguous()
    bufs = [entry[k] for k in _CODES + _PARAMS]
    cuda.require_cuda(q, length, *bufs)
    if any(entry[k].data_ptr() % 16 for k in _CODES):
        raise ValueError("K6 reads cache codes in 16-byte vectors: the "
                         "buffers must be 16-byte aligned")
    lib = cuda.library("cache_attention", _SIGNATURES)
    per, n_split = launch_plan(b, g, hi_len, s_total,
                               cuda.sm_count(q.device))
    part = torch.empty((b, g, n_split, h // g, hd + 2), dtype=torch.float32,
                       device=q.device)
    hi0, lo0 = (0, hi_len) if block is None else (int(v) for v in block)
    state = None if block is None else torch.empty(
        (b, g, h // g, hd + 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q) if block is None else state
    err = lib.cache_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), b, h, g, hd, hi_len,
        s_total, *(t.data_ptr() for t in bufs), length.data_ptr(),
        per, n_split, 1.0 / math.sqrt(hd),
        part.data_ptr(), out.data_ptr(), hi0, lo0, cuda.ptr(state),
        cuda.stream_ptr(q))
    cuda.check(err, "cache_attention")
    cache_decode_attention.launches += 1
    if block is not None:
        cache_decode_attention.block_launches += 1
    return out


cache_decode_attention.launches = 0
cache_decode_attention.block_launches = 0


def merge_states(parts: torch.Tensor, dtype) -> torch.Tensor:
    """K6's merge over the ranks' block states of a sequence-split cache:
    ``parts`` ``(n, b, g, h / g, hd + 2)`` f32 in rank order (a state
    with ``m = -inf`` weighs 0) → ``(b, 1, h, hd)`` in ``dtype`` — the
    kernel that merges K6's own ranges, launched on the gathered states
    (counted in K6's ``launches`` and ``merge_launches``)."""
    if parts.device.type == "cpu":
        return merge_states_ref(parts, dtype)
    n, b, g, rep, hd2 = parts.shape
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("K6 writes bf16 or f32")
    parts = parts.float().permute(1, 2, 0, 3, 4).contiguous()
    cuda.require_cuda(parts)
    out = torch.empty((b, 1, g * rep, hd2 - 2), dtype=dtype,
                      device=parts.device)
    err = cuda.library("cache_attention", _SIGNATURES).\
        cache_attention_merge_states(
            parts.data_ptr(), int(dtype == torch.bfloat16), b, g * rep, g,
            hd2 - 2, n, out.data_ptr(), cuda.stream_ptr(parts))
    cuda.check(err, "cache_attention_merge_states")
    cache_decode_attention.launches += 1
    cache_decode_attention.merge_launches += 1
    return out


cache_decode_attention.merge_launches = 0
