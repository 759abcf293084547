"""Decode attention over the contiguous packed KV cache: K6
``cache_decode_attention`` (CUDA source: ``csrc/cache_attention.cu``).

Replaces ``cache_decode_attention`` (``src/repro/kernels/cache_attention.py``),
the bucketed engine's fused decode attention: one query token per batch row
over that row's int8 hi region (the first ``hi_len`` tokens) and int4-nibble
lo region, with f16 per-(token, head) scale / zero point, under the mask
``pos < length``.  The kernel splits each row's positions over several blocks
(flash-decoding) and merges their partial softmax states in a second launch,
in a fixed order; its plain version (``ref.cache_decode_attention_ref``)
keeps the Pallas kernel's block order, so the two agree to rounding.

Bound on the H100: bytes — the packed cache, its scales and zero points.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import cache_decode_attention_ref

_HEAD_DIMS = (16, 32, 64, 112, 128)   # every config's (Kimi-K2: 112)
_MAX_REP = 8
_CODES = ("k_hi", "v_hi", "k_lo", "v_lo")
_PARAMS = ("k_scale", "k_zp", "v_scale", "v_zp")

_SIGNATURES = {
    "cache_attention": [cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT,
                        cuda.INT, cuda.INT, cuda.INT, *([cuda.VP] * 8),
                        cuda.VP, cuda.INT, cuda.INT, cuda.FLT, cuda.VP,
                        cuda.VP, cuda.VP],
    "cache_attention_split_len": [cuda.INT, cuda.INT, cuda.INT, cuda.INT]}


def cache_decode_attention(entry: dict, q: torch.Tensor,
                           length: torch.Tensor) -> torch.Tensor:
    """K6.  ``entry``: one layer's contiguous cache (``k_hi / v_hi`` (b, hi,
    g, hd) int8, ``k_lo / v_lo`` (b, S − hi, g, hd/2) uint8, ``*_scale /
    *_zp`` (b, S, g) f16); ``q``: (b, 1, h, hd) bf16 or f32; ``length``:
    (b,) or (1,) int32, at least 1 per row.  Returns (b, 1, h, hd) in q's
    dtype.  CPU tensors run the plain version; CUDA tensors launch the
    kernel or raise."""
    if q.device.type == "cpu":
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
    sms = cuda.sm_count(q.device)
    split_len = lib.cache_attention_split_len(b, g, s_total, sms)
    n_split = -(-s_total // split_len)
    part = torch.empty((b, g, n_split, h // g, hd + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    err = lib.cache_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), b, h, g, hd, hi_len,
        s_total, *(t.data_ptr() for t in bufs), length.data_ptr(),
        split_len, n_split, 1.0 / math.sqrt(hd),
        part.data_ptr(), out.data_ptr(), cuda.stream_ptr(q))
    cuda.check(err, "cache_attention")
    cache_decode_attention.launches += 1
    return out


cache_decode_attention.launches = 0
