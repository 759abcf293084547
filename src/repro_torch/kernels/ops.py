"""Public entry points of the port's kernels (the twin of
``repro.kernels.ops``).  The fused STaMP linears are the K1 → K2 chain
(with the span link ``stamp_span_transform`` over long spans; over a
flattened batch of uniform spans, ``stamp_quant_segment_matmul``), the
grouped MoE expert FFN is K5, the contiguous cache's decode attention K6;
the standalone kernel library is ``int8_matmul`` (K7), ``quantize_pack``
(K8), ``haar_dwt_seq`` (K9) and ``walsh_hadamard`` (K10), with the
reference's signatures less ``interpret`` and ``block_d`` (a Pallas tile
that changes no number).  Every wrapper launches its CUDA kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.cache_attention import cache_decode_attention
from repro_torch.kernels.decode_matmul import stamp_decode_matmul
from repro_torch.kernels.haar_dwt import haar_dwt_seq
from repro_torch.kernels.int8_gemm import int8_matmul
from repro_torch.kernels.paged_attention import (  # noqa: F401
    paged_decode_attention, paged_ragged_attention)
from repro_torch.kernels.quant_pack import quantize_pack
from repro_torch.kernels import stamp_matmul as SM
from repro_torch.kernels.stamp_matmul import (stamp_int_gemm,
                                              stamp_span_transform,
                                              stamp_transform_quantize)
from repro_torch.kernels.wht import walsh_hadamard

#: every kernel wrapper: the serve paths' and the standalone library's;
#: each carries a ``launches`` count
KERNELS = (stamp_transform_quantize, stamp_int_gemm, stamp_decode_matmul,
           paged_ragged_attention, SM.stamp_quant_grouped_matmul,
           cache_decode_attention, int8_matmul, quantize_pack, haar_dwt_seq,
           walsh_hadamard, stamp_span_transform)


def reset_launch_counts() -> None:
    """Every wrapper's count to 0, its counts of launches in a mode
    (``stats_launches`` …) too."""
    for k in KERNELS:
        for name in list(vars(k)):
            if name.endswith("launches"):
                setattr(k, name, 0)


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def _quantize(x, transform, levels, skip_first, num_hi, hi_bits, lo_bits,
              row_minmax=None):
    """K1 over ``x``; with ``row_minmax`` (a row-parallel block) K1's
    statistics mode, ``row_minmax(min, max)`` (the all-reduce over the
    model ranks), then K1 with the whole rows' statistics — after the
    span link's forward transform, once, where K1's windows cannot hold
    the span."""
    kw = dict(transform=transform, levels=levels, skip_first=skip_first,
              num_hi=num_hi, hi_bits=hi_bits, lo_bits=lo_bits)
    x = x.contiguous()
    if row_minmax is None:
        return stamp_transform_quantize(x, **kw)
    if transform in SM._KINDS and not SM.tq_fits(x.shape[1], transform,
                                                 levels, skip_first):
        x = stamp_span_transform(x, transform=transform, levels=levels,
                                 skip_first=skip_first)
        kw["transform"] = "none"
    stats = stamp_transform_quantize(x, stats_only=True, **kw)
    mn, mx = row_minmax(stats[:, 0], stats[:, 1])
    return stamp_transform_quantize(x, row_stats=torch.stack([mn, mx], -1),
                                    **kw)


def stamp_quant_matmul(x: torch.Tensor, qw, sw, zw, qw_sum,
                       bias: Optional[torch.Tensor] = None, *,
                       transform: str = "dwt", levels: int = 3,
                       skip_first: bool = True, num_hi: int = 64,
                       hi_bits: int = 8, lo_bits: int = 4,
                       out_dtype=None, row_minmax=None,
                       sum_parts=None) -> torch.Tensor:
    """Fused STaMP linear ``L⁻¹(Q(L·x)·W) + bias``: x (b, s, K) → (b, s,
    N); ``qw`` (K, N) int8, ``sw/zw`` (1, N) f32, ``qw_sum`` (1, N) int32
    (``PreparedLinear``'s buffers).  ``row_minmax`` and ``sum_parts``: ``x``
    is a row-parallel block (``qw`` the weight's rows of its K range,
    ``sw`` / ``zw`` the whole columns'), whose rows' ``(min, max)``
    ``row_minmax`` makes the whole rows' (:func:`_quantize`) and whose
    int32 parts ``sum_parts`` sums over the blocks (K2's parts and summed
    modes): the result is then the whole product, one device's bit for
    bit."""
    qx, sx, zx = _quantize(x, transform, levels, skip_first, num_hi,
                           hi_bits, lo_bits, row_minmax)
    kw = dict(transform=transform, levels=levels, skip_first=skip_first,
              out_dtype=out_dtype or x.dtype)
    if sum_parts is not None:
        parts = sum_parts(SM.stamp_int_gemm_parts(qx, x.shape[1], qw,
                                                  qw_sum))
        return SM.stamp_int_gemm_summed(parts, sx, zx, x.shape[1], sw, zw,
                                        bias, **kw)
    return stamp_int_gemm(qx, sx, zx, x.shape[1], qw, sw, zw, qw_sum, bias,
                          **kw)


def stamp_quant_segment_matmul(x: torch.Tensor, qw, sw, zw, qw_sum,
                               bias: Optional[torch.Tensor] = None, *,
                               seg_len: int, **kw) -> torch.Tensor:
    """The twin of ``stamp_quant_segment_matmul_pallas``: the fused STaMP
    linear over a flattened batch of uniform ``seg_len``-token spans ``x``
    (b, n·seg_len, K) (or head-split (b, n·seg_len, nh, hd)).  The
    transform runs per span, never across the flattened batch: the spans
    fold onto the batch axis through :func:`stamp_quant_matmul` (``kw``:
    its STaMP settings) and unfold to (b, n·seg_len, N) — the same numbers
    as one call per span."""
    b, t = x.shape[0], x.shape[1]
    if t % seg_len:
        raise ValueError(f"flattened length {t} is not a whole number of "
                         f"{seg_len}-token segments")
    y = stamp_quant_matmul(x.reshape(b * (t // seg_len), seg_len, -1), qw,
                           sw, zw, qw_sum, bias, **kw)
    return y.reshape(b, t, y.shape[-1])


def stamp_quant_dual_matmul(x: torch.Tensor, qw_g, sw_g, zw_g, qw_sum_g,
                            qw_u, sw_u, zw_u, qw_sum_u, bias_g=None,
                            bias_u=None, *, transform: str = "dwt",
                            levels: int = 3, skip_first: bool = True,
                            num_hi: int = 64, hi_bits: int = 8,
                            lo_bits: int = 4,
                            out_dtype=None) -> torch.Tensor:
    """Fused gate/up pair: ONE quantize of ``x`` feeds both GEMMs and the
    epilogue returns ``silu(g)·u``."""
    qx, sx, zx = _quantize(x, transform, levels, skip_first, num_hi,
                           hi_bits, lo_bits)
    return stamp_int_gemm(qx, sx, zx, x.shape[1], qw_g, sw_g, zw_g, qw_sum_g,
                          bias_g, qw_u, sw_u, zw_u, qw_sum_u, bias_u,
                          transform=transform, levels=levels,
                          skip_first=skip_first,
                          out_dtype=out_dtype or x.dtype)


def stamp_quant_grouped_matmul(qx, sx, zx, counts, qw_gate, sw_gate,
                               zw_gate, qs_gate, qw_up, sw_up, zw_up, qs_up,
                               qw_down, sw_down, zw_down, qs_down, *,
                               block_c: int = 128, block_f: int = 512,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Grouped MoE expert FFN over the quantized dispatch buffer (K5):
    ``qx/sx/zx`` (b, E, C, d) codes with per-token scale / shifted zero
    point, ``counts`` (b, E) occupancy, the stacked prepared expert buffers
    with their column sums (``qs_down``: per ``block_f`` slab).  Returns
    the (b, E, C, d) expert outputs for the combine.  ``block_c`` is kept
    only to mirror the reference's signature: it is the Pallas kernel's
    capacity tile, rows are independent, so it changes no number, and K5
    reads it nowhere (it tiles the rows its own way)."""
    return SM.stamp_quant_grouped_matmul(
        qx, sx, zx, counts, qw_gate, sw_gate, zw_gate, qs_gate, qw_up,
        sw_up, zw_up, qs_up, qw_down, sw_down, zw_down, qs_down,
        block_f=block_f, out_dtype=out_dtype)
