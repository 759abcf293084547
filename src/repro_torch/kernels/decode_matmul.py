"""Single-token STaMP decode matmul: K3 ``stamp_decode_matmul`` (CUDA
source: ``csrc/decode_matmul.cu``).

Replaces ``stamp_decode_matmul_pallas`` (``src/repro/kernels/
decode_matmul.py``): per-row 8-bit min-max quantize of the decode tokens,
int8 GEMM against the prepared int8 weight, zero-point epilogue and bias.
Decode spans are single tokens, so no sequence transform applies.

Bound on the H100: bytes — the (K, N) int8 weight is read once per call
and an 8-row product does 16 operations per weight byte.  One launch: a
block streams a (K range, column strip) slab of the weight for a tile of
up to ``ROWS`` rows through a deep ring of 16-byte copies; the K ranges
of a strip form a thread block cluster, which shares the rows' min / max
(every block quantizes its own range with the whole row's scale) and sums
the ranges' int32 products in distributed shared memory before the
epilogue (see the source note).  :func:`decode_plan` sizes the launch.

A row-parallel block of a model split: :func:`decode_row_minmax` (the
statistics mode) gives its rows' (min, max), all-reduced into the whole
rows'; the parts mode (:func:`stamp_decode_matmul_parts`) quantizes the
block with them and writes its int32 products and row sums instead of
its epilogue, and the summed mode
(:func:`stamp_decode_matmul_summed`) finishes the ranks' summed parts:
one launch over the whole rows, bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.core.stamp import token_quantize
from repro_torch.kernels import cuda
from repro_torch.kernels.stamp_matmul import (_epilogue, int_gemm_parts_plain,
                                              int_matmul)

ROWS = 8             # decode rows a block (any M is tiled by them)
STRIPS = (256, 128)  # weight columns a block: the wider unless it idles SMs
STAGE_K = 32         # k rows a stage of the ring
MAX_SPLIT = 8        # k ranges of a cluster
MIN_RANGE_K = 256    # k rows a range holds at least
FILL = 3             # blocks an SM the plan aims at (one wave)

_SIGNATURES = {
    "stamp_decode_matmul": [
        cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.VP, cuda.VP,
        cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT,
        cuda.VP, cuda.INT, cuda.VP, cuda.VP, cuda.VP],
    "stamp_decode_matmul_summed": [cuda.VP, cuda.VP, cuda.INT, cuda.INT,
                                   cuda.VP, cuda.VP, cuda.VP, cuda.VP,
                                   cuda.INT, cuda.VP],
    "decode_row_minmax": [cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.VP,
                          cuda.VP]}


def _lib():
    return cuda.library("decode_matmul", _SIGNATURES)


def row_quantize8(x: torch.Tensor, row_stats=None) -> tuple:
    """Per-row 8-bit asymmetric min-max quantize of ``(M, K)`` rows: signed
    int8 codes plus ``(M,)`` f32 scale and shifted zero point (the Pallas
    decode kernel's quantizer, which is :func:`token_quantize`'s);
    ``row_stats`` (M, 2): the rows' ``(min, max)`` to take in place of
    their own."""
    minmax = None if row_stats is None else \
        row_stats.float()[:, :, None].unbind(1)
    q, s, z = token_quantize(x, minmax=minmax)
    return q, s[:, 0], z[:, 0]


def row_minmax_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K3's statistics mode: ``(M, 2)`` f32 rows' ``(min,
    max)``."""
    xf = x.float()
    return torch.stack([xf.amin(dim=-1), xf.amax(dim=-1)], dim=-1)


def decode_row_minmax(x: torch.Tensor) -> torch.Tensor:
    """K3's statistics mode for a row-parallel block of a model split: each
    of the ``(M, K)`` rows' ``(min, max)`` over this block, ``(M, 2)`` f32
    (all-reduced over the ranks, they are :func:`stamp_decode_matmul`'s
    ``row_stats`` of its parts and summed modes).  Counted in K3's
    ``launches`` and ``stats_launches``.
    A kernel rather than ``torch.aminmax``, which takes 1.6-4x its device
    time on these rows (``chip_smoke.py``'s ``[split_mode]`` lines)."""
    if x.device.type == "cpu":
        return row_minmax_plain(x)
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K3's statistics take (M, K) bf16 or f32 rows, "
                         f"got {tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    cuda.require_cuda(x)
    out = torch.empty((x.shape[0], 2), dtype=torch.float32, device=x.device)
    err = _lib().decode_row_minmax(x.data_ptr(),
                                   int(x.dtype == torch.bfloat16),
                                   x.shape[0], x.shape[1], out.data_ptr(),
                                   cuda.stream_ptr(x))
    cuda.check(err, "decode_row_minmax")
    stamp_decode_matmul.launches += 1
    stamp_decode_matmul.stats_launches += 1
    return out


def decode_matmul_plain(x, qw, sw, zw, qw_sum, bias=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K3.  ``x``: (M, K); returns (M, N)."""
    qx, sx, zx = row_quantize8(x)
    y = _epilogue(int_matmul(qx, qw), sx, zx, sw.reshape(1, -1).float(),
                  zw.reshape(1, -1).float(), qx.sum(dim=1, dtype=torch.int32),
                  qw_sum.reshape(-1), qx.shape[1])
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y.to(out_dtype)


def decode_parts_plain(x, qw, qw_sum, row_stats) -> torch.Tensor:
    """Plain version of K3's parts mode (:func:`stamp_decode_matmul_parts`):
    K2's parts layout over the rows' codes quantized with ``row_stats``."""
    return int_gemm_parts_plain(row_quantize8(x, row_stats)[0], qw, qw_sum)


def decode_summed_plain(parts, row_stats, sw, zw, bias=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K3's summed mode (:func:`stamp_decode_matmul_summed`):
    :func:`decode_matmul_plain`'s epilogue over the summed parts, with the
    scale and zero point ``row_stats`` give."""
    m, n = parts.shape[0] - 1, parts.shape[1] - 1
    mn, mx = row_stats.float()[:, :, None].unbind(1)
    _, sx, zx = token_quantize(torch.zeros_like(mn), minmax=(mn, mx))
    y = _epilogue(parts[:m, :n], sx[:, 0], zx[:, 0], sw.reshape(1, -1).float(),
                  zw.reshape(1, -1).float(), parts[:m, n], parts[m, :n],
                  int(parts[m, n]))
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y.to(out_dtype)


def decode_plan(m: int, k: int, n: int, sms: int) -> dict:
    """K3's launch: strips of ``strip`` columns, row tiles of ``ROWS``, and
    ``n_split`` ranges of ``split_k`` rows (whole stages) covering K, one
    cluster a (strip, row tile): as many ranges as keep the blocks within
    one wave of ``FILL`` blocks an SM (at most ``MAX_SPLIT``, each range at
    least ``MIN_RANGE_K`` rows unless K is shorter), in clusters of 1, 2, 4
    or 8 blocks — a cluster must fit one GPC (16–18 SMs), and 7-block
    clusters left a second wave (Arctic's qkv, 36 x 7, measured).  Strips
    are 256 columns wide unless that leaves SMs without a block (llama's
    down: 16 strips x 8 ranges), then 128."""
    row_tiles = -(-m // ROWS)
    for strip in STRIPS:
        strips = -(-n // strip)
        n_split = max(1, min(MAX_SPLIT,
                             FILL * sms // max(strips * row_tiles, 1),
                             k // MIN_RANGE_K))
        n_split = 1 << (n_split.bit_length() - 1)
        if strips * row_tiles * n_split >= sms:
            break
    split_k = -(-(-(-k // n_split)) // STAGE_K) * STAGE_K
    n_split = -(-k // split_k)
    return dict(strip=strip, strips=strips, row_tiles=row_tiles,
                n_split=n_split, split_k=split_k)


def _check(x, qw, qw_sum, row_stats) -> tuple:
    """K3's shapes and dtypes; returns the contiguous ``x``, ``qw_sum`` and
    ``row_stats``."""
    x = x.contiguous()
    m, k = x.shape
    n = qw.shape[1]
    if k < 1 or k % 4 or n % 4 or qw.shape[0] != k:
        raise ValueError(f"K3 takes K, N multiples of 4; got x "
                         f"{tuple(x.shape)}, qw {tuple(qw.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("K3 reads bf16 or f32")
    if qw_sum.dtype != torch.int32:
        raise ValueError(f"column sums must be int32, got {qw_sum.dtype}")
    if row_stats is not None:
        row_stats = row_stats.float().contiguous()
        if tuple(row_stats.shape) != (m, 2):
            raise ValueError(f"K3's row statistics are (M, 2) = {(m, 2)}, "
                             f"got {tuple(row_stats.shape)}")
    return x, qw_sum.reshape(-1).contiguous(), row_stats


def _launch(x, qw, sw, zw, qw_sum, bias, out, row_stats, parts) -> None:
    """One K3 launch (its parts mode where ``parts`` is given)."""
    m, k = x.shape
    n = qw.shape[1]
    plan = decode_plan(m, k, n, cuda.sm_count(x.device))
    vec = int(n % 16 == 0 and qw.data_ptr() % 16 == 0)
    err = _lib().stamp_decode_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, n, qw.data_ptr(),
        cuda.ptr(sw), cuda.ptr(zw), qw_sum.data_ptr(), cuda.ptr(bias),
        plan["n_split"], plan["split_k"], plan["strip"], vec, cuda.ptr(out),
        int(out is not None and out.dtype == torch.bfloat16),
        cuda.ptr(row_stats), cuda.ptr(parts), cuda.stream_ptr(x))
    cuda.check(err, "stamp_decode_matmul")
    stamp_decode_matmul.launches += 1


def stamp_decode_matmul_parts(x: torch.Tensor, qw: torch.Tensor,
                              qw_sum: torch.Tensor,
                              row_stats: torch.Tensor) -> torch.Tensor:
    """K3's parts mode, for a row-parallel block of a model split (``x``
    this block's (M, K) rows, ``qw`` the weight's rows of its K range,
    ``qw_sum`` their column sums, ``row_stats`` the whole rows' (min, max)):
    the rows quantized with ``row_stats``, then K2's parts layout ``(M +
    1, N + 1)`` int32 — the products, each row's Σqx in the last column,
    the block's Σqw and K in the last row.  The ranks' parts summed are the
    whole rows' for :func:`stamp_decode_matmul_summed`.  Counted in K3's
    ``launches`` and ``parts_launches``."""
    if x.device.type == "cpu":
        return decode_parts_plain(x, qw, qw_sum, row_stats)
    x, qw_sum, row_stats = _check(x, qw, qw_sum, row_stats)
    m, k = x.shape
    n = qw.shape[1]
    cuda.require_cuda(x, qw, qw_sum, row_stats)
    parts = torch.empty((m + 1, n + 1), dtype=torch.int32, device=x.device)
    parts[m, :n] = qw_sum
    parts[m, n:].fill_(k)
    _launch(x, qw, None, None, qw_sum, None, None, row_stats, parts)
    stamp_decode_matmul.parts_launches += 1
    return parts


def stamp_decode_matmul_summed(parts: torch.Tensor, row_stats: torch.Tensor,
                               sw: torch.Tensor, zw: torch.Tensor, bias=None,
                               out_dtype=torch.float32) -> torch.Tensor:
    """K3's summed mode: the ranks' :func:`stamp_decode_matmul_parts`
    summed, finished by K3's scale, zero point and epilogue — the output
    of :func:`stamp_decode_matmul` over the whole rows, bit for bit.
    Returns (M, N).  Counted in K3's ``launches`` and
    ``summed_launches``."""
    if parts.device.type == "cpu":
        return decode_summed_plain(parts, row_stats, sw, zw, bias, out_dtype)
    if parts.dtype != torch.int32 or not parts.is_contiguous():
        raise ValueError("K3 sums contiguous int32 parts")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("K3 writes bf16 or f32")
    m, n = parts.shape[0] - 1, parts.shape[1] - 1
    row_stats = row_stats.float().contiguous()
    if tuple(row_stats.shape) != (m, 2):
        raise ValueError(f"K3's row statistics are (M, 2) = {(m, 2)}, got "
                         f"{tuple(row_stats.shape)}")
    sw = sw.reshape(-1).float().contiguous()
    zw = zw.reshape(-1).float().contiguous()
    bias = None if bias is None else bias.reshape(-1).float().contiguous()
    cuda.require_cuda(parts, row_stats, sw, zw, bias)
    out = torch.empty((m, n), dtype=out_dtype, device=parts.device)
    err = _lib().stamp_decode_matmul_summed(
        parts.data_ptr(), row_stats.data_ptr(), m, n, sw.data_ptr(),
        zw.data_ptr(), cuda.ptr(bias), out.data_ptr(),
        int(out_dtype == torch.bfloat16), cuda.stream_ptr(parts))
    cuda.check(err, "stamp_decode_matmul_summed")
    stamp_decode_matmul.launches += 1
    stamp_decode_matmul.summed_launches += 1
    return out


def stamp_decode_matmul(x: torch.Tensor, qw: torch.Tensor, sw: torch.Tensor,
                        zw: torch.Tensor, qw_sum: torch.Tensor, bias=None,
                        out_dtype=torch.float32) -> torch.Tensor:
    """K3.  ``x``: (M, K) bf16 or f32, any M; ``qw``: (K, N) int8; ``sw/zw``:
    (1, N) f32; ``qw_sum``: (1, N) int32 column sums of ``qw``
    (``PreparedLinear.qw_sum``)."""
    if x.device.type == "cpu":
        return decode_matmul_plain(x, qw, sw, zw, qw_sum, bias, out_dtype)
    x, qw_sum, _ = _check(x, qw, qw_sum, None)
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("K3 writes bf16 or f32")
    sw = sw.reshape(-1).float().contiguous()
    zw = zw.reshape(-1).float().contiguous()
    bias = None if bias is None else bias.reshape(-1).float().contiguous()
    cuda.require_cuda(x, qw, sw, zw, qw_sum, bias)
    out = torch.empty((x.shape[0], qw.shape[1]), dtype=out_dtype,
                      device=x.device)
    _launch(x, qw, sw, zw, qw_sum, bias, out, None, None)
    return out


stamp_decode_matmul.launches = 0
stamp_decode_matmul.stats_launches = 0
stamp_decode_matmul.parts_launches = 0
stamp_decode_matmul.summed_launches = 0
