"""Fused STaMP prefill linears: K1 ``stamp_transform_quantize`` then K2
``stamp_int_gemm`` (CUDA source: ``csrc/stamp_matmul.cu``); and the grouped
MoE expert FFN, K5 ``stamp_quant_grouped_matmul`` (``csrc/
grouped_matmul.cu``, see its section below).

Replaces ``stamp_quant_matmul_pallas`` and ``stamp_quant_dual_matmul_pallas``
(``src/repro/kernels/stamp_matmul.py``).  The TPU kernel holds the whole
``(s, K)`` activation tile in VMEM; shared memory cannot (the down-proj's
int8 codes alone are 1.8 MB at s = 128), so the chain is two launches: K1
writes the int8 codes and per-token scale / zero point of every span, K2
reads them with the int8 weights and keeps the int32 product, the epilogue,
the inverse transform and the bias on chip for one whole span per block.

Bound on the H100: K1 by bytes (it reads the activation twice: the min/max
pass and the quantize pass recompute the transform instead of spilling f32),
K2 by integer operations (``wgmma`` on the tensor cores, fed by a
``cp.async`` ring; :func:`gemm_plan` splits K over a thread block cluster
where the column tiles and spans give too few blocks).  See the source note
for the design.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs its
plain PyTorch version for a CPU tensor; ``launches`` counts kernel launches.
The plain versions repeat the Pallas kernel's arithmetic: int32-exact
integer product, f32 epilogue in the same order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import quant as Q
from repro_torch.core import transforms as T
from repro_torch.core.stamp import token_quantize
from repro_torch.kernels import cuda

_KINDS = {"none": 0, "dwt": 1, "wht": 2}
MAX_SPAN = 128        # rows K2 keeps on chip: one whole span per block
GEMM_COLS = 128       # B columns a K2 block multiplies (dual: 64 + 64)
GEMM_BK = 64          # k per pipeline step
MIN_SPLIT_STEPS = 8   # steps a K range holds at least
MAX_SPLITS = 8        # K ranges of one output tile: one thread block cluster

_SIGNATURES = {
    "stamp_transform_quantize": [
        cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.INT,
        cuda.INT, cuda.FLT, cuda.FLT, cuda.INT, cuda.FLT, cuda.FLT, cuda.VP,
        cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP],
    "stamp_int_gemm": [
        cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT,
        cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP,
        cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.FLT,
        cuda.FLT, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.VP],
}


def _lib():
    return cuda.library("stamp_matmul", _SIGNATURES)


def _transform_args(transform: str, levels: int, skip_first: bool,
                    s: int) -> tuple:
    if transform not in _KINDS:
        raise ValueError(f"transform {transform!r} is not fusable "
                         f"(expected one of {tuple(_KINDS)})")
    p = T.largest_pow2(max(s - int(skip_first), 0))
    return (_KINDS[transform], int(levels), int(skip_first),
            Q.recip32(T.SQRT2), Q.recip32(math.sqrt(p)) if p else 1.0)


def _n_levels(hi_bits: int, lo_bits: int) -> tuple[float, float]:
    return 2.0 ** hi_bits - 1.0, 2.0 ** lo_bits - 1.0


# --------------------------------------------------------------------- K1 --


def transform_quantize_plain(x: torch.Tensor, *, transform: str,
                             levels: int, skip_first: bool, num_hi: int,
                             hi_bits: int, lo_bits: int) -> tuple:
    """Plain version of K1 (the Pallas ``_transform_quantize``): per-span
    sequence transform, then per-token min-max quantize with the first
    ``num_hi`` rows at ``hi_bits``.  ``x``: (b, s, K).  Returns signed int8
    codes (b·s, K) and f32 scale / shifted zero point (b·s,)."""
    b, s, k = x.shape
    tx = T.sequence_transform(x.float(), transform, axis=-2, levels=levels,
                              skip_first=skip_first)
    n_hi, n_lo = _n_levels(hi_bits, lo_bits)
    row = torch.arange(s, device=x.device)[:, None]
    n_lev = torch.where(row < num_hi, n_hi, n_lo).float()
    mn = tx.amin(dim=-1, keepdim=True)
    mx = tx.amax(dim=-1, keepdim=True)
    sx = torch.clamp_min((mx - mn) / n_lev, Q.EPS)
    zx = torch.round(-mn / sx)
    q = torch.minimum(torch.clamp_min(torch.round(tx / sx) + zx, 0.0), n_lev)
    qx = (q - 128.0).to(torch.int8)
    return qx.reshape(b * s, k), sx.reshape(b * s), (zx - 128.0).reshape(b * s)


def stamp_transform_quantize(x: torch.Tensor, *, transform: str = "dwt",
                             levels: int = 3, skip_first: bool = True,
                             num_hi: int = 64, hi_bits: int = 8,
                             lo_bits: int = 4) -> tuple:
    """K1.  ``x``: (b, s, K) bf16 or f32 (a head-split out-proj input is
    passed as its contiguous (b, s, nh·hd) view)."""
    kw = dict(transform=transform, levels=levels, skip_first=skip_first,
              num_hi=num_hi, hi_bits=hi_bits, lo_bits=lo_bits)
    if x.device.type == "cpu":
        return transform_quantize_plain(x, **kw)
    cuda.require_cuda(x)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K1 takes bf16 or f32 activations, got {x.dtype}")
    b, s, k = x.shape
    nslab = -(-k // 32)
    f32 = dict(dtype=torch.float32, device=x.device)
    pmin = torch.empty(b * s * nslab, **f32)
    pmax = torch.empty(b * s * nslab, **f32)
    qx = torch.empty((b * s, k), dtype=torch.int8, device=x.device)
    sx = torch.empty(b * s, **f32)
    zx = torch.empty(b * s, **f32)
    n_hi, n_lo = _n_levels(hi_bits, lo_bits)
    err = _lib().stamp_transform_quantize(
        x.data_ptr(), int(x.dtype == torch.bfloat16), b, s, k,
        *_transform_args(transform, levels, skip_first, s), num_hi, n_hi,
        n_lo, pmin.data_ptr(), pmax.data_ptr(), qx.data_ptr(), sx.data_ptr(),
        zx.data_ptr(), cuda.stream_ptr(x))
    cuda.check(err, "stamp_transform_quantize")
    stamp_transform_quantize.launches += 1
    return qx, sx, zx


stamp_transform_quantize.launches = 0


# --------------------------------------------------------------------- K2 --


def int_matmul(qx: torch.Tensor, qw: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 product with int32 results.  Computed in float64,
    which holds every partial sum exactly (|Σ| <= 128²·K < 2^53), so it
    equals int32 accumulation for any K < 2^17 (no int32 overflow either)
    on every device — PyTorch has no integer matmul on CUDA."""
    if qx.shape[-1] >= 1 << 17:
        raise ValueError("K must stay below 2^17 for exact int32 results")
    return (qx.double() @ qw.double()).to(torch.int32)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x · 1/(1 + exp(−x))`` in ``x``'s dtype, each step rounded to it:
    ``jax.nn.silu`` as the reference compiles it (bit for bit in bf16)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def _epilogue(acc, sx, zx, sw, zw, qx_sum, qw_sum, k: int) -> torch.Tensor:
    """``((acc - zx·Σqw) - zw·Σqx + (K·zx)·zw) · sx · sw`` in f32, the
    Pallas kernels' order (the f32 cast of the int32 accumulator first)."""
    zx, sx = zx[:, None], sx[:, None]
    corr = acc.float() - zx * qw_sum.float() - zw * qx_sum[:, None].float() \
        + float(k) * zx * zw
    return corr * sx * sw


def _gemm_one(qx, sx, zx, qw, sw, zw, qw_sum, bias, b: int, s: int,
              inverse):
    acc = int_matmul(qx, qw)
    y = _epilogue(acc, sx, zx, sw.reshape(1, -1).float(),
                  zw.reshape(1, -1).float(),
                  qx.sum(dim=1, dtype=torch.int32), qw_sum.reshape(-1),
                  qx.shape[1])
    y = inverse(y.reshape(b, s, -1))
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y


def int_gemm_plain(qx, sx, zx, span_len: int, qw, sw, zw, qw_sum, bias=None,
                   qw_up=None, sw_up=None, zw_up=None, qw_sum_up=None,
                   bias_up=None, *, transform: str, levels: int,
                   skip_first: bool,
                   out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K2: int32 product, zero-point epilogue, inverse
    transform per span, bias; with ``qw_up`` the dual (gate, up) form
    returns ``silu(g)·u``.  Returns (spans, span_len, N)."""
    rows = qx.shape[0]
    b, s = rows // span_len, span_len

    def inverse(y):
        return T.inverse_sequence_transform(y, transform, axis=-2,
                                            levels=levels,
                                            skip_first=skip_first)

    y = _gemm_one(qx, sx, zx, qw, sw, zw, qw_sum, bias, b, s, inverse)
    if qw_up is not None:
        u = _gemm_one(qx, sx, zx, qw_up, sw_up, zw_up, qw_sum_up, bias_up, b,
                      s, inverse)
        y = silu(y) * u
    return y.to(out_dtype)


def gemm_plan(spans: int, k: int, n: int, dual: bool, sms: int) -> dict:
    """K2's launch: ``col_tiles`` blocks of output columns (128, or 64
    gate/up pairs) per span, and K cut into ``n_split`` ranges of
    ``split_k`` (whole steps of ``GEMM_BK``) when the column tiles and spans
    give fewer blocks than the card has SMs (``sms``), each range at least
    ``MIN_SPLIT_STEPS`` steps and at most ``MAX_SPLITS`` ranges (one
    cluster).  The ranges' int32 products are summed before the epilogue,
    so any split gives the same bits."""
    cols = GEMM_COLS // 2 if dual else GEMM_COLS
    col_tiles = -(-n // cols)
    steps = max(-(-k // GEMM_BK), 1)
    want = -(-sms // max(spans * col_tiles, 1))
    splits = max(min(want, steps // MIN_SPLIT_STEPS, MAX_SPLITS), 1)
    per = -(-steps // splits)
    return dict(col_tiles=col_tiles, n_split=-(-steps // per),
                split_k=per * GEMM_BK)


def _f32_vec(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.reshape(-1).float().contiguous()


def _i32_vec(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if t is not None and t.dtype != torch.int32:
        raise ValueError(f"column sums must be int32, got {t.dtype}")
    return None if t is None else t.reshape(-1).contiguous()


def stamp_int_gemm(qx, sx, zx, span_len: int, qw, sw, zw, qw_sum, bias=None,
                   qw_up=None, sw_up=None, zw_up=None, qw_sum_up=None,
                   bias_up=None, *, transform: str = "dwt", levels: int = 3,
                   skip_first: bool = True,
                   out_dtype=torch.float32) -> torch.Tensor:
    """K2 over K1's outputs.  ``qx``: (spans·span_len, K) int8 codes;
    ``qw``: (K, N) int8; ``sw/zw``: (1, N) f32; ``qw_sum``: (1, N) int32
    column sums of ``qw`` (``PreparedLinear.qw_sum``); with ``qw_up`` the
    dual gate/up kernel returning ``silu(g)·u``.  Returns (spans, span_len,
    N)."""
    kw = dict(transform=transform, levels=levels, skip_first=skip_first,
              out_dtype=out_dtype)
    if qx.device.type == "cpu":
        return int_gemm_plain(qx, sx, zx, span_len, qw, sw, zw, qw_sum, bias,
                              qw_up, sw_up, zw_up, qw_sum_up, bias_up, **kw)
    rows, k = qx.shape
    n = qw.shape[1]
    if span_len > MAX_SPAN:
        raise ValueError(f"K2 keeps one span on chip: span_len {span_len} > "
                         f"{MAX_SPAN}")
    if k % 4 or n % 4 or qw.shape[0] != k:
        raise ValueError(f"K2 needs K and N multiples of 4 and a (K, N) "
                         f"weight; got qx {tuple(qx.shape)}, qw "
                         f"{tuple(qw.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K2 writes bf16 or f32, not {out_dtype}")
    dual = qw_up is not None
    sw, zw, bias = _f32_vec(sw), _f32_vec(zw), _f32_vec(bias)
    sw_up, zw_up, bias_up = _f32_vec(sw_up), _f32_vec(zw_up), \
        _f32_vec(bias_up)
    qw_sum, qw_sum_up = _i32_vec(qw_sum), _i32_vec(qw_sum_up)
    cuda.require_cuda(qx, sx, zx, qw, sw, zw, qw_sum, bias, qw_up, sw_up,
                      zw_up, qw_sum_up, bias_up)
    if dual and (qw_up.shape != qw.shape or qw_sum_up is None):
        raise ValueError("the dual GEMM needs an up weight of the gate's "
                         "shape with its column sums")
    b = rows // span_len
    dev = qx.device
    plan = gemm_plan(b, k, n, dual, cuda.sm_count(dev))
    # 16-byte copies where rows and pointers allow, else 4-byte ones
    vec = int(k % 16 == 0 and n % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (qx, qw, qw_up) if t is not None))
    out = torch.empty((b, span_len, n), dtype=out_dtype, device=dev)
    err = _lib().stamp_int_gemm(
        qx.data_ptr(), sx.data_ptr(), zx.data_ptr(), b, span_len, k, n,
        qw.data_ptr(), sw.data_ptr(), zw.data_ptr(), qw_sum.data_ptr(),
        cuda.ptr(bias), cuda.ptr(qw_up), cuda.ptr(sw_up), cuda.ptr(zw_up),
        cuda.ptr(qw_sum_up), cuda.ptr(bias_up),
        *_transform_args(transform, levels, skip_first, span_len),
        out.data_ptr(), int(out_dtype == torch.bfloat16), plan["n_split"],
        plan["split_k"], vec, cuda.stream_ptr(qx))
    cuda.check(err, "stamp_int_gemm")
    stamp_int_gemm.launches += 1
    return out


stamp_int_gemm.launches = 0


# --------------------------------------------------------------------- K5 --
#
# Replaces ``stamp_quant_grouped_matmul_pallas`` (``src/repro/kernels/
# stamp_matmul.py``): per expert bucket, gate and up int8 GEMMs off the one
# quantized dispatch tile, ``silu(g)·u``, an 8-bit per-row requantize of each
# ``block_f`` slab, and the down-projection's partial products summed in f32
# over the slabs in order; rows at or past the bucket's count are exact
# zeros.  Bound on the H100: bytes — a prefill step's few rows per expert
# stream every occupied expert's int8 weights once (see the source note).

_GROUPED_SIGNATURE = {"stamp_grouped_moe": [
    cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT,
    cuda.INT, cuda.INT, cuda.INT, cuda.VP, cuda.VP, cuda.VP, cuda.VP,
    cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP,
    cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.VP]}
MAX_BLOCK_F = 512     # f-slab columns one K5 block requantizes on chip


def grouped_block_f(block_f: int, f: int) -> int:
    """The requantize slab width: ``block_f`` halved until it divides
    ``f`` (the Pallas kernel's ``_pick_block_n``).  It is part of the
    numerics: each slab of a row gets its own 8-bit scale."""
    bf = min(block_f, f)
    while f % bf:
        bf //= 2
    return bf


def down_slab_sums(qw_down: torch.Tensor, block_f: int = 512
                   ) -> torch.Tensor:
    """Column sums of each ``block_f`` slab of the stacked ``(E, f, d)``
    down-projection codes: ``(E, f / bf, d)`` int32, fixed with the weight
    (the slab epilogues' Σqw)."""
    e, f, d = qw_down.shape
    bf = grouped_block_f(block_f, f)
    return qw_down.reshape(e, f // bf, bf, d).sum(dim=2, dtype=torch.int32)


def grouped_matmul_plain(qx, sx, zx, counts, qw_gate, sw_gate, zw_gate,
                         qs_gate, qw_up, sw_up, zw_up, qs_up, qw_down,
                         sw_down, zw_down, qs_down, *, block_f: int = 512,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K5, the Pallas kernel's integer form: int32 sums,
    the ``_int_gemm`` epilogue (gate/up over ``K = d``, each down slab over
    ``K = bf``), ``_rowwise_quantize`` per slab and the f32 sum of the
    slabs in order ``j = 0 .. nf - 1``.  Experts with no kept token are
    skipped (their rows are all zeros, as every row past its count is).
    Returns ``(b, E, C, d)``."""
    b, e, cap, d = qx.shape
    f = qw_gate.shape[-1]
    dm = qw_down.shape[-1]
    bf = grouped_block_f(block_f, f)
    out = torch.zeros((b, e, cap, dm), dtype=torch.float32, device=qx.device)
    slot = torch.arange(cap, device=qx.device)
    for ei in torch.nonzero(counts.sum(dim=0) > 0).flatten().tolist():
        x = qx[:, ei].reshape(b * cap, d)
        s, z = sx[:, ei].reshape(-1), zx[:, ei].reshape(-1)
        xs = x.sum(dim=1, dtype=torch.int32)

        def up_proj(qw, sw, zw, qs):
            return _epilogue(int_matmul(x, qw[ei]), s, z,
                             sw[ei].reshape(1, -1).float(),
                             zw[ei].reshape(1, -1).float(), xs,
                             qs[ei].reshape(-1), d)

        a = silu(up_proj(qw_gate, sw_gate, zw_gate, qs_gate)) * \
            up_proj(qw_up, sw_up, zw_up, qs_up)
        acc = torch.zeros((b * cap, dm), dtype=torch.float32,
                          device=qx.device)
        for j in range(f // bf):
            qa, sa, za = token_quantize(a[:, j * bf:(j + 1) * bf])
            acc = acc + _epilogue(
                int_matmul(qa, qw_down[ei, j * bf:(j + 1) * bf]), sa[:, 0],
                za[:, 0], sw_down[ei].reshape(1, -1).float(),
                zw_down[ei].reshape(1, -1).float(),
                qa.sum(dim=1, dtype=torch.int32), qs_down[ei, j], bf)
        keep = slot[None, :] < counts[:, ei, None]
        out[:, ei] = torch.where(keep[..., None], acc.reshape(b, cap, dm),
                                 0.0)
    return out.to(out_dtype)


def stamp_quant_grouped_matmul(qx, sx, zx, counts, qw_gate, sw_gate,
                               zw_gate, qs_gate, qw_up, sw_up, zw_up, qs_up,
                               qw_down, sw_down, zw_down, qs_down, *,
                               block_f: int = 512,
                               out_dtype=torch.float32) -> torch.Tensor:
    """K5 over the gathered dispatch buffer.  ``qx``: (b, E, C, d) int8
    codes with ``sx/zx`` (b, E, C, 1) f32; ``counts``: (b, E) int32 kept
    tokens per bucket (a prefix of ``[0, C)``); ``qw_gate/qw_up``: (E, d, f)
    int8 with ``sw/zw`` (E, 1, f) f32 and ``qs`` (E, 1, f) int32 column
    sums; ``qw_down``: (E, f, d) with ``sw/zw`` (E, 1, d) and ``qs_down``
    (E, f / bf, d) slab sums (:func:`down_slab_sums`).  Returns (b, E, C,
    d)."""
    args = (qx, sx, zx, counts, qw_gate, sw_gate, zw_gate, qs_gate, qw_up,
            sw_up, zw_up, qs_up, qw_down, sw_down, zw_down, qs_down)
    if qx.device.type == "cpu":
        return grouped_matmul_plain(*args, block_f=block_f,
                                    out_dtype=out_dtype)
    b, e, cap, d = qx.shape
    f = qw_gate.shape[-1]
    bf = grouped_block_f(block_f, f)
    nf = f // bf
    want = {"qw_gate": (e, d, f), "qw_up": (e, d, f), "qw_down": (e, f, d),
            "counts": (b, e), "qs_down": (e, nf, d)}
    got = {"qw_gate": qw_gate.shape, "qw_up": qw_up.shape,
           "qw_down": qw_down.shape, "counts": counts.shape,
           "qs_down": qs_down.shape}
    for name, shape in want.items():
        if tuple(got[name]) != shape:
            raise ValueError(f"K5: {name} has shape {tuple(got[name])}, "
                             f"expected {shape}")
    if d % 4 or bf % 4 or bf > MAX_BLOCK_F:
        raise ValueError(f"K5 needs d and the slab width multiples of 4 "
                         f"and a slab of at most {MAX_BLOCK_F}; got d={d}, "
                         f"bf={bf}")
    if qx.dtype != torch.int8 or counts.dtype != torch.int32 or \
            qs_gate.dtype != torch.int32 or qs_down.dtype != torch.int32:
        raise ValueError("K5 takes int8 codes with int32 counts and sums")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K5 writes bf16 or f32, not {out_dtype}")
    sx, zx = sx.float().contiguous(), zx.float().contiguous()
    vecs = [t.float().contiguous() for t in (sw_gate, zw_gate, sw_up, zw_up,
                                             sw_down, zw_down)]
    cuda.require_cuda(qx, sx, zx, counts, qw_gate, qs_gate, qw_up, qs_up,
                      qw_down, qs_down, *vecs)
    dev = qx.device
    rows = b * e * cap
    qa = torch.empty((rows, f), dtype=torch.int8, device=dev)
    sa = torch.empty((rows, nf), dtype=torch.float32, device=dev)
    za = torch.empty((rows, nf), dtype=torch.float32, device=dev)
    qas = torch.empty((rows, nf), dtype=torch.int32, device=dev)
    out = torch.empty((b, e, cap, d), dtype=out_dtype, device=dev)
    swg, zwg, swu, zwu, swd, zwd = vecs
    err = cuda.library("grouped_matmul", _GROUPED_SIGNATURE).stamp_grouped_moe(
        qx.data_ptr(), sx.data_ptr(), zx.data_ptr(), counts.data_ptr(), b, e,
        cap, d, f, bf, qw_gate.data_ptr(), swg.data_ptr(), zwg.data_ptr(),
        qs_gate.data_ptr(), qw_up.data_ptr(), swu.data_ptr(), zwu.data_ptr(),
        qs_up.data_ptr(), qw_down.data_ptr(), swd.data_ptr(), zwd.data_ptr(),
        qs_down.data_ptr(), qa.data_ptr(), sa.data_ptr(), za.data_ptr(),
        qas.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        cuda.stream_ptr(qx))
    cuda.check(err, "stamp_quant_grouped_matmul")
    stamp_quant_grouped_matmul.launches += 1
    return out


stamp_quant_grouped_matmul.launches = 0
