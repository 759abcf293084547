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

Bound on the H100: K1 by bytes (one launch over row windows,
:func:`tq_windows`, in thread block clusters over K, :func:`tq_plan`; it
reads the activation once, or twice where a K range is longer than a
chunk and the quantize pass recomputes the transform instead of spilling
f32), K2 by integer operations (``wgmma`` on the tensor cores, fed by a
``cp.async`` ring; :func:`gemm_plan` splits K over a thread block cluster
where the column tiles and spans give too few blocks).  See the source note
for the design.

A span longer than K2's ``MAX_SPAN`` rows (or, under the WHT, one whose
power-of-two block exceeds K1's ``TQ_MAX_IN`` window rows) takes a longer
chain of the same arithmetic: :func:`stamp_span_transform` writes the
forward transform in f32 for K1 to quantize with transform none, and K2
with transform none over tiles of ``MAX_SPAN`` rows writes the f32 products
that the inverse :func:`stamp_span_transform` turns into the output, with
the bias and the dual ``silu(g)·u``.  So both wrappers take any span the
reference takes.

A row-parallel block of a model split (this rank's K range of the input
and of the weight's rows) takes the chain in two modes of each kernel: K1
writes the block's rows' min / max, then quantizes with the whole rows'
(all-reduced), so its codes are the whole rows' block; K2 writes its
int32 products and row sums (:func:`stamp_int_gemm_parts`), and after
their integer all-reduce finishes the whole rows' epilogue
(:func:`stamp_int_gemm_summed`): one device's output, bit for bit.

Each wrapper launches its kernel for a CUDA tensor (or raises) and runs its
plain PyTorch version for a CPU tensor; ``launches`` counts kernel launches.
The plain versions repeat the Pallas kernel's arithmetic: int32-exact
integer product, f32 epilogue in the same order.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import quant as Q
from repro_torch.core import transforms as T
from repro_torch.core.stamp import token_quantize
from repro_torch.kernels import cuda
from repro_torch.kernels import wht as W

_KINDS = {"none": 0, "dwt": 1, "wht": 2}
MAX_SPAN = 128        # rows K2 keeps on chip: one whole span (or tile)
GEMM_COLS = 128       # B columns a K2 block multiplies (dual: 64 + 64)
GEMM_BK = 64          # k per pipeline step
MIN_SPLIT_STEPS = 8   # steps a K range holds at least
MAX_SPLITS = 8        # K ranges of one output tile: one thread block cluster

_SIGNATURES = {
    "stamp_transform_quantize": [
        cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.VP, cuda.INT,
        cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.FLT,
        cuda.FLT, cuda.INT, cuda.FLT, cuda.FLT, cuda.VP, cuda.VP, cuda.VP,
        cuda.VP, cuda.VP, cuda.VP],
    "stamp_int_gemm": [
        cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT,
        cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP,
        cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.FLT,
        cuda.FLT, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.VP,
        cuda.VP, cuda.VP],
}
_SPAN_SIGNATURES = {
    "span_windows": [
        cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.VP,
        cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.FLT, cuda.VP, cuda.VP,
        cuda.VP, cuda.INT, cuda.INT, cuda.VP, cuda.VP, cuda.INT, cuda.VP],
    "span_wht": [
        cuda.VP, cuda.VP, cuda.INT, cuda.LL, cuda.VP, cuda.VP, cuda.INT,
        cuda.LL, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.LL,
        cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.FLT, cuda.VP, cuda.VP,
        cuda.VP, cuda.LL, cuda.INT, cuda.INT, cuda.INT, cuda.VP],
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
                             hi_bits: int, lo_bits: int,
                             row_stats: Optional[torch.Tensor] = None,
                             stats_only: bool = False):
    """Plain version of K1 (the Pallas ``_transform_quantize``): per-span
    sequence transform, then per-token min-max quantize with the first
    ``num_hi`` rows at ``hi_bits``.  ``x``: (b, s, K).  Returns signed int8
    codes (b·s, K) and f32 scale / shifted zero point (b·s,).  Its two
    modes for a row-parallel block (:func:`stamp_transform_quantize`):
    ``stats_only`` returns the transformed rows' ``(min, max)`` (b·s, 2);
    ``row_stats`` (b·s, 2) quantizes with those in place of the rows'
    own."""
    b, s, k = x.shape
    tx = T.sequence_transform(x.float(), transform, axis=-2, levels=levels,
                              skip_first=skip_first)
    n_hi, n_lo = _n_levels(hi_bits, lo_bits)
    row = torch.arange(s, device=x.device)[:, None]
    n_lev = torch.where(row < num_hi, n_hi, n_lo).float()
    if row_stats is None:
        mn = tx.amin(dim=-1, keepdim=True)
        mx = tx.amax(dim=-1, keepdim=True)
    else:
        mn, mx = row_stats.float().reshape(b, s, 2).unbind(-1)
        mn, mx = mn[..., None], mx[..., None]
    if stats_only:
        return torch.cat([mn, mx], dim=-1).reshape(b * s, 2)
    sx = torch.clamp_min((mx - mn) / n_lev, Q.EPS)
    zx = torch.round(-mn / sx)
    q = torch.minimum(torch.clamp_min(torch.round(tx / sx) + zx, 0.0), n_lev)
    qx = (q - 128.0).to(torch.int8)
    return qx.reshape(b * s, k), sx.reshape(b * s), (zx - 128.0).reshape(b * s)


TQ_OUT = 16           # output rows of a K1 row window
TQ_MAX_IN = 256       # input rows a window may load
TQ_HDR = 8            # ints of a window's program header
TQ_HAAR, TQ_BFLY, TQ_SCALE = 1, 2, 3
MAX_CLUSTER = 16      # K ranges of a window (one thread block cluster)
TQ_SLOTS = 65536      # shared-memory bytes of a K1 block's slots
TQ_U = 2              # columns a K1 thread carries at once
TQ_CLUSTER_PASSES = 8  # K ranges of a window whose outputs are recomputed


def _haar_ops(s: int, levels: int, skip_first: bool,
              inverse: bool = False) -> tuple:
    """The Haar DWT (or, ``inverse``, its inverse) of one column of ``s``
    rows run symbolically in the reference's order
    (:func:`~repro_torch.core.transforms.haar_dwt`, ``haar_idwt``), each
    butterfly ``(a, b) -> ((a + b)·r, (a - b)·r)`` on approximation and
    detail (forward: even and odd row).  Node numbering and the returned
    ``(ops, made, out)`` as in :func:`_transform_ops`."""
    off = int(skip_first) if s else 0
    cur = list(range(off, s))
    ops, made = [], []
    sizes = T.haar_band_sizes(len(cur), levels)[:-1]
    for lo in (sizes[::-1] if inverse else sizes):
        band, pairs = cur[:lo], lo // 2
        a_in = band[:pairs] if inverse else band[0:2 * pairs:2]
        b_in = band[pairs:2 * pairs] if inverse else band[1:2 * pairs:2]
        res = []
        for a, b in zip(a_in, b_in):
            nxt = s + 2 * len(ops)
            ops.append((TQ_HAAR, a, b))
            made.append((nxt, nxt + 1))
            res.append((nxt, nxt + 1))
        new = [v for pair in res for v in pair] if inverse else \
            [a for a, _ in res] + [d for _, d in res]
        cur = new + band[2 * pairs:] + cur[lo:]
    return ops, made, list(range(off)) + cur


def _transform_ops(s: int, transform: str, levels: int,
                   skip_first: bool) -> tuple:
    """The sequence transform of one column of ``s`` rows run symbolically,
    in the reference's order (:func:`~repro_torch.core.transforms.haar_dwt`,
    :func:`~repro_torch.core.transforms.wht`).  Values are nodes: input row
    ``r`` is node ``r``; an op ``(kind, a, b)`` consumes nodes ``a`` and
    ``b`` (``b = -1`` for a scale) and makes the next one or two.  Returns
    ``(ops, made, out)``: the ops in order, the nodes each made, and the
    node that ends at each output row."""
    if transform == "dwt":
        return _haar_ops(s, levels, skip_first)
    off = int(skip_first) if s else 0
    cur = list(range(off, s))
    ops, made = [], []
    nxt = [s]

    def op(kind, a, b):
        outs = tuple(range(nxt[0], nxt[0] + (1 if b < 0 else 2)))
        nxt[0] += len(outs)
        ops.append((kind, a, b))
        made.append(outs)
        return outs

    n = len(cur)
    if transform == "wht" and n:
        p = T.largest_pow2(n)
        body = cur[:p]
        h = 1
        while h < p:
            for blk in range(0, p, 2 * h):
                for j in range(h):
                    a, b = op(TQ_BFLY, body[blk + j], body[blk + h + j])
                    body[blk + j], body[blk + h + j] = a, b
            h *= 2
        body = [op(TQ_SCALE, v, -1)[0] for v in body]
        cur = body + cur[p:]
    elif transform not in _KINDS:
        raise ValueError(f"transform {transform!r} is not fusable")
    return ops, made, list(range(off)) + cur


def tq_windows(s: int, transform: str, levels: int,
               skip_first: bool) -> list:
    """K1's row windows of a span of ``s`` rows: every output row in one
    window, a window at most ``TQ_OUT`` output rows, each with the program
    that computes them from its input rows alone (:func:`row_windows`)."""
    ops, made, out = _transform_ops(s, transform, levels, skip_first)
    return row_windows(s, ops, made, out, TQ_OUT, TQ_MAX_IN,
                       f"K1: {transform} over {s} rows")


def row_windows(s: int, ops: list, made: list, out: list, max_out: int,
                max_in: int, what: str) -> list:
    """Row windows of the symbolic transform ``(ops, made, out)`` of ``s``
    rows: every output row in one window, a window at most ``max_out``
    output rows, each with the program that computes them from its input
    rows alone.  Output rows whose transforms share an input row stay in
    one window (split only where such a group outgrows ``max_out`` rows,
    each part then recomputing the ops it needs); small groups go into the
    first window with room.  Returns ``[(in_rows, ops, outs)]``: the input
    rows loaded into slots 0, 1, ...; the ops ``(kind, slot, slot)`` in the
    reference's order, each writing its results over its operands' slots;
    ``(slot, output row)`` pairs.  Raises where a window needs more than
    ``max_in`` input rows."""
    maker = {v: i for i, vs in enumerate(made) for v in vs}

    def ancestry(nodes):
        """(op indices, input rows) behind ``nodes``."""
        seen_ops, rows, todo = set(), set(), list(nodes)
        while todo:
            v = todo.pop()
            if v < s:
                rows.add(v)
            elif maker[v] not in seen_ops:
                seen_ops.add(maker[v])
                kind, a, b = ops[maker[v]]
                todo += [a] if b < 0 else [a, b]
        return seen_ops, rows

    # output rows grouped by shared input rows (union-find over input rows)
    parent = list(range(s))

    def find(r):
        while parent[r] != r:
            parent[r] = parent[parent[r]]
            r = parent[r]
        return r

    needs = [sorted(ancestry([out[r]])[1]) for r in range(s)]
    for r in range(s):
        for q in needs[r][1:]:
            parent[find(q)] = find(needs[r][0])
    groups = {}
    for r in range(s):
        groups.setdefault(find(needs[r][0]), []).append(r)
    chunks = []
    for rows in sorted(groups.values()):
        chunks += [rows[i:i + max_out] for i in range(0, len(rows), max_out)]
    packed = []
    for rows in chunks:              # first fit: fewer windows, fewer blocks
        for window in packed:
            if len(window) + len(rows) <= max_out:
                window += rows
                break
        else:
            packed.append(list(rows))
    windows = []
    for rows in packed:
        op_ids, ins = ancestry([out[r] for r in rows])
        ins = sorted(ins)
        if len(ins) > max_in:
            raise ValueError(f"{what}: a row window needs {len(ins)} input "
                             f"rows (at most {max_in})")
        slot = {r: i for i, r in enumerate(ins)}
        home = dict(slot)             # node -> slot it lives in
        prog = []
        for i in sorted(op_ids):
            kind, a, b = ops[i]
            prog.append((kind, home[a], home[b] if b >= 0 else -1))
            for v, src in zip(made[i], (a, b)):
                home[v] = home[src]
        windows.append((ins, prog, [(home[out[r]], r) for r in rows]))
    return windows


def tq_program(windows: list) -> list:
    """The windows as the kernel reads them: a header of ``TQ_HDR`` ints a
    window (inputs, ops and outputs counted, then their offsets), then the
    input rows, the ops as ``kind << 28 | slot << 14 | slot`` (the second
    slot 0 for a scale) and the outputs as (slot, row)."""
    head, data = [], []
    base = TQ_HDR * len(windows)
    for ins, prog, outs in windows:
        at = base + len(data)
        head += [len(ins), len(prog), len(outs), at, at + len(ins),
                 at + len(ins) + len(prog), 0, 0]
        data += list(ins)
        data += [kind << 28 | i << 14 | max(j, 0) for kind, i, j in prog]
        data += [v for o in outs for v in o]
    return head + data


def tq_plan(k: int, max_in: int, max_prog: int) -> dict:
    """K1's launch: each window's K split into ``cl`` ranges of ``kc``
    columns (one thread block cluster).  A thread carries ``TQ_U`` columns
    and a block has ``threads`` of them, as many as let its slots
    (``max_in`` input rows x ``TQ_U`` columns a thread, f32) fit
    ``TQ_SLOTS``.  Where ``MAX_CLUSTER`` ranges of one chunk (``TQ_U x
    threads`` columns) cover K, each range is one chunk and the window's
    outputs stay in registers from the min / max to the quantize
    (``keep``); else ``TQ_CLUSTER_PASSES`` ranges make a second pass that
    recomputes them.  ``room``: ints of the longest window program
    (``max_prog``), kept in shared memory before the slots (``smem``
    bytes in all)."""
    threads = 256
    while threads > 32 and max(max_in, 1) * TQ_U * threads * 4 > TQ_SLOTS:
        threads //= 2
    cl = max(-(-k // (TQ_U * threads)), 1)
    keep = cl <= MAX_CLUSTER
    if not keep:
        cl = min(MAX_CLUSTER, TQ_CLUSTER_PASSES)
    room = -(-max_prog // 4) * 4
    return dict(cl=cl, kc=-(-k // cl), keep=keep, threads=threads,
                room=room, smem=4 * room + max(max_in, 1) * TQ_U * threads
                * 4)


_PROGRAMS: dict = {}


def _window_programs(device, key, make) -> tuple:
    """A window launch's program (:func:`tq_program` of the windows
    ``make()`` plans) on ``device``, built once per ``key`` and card, with
    the window count, the most input rows a window loads and the longest
    window's program in ints."""
    hit = _PROGRAMS.get((device, key))
    if hit is None:
        windows = make()
        prog = torch.tensor(tq_program(windows), dtype=torch.int32,
                            device=device)
        hit = (prog, len(windows), max(len(w[0]) for w in windows),
               max(len(i) + len(o) + 2 * len(u) for i, o, u in windows))
        _PROGRAMS[(device, key)] = hit
    return hit


def _tq_launch_args(device, s: int, transform: str, levels: int,
                    skip_first: bool) -> tuple:
    """K1's windows' program on ``device`` (:func:`_window_programs`)."""
    return _window_programs(
        device, ("K1", s, transform, levels, bool(skip_first)),
        lambda: tq_windows(s, transform, levels, skip_first))


@functools.lru_cache(maxsize=None)
def tq_fits(s: int, transform: str, levels: int, skip_first: bool) -> bool:
    """Whether K1's row windows of a span of ``s`` rows load at most
    ``TQ_MAX_IN`` input rows each.  Under the WHT a window loads the whole
    power-of-two block; otherwise the windows are planned to find out."""
    if transform == "wht":
        return T.largest_pow2(max(s - int(skip_first), 0)) <= TQ_MAX_IN
    try:
        tq_windows(s, transform, levels, skip_first)
    except ValueError:
        return False
    return True


def stamp_transform_quantize(x: torch.Tensor, *, transform: str = "dwt",
                             levels: int = 3, skip_first: bool = True,
                             num_hi: int = 64, hi_bits: int = 8,
                             lo_bits: int = 4,
                             row_stats: Optional[torch.Tensor] = None,
                             stats_only: bool = False):
    """K1.  ``x``: (b, s, K) bf16 or f32 (a head-split out-proj input is
    passed as its contiguous (b, s, nh·hd) view).  Where K1's windows
    cannot hold the transform (:func:`tq_fits`), the forward
    :func:`stamp_span_transform` runs first and K1 quantizes its f32 rows
    with transform none.  For a row-parallel block of a model split (its
    rows' min / max must be the whole rows'), two modes: ``stats_only``
    returns each transformed row's ``(min, max)`` over this block (b·s,
    2) f32 and no codes; ``row_stats`` (b·s, 2) quantizes with the given
    ``(min, max)`` (the ranks' all-reduced) in place of the block's.  The
    transform is per column, so the codes, scales and zero points are
    then the matching block of the whole row's, bit for bit.  Launches in
    those modes are also counted in ``stats_launches`` /
    ``given_launches``."""
    kw = dict(transform=transform, levels=levels, skip_first=skip_first,
              num_hi=num_hi, hi_bits=hi_bits, lo_bits=lo_bits,
              row_stats=row_stats, stats_only=stats_only)
    if stats_only and row_stats is not None:
        raise ValueError("K1 takes row statistics or writes them, not both")
    if transform in _KINDS and not tq_fits(x.shape[1], transform, levels,
                                           skip_first):
        tx = stamp_span_transform(x, transform=transform, levels=levels,
                                  skip_first=skip_first)
        return stamp_transform_quantize(tx, **dict(kw, transform="none"))
    if x.device.type == "cpu":
        return transform_quantize_plain(x, **kw)
    cuda.require_cuda(x)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K1 takes bf16 or f32 activations, got {x.dtype}")
    b, s, k = x.shape
    targs = _transform_args(transform, levels, skip_first, s)
    f32 = dict(dtype=torch.float32, device=x.device)
    if row_stats is not None:
        row_stats = row_stats.float().contiguous()
        cuda.require_cuda(row_stats)
        if tuple(row_stats.shape) != (b * s, 2):
            raise ValueError(f"K1's row statistics are (b·s, 2) = "
                             f"{(b * s, 2)}, got {tuple(row_stats.shape)}")
    stats = torch.empty((b * s, 2), **f32) if stats_only else None
    qx = torch.empty((0 if stats_only else b * s, k), dtype=torch.int8,
                     device=x.device)
    sx = torch.empty(0 if stats_only else b * s, **f32)
    zx = torch.empty(0 if stats_only else b * s, **f32)
    if b * s == 0 or k == 0:
        if stats_only:
            return stats.copy_(torch.tensor([math.inf, -math.inf]))
        return qx, sx, zx
    prog, n_win, max_in, max_prog = _tq_launch_args(
        x.device, s, transform, levels, skip_first)
    plan = tq_plan(k, max_in, max_prog)
    n_hi, n_lo = _n_levels(hi_bits, lo_bits)
    err = _lib().stamp_transform_quantize(
        x.data_ptr(), int(x.dtype == torch.bfloat16), b, s, k,
        prog.data_ptr(), n_win, plan["cl"], plan["kc"], int(plan["keep"]),
        plan["room"], plan["threads"], plan["smem"],
        targs[3], targs[4], num_hi, n_hi, n_lo, qx.data_ptr(), sx.data_ptr(),
        zx.data_ptr(), cuda.ptr(row_stats), cuda.ptr(stats),
        cuda.stream_ptr(x))
    cuda.check(err, "stamp_transform_quantize")
    stamp_transform_quantize.launches += 1
    if stats_only:
        stamp_transform_quantize.stats_launches += 1
        return stats
    if row_stats is not None:
        stamp_transform_quantize.given_launches += 1
    return qx, sx, zx


stamp_transform_quantize.launches = 0
stamp_transform_quantize.stats_launches = 0
stamp_transform_quantize.given_launches = 0


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


def _finish(acc, qx_sum, qw_sum, k: int, sx, zx, sw, zw, bias, b: int,
            s: int, inverse):
    y = _epilogue(acc, sx, zx, sw.reshape(1, -1).float(),
                  zw.reshape(1, -1).float(), qx_sum, qw_sum.reshape(-1), k)
    y = inverse(y.reshape(b, s, -1))
    if bias is not None:
        y = y + bias.reshape(1, -1).float()
    return y


def _gemm_one(qx, sx, zx, qw, sw, zw, qw_sum, bias, b: int, s: int,
              inverse):
    return _finish(int_matmul(qx, qw), qx.sum(dim=1, dtype=torch.int32),
                   qw_sum, qx.shape[1], sx, zx, sw, zw, bias, b, s, inverse)


def _inverse(transform: str, levels: int, skip_first: bool):
    def inverse(y):
        return T.inverse_sequence_transform(y, transform, axis=-2,
                                            levels=levels,
                                            skip_first=skip_first)
    return inverse


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
    inverse = _inverse(transform, levels, skip_first)
    y = _gemm_one(qx, sx, zx, qw, sw, zw, qw_sum, bias, b, s, inverse)
    if qw_up is not None:
        u = _gemm_one(qx, sx, zx, qw_up, sw_up, zw_up, qw_sum_up, bias_up, b,
                      s, inverse)
        y = silu(y) * u
    return y.to(out_dtype)


def int_gemm_parts_plain(qx, qw, qw_sum) -> torch.Tensor:
    """Plain version of K2's parts mode (:func:`stamp_int_gemm_parts`)."""
    rows, k = qx.shape
    n = qw.shape[1]
    parts = torch.zeros((rows + 1, n + 1), dtype=torch.int32,
                        device=qx.device)
    parts[:rows, :n] = int_matmul(qx, qw)
    parts[:rows, n] = qx.sum(dim=1, dtype=torch.int32)
    parts[rows, :n] = qw_sum.reshape(-1)
    parts[rows, n] = k
    return parts


def int_gemm_summed_plain(parts, sx, zx, span_len: int, sw, zw, bias=None,
                          *, transform: str, levels: int, skip_first: bool,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of K2's summed mode (:func:`stamp_int_gemm_summed`):
    :func:`int_gemm_plain`'s epilogue, inverse transform and bias over the
    summed parts.  Returns (spans, span_len, N)."""
    rows, n = parts.shape[0] - 1, parts.shape[1] - 1
    y = _finish(parts[:rows, :n], parts[:rows, n], parts[rows, :n],
                int(parts[rows, n]), sx, zx, sw, zw, bias, rows // span_len,
                span_len, _inverse(transform, levels, skip_first))
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
    dual gate/up kernel returning ``silu(g)·u``.  Spans over ``MAX_SPAN``
    rows run the long-span chain (module note).  Returns (spans, span_len,
    N)."""
    kw = dict(transform=transform, levels=levels, skip_first=skip_first,
              out_dtype=out_dtype)
    if span_len > MAX_SPAN and transform != "none":
        # the long-span chain: the products without a transform, in f32,
        # then the inverse transform with the bias (and silu(g)·u)
        pre = dict(kw, transform="none", out_dtype=torch.float32)
        g = stamp_int_gemm(qx, sx, zx, span_len, qw, sw, zw, qw_sum, **pre)
        u = None if qw_up is None else stamp_int_gemm(
            qx, sx, zx, span_len, qw_up, sw_up, zw_up, qw_sum_up, **pre)
        return stamp_span_transform(g, u, bias, bias_up, transform=transform,
                                    levels=levels, skip_first=skip_first,
                                    inverse=True, out_dtype=out_dtype)
    if qx.device.type == "cpu":
        return int_gemm_plain(qx, sx, zx, span_len, qw, sw, zw, qw_sum, bias,
                              qw_up, sw_up, zw_up, qw_sum_up, bias_up, **kw)
    rows, k = qx.shape
    n = qw.shape[1]
    _check_gemm(qx, qw, span_len)
    if qw_up is not None and (qw_up.shape != qw.shape or qw_sum_up is None):
        raise ValueError("the dual GEMM needs an up weight of the gate's "
                         "shape with its column sums")
    out = torch.empty((rows // span_len, span_len, n), dtype=out_dtype,
                      device=qx.device)
    _launch_gemm(qx, sx, zx, rows, min(span_len, MAX_SPAN), k, n, qw, sw, zw,
                 qw_sum, bias, qw_up, sw_up, zw_up, qw_sum_up, bias_up,
                 transform, levels, skip_first, out, None, None)
    return out


stamp_int_gemm.launches = 0
stamp_int_gemm.parts_launches = 0
stamp_int_gemm.summed_launches = 0


def _check_gemm(qx, qw, span_len: int) -> None:
    rows, k = qx.shape
    if k % 4 or qw.shape[1] % 4 or qw.shape[0] != k:
        raise ValueError(f"K2 needs K and N multiples of 4 and a (K, N) "
                         f"weight; got qx {tuple(qx.shape)}, qw "
                         f"{tuple(qw.shape)}")
    if rows % span_len:
        raise ValueError(f"K2 takes whole spans: {rows} rows in spans of "
                         f"{span_len}")


def _launch_gemm(qx, sx, zx, rows: int, tile: int, k: int, n: int, qw, sw,
                 zw, qw_sum, bias, qw_up, sw_up, zw_up, qw_sum_up, bias_up,
                 transform: str, levels: int, skip_first: bool, out,
                 parts_out, parts_in) -> None:
    """One K2 launch over ``rows`` rows in spans (or, without a transform,
    tiles) of ``tile``: the product of ``qx`` and ``qw`` (with ``qw_up``
    the dual one) into ``out``, its parts into ``parts_out``, or the
    summed ``parts_in`` finished into ``out`` (``qx``, ``qw`` and
    ``qw_sum`` ``None``).  Counted in ``stamp_int_gemm``'s ``launches``
    and its mode's."""
    if out is not None and out.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K2 writes bf16 or f32, not {out.dtype}")
    dual = qw_up is not None
    sw, zw, bias = _f32_vec(sw), _f32_vec(zw), _f32_vec(bias)
    sw_up, zw_up, bias_up = _f32_vec(sw_up), _f32_vec(zw_up), \
        _f32_vec(bias_up)
    qw_sum, qw_sum_up = _i32_vec(qw_sum), _i32_vec(qw_sum_up)
    cuda.require_cuda(qx, sx, zx, qw, sw, zw, qw_sum, bias, qw_up, sw_up,
                      zw_up, qw_sum_up, bias_up, out, parts_out, parts_in)
    dev = (qx if qx is not None else parts_in).device
    if parts_in is None:
        plan = gemm_plan(-(-rows // tile), k, n, dual, cuda.sm_count(dev))
        # 16-byte copies where rows and pointers allow, else 4-byte ones
        vec = int(k % 16 == 0 and n % 16 == 0 and all(
            t.data_ptr() % 16 == 0 for t in (qx, qw, qw_up)
            if t is not None))
    else:
        plan, vec = dict(n_split=1, split_k=GEMM_BK), 0
    err = _lib().stamp_int_gemm(
        cuda.ptr(qx), cuda.ptr(sx), cuda.ptr(zx), rows, tile, k, n,
        cuda.ptr(qw), cuda.ptr(sw), cuda.ptr(zw), cuda.ptr(qw_sum),
        cuda.ptr(bias), cuda.ptr(qw_up), cuda.ptr(sw_up), cuda.ptr(zw_up),
        cuda.ptr(qw_sum_up), cuda.ptr(bias_up),
        *_transform_args(transform, levels, skip_first, tile),
        cuda.ptr(out), int(out is not None and out.dtype == torch.bfloat16),
        plan["n_split"], plan["split_k"], vec, cuda.ptr(parts_out),
        cuda.ptr(parts_in), cuda.stream_ptr(qx if qx is not None
                                            else parts_in))
    cuda.check(err, "stamp_int_gemm")
    stamp_int_gemm.launches += 1
    if parts_out is not None:
        stamp_int_gemm.parts_launches += 1
    if parts_in is not None:
        stamp_int_gemm.summed_launches += 1


def stamp_int_gemm_parts(qx, span_len: int, qw, qw_sum) -> torch.Tensor:
    """K2's parts mode, for a row-parallel block of a model split (``qx``
    this block's codes over its K range, ``qw`` the weight's rows of that
    range, ``qw_sum`` their column sums): everything the epilogue needs
    that is a sum over K, as ``(rows + 1, N + 1)`` int32 — ``[:rows, :N]``
    the int32 products, ``[:rows, N]`` the rows' Σqx, ``[rows, :N]`` the
    block's Σqw and ``[rows, N]`` its K.  The ranks' parts summed (an
    integer all-reduce, exact) are the whole rows' for
    :func:`stamp_int_gemm_summed`.  No transform: it acts in the
    epilogue."""
    if qx.device.type == "cpu":
        return int_gemm_parts_plain(qx, qw, qw_sum)
    rows, k = qx.shape
    n = qw.shape[1]
    _check_gemm(qx, qw, span_len)
    parts = torch.empty((rows + 1, n + 1), dtype=torch.int32,
                        device=qx.device)
    parts[rows, :n] = qw_sum.reshape(-1)
    parts[rows, n:].fill_(k)
    _launch_gemm(qx, None, None, rows, min(span_len, MAX_SPAN), k, n, qw,
                 None, None, qw_sum, None, None, None, None, None, None,
                 "none", 0, False, None, parts, None)
    return parts


def stamp_int_gemm_summed(parts, sx, zx, span_len: int, sw, zw, bias=None,
                          *, transform: str = "dwt", levels: int = 3,
                          skip_first: bool = True,
                          out_dtype=torch.float32) -> torch.Tensor:
    """K2's summed mode: the ranks' :func:`stamp_int_gemm_parts` summed,
    finished by K2's epilogue, inverse transform and bias (``sx`` / ``zx``
    the whole rows' scales and zero points, ``sw`` / ``zw`` the whole
    columns') — :func:`stamp_int_gemm` of the whole rows, bit for bit.
    Spans over ``MAX_SPAN`` rows finish without a transform, then the
    span link inverts it.  Returns (spans, span_len, N)."""
    kw = dict(transform=transform, levels=levels, skip_first=skip_first,
              out_dtype=out_dtype)
    if span_len > MAX_SPAN and transform != "none":
        g = stamp_int_gemm_summed(parts, sx, zx, span_len, sw, zw,
                                  **dict(kw, transform="none",
                                         out_dtype=torch.float32))
        return stamp_span_transform(g, None, bias, transform=transform,
                                    levels=levels, skip_first=skip_first,
                                    inverse=True, out_dtype=out_dtype)
    if parts.device.type == "cpu":
        return int_gemm_summed_plain(parts, sx, zx, span_len, sw, zw, bias,
                                     **kw)
    if parts.dtype != torch.int32 or not parts.is_contiguous():
        raise ValueError("K2 sums contiguous int32 parts")
    rows, n = parts.shape[0] - 1, parts.shape[1] - 1
    if rows % span_len:
        raise ValueError(f"K2 takes whole spans: {rows} rows in spans of "
                         f"{span_len}")
    out = torch.empty((rows // span_len, span_len, n), dtype=out_dtype,
                      device=parts.device)
    _launch_gemm(None, sx, zx, rows, min(span_len, MAX_SPAN), 0, n, None, sw,
                 zw, None, bias, None, None, None, None, None, transform,
                 levels, skip_first, out, None, parts)
    return out


# ------------------------------------------------------- long-span link --
#
# Replaces no TPU kernel of its own: it is the third link of the chain that
# replaces ``stamp_quant_matmul_pallas`` / ``stamp_quant_dual_matmul_pallas``
# over spans longer than K2's tile (module note; CUDA source
# ``csrc/span_link.cu``).  Bound on the H100: bytes, one read and one write
# of the activation (forward) or of the f32 products (inverse).  Under the
# Haar DWT it runs row windows planned here (:func:`span_passes`), under
# the WHT K10's tiles over each span's power-of-two block
# (:func:`span_wht_plan`), whose first launch also writes the rows around
# the block.

SL_OUT = 32           # output rows of a forward link window
SL_OUT_INVERSE = 16   # ... of an inverse one
SL_MAX_IN = 64        # input rows a link window may load
SL_COLS = 256         # columns of a window block's strip
SL_SMEM = 64 * 1024   # bytes of a window block's slots, at most


@functools.lru_cache(maxsize=64)
def span_passes(s: int, levels: int, skip_first: bool,
                inverse: bool) -> tuple:
    """The Haar link's launches over spans of ``s`` rows: row windows
    (:func:`row_windows`, at most ``SL_OUT`` output rows, ``SL_OUT_INVERSE``
    for the inverse, and ``SL_MAX_IN`` input rows each) of a range of levels
    each.  An inverse output row needs one detail row a level and one
    approximation, so the inverse is one launch.  A forward approximation
    row needs 2^levels input rows, so the forward takes as many levels a
    launch as its windows hold, and the low-pass band left for the next
    levels (at the front of the span, after the sink row) goes to an f32
    scratch that the next launch reads as its span; every value still
    meets the same operations in the same order.
    Returns ``((windows, band), ...)``: an output ``(slot, row)`` is final
    output row ``row`` or, for ``row < 0``, row ``-1 - row`` of the
    ``band`` scratch rows; launch 0 reads the input, launch ``k`` the
    scratch of launch ``k - 1``."""
    what = f"span link: {'inverse ' if inverse else ''}dwt over {s} rows"
    if inverse:
        # windows of 16 rows: smaller blocks, more of them in flight
        # (measured faster than 32 at 3 and 8 levels, about even at 9)
        ops, made, out = _haar_ops(s, levels, skip_first, True)
        return ((row_windows(s, ops, made, out, SL_OUT_INVERSE, SL_MAX_IN,
                             what), 0),)
    off = int(skip_first) if s else 0
    sizes = T.haar_band_sizes(s - off, levels)
    total, done, passes = len(sizes) - 1, 0, []
    while True:
        rows, skip = (s, skip_first) if not passes else (sizes[done], False)
        first = off if not passes else 0   # the band's first row here
        base = 0 if not passes else off     # output row of this row 0
        # a window's 2^k-row groups hold SL_OUT outputs; fewer levels
        # where the odd-band carries join groups past SL_MAX_IN rows
        k = min(total - done, SL_OUT.bit_length() - 1)
        while True:
            ops, made, out = _haar_ops(rows, k, skip)
            try:
                windows = row_windows(rows, ops, made, out, SL_OUT,
                                      SL_MAX_IN, what)
                break
            except ValueError:
                if k <= 1:
                    raise
                k -= 1
        done += k
        band = sizes[done] if done < total else 0

        def dest(r):
            return first - 1 - r if first <= r < first + band else base + r

        passes.append(([(ins, prog, [(sl, dest(r)) for sl, r in outs])
                        for ins, prog, outs in windows], band))
        if done >= total:
            return tuple(passes)


def span_window_plan(n: int, max_in: int, max_prog: int, dual: bool
                     ) -> dict:
    """A window launch's blocks: a strip of ``cols`` columns, one a thread
    (a multiple of 32, up to ``SL_COLS`` and no wider than N needs), about
    halved until the slots (``max_in`` rows of the strip, two sets for the
    dual, f32) fit ``SL_SMEM``; ``room`` ints of the longest window program
    before them, ``smem`` bytes in all."""
    cols = min(SL_COLS, -(-n // 32) * 32)
    sets = 2 if dual else 1
    while cols > 32 and max_in * cols * 4 * sets > SL_SMEM:
        cols = max(32, cols // 64 * 32)
    room = -(-max_prog // 4) * 4
    return dict(cols=cols, room=room,
                smem=4 * room + max(max_in, 1) * cols * 4 * sets)


class WhtLaunch(NamedTuple):
    """One launch of the WHT link over the ``p``-row block of each span: a
    range of its stages, as tiles of ``T`` positions (element ``j`` of
    tile ``t`` of group ``z`` at block position ``z·p / groups + t·tmul +
    j·istride``; a middle launch's groups are its high position bits), ``w``
    columns a block.  ``first`` reads the input, ``last``
    scales, adds the bias, combines the dual and writes the output; the
    others read and write f32 scratch."""
    T: int
    tiles: int
    tmul: int
    istride: int
    groups: int
    w: int
    first: bool
    last: bool


def span_wht_plan(s: int, n: int, skip_first: bool, dual: bool,
                  itemsize: int, out_itemsize: int) -> list:
    """The WHT link's launches for spans of ``s`` rows of ``n`` columns
    (``itemsize``-byte inputs, ``out_itemsize``-byte outputs): K10's
    sequence tiles (``wht._width``, rows of a whole sector of the narrower
    of what a launch reads and writes, but of what the dual's last launch
    reads) over the power-of-two block ``p``, one launch where a block
    holds all ``p`` positions (the dual's last launch keeps two tiles),
    else the stages in ranges of bits, each launch's tile as long as a
    block holds."""
    p = T.largest_pow2(max(s - int(skip_first), 0))
    if not p:
        return []

    def bits(isz, two):
        """log2 of the longest tile (K10's ``longest``)."""
        t = W.MAX_SMEM_BYTES // (4 * max(W.SECTOR // isz, 4) * (2 if two
                                                                 else 1))
        return t.bit_length() - 1

    lp = p.bit_length() - 1
    out, lo = [], 0
    while lo < lp or not out:
        isz = itemsize if lo == 0 else 4
        # (the dual's two tiles at the output's width would hold an SM)
        last_isz = isz if dual else min(isz, out_itemsize)
        if lp - lo <= bits(last_isz, dual):
            k, isz = lp - lo, last_isz
        else:
            k = min(bits(isz, False), lp - lo - 1)
        t = 1 << k
        geo = (p // t, t, 1, 1) if lo == 0 else \
            (1 << lo, 1, 1 << lo, p >> (lo + k))
        out.append(WhtLaunch(t, *geo, W._width(t, n, True, isz), lo == 0,
                             lo + k == lp))
        lo += k
    return out


def span_transform_plain(x, x_up=None, bias=None, bias_up=None, *,
                         transform: str, levels: int, skip_first: bool,
                         inverse: bool = False,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain version of the span link: the sequence transform (or its
    inverse) of ``x.float()`` per span, then the bias, and with ``x_up``
    ``silu(g)·u`` of the two (each with its bias): :func:`int_gemm_plain`'s
    steps after the epilogue."""
    fn = T.inverse_sequence_transform if inverse else T.sequence_transform

    def one(v, b):
        y = fn(v.float(), transform, axis=-2, levels=levels,
               skip_first=skip_first)
        return y if b is None else y + b.reshape(1, -1).float()

    y = one(x, bias)
    if x_up is not None:
        y = silu(y) * one(x_up, bias_up)
    return y.to(out_dtype)


def stamp_span_transform(x: torch.Tensor, x_up=None, bias=None,
                         bias_up=None, *, transform: str = "dwt",
                         levels: int = 3, skip_first: bool = True,
                         inverse: bool = False,
                         out_dtype=torch.float32) -> torch.Tensor:
    """The long-span link.  ``x`` (and ``x_up``, the dual's up products):
    (b, s, N) f32 or bf16; ``bias``/``bias_up``: (N,) or (1, N).  Forward:
    the f32 sequence transform of ``x``; inverse: the inverse transform,
    the bias and (dual) ``silu(g)·u``, in ``out_dtype``.  Any span length;
    under the WHT N must be a multiple of 4.  Returns (b, s, N)."""
    kw = dict(transform=transform, levels=levels, skip_first=skip_first,
              inverse=inverse, out_dtype=out_dtype)
    if x.device.type == "cpu":
        return span_transform_plain(x, x_up, bias, bias_up, **kw)
    if transform not in ("dwt", "wht"):
        raise ValueError(f"the span link transforms dwt or wht, not "
                         f"{transform!r}")
    if x.dim() != 3 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the span link takes (b, s, N) bf16 or f32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the span link writes bf16 or f32, not {out_dtype}")
    if x_up is not None and (x_up.shape != x.shape or
                             x_up.dtype != x.dtype):
        raise ValueError("the dual's up products must match the gate's")
    b, s, n = x.shape
    if transform == "wht" and n % 4:
        raise ValueError(f"the span link's WHT takes N a multiple of 4, "
                         f"got {n}")
    bias, bias_up = _f32_vec(bias), _f32_vec(bias_up)
    cuda.require_cuda(x, x_up, bias, bias_up)
    dev = x.device
    out = torch.empty((b, s, n), dtype=out_dtype, device=dev)
    if not out.numel():
        return out
    lib = cuda.library("span_link", _SPAN_SIGNATURES)
    in_bf16, out_bf16 = int(x.dtype == torch.bfloat16), \
        int(out_dtype == torch.bfloat16)
    f32 = dict(dtype=torch.float32, device=dev)
    targs = _transform_args(transform, levels, skip_first, s)
    dual = x_up is not None

    def windows(key, wins, src, src_bf16, rows, band):
        """One window launch from ``src`` (spans of ``rows`` rows) into
        ``out`` and, where ``band``, a new f32 scratch of ``band`` rows."""
        prog, n_win, max_in, max_prog = _window_programs(dev, key,
                                                         lambda: wins)
        plan = span_window_plan(n, max_in, max_prog, dual)
        scr = torch.empty((2 if dual else 1, b, band, n), **f32) \
            if band else None
        err = lib.span_windows(
            src[0].data_ptr(), cuda.ptr(src[1] if dual else None), src_bf16,
            rows, b, n, prog.data_ptr(), n_win, plan["room"],
            plan["cols"], plan["smem"], targs[3], cuda.ptr(bias),
            cuda.ptr(bias_up), out.data_ptr(), out_bf16, s,
            cuda.ptr(None if scr is None else scr[0]),
            cuda.ptr(scr[1] if scr is not None and dual else None), band,
            cuda.stream_ptr(x))
        cuda.check(err, "stamp_span_transform")
        stamp_span_transform.launches += 1
        return scr

    src = (x, x_up)
    off = int(skip_first)
    p = T.largest_pow2(s - off)
    if transform == "dwt" or not p:
        # (a span of only the sink row: the WHT is the identity windows of
        # a DWT of no levels)
        levels = levels if p else 0
        src_bf16, rows = in_bf16, s
        for i, (wins, band) in enumerate(span_passes(s, levels, skip_first,
                                                     inverse)):
            src = windows(("link", s, levels, skip_first, inverse, i), wins,
                          src, src_bf16, rows, band)
            src_bf16, rows = 0, band
        return out
    if x.data_ptr() % 16 or (dual and x_up.data_ptr() % 16):
        src = tuple(None if v is None else v.clone() for v in src)
    at = off * n                    # the block's first element of a span
    scr = None
    for st in span_wht_plan(s, n, skip_first, dual, x.element_size(),
                            out.element_size()):
        dst = None if st.last else torch.empty(
            (2 if dual else 1, b, p, n), **f32)
        y0 = out.data_ptr() + at * out.element_size() if st.last \
            else dst[0].data_ptr()
        y1 = None if st.last or not dual else dst[1].data_ptr()
        if st.first:
            x0 = src[0].data_ptr() + at * x.element_size()
            x1 = src[1].data_ptr() + at * x.element_size() if dual else None
        else:
            x0, x1 = scr[0].data_ptr(), scr[1].data_ptr() if dual else None
        err = lib.span_wht(
            x0, x1, in_bf16 if st.first else 0,
            s * n if st.first else p * n // st.groups, y0, y1, out_bf16,
            s * n if st.last else p * n // st.groups, b * st.groups, st.T,
            st.tiles, st.tmul, st.istride, n, n, st.w, int(st.first),
            int(st.last), targs[4], cuda.ptr(bias), cuda.ptr(bias_up),
            out.data_ptr() + at * out.element_size(), s * n, s - p, off, p,
            cuda.stream_ptr(x))
        cuda.check(err, "stamp_span_transform")
        stamp_span_transform.launches += 1
        scr = dst
    return out


stamp_span_transform.launches = 0


# --------------------------------------------------------------------- K5 --
#
# Replaces ``stamp_quant_grouped_matmul_pallas`` (``src/repro/kernels/
# stamp_matmul.py``): per expert bucket, gate and up int8 GEMMs off the one
# quantized dispatch tile, ``silu(g)·u``, an 8-bit per-row requantize of each
# ``block_f`` slab, and the down-projection's partial products summed in f32
# over the slabs in order; rows at or past the bucket's count are exact
# zeros.  Bound on the H100: bytes — a prefill step's few rows per expert
# stream every occupied expert's int8 weights once (see the source note:
# persistent blocks over a work list of (expert, row group, slab or column
# tile) that the card builds from the counts, ``mma.sync`` on weight tiles
# held in a ``cp.async`` ring).

_GROUPED_SIGNATURE = {"stamp_grouped_moe": [
    cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT,
    cuda.INT, cuda.INT, cuda.INT, cuda.VP, cuda.VP, cuda.VP, cuda.VP,
    cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP,
    cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.INT, cuda.INT,
    cuda.INT, cuda.INT, cuda.VP, cuda.VP]}
MAX_BLOCK_F = 512     # f-slab columns one K5 block requantizes on chip
GROUP_ROWS = 32       # kept rows an expert's weights are streamed once for
MAX_GROUPS = 256      # row groups of one expert the work list encodes


def grouped_token_tiles(b: int, cap: int) -> int:
    """Token tiles of 8 rows K5 multiplies against each weight tile: enough
    for the most kept rows an expert can have (``b · cap``), 1, 2 or 4."""
    need = -(-b * cap // 8)
    return 1 if need <= 1 else 2 if need <= 2 else 4


def grouped_work(counts: torch.Tensor, cap: int, nf: int) -> list:
    """K5's work list as the card builds it: for every occupied expert in
    order, its row groups of up to ``GROUP_ROWS`` kept rows (the flat
    ``(b, E, C)`` dispatch rows, bucket by bucket), each with the ``nf``
    slabs (or column tiles) of one work item apiece.  Returns ``[(expert,
    [rows])]``, one entry a row group; item ``i`` is entry ``i // nf``,
    slab ``i % nf``."""
    b, e = counts.shape
    kept = counts.clamp(0, cap)
    out = []
    for ei in range(e):
        rows = [(i * e + ei) * cap + c for i in range(b)
                for c in range(int(kept[i, ei]))]
        for g0 in range(0, len(rows), GROUP_ROWS):
            out.append((ei, rows[g0:g0 + GROUP_ROWS]))
    return out


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
                               out_dtype=torch.float32,
                               weight_bytes: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """K5 over the gathered dispatch buffer.  ``qx``: (b, E, C, d) int8
    codes with ``sx/zx`` (b, E, C, 1) f32; ``counts``: (b, E) int32 kept
    tokens per bucket (a prefix of ``[0, C)``); ``qw_gate/qw_up``: (E, d, f)
    int8 with ``sw/zw`` (E, 1, f) f32 and ``qs`` (E, 1, f) int32 column
    sums; ``qw_down``: (E, f, d) with ``sw/zw`` (E, 1, d) and ``qs_down``
    (E, f / bf, d) slab sums (:func:`down_slab_sums`).  ``weight_bytes``
    (an int64 counter on the card, optional) gets the expert weight bytes
    the kernels streamed added to it.  Returns (b, E, C, d)."""
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
    if d % 16 or bf % 32 or bf > MAX_BLOCK_F:
        raise ValueError(f"K5 needs d a multiple of 16 and the slab width "
                         f"a multiple of 32 of at most {MAX_BLOCK_F}; got "
                         f"d={d}, bf={bf}")
    if not 1 <= cap <= 255 or -(-b * cap // GROUP_ROWS) > MAX_GROUPS:
        raise ValueError(f"K5 takes 1 to 255 capacity slots and at most "
                         f"{MAX_GROUPS * GROUP_ROWS} rows a bucket column; "
                         f"got b={b}, C={cap}")
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
    if weight_bytes is not None:
        cuda.require_cuda(weight_bytes)
        if weight_bytes.dtype != torch.int64 or weight_bytes.numel() != 1:
            raise ValueError("weight_bytes is one int64 counter")
    err = cuda.library("grouped_matmul", _GROUPED_SIGNATURE).stamp_grouped_moe(
        qx.data_ptr(), sx.data_ptr(), zx.data_ptr(), counts.data_ptr(), b, e,
        cap, d, f, bf, qw_gate.data_ptr(), swg.data_ptr(), zwg.data_ptr(),
        qs_gate.data_ptr(), qw_up.data_ptr(), swu.data_ptr(), zwu.data_ptr(),
        qs_up.data_ptr(), qw_down.data_ptr(), swd.data_ptr(), zwd.data_ptr(),
        qs_down.data_ptr(), qa.data_ptr(), sa.data_ptr(), za.data_ptr(),
        qas.data_ptr(), out.data_ptr(), int(out_dtype == torch.bfloat16),
        grouped_token_tiles(b, cap), e * -(-b * cap // GROUP_ROWS),
        cuda.sm_count(dev), cuda.ptr(weight_bytes), cuda.stream_ptr(qx))
    cuda.check(err, "stamp_quant_grouped_matmul")
    stamp_quant_grouped_matmul.launches += 1
    return out


stamp_quant_grouped_matmul.launches = 0
