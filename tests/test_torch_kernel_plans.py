"""The launch plans of the port's redesigned kernels, run in PyTorch on the
CPU against the plain versions: K4's tile gather through the block table,
its prefill row tiles, the split of a decode span over blocks and the
in-order merge of the ranges' ``(m, l, acc)`` partials; K2's split of K into
ranges whose int32 products are summed before the epilogue.  The CUDA
kernels follow these plans (``launch_plan`` and ``gemm_plan`` size their
launches); ``tests/test_torch_cuda.py`` holds the kernels themselves against
the plain versions on a card."""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import stamp as TS
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import stamp_matmul as TSM
from repro_torch.kernels.ref import span_kv
from repro_torch.serving import kvcache as TKV
from test_torch_cuda import paged_pools

NEG = -1e30


# ---------------------------------------------------------------------------
# K4: paged attention
# ---------------------------------------------------------------------------


def kv_slot(pos: int, span: int, hi_table, lo_table, block_size: int
            ) -> tuple:
    """Where K4's tile gather (``issue_tile`` in ``csrc/paged_attention.cu``)
    finds logical position ``pos`` of ``span``: ``(is_hi, page, offset)``.
    The first ``nh · bs`` positions lie in the span's hi pages, the rest in
    its lo pages."""
    nh = hi_table.shape[1]
    num_hi = nh * block_size
    if pos < num_hi:
        return True, int(hi_table[span, pos // block_size]), \
            pos % block_size
    lp = pos - num_hi
    return False, int(lo_table[span, lp // block_size]), lp % block_size


def _gather(entry, span, length, kvh, hi_table, lo_table, bs):
    """K and V (length, hd) f32 of one kv head, each position found through
    :func:`kv_slot` and dequantized with its own token's scale and zero
    point, as the kernel's tile gather does."""
    ks, vs = [], []
    for pos in range(length):
        is_hi, page, off = kv_slot(pos, span, hi_table, lo_table, bs)
        region = "hi" if is_hi else "lo"
        pair = []
        for name in ("k", "v"):
            codes = entry[f"{name}_{region}"][page, off, kvh]
            vals = codes.float() if is_hi else TKV.unpack_nibbles(codes)
            pair.append((vals - entry[f"{name}_{region}_zp"][page, off, kvh]
                         .float()) *
                        entry[f"{name}_{region}_scale"][page, off, kvh]
                        .float())
        ks.append(pair[0])
        vs.append(pair[1])
    return torch.stack(ks), torch.stack(vs)


def _walk_range(q, qpos, k, v, kv0, kv1):
    """The kernel's walk over positions [kv0, kv1) in tiles of ``KV_TILE``:
    per tile the masked scores, the new running max, ``p = exp(s - m)`` (0
    where masked), and the rescale of (l, acc).  Returns the partial."""
    rows = q.shape[0]
    m = torch.full((rows,), NEG)
    l = torch.zeros(rows)
    acc = torch.zeros((rows, q.shape[1]))
    for t0 in range(kv0, kv1, TPA.KV_TILE):
        t1 = min(t0 + TPA.KV_TILE, kv1)
        pos = torch.arange(t0, t1)
        ok = pos[None, :] <= qpos[:, None]
        s = torch.where(ok, q @ k[t0:t1].T, NEG)
        m_new = torch.maximum(m, s.amax(dim=1))
        p = torch.where(ok, torch.exp(s - m_new[:, None]), 0.0)
        c = torch.exp(m - m_new)
        l = l * c + p.sum(dim=1)
        acc = acc * c[:, None] + p @ v[t0:t1]
        m = m_new
    return m, l, acc


def _merge(parts):
    """The merge launch: the ranges' partials in range order."""
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    l = torch.zeros_like(m)
    o = torch.zeros_like(parts[0][2])
    for pm, pl, po in parts:
        c = torch.exp(pm - m)
        l = l + pl * c
        o = o + po * c[:, None]
    return o / torch.clamp_min(l, 1e-30)[:, None]


def _k4_schedule(entry, q_pf, q_dec, starts, lengths, ht, lt, bs, plan):
    """K4's work list run in PyTorch: prefill blocks of ``PF_ROWS`` query
    rows (row = token · rep + head), then decode blocks, one per range of
    :func:`decode_ranges` (worked out from the decode spans' lengths, as the
    card does), each span's ranges merged in range order."""
    n_pf, c_len, h, hd = q_pf.shape
    g = entry["k_lo"].shape[2]
    rep = h // g
    scale = 1.0 / math.sqrt(hd)
    out_pf = torch.zeros_like(q_pf)
    out_dec = torch.zeros_like(q_dec)
    for span in range(n_pf):
        length, qs = int(lengths[span]), int(starts[span])
        for kvh in range(g):
            k, v = _gather(entry, span, length, kvh, ht, lt, bs)
            for rt in range(plan["row_tiles"]):
                rows = torch.arange(rt * TPA.PF_ROWS,
                                    min((rt + 1) * TPA.PF_ROWS, c_len * rep))
                if rows.numel() == 0:
                    continue
                tok, head = rows // rep, kvh * rep + rows % rep
                q = q_pf[span, tok, head] * scale
                kv1 = min(length, qs + int(tok[-1]) + 1)
                m, l, acc = _walk_range(q, qs + tok, k, v, 0, kv1)
                out_pf[span, tok, head] = acc / torch.clamp_min(l, 1e-30)[
                    :, None]
    ranges = TPA.decode_ranges(lengths[n_pf:].tolist(), plan["n_split"])
    assert len(ranges) <= q_dec.shape[0] * plan["n_split"]
    for ds in range(q_dec.shape[0]):
        span = n_pf + ds
        length = int(lengths[span])
        for kvh in range(g):
            k, v = _gather(entry, span, length, kvh, ht, lt, bs)
            q = q_dec[ds, 0, kvh * rep:(kvh + 1) * rep] * scale
            qpos = torch.full((rep,), length - 1)
            parts = [_walk_range(q, qpos, k, v, kv0, kv1)
                     for i, kv0, kv1, _ in ranges if i == ds]
            out_dec[ds, 0, kvh * rep:(kvh + 1) * rep] = _merge(parts)
    return out_pf, out_dec


def hi_tokens(block_size: int) -> int:
    """The hi region of the K4 cases: the first whole pages holding at
    least 16 tokens (an odd page size's num_hi is a multiple of it)."""
    return -(-16 // block_size) * block_size


@pytest.mark.parametrize("block_size", [4, 16, 5])
def test_k4_tile_gather_reads_the_plain_pages(block_size):
    """Every position the kernel's tile gather finds through the block
    table (:func:`kv_slot`) dequantizes to the K and V the plain version
    reads from the span's pages, hi region then lo region; an odd page
    size included."""
    spans = [(0, 70), (16, 27), (0, 9)]
    entry, ht, lt = paged_pools(block_size, hi_tokens(block_size), spans,
                                g=2, hd=16, seed=3)
    ht, lt = torch.from_numpy(ht), torch.from_numpy(lt)
    for span, (_, length) in enumerate(spans):
        kd, vd = span_kv(entry, ht[span], lt[span])
        for kvh in range(2):
            k, v = _gather(entry, span, length, kvh, ht, lt, block_size)
            assert torch.equal(k, kd[:length, kvh])
            assert torch.equal(v, vd[:length, kvh])


@pytest.mark.parametrize("block_size,heads", [(4, 4), (16, 4), (4, 8),
                                              (16, 14), (5, 8)])
def test_k4_schedule_is_the_plain_attention(block_size, heads):
    """Prefill row tiles and decode ranges, walked in tiles and merged in
    order, give the plain version's outputs: a mixed step (two prefill
    chunks, a continuation chunk and a first chunk, and decode spans of 1 to
    600 positions, each walked whole) and the all-decode step of the same
    decode spans, split into ranges of whole tiles (some of them empty for
    the short spans)."""
    spans = [(16, 27), (0, 9), (599, 600), (70, 71), (0, 1), (300, 301)]
    num_hi, c_len, g, hd = hi_tokens(block_size), 12, 2, 16
    entry, ht, lt = paged_pools(block_size, num_hi, spans, g=g, hd=hd,
                                seed=block_size + heads)
    rng = np.random.default_rng(heads)
    q_pf = torch.from_numpy(rng.standard_normal(
        (2, c_len, heads, hd)).astype(np.float32))
    q_dec = torch.from_numpy(rng.standard_normal(
        (4, 1, heads, hd)).astype(np.float32))
    starts = torch.tensor([s for s, _ in spans], dtype=torch.int32)
    lengths = torch.tensor([l for _, l in spans], dtype=torch.int32)
    ht, lt = torch.from_numpy(ht), torch.from_numpy(lt)
    capacity = (ht.shape[1] + lt.shape[1]) * block_size
    for n_pf in (2, 0):
        plan = TPA.launch_plan(n_pf, 4, c_len, heads // g, g, capacity, 132)
        assert (plan["n_split"] > 1) == (n_pf == 0)
        args = (entry, q_pf[:n_pf], q_dec, starts[2 - n_pf:],
                lengths[2 - n_pf:], ht[2 - n_pf:], lt[2 - n_pf:])
        got = _k4_schedule(*args, block_size, plan)
        want = TPA.paged_attention_plain(*args, block_size)
        for i in range(n_pf):   # chunk rows past a span's length are dropped
            n = int(lengths[i] - starts[i])
            torch.testing.assert_close(got[0][i, :n], want[0][i, :n],
                                       rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_pf,s_slots,c_len,rep,capacity,split", [
    (2, 8, 128, 4, 136, 1),      # the llama serve step: 128 prefill blocks
    (0, 8, 128, 4, 136, 1),      # its all-decode step: 5 tiles, whole
    (2, 8, 128, 7, 136, 1),      # Arctic's: 224 prefill blocks
    (2, 8, 128, 4, 32768, 1),    # a mixed step walks its decode spans whole
    (0, 8, 128, 4, 32768, 4),    # a long cache: one wave of 8 · 8 · 4 slots
    (0, 8, 128, 4, 256, 4),      # 8 tiles: split
    (0, 8, 128, 4, 224, 1),      # 7 tiles: whole
    (0, 1, 128, 4, 300, 5),      # 10 tiles: at most 5 ranges of 2
    (0, 40, 128, 4, 32768, 1),   # 320 kv-head spans already fill a wave
])
def test_k4_launch_plan_sizes_blocks_by_span_type(n_pf, s_slots, c_len, rep,
                                                  capacity, split):
    """Prefill blocks cover every query row exactly once; an all-decode
    step whose tables map at least ``SPLIT_FROM_TILES`` tiles gets as many
    slots a span as one wave of ``FILL`` blocks an SM holds (at most a slot
    for every ``MIN_RANGE_TILES`` tiles); a mixed step's decode spans stay
    whole."""
    plan = TPA.launch_plan(n_pf, s_slots, c_len, rep, 8, capacity, 132)
    if n_pf:
        assert (plan["row_tiles"] - 1) * TPA.PF_ROWS < c_len * rep <= \
            plan["row_tiles"] * TPA.PF_ROWS
    else:
        assert plan["row_tiles"] == 0
    assert plan["n_split"] == split
    assert s_slots * 8 * plan["n_split"] <= max(TPA.FILL * 132, s_slots * 8)


LONG = [32768, 30001, 24576, 16385, 8192, 4097, 1024, 65]


@pytest.mark.parametrize("lengths,n_split,counts", [
    ([256] * 8, 4, [4] * 8),             # 8 tiles: 4 ranges of 2 tiles
    ([32768] * 8, 4, [4] * 8),           # 4 ranges of 256 tiles
    (LONG, 4, [7, 7, 6, 4, 2, 1, 1, 1]),  # 29 ranges of 128-146 tiles
    ([97 + j for j in range(8)], 4, [1] * 8),   # short spans stay whole
    ([224, 225, 1, 0], 3, [1, 4, 1, 1]),  # 7 tiles whole, 8 split; empty
    ([600, 1, 33, 77], 9, [9, 1, 1, 1]),
    ([100, 600], 1, [1, 1]),              # unsplit: every span whole
])
def test_k4_decode_ranges(lengths, n_split, counts):
    """The split K4 works out on the card: every span's ranges cover its
    positions once, in order, in the slots after the spans before it, and
    fit the ``S · n_split`` slots; a split span's ranges differ by at most
    a tile and hold at least ``MIN_RANGE_TILES``; spans under
    ``SPLIT_FROM_TILES`` tiles stay whole."""
    ranges = TPA.decode_ranges(lengths, n_split)
    assert len(ranges) <= len(lengths) * n_split
    assert [i for i, *_ in ranges] == sorted(i for i, *_ in ranges)
    got = [sum(1 for i, *_ in ranges if i == s) for s in range(len(lengths))]
    assert got == counts
    for s, n in enumerate(lengths):
        mine = [(kv0, kv1, k) for i, kv0, kv1, k in ranges if i == s]
        assert mine[0][0] == 0 and mine[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(mine, mine[1:]))
        assert all(k == len(mine) for *_, k in mine)
        if len(mine) > 1:
            sizes = [-(-(kv1 - kv0) // TPA.KV_TILE) for kv0, kv1, _ in mine]
            assert min(sizes) >= TPA.MIN_RANGE_TILES
            assert max(sizes) - min(sizes) <= 1
            assert all(kv0 % TPA.KV_TILE == 0 for kv0, _, _ in mine)
    for n, k in zip(lengths, got):
        if -(-n // TPA.KV_TILE) < TPA.SPLIT_FROM_TILES:
            assert k == 1


# ---------------------------------------------------------------------------
# K2: STaMP int GEMM
# ---------------------------------------------------------------------------


def split_k_product(qx: torch.Tensor, qw: torch.Tensor, split_k: int
                    ) -> torch.Tensor:
    """The int32 product as K2 forms it under a K split: each range's
    exact partial product, summed in range order."""
    k = qx.shape[1]
    acc = torch.zeros((qx.shape[0], qw.shape[1]), dtype=torch.int32,
                      device=qx.device)
    for k0 in range(0, k, split_k):
        acc += TSM.int_matmul(qx[:, k0:k0 + split_k], qw[k0:k0 + split_k])
    return acc


@pytest.mark.parametrize("spans,k,n,dual,split", [
    (2, 4096, 6144, False, 2),      # llama paged qkv: 96 blocks
    (2, 4096, 14336, True, 1),      # gate_up dual: 448 blocks
    (2, 14336, 4096, False, 3),     # down: 64 blocks
    (8, 4096, 6144, False, 1),      # bucketed 8 spans
    (2, 7168, 7168, False, 2),      # Arctic wo
    (1, 256, 96, False, 1),         # too short to split
])
def test_k2_gemm_plan(spans, k, n, dual, split):
    """Column tiles cover N; K is cut into whole steps only where the
    blocks would not fill the card's 132 SMs, and each range keeps at least
    ``MIN_SPLIT_STEPS`` steps."""
    plan = TSM.gemm_plan(spans, k, n, dual, 132)
    cols = TSM.GEMM_COLS // (2 if dual else 1)
    assert (plan["col_tiles"] - 1) * cols < n <= plan["col_tiles"] * cols
    assert plan["n_split"] == split
    assert plan["split_k"] % TSM.GEMM_BK == 0
    assert (plan["n_split"] - 1) * plan["split_k"] < k <= \
        plan["n_split"] * plan["split_k"]
    if split > 1:
        assert plan["split_k"] >= TSM.MIN_SPLIT_STEPS * TSM.GEMM_BK


@pytest.mark.parametrize("k,split_k", [(4096, 2048), (14336, 4800),
                                       (1000, 512)])
def test_k2_split_k_is_the_int32_product(k, split_k):
    """At |codes| = 128 the ranges' int32 products summed in range order
    equal the whole product bit for bit (integer sums are exact in any
    order); past 2^24 an f32 accumulator would round the same sum."""
    rng = np.random.default_rng(k)
    qx = torch.from_numpy(rng.integers(-128, 128, (3, k)).astype(np.int8))
    qw = torch.from_numpy(rng.integers(-128, 128, (k, 5)).astype(np.int8))
    qx[0], qw[:, 0] = -128, -128
    qx[0, -1], qw[-1, 0] = 1, 1
    whole = TSM.int_matmul(qx, qw)
    assert torch.equal(split_k_product(qx, qw, split_k), whole)
    exact = 128 * 128 * (k - 1) + 1
    assert int(whole[0, 0]) == exact
    if exact > 1 << 24:
        assert float(torch.tensor(exact, dtype=torch.float32)) != exact


@pytest.mark.parametrize("transform", ["dwt", "wht", "none"])
@pytest.mark.parametrize("dual", [False, True])
def test_k2_split_k_then_epilogue_is_the_plain_gemm(transform, dual):
    """The split path's second step (sum the ranges' int32 products and the
    row sums, then the zero-point epilogue, the inverse transform, the bias
    and silu·mul) gives the plain version's output exactly."""
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((2, 33, 1000), generator=gen)
    kw = dict(transform=transform, levels=3, skip_first=True)
    qx, sx, zx = TSM.transform_quantize_plain(x, num_hi=4, hi_bits=8,
                                              lo_bits=4, **kw)
    ws = [TS.prepare_linear(torch.randn((1000, 96), generator=gen))
          for _ in range(2 if dual else 1)]
    bias = [torch.randn(96, generator=gen) for _ in ws]
    plan_split = 512
    s, b = 33, 2

    def inverse(y):
        return TSM.T.inverse_sequence_transform(y, transform, axis=-2,
                                                levels=3, skip_first=True)

    outs = []
    for w, bi in zip(ws, bias):
        acc = split_k_product(qx, w.qw, plan_split)
        rsum = sum(qx[:, k0:k0 + plan_split].sum(dim=1, dtype=torch.int32)
                   for k0 in range(0, 1000, plan_split))
        y = TSM._epilogue(acc, sx, zx, w.sw.reshape(1, -1).float(),
                          w.zw.reshape(1, -1).float(), rsum,
                          w.qw_sum.reshape(-1), 1000)
        outs.append(inverse(y.reshape(b, s, -1)) + bi)
    got = TSM.silu(outs[0]) * outs[1] if dual else outs[0]
    args = [ws[0].qw, ws[0].sw, ws[0].zw, ws[0].qw_sum, bias[0]]
    if dual:
        args += [ws[1].qw, ws[1].sw, ws[1].zw, ws[1].qw_sum, bias[1]]
    want = TSM.int_gemm_plain(qx, sx, zx, s, *args, **kw)
    assert torch.equal(got, want)
