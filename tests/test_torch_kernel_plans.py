"""The launch plans of the port's redesigned kernels, run in PyTorch on the
CPU against the plain versions: K4's tile gather through the block table
(head_dim 112 too), its prefill row tiles, the split of a decode span over
blocks and the in-order merge of the ranges' ``(m, l, acc)`` partials; K2's
split of K into ranges whose int32 products are summed before the
epilogue; K3's row tiles and cluster of K ranges (shared min / max, int32
products joined, then the epilogue); K7's tiles, k stages, transposed B
layout and operand sums; K6's tiles and ranges, its factored scores and
weights merged in order, its MMA fragments' feature order and its
shared-memory layout; K8's route and the words each lane holds; and every
plan at the full widths of the dense archs.  The CUDA kernels follow these
plans
(``launch_plan``, ``gemm_plan`` and ``decode_plan`` size their launches);
``tests/test_torch_cuda.py`` holds the kernels themselves against the plain
versions on a card."""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import stamp as TS
from repro_torch.kernels import cache_attention as TCA
from repro_torch.kernels import decode_matmul as TDM
from repro_torch.kernels import int8_gemm as TIM
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import quant_pack as TQP
from repro_torch.kernels import ref as TR
from repro_torch.kernels import stamp_matmul as TSM
from repro_torch.kernels.ref import span_kv
from repro_torch.serving import kvcache as TKV
from test_torch_cuda import paged_pools

# One PyTorch thread a process: the tier-1 run puts six pytest workers on
# the machine's cores, where PyTorch's default of an OpenMP thread per core
# makes each worker's ops wait on the others' (tens of times slower).
torch.set_num_threads(1)

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


def issue_chunks(hd: int, hi: bool) -> tuple:
    """K4's gather of one token's K or V code row (``issue_tile``): ``(chunk
    bytes, chunks)`` — the largest of 16 or 8 bytes that divides a hi row
    of ``hd`` bytes, and of 16, 8 or 4 bytes that divides a lo row of ``hd
    / 2``."""
    rb = hd if hi else hd // 2
    ch = next(c for c in (16, 8, 4) if rb % c == 0)
    return ch, rb // ch


def _gather_rows(entry, span, length, kvh, hi_table, lo_table, bs, hd):
    """The code rows of one kv head as K4 copies them chunk by chunk from
    the pools' bytes (each chunk aligned to its size), then dequantized."""
    out = {"k": [], "v": []}
    for pos in range(length):
        is_hi, page, off = kv_slot(pos, span, hi_table, lo_table, bs)
        region = "hi" if is_hi else "lo"
        ch, n = issue_chunks(hd, is_hi)
        for name in ("k", "v"):
            pool = entry[f"{name}_{region}"]
            flat = pool.contiguous().view(torch.uint8).reshape(-1)
            row_bytes = pool.shape[-1]
            tok = (page * bs + off) * pool.shape[2] + kvh
            assert (tok * row_bytes) % ch == 0      # every chunk aligned
            row = torch.cat([flat[tok * row_bytes + ch * c:
                                  tok * row_bytes + ch * (c + 1)]
                             for c in range(n)])
            assert row.numel() == row_bytes         # the chunks cover it
            codes = row.view(torch.int8) if is_hi else row
            vals = codes.float() if is_hi else TKV.unpack_nibbles(codes)
            out[name].append(
                (vals - entry[f"{name}_{region}_zp"][page, off, kvh].float())
                * entry[f"{name}_{region}_scale"][page, off, kvh].float())
    return torch.stack(out["k"]), torch.stack(out["v"])


@pytest.mark.parametrize("block_size", [4, 16, 5])
def test_k4_tile_gather_at_head_dim_112(block_size):
    """At Kimi-K2's head_dim 112 a hi row is 7 chunks of 16 bytes and a lo
    row 56 bytes, 7 chunks of 8 (16-byte chunks would leave 8 bytes out and
    misalign every odd row): the rows K4 copies chunk by chunk through the
    block table dequantize to the plain version's K and V, 8 kv heads."""
    assert issue_chunks(112, True) == (16, 7)
    assert issue_chunks(112, False) == (8, 7)
    spans = [(0, 70), (16, 27), (0, 9)]
    entry, ht, lt = paged_pools(block_size, hi_tokens(block_size), spans,
                                g=8, hd=112, seed=5)
    ht, lt = torch.from_numpy(ht), torch.from_numpy(lt)
    for span, (_, length) in enumerate(spans):
        kd, vd = span_kv(entry, ht[span], lt[span])
        for kvh in (0, 7):
            k, v = _gather_rows(entry, span, length, kvh, ht, lt, block_size,
                                112)
            assert torch.equal(k, kd[:length, kvh])
            assert torch.equal(v, vd[:length, kvh])


@pytest.mark.parametrize("block_size", [4, 16, 5])
def test_k4_tile_gather_at_head_dim_72(block_size):
    """At PixArt-Σ's head_dim 72 a hi row is 72 bytes, 9 chunks of 8, and a
    lo row 36 bytes, 9 chunks of 4 (8-byte chunks would misalign every odd
    row): the rows K4 copies chunk by chunk through the block table
    dequantize to the plain version's K and V, 4 kv heads."""
    assert issue_chunks(72, True) == (8, 9)
    assert issue_chunks(72, False) == (4, 9)
    spans = [(0, 70), (16, 27), (0, 9)]
    entry, ht, lt = paged_pools(block_size, hi_tokens(block_size), spans,
                                g=4, hd=72, seed=7)
    ht, lt = torch.from_numpy(ht), torch.from_numpy(lt)
    for span, (_, length) in enumerate(spans):
        kd, vd = span_kv(entry, ht[span], lt[span])
        for kvh in (0, 3):
            k, v = _gather_rows(entry, span, length, kvh, ht, lt, block_size,
                                72)
            assert torch.equal(k, kd[:length, kvh])
            assert torch.equal(v, vd[:length, kvh])


def dequant_chunks(hd: int, row: int, part: int) -> list:
    """The float4 chunks (features 4c .. 4c + 3) thread ``part`` of a K4
    dequantize row takes (``dequant_tile``): one of every group of four,
    rotated by the row, then one of the tail where ``hd / 4`` is not whole
    groups (head_dim 72: 18 chunks, a tail of 2)."""
    g, r = hd // 16, hd // 4 % 4
    out = [4 * ((i + row) % g) + part for i in range(g)]
    return out + ([4 * g + part] if part < r else [])


@pytest.mark.parametrize("hd", [16, 32, 64, 72, 112, 128])
def test_k4_dequant_covers_every_feature_once(hd):
    """Every row's four threads dequantize each of its ``hd / 4`` float4
    chunks exactly once, at every rotation, head_dim 72's tail included."""
    for row in range(64):
        got = sorted(c for part in range(4)
                     for c in dequant_chunks(hd, row, part))
        assert got == list(range(hd // 4))


def k6_copies(hd: int, hi: bool) -> tuple:
    """K6's stage copies of one code row (``fetch``): ``(chunk bytes,
    chunks)``, the largest of 16, 8 or 4 bytes that divides the row."""
    rb = hd if hi else hd // 2
    cb = next(c for c in (16, 8, 4) if rb % c == 0)
    return cb, rb // cb


@pytest.mark.parametrize("hd", [16, 32, 64, 72, 112, 128])
def test_k6_copies_put_every_byte_where_the_reads_find_it(hd):
    """K6's copies of a code row into a stage, chunk by chunk, aligned to
    their size in the cache (rows start at multiples of their length): a hi
    row's byte b lands at ``r · HDP + b``, a lo row's at the lo layout's
    place for it (at a padded width of 128 — head_dim 72 and 112 — the
    swizzled 8-byte chunks of ``lo_off<128>``), which is where the score and
    value reads look; no two bytes share a place."""
    hdp = 128 if hd in (72, 112) else hd
    for hi in (True, False):
        cb, n = k6_copies(hd, hi)
        rb = hd if hi else hd // 2
        assert cb * n == rb
        for r in range(0, 128, 7):
            assert (r * rb) % cb == 0            # every copy aligned
            placed = {}
            for c in range(n):
                for i in range(cb):
                    b = cb * c + i
                    if hi:
                        dst = r * hdp + b
                    elif hdp == 128:
                        dst = k6_lo_off(r, cb * c // 8) + cb * c % 8 + i
                    else:
                        dst = r * (hdp // 2) + b
                    placed[b] = dst
            if hi:
                want = {b: r * hdp + b for b in range(rb)}
            elif hdp == 128:
                want = {b: k6_lo_off(r, b // 8) + b % 8 for b in range(rb)}
            else:
                want = {b: r * (hdp // 2) + b for b in range(rb)}
            assert placed == want
            assert len(set(placed.values())) == rb


@pytest.mark.parametrize("block_size", [4, 16])
def test_k4_schedule_at_head_dim_112(block_size):
    """K4's row tiles and decode ranges at head_dim 112 with 8 query heads
    a kv head give the plain version's outputs, mixed and all-decode."""
    spans = [(16, 27), (0, 9), (599, 600), (70, 71), (0, 1), (300, 301)]
    num_hi, c_len, g, hd, heads = hi_tokens(block_size), 12, 2, 112, 16
    entry, ht, lt = paged_pools(block_size, num_hi, spans, g=g, hd=hd,
                                seed=block_size)
    rng = np.random.default_rng(block_size)
    q_pf = torch.from_numpy(rng.standard_normal(
        (2, c_len, heads, hd)).astype(np.float32))
    q_dec = torch.from_numpy(rng.standard_normal(
        (4, 1, heads, hd)).astype(np.float32))
    starts = torch.tensor([s for s, _ in spans], dtype=torch.int32)
    lengths = torch.tensor([n for _, n in spans], dtype=torch.int32)
    ht, lt = torch.from_numpy(ht), torch.from_numpy(lt)
    capacity = (ht.shape[1] + lt.shape[1]) * block_size
    for n_pf in (2, 0):
        plan = TPA.launch_plan(n_pf, 4, c_len, heads // g, g, capacity, 132)
        args = (entry, q_pf[:n_pf], q_dec, starts[2 - n_pf:],
                lengths[2 - n_pf:], ht[2 - n_pf:], lt[2 - n_pf:])
        got = _k4_schedule(*args, block_size, plan)
        want = TPA.paged_attention_plain(*args, block_size)
        for i in range(n_pf):
            n = int(lengths[i] - starts[i])
            torch.testing.assert_close(got[0][i, :n], want[0][i, :n],
                                       rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)


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


# ---------------------------------------------------------------------------
# K3: decode matmul
# ---------------------------------------------------------------------------


def k3_plan_run(x, qw, sw, zw, qw_sum, bias, plan):
    """K3's launch run in PyTorch: row tiles of ``ROWS``; in each, the
    cluster's ``n_split`` K ranges of ``split_k`` rows take their rows' min
    and max, share them (every range derives the same scale and zero point
    from the whole row), quantize their own range stage by stage, and form
    their int32 products and Σqx; the ranges' sums are joined in rank
    order and the epilogue (bias last) finishes."""
    m, k = x.shape
    xf = x.float()
    out = torch.empty((m, qw.shape[1]))
    inv255 = torch.tensor(1.0 / 255.0, dtype=torch.float32)
    ranges = [(r * plan["split_k"], min(k, (r + 1) * plan["split_k"]))
              for r in range(plan["n_split"])]
    assert ranges[-1][1] == k and all(kb < ke for kb, ke in ranges)
    for row0 in range(0, m, TDM.ROWS):
        xt = xf[row0:row0 + TDM.ROWS]
        mins = [xt[:, kb:ke].amin(dim=1) for kb, ke in ranges]
        maxs = [xt[:, kb:ke].amax(dim=1) for kb, ke in ranges]
        mn, mx = mins[0], maxs[0]
        for a, b in zip(mins[1:], maxs[1:]):
            mn, mx = torch.minimum(mn, a), torch.maximum(mx, b)
        s = torch.clamp_min((mx - mn) * inv255, 1e-8)
        z = torch.round(-mn / s)
        acc = torch.zeros((xt.shape[0], qw.shape[1]), dtype=torch.int32)
        qsum = torch.zeros(xt.shape[0], dtype=torch.int32)
        for kb, ke in ranges:
            for k0 in range(kb, ke, TDM.STAGE_K):
                k1 = min(k0 + TDM.STAGE_K, ke)
                codes = (torch.clamp(torch.round(xt[:, k0:k1] / s[:, None]) +
                                     z[:, None], 0.0, 255.0) - 128
                         ).to(torch.int8)
                acc += TSM.int_matmul(codes, qw[k0:k1])
                qsum += codes.sum(dim=1, dtype=torch.int32)
        y = TSM._epilogue(acc, s, z - 128, sw.reshape(1, -1).float(),
                          zw.reshape(1, -1).float(), qsum, qw_sum.reshape(-1),
                          k)
        if bias is not None:
            y = y + bias.reshape(1, -1).float()
        out[row0:row0 + TDM.ROWS] = y
    return out


@pytest.mark.parametrize("m", [1, 8, 16, 17, 64])
@pytest.mark.parametrize("k", [1000, 4096, 14336])
def test_k3_plan_is_the_plain_decode_matmul(m, k):
    """K3's row tiles, K ranges (shared min / max, per-stage codes, int32
    products and Σqx joined in rank order) and epilogue give
    ``decode_matmul_plain``'s output bit for bit, bf16 activations with a
    bias; the plan fills one wave of the card's 132 SMs."""
    n = 200
    gen = torch.Generator().manual_seed(m + k)
    x = torch.randn((m, k), generator=gen).to(torch.bfloat16)
    p = TS.prepare_linear(torch.randn((k, n), generator=gen) / k ** 0.5)
    bias = torch.randn(n, generator=gen)
    plan = TDM.decode_plan(m, k, n, 132)
    assert plan["row_tiles"] == -(-m // TDM.ROWS)
    assert plan["strips"] * plan["row_tiles"] * plan["n_split"] <= \
        max(TDM.FILL * 132, plan["strips"] * plan["row_tiles"])
    assert plan["split_k"] % TDM.STAGE_K == 0 and \
        plan["n_split"] in (1, 2, 4, 8)
    got = k3_plan_run(x, p.qw, p.sw, p.zw, p.qw_sum, bias, plan)
    want = TDM.decode_matmul_plain(x, p.qw, p.sw, p.zw, p.qw_sum, bias)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n,strip,n_split,split_k", [
    (8, 4096, 6144, 256, 8, 512),       # llama qkv: 24 strips x 8 ranges
    (8, 4096, 14336, 256, 4, 1024),     # gate: 56 strips
    (8, 14336, 4096, 128, 8, 1792),     # down: 16 wide strips idle SMs
    (8, 7168, 9216, 256, 8, 896),       # Arctic qkv: 36 strips x 8
    (4, 4096, 4096, 128, 8, 512),       # bucketed wo
    (64, 4096, 6144, 256, 2, 2048),     # 8 row tiles
    (1, 100, 200, 128, 1, 128),         # shorter than a range: whole
])
def test_k3_decode_plan(m, k, n, strip, n_split, split_k):
    """The ranges cover K in whole stages, none empty, in clusters of a
    power of two blocks, as many as keep the blocks within one wave of
    ``FILL`` an SM; strips are 256 columns unless that leaves SMs without
    a block."""
    plan = TDM.decode_plan(m, k, n, 132)
    assert plan["n_split"] & (plan["n_split"] - 1) == 0
    assert (plan["strip"], plan["n_split"], plan["split_k"]) == \
        (strip, n_split, split_k)
    assert plan["strips"] == -(-n // strip)
    assert (n_split - 1) * split_k < k <= n_split * split_k


# ---------------------------------------------------------------------------
# K7: standalone int8 GEMM
# ---------------------------------------------------------------------------

K7_TILE, K7_BK, BT_SBO, BT_LBO = 128, 128, 1040, 128


def byte_perm(x: int, y: int, s: int) -> int:
    """CUDA's ``__byte_perm``: byte i of the result is byte ``(s >> 4i) &
    7`` of the 8 bytes ``y:x``."""
    both = (y & 0xFFFFFFFF) << 32 | (x & 0xFFFFFFFF)
    return sum(((both >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def transpose4(w):
    """K7's (and K2's, K3's) ``transpose4``: 4 words, rows k .. k+3 of 4
    columns, to 4 words, columns of 4 k values."""
    t0, t1 = byte_perm(w[0], w[1], 0x5140), byte_perm(w[2], w[3], 0x5140)
    t2, t3 = byte_perm(w[0], w[1], 0x7362), byte_perm(w[2], w[3], 0x7362)
    return [byte_perm(t0, t1, 0x5410), byte_perm(t0, t1, 0x7632),
            byte_perm(t2, t3, 0x5410), byte_perm(t2, t3, 0x7632)]


def k7_transposed_tile(raw: np.ndarray) -> np.ndarray:
    """The transposer's output for one (128 k, 128 columns) raw B tile:
    the bytes of the K-major core-matrix buffer, column n's 16-byte k-chunk
    c at ``(n // 8) · 1040 + c · 128 + (n % 8) · 16``, built item by item
    as the kernel's threads do (chunk c, columns 4 cw .. 4 cw + 3)."""
    words = raw.view(np.uint32)                      # (128, 32)
    buf = np.zeros(K7_TILE // 8 * BT_SBO, np.uint8)
    for c in range(K7_BK // 16):
        for cw in range(K7_TILE // 4):
            col = [transpose4([int(words[16 * c + 4 * q + r, cw])
                               for r in range(4)]) for q in range(4)]
            for j in range(4):
                n = 4 * cw + j
                off = (n >> 3) * BT_SBO + c * BT_LBO + (n & 7) * 16
                buf[off:off + 16] = np.array(
                    [col[q][j] for q in range(4)], np.uint32).view(np.uint8)
    return buf


def test_k7_transposed_tile_is_the_k_major_weight():
    """Reading the transposer's buffer as ``wgmma``'s descriptor does
    (column n's chunks c at the core-matrix offsets) gives the weight tile
    transposed, every byte; the 1040-byte groups put a warp's 16-byte
    stores (8 lanes, columns 4 cw + j) on 8 distinct 4-bank groups."""
    raw = np.random.default_rng(0).integers(-128, 128, (128, 128)).astype(
        np.int8)
    buf = k7_transposed_tile(raw)
    got = np.zeros((128, 128), np.int8)               # (n, k)
    for n in range(128):
        for c in range(8):
            off = (n >> 3) * BT_SBO + c * BT_LBO + (n & 7) * 16
            got[n, 16 * c:16 * c + 16] = buf[off:off + 16].view(np.int8)
    np.testing.assert_array_equal(got, raw.T)
    for j in range(4):
        banks = {((((4 * cw + j) >> 3) * BT_SBO + ((4 * cw + j) & 7) * 16)
                  // 16) % 8 for cw in range(8)}
        assert len(banks) == 8


def k7_tile_run(qx, qw, sx, zx, sw, zw):
    """K7's walk in PyTorch: 128 x 128 output tiles, k stages of 128
    (zero-padded past K, as TMA fills them), each stage's int32 product
    with the B tile and 16 columns of ones added (the ones' products are
    the rows' Σqx), Σqw from the staged B columns; then the epilogue of
    each tile."""
    m, k = qx.shape
    n = qw.shape[1]
    kp = -(-k // K7_BK) * K7_BK
    xp = torch.zeros((m, kp), dtype=torch.int8)
    wp = torch.zeros((kp, n), dtype=torch.int8)
    xp[:, :k], wp[:k] = qx, qw
    out = torch.empty((m, n))
    for m0 in range(0, m, K7_TILE):
        for n0 in range(0, n, K7_TILE):
            a = xp[m0:m0 + K7_TILE]
            b = wp[:, n0:n0 + K7_TILE]
            acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.int32)
            rsum = torch.zeros(a.shape[0], dtype=torch.int32)
            csum = torch.zeros(b.shape[1], dtype=torch.int32)
            ones = torch.ones((K7_BK, 16), dtype=torch.int8)
            for k0 in range(0, kp, K7_BK):
                sa, sb = a[:, k0:k0 + K7_BK], b[k0:k0 + K7_BK]
                prod = TSM.int_matmul(sa, torch.cat([sb, ones], dim=1))
                acc += prod[:, :sb.shape[1]]
                rsum += prod[:, sb.shape[1]]
                csum += sb.sum(dim=0, dtype=torch.int32)
            y = TSM._epilogue(acc, sx[m0:m0 + K7_TILE, 0].float(),
                              zx[m0:m0 + K7_TILE, 0].float(),
                              sw[:, n0:n0 + K7_TILE].float(),
                              zw[:, n0:n0 + K7_TILE].float(), rsum, csum, k)
            out[m0:m0 + K7_TILE, n0:n0 + K7_TILE] = y
    return out


@pytest.mark.parametrize("m,k,n", [(8, 100, 384), (100, 128, 200),
                                   (256, 1024, 384), (130, 300, 7)])
def test_k7_tile_plan_is_the_plain_int8_matmul(m, k, n):
    """K7's tiles and k stages, with Σqx from the ones columns' products
    and Σqw from the staged B tiles, give ``int8_matmul_plain``'s f32
    output bit for bit; the wrapper's padded operands (K and N off 16)
    hold the same products and sums."""
    gen = torch.Generator().manual_seed(m + k + n)
    qx = torch.randint(-128, 128, (m, k), generator=gen, dtype=torch.int8)
    qw = torch.randint(-128, 128, (k, n), generator=gen, dtype=torch.int8)
    sx = torch.rand((m, 1), generator=gen) * 0.1 + 1e-3
    zx = torch.randint(-128, 128, (m, 1), generator=gen).float()
    sw = torch.rand((1, n), generator=gen) * 1e-2 + 1e-4
    zw = torch.randint(-8, 9, (1, n), generator=gen).float()
    want = TIM.int8_matmul_plain(qx, qw, sx, zx, sw, zw,
                                 out_dtype=torch.float32)
    assert torch.equal(k7_tile_run(qx, qw, sx, zx, sw, zw), want)
    xp, wp = TIM.tma_operands(qx, qw)
    assert xp.shape[1] % TIM.ALIGN == 0 and wp.shape[1] % TIM.ALIGN == 0
    assert torch.equal(TSM.int_matmul(xp, wp)[:, :n], TSM.int_matmul(qx, qw))
    assert torch.equal(xp.sum(dim=1, dtype=torch.int32),
                       qx.sum(dim=1, dtype=torch.int32))
    assert torch.equal(wp.sum(dim=0, dtype=torch.int32)[:n],
                       qw.sum(dim=0, dtype=torch.int32))


# ---------------------------------------------------------------------------
# K6: decode attention over the contiguous packed cache
# ---------------------------------------------------------------------------


def k6_k_feature(hdp: int, tig: int, kk: int, j: int) -> int:
    """``k_feature`` of ``csrc/cache_attention.cu``: the feature in slot
    ``j`` (b0 low, b0 high, b1 low, b1 high) of k-step ``kk`` of lane group
    ``tig`` in the score MMAs."""
    beta = (j & 1) if hdp == 16 else 4 * (kk >> 1) + (kk & 1) + 2 * (j & 1)
    return tig * (hdp // 4) + 2 * beta + (j >> 1)


def nibble_pair(w: int, sh: int) -> tuple:
    """The kernel's ``nibbles(w, sh)``: the nibbles at bits [sh, sh + 4)
    and [sh + 16, sh + 20), as (128 + x) − 128 in bf16 (exact)."""
    return (w >> sh) & 0xF, (w >> (sh + 16)) & 0xF


def k6_score_codes(row: np.ndarray, hdp: int, tig: int, kk: int) -> list:
    """Lane group ``tig``'s four codes of k-step ``kk`` read from a lo row
    (``hdp / 2`` bytes) as the kernel reads them: its ``hdp / 8`` bytes as
    words (at head_dim 16 its two bytes spread to bytes 0 and 2)."""
    nb = hdp // 8
    chunk = row[tig * nb:(tig + 1) * nb]
    if hdp == 16:
        words = [int(chunk[0]) | (int(chunk[1]) << 16)]
    else:
        words = [int.from_bytes(bytes(chunk[4 * i:4 * i + 4]), "little")
                 for i in range(nb // 4)]
    x = words[kk >> 1]
    b0 = nibble_pair(x, 12 if kk & 1 else 4)
    b1 = nibble_pair(x, 8 if kk & 1 else 0)
    return [b0[0], b0[1], b1[0], b1[1]]


def k6_value_codes(rows: np.ndarray, hdp: int, gid: int, tig: int,
                   mt: int) -> list:
    """Lane (gid, tig)'s A fragment of m-tile ``mt`` in the value MMAs, as
    pairs (k = 2 tig, 2 tig + 1 and 2 tig + 8, 2 tig + 9) for rows gid and
    gid + 8: bytes ``KS·gid + mt`` of positions tig, tig + 4, tig + 8 and
    tig + 12 through the kernel's ``__byte_perm``."""
    ks = hdp // 16
    w = [int.from_bytes(bytes(rows[tig + 4 * i, ks * gid:ks * gid + ks]),
                        "little") for i in range(4)]
    sel = (mt & 3) | ((4 + (mt & 3)) << 8)
    v01 = byte_perm(w[0] >> (32 * (mt >> 2)) & 0xFFFFFFFF,
                    w[1] >> (32 * (mt >> 2)) & 0xFFFFFFFF, sel)
    v23 = byte_perm(w[2] >> (32 * (mt >> 2)) & 0xFFFFFFFF,
                    w[3] >> (32 * (mt >> 2)) & 0xFFFFFFFF, sel)
    return [nibble_pair(v01, 4), nibble_pair(v01, 0), nibble_pair(v23, 4),
            nibble_pair(v23, 0)]


def _nibble(rows: np.ndarray, pos: int, f: int) -> int:
    byte = int(rows[pos, f // 2])
    return byte >> 4 if f % 2 == 0 else byte & 0xF


@pytest.mark.parametrize("hdp", [16, 32, 64, 128])
def test_k6_score_fragments_read_every_feature_once(hdp):
    """The score MMAs' feature order: over the 4 lane groups and hdp/16
    k-steps the slots cover every feature once, and the codes a lane
    extracts from its words (masks and shifts into bf16's mantissa) are
    the row's nibbles at exactly those features, so codes and queries
    (loaded by ``k_feature``) meet feature by feature."""
    rng = np.random.default_rng(hdp)
    row = rng.integers(0, 256, hdp // 2, dtype=np.uint8)
    seen = []
    for tig in range(4):
        for kk in range(hdp // 16):
            feats = [k6_k_feature(hdp, tig, kk, j) for j in range(4)]
            seen += feats
            assert k6_score_codes(row, hdp, tig, kk) == [
                _nibble(row[None], 0, f) for f in feats]
    assert sorted(seen) == list(range(hdp))


@pytest.mark.parametrize("hdp", [16, 32, 64, 128])
def test_k6_value_fragments_are_the_transposed_codes(hdp):
    """The value MMAs' A fragments: lane (gid, tig) of m-tile mt holds
    feature 2 (KS gid + mt) (row gid) and the one after it (row gid + 8)
    at positions tig, tig + 4 (k = 2 tig, 2 tig + 1) and tig + 8, tig + 12
    (k = 2 tig + 8, 2 tig + 9): the m-tiles' rows cover every feature
    once, and k matches the score accumulators' positions."""
    rng = np.random.default_rng(hdp + 1)
    rows = rng.integers(0, 256, (16, hdp // 2), dtype=np.uint8)
    ks = hdp // 16
    feats = set()
    for gid in range(8):
        for mt in range(ks):
            f = 2 * (ks * gid + mt)
            feats |= {f, f + 1}
            for tig in range(4):
                a0, a1, a2, a3 = k6_value_codes(rows, hdp, gid, tig, mt)
                p = [tig, tig + 4, tig + 8, tig + 12]
                assert a0 == (_nibble(rows, p[0], f), _nibble(rows, p[1], f))
                assert a1 == (_nibble(rows, p[0], f + 1),
                              _nibble(rows, p[1], f + 1))
                assert a2 == (_nibble(rows, p[2], f), _nibble(rows, p[3], f))
                assert a3 == (_nibble(rows, p[2], f + 1),
                              _nibble(rows, p[3], f + 1))
    assert feats == set(range(hdp))
    # the score accumulators d[nt][e] of lane (gid, tig) hold positions
    # 8 nt + tig + 4 e, the value MMAs' k = 2 tig + 8 nt + e
    for nt in range(2):
        for c in range(8):
            pos = 8 * nt + (c >> 1) + 4 * (c & 1)
            tig, e = c >> 1, c & 1
            assert pos == 8 * nt + tig + 4 * e


def k6_lo_off(r: int, c: int) -> int:
    """``lo_off<128>``: byte offset of 8-byte chunk c of row r of a lo
    tile at head_dim 128 (rows of 64 bytes)."""
    return 64 * (r ^ ((r >> 2) & 1)) + 8 * (c ^ (((r >> 1) & 1) << 2))


def test_k6_lo_tile_layout_has_no_bank_conflict():
    """Head_dim 128's lo tile (128 rows of 64 bytes): every chunk has its
    own place, the score reads (16 bytes of rows p0 + 8 nt + gid / 2 +
    4 (gid % 2), a quarter warp a wavefront) and the value reads (8 bytes
    of rows p0 + tig + 4 i, a half warp a wavefront) each cover a
    wavefront's 128 bytes without two lanes on one bank."""
    offs = {k6_lo_off(r, c) for r in range(128) for c in range(8)}
    assert offs == set(range(0, 128 * 64, 8))
    for p0 in range(0, 128, 16):
        for nt in range(2):
            for quarter in range(4):
                banks = []
                for lane in range(8 * quarter, 8 * quarter + 8):
                    gid, tig = lane >> 2, lane & 3
                    r = p0 + 8 * nt + (gid >> 1) + 4 * (gid & 1)
                    o = k6_lo_off(r, 2 * tig)
                    assert k6_lo_off(r, 2 * tig + 1) == o + 8
                    banks += [(o // 4 + i) % 32 for i in range(4)]
                assert len(set(banks)) == 32
        for i in range(4):
            for half in range(2):
                banks = []
                for lane in range(16 * half, 16 * half + 16):
                    gid, tig = lane >> 2, lane & 3
                    o = k6_lo_off(p0 + tig + 4 * i, gid)
                    banks += [(o // 4 + k) % 32 for k in range(2)]
                assert len(set(banks)) == 32


@pytest.mark.parametrize("b,g,hi,s,sms,per,n_split", [
    (4, 8, 4, 136, 132, 1, 3),          # the bucketed serve shape
    (8, 8, 64, 32768, 132, 16, 17),     # the long cache
    (1, 1, 0, 100, 132, 1, 1),
    (2, 2, 300, 2000, 132, 1, 19),
    (64, 8, 8, 4096, 132, 11, 3)])
def test_k6_launch_plan(b, g, hi, s, sms, per, n_split):
    """K6's ranges: whole tiles of ``TILE_HI`` hi and ``TILE_LO`` lo
    positions (no tile holds both), about ``FILL`` blocks an SM when every
    row is full, the ranges covering the row's tiles."""
    tiles = TCA.tiles(hi, s)
    assert sum(n for _, n, _ in tiles) == s
    assert all(t + n <= hi for t, n, is_hi in tiles if is_hi)
    assert all(t >= hi for t, n, is_hi in tiles if not is_hi)
    assert TCA.launch_plan(b, g, hi, s, sms) == (per, n_split)
    assert (n_split - 1) * per < len(tiles) <= n_split * per


def k6_range_run(entry, q, length, sms=132):
    """K6 on the CPU in its own terms: each range of the launch plan scores
    its tiles' valid positions on the codes minus their zero points cut to
    whole numbers in [-128, 127] (zc), s = sk (Σ (c − zkc) q − (zk − zkc)
    Σ q) / √hd, keeps (m, l, Σ w (c − zvc) − Σ w (zv − zvc)) with w = p
    sv, and the ranges merge in order as the second launch does; then
    o / max(l, 1e-30)."""
    b, _, h, hd = q.shape
    hi, g = entry["k_hi"].shape[1], entry["k_hi"].shape[2]
    s_total = entry["k_scale"].shape[1]
    rep = h // g
    per, n_split = TCA.launch_plan(b, g, hi, s_total, sms)
    tiles = TCA.tiles(hi, s_total)
    codes = {n: torch.cat([entry[f"{n}_hi"].float(),
                           TKV.unpack_nibbles(entry[f"{n}_lo"])], dim=1)
             for n in ("k", "v")}

    def cut(z):
        return torch.clamp(torch.round(z), -128.0, 127.0)

    out = torch.empty((b, h, hd))
    for bi in range(b):
        n = int(length.reshape(-1).expand(b)[bi])
        for kvh in range(g):
            qg = q[bi, 0, kvh * rep:(kvh + 1) * rep].float()
            parts = []
            for sp in range(n_split):
                pos = [p for t, cnt, _ in tiles[sp * per:(sp + 1) * per]
                       for p in range(t, t + cnt) if p < n]
                if not pos:
                    parts.append((torch.full((rep,), NEG), torch.zeros(rep),
                                  torch.zeros(rep, hd)))
                    continue
                ix = torch.tensor(pos)
                ck, cv = codes["k"][bi, ix, kvh], codes["v"][bi, ix, kvh]
                sk, zk, sv, zv = (entry[f"{a}"][bi, ix, kvh].float() for a in
                                  ("k_scale", "k_zp", "v_scale", "v_zp"))
                sc = ((qg @ (ck - cut(zk)[:, None]).T)
                      - (zk - cut(zk)) * qg.sum(-1, keepdim=True)) * sk \
                    / math.sqrt(hd)
                m = sc.amax(-1)
                p = torch.exp(sc - m[:, None])
                w = p * sv
                parts.append((m, p.sum(-1),
                              w @ (cv - cut(zv)[:, None])
                              - (w * (zv - cut(zv))).sum(-1)[:, None]))
            mm = torch.stack([m for m, _, _ in parts]).amax(0)
            l = sum(l * torch.exp(m - mm) for m, l, _ in parts)
            o = sum(o * torch.exp(m - mm)[:, None] for m, _, o in parts)
            out[bi, kvh * rep:(kvh + 1) * rep] = o / torch.clamp_min(
                l, 1e-30)[:, None]
    return out.reshape(b, 1, h, hd)


@pytest.mark.parametrize("shape,lengths,sms,shift", [
    ((4, 136, 8, 32, 32, 4), (97, 98, 99, 100), 132, 0.0),
    ((2, 600, 2, 16, 8, 70), (1, 600), 132, 0.0),
    ((3, 400, 2, 112, 16, 64), (64, 65, 300), 2, 0.0),
    ((2, 300, 4, 72, 4, 8), (9, 300), 132, 0.0),
    ((1, 300, 1, 64, 4, 1), (300,), 1, 0.0),
    # zero points far outside [-128, 127]: K and V all near 200
    ((2, 200, 2, 32, 8, 8), (9, 200), 132, 200.0)])
def test_k6_ranges_merge_to_the_plain_attention(shape, lengths, sms, shift):
    """K6's factored scores and weights (codes minus cut zero points times
    queries, the zero points' remainder times Σ q; weights times codes
    minus cut zero points, minus the weights times the remainder) over the
    launch plan's ranges, merged in order, give the plain version's
    attention within 1e-5 of its largest magnitude: lengths of 1, at the
    hi boundary, inside and past the first range, and zero points that the
    cut leaves a remainder."""
    b, s, g, hd, h, num_hi = shape
    gen = torch.Generator().manual_seed(0)
    k = torch.randn((b, s, g, hd), generator=gen) + shift
    v = torch.randn((b, s, g, hd), generator=gen) + shift
    q = torch.randn((b, 1, h, hd), generator=gen) / math.sqrt(hd)
    entry = TKV.quantize_full(k, v, TKV.KVCacheConfig(num_hi=num_hi))
    if shift:
        assert float(entry["k_zp"].float().abs().max()) > 128
    length = torch.tensor(lengths, dtype=torch.int32)
    got = k6_range_run(entry, q, length, sms)
    want = TR.cache_decode_attention_ref(entry, q, length)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# K1: STaMP transform + quantize over row windows
# ---------------------------------------------------------------------------


def k1_window_run(x, transform, levels, skip_first, num_hi, hi_bits=8,
                  lo_bits=4, k_ranges=3):
    """K1 as the card runs it: every row window's program (input rows into
    slots, the butterflies in place, the outputs read from their slots)
    over the columns of ``k_ranges`` K ranges, the ranges' per-row min /
    max joined, then the scale, zero point and codes of each range from a
    second run of the program."""
    b, s, k = x.shape
    p = TSM.T.largest_pow2(max(s - int(skip_first), 0))
    inv2 = torch.tensor(TSM.Q.recip32(TSM.T.SQRT2))
    invw = torch.tensor(TSM.Q.recip32(math.sqrt(p)) if p else 1.0)
    windows = TSM.tq_windows(s, transform, levels, skip_first)

    def run(ins, prog, outs, cols):
        slots = [x[:, r, cols].float() for r in ins]
        for kind, i, j in prog:
            if kind == TSM.TQ_SCALE:
                slots[i] = slots[i] * invw
            else:
                a, c = slots[i], slots[j]
                if kind == TSM.TQ_HAAR:
                    slots[i], slots[j] = (a + c) * inv2, (a - c) * inv2
                else:
                    slots[i], slots[j] = a + c, a - c
        return {r: slots[sl] for sl, r in outs}

    kc = -(-k // k_ranges)
    ranges = [slice(c0, min(k, c0 + kc)) for c0 in range(0, k, kc)]
    qx = torch.empty((b, s, k), dtype=torch.int8)
    sx = torch.empty((b, s))
    zx = torch.empty((b, s))
    seen = []
    for ins, prog, outs in windows:
        assert len(outs) <= TSM.TQ_OUT and len(ins) <= TSM.TQ_MAX_IN
        parts = [run(ins, prog, outs, cols) for cols in ranges]
        for _, r in outs:
            seen.append(r)
            mn = torch.stack([pt[r].amin(dim=-1) for pt in parts]).amin(0)
            mx = torch.stack([pt[r].amax(dim=-1) for pt in parts]).amax(0)
            n = float(2 ** (hi_bits if r < num_hi else lo_bits) - 1)
            sc = torch.clamp_min((mx - mn) / n, TSM.Q.EPS)
            z = torch.round(-mn / sc)
            sx[:, r], zx[:, r] = sc, z - 128.0
            for cols, pt in zip(ranges, parts):
                q = torch.clamp(torch.round(pt[r] / sc[:, None]) + z[:, None],
                                0.0, n)
                qx[:, r, cols] = (q - 128.0).to(torch.int8)
    assert sorted(seen) == list(range(s))      # every row in one window
    return qx.reshape(b * s, k), sx.reshape(-1), zx.reshape(-1)


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33, 100, 127, 128, 129])
@pytest.mark.parametrize("transform", ["dwt", "wht", "none"])
@pytest.mark.parametrize("skip_first", [True, False])
def test_k1_row_windows_are_the_plain_transform_quantize(s, transform,
                                                         skip_first):
    """The row windows' programs, run over K ranges whose min / max are
    joined before the quantize, give K1's plain version's codes, scales
    and zero points bit for bit: odd and non-power-of-two spans (the DWT's
    odd bands carry their first detail into the next level, the WHT leaves
    a tail), the sink row in and out, ``num_hi`` below and past the span."""
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal((2, s, 40)).astype(np.float32))
    for num_hi in (4, s + 1):
        kw = dict(transform=transform, levels=3, skip_first=skip_first,
                  num_hi=num_hi, hi_bits=8, lo_bits=4)
        want = TSM.transform_quantize_plain(x, **kw)
        got = k1_window_run(x, transform, 3, skip_first, num_hi)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("levels", [1, 2, 5])
def test_k1_row_windows_at_other_levels(levels):
    """Deeper and shallower Haar DWTs: windows of 2^levels input rows (up
    to ``TQ_OUT`` outputs each, a deeper tree split over windows that each
    recompute its ops), still the plain version's codes."""
    x = torch.from_numpy(np.random.default_rng(levels).standard_normal(
        (1, 128, 24)).astype(np.float32))
    kw = dict(transform="dwt", levels=levels, skip_first=True, num_hi=4,
              hi_bits=8, lo_bits=4)
    want = TSM.transform_quantize_plain(x, **kw)
    got = k1_window_run(x, "dwt", levels, True, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k1_windows_of_the_main_path():
    """At the serve path's span (128 rows, 3-level DWT past the sink row)
    eight windows each read at most 16 input rows for their 16 outputs, so
    the transform costs no more than one read of the span; the odd band
    (127 rows) joins the first and last 8-row groups in one window, which
    also takes the sink row and the band's pass-through tail."""
    windows = TSM.tq_windows(128, "dwt", 3, True)
    assert len(windows) == 8
    assert sum(len(o) for _, _, o in windows) == 128
    assert max(len(i) for i, _, _ in windows) <= 16
    assert sum(len(i) for i, _, _ in windows) == 128
    joined = [i for i, _, _ in windows if 1 in i and 126 in i]
    assert len(joined) == 1


@pytest.mark.parametrize("k,max_in,cl,keep,threads", [
    (4096, 16, 8, True, 256), (4864, 16, 10, True, 256),
    (7168, 16, 14, True, 256), (14336, 16, 8, False, 256),
    (100, 64, 1, True, 128), (4100, 64, 8, False, 128),
    (4100, 16, 9, True, 256), (40, 256, 1, True, 32),
    (20000, 16, 8, False, 256)])
def test_k1_launch_plan(k, max_in, cl, keep, threads):
    """K ranges covering K: ranges of one chunk (``keep``: the outputs wait
    in registers) wherever at most ``MAX_CLUSTER`` of them (one cluster)
    cover K, else ``TQ_CLUSTER_PASSES`` ranges that recompute; the slots
    of a block within ``TQ_SLOTS`` of shared memory and the program's room
    before them."""
    plan = TSM.tq_plan(k, max_in, 141)
    assert (plan["cl"], plan["keep"], plan["threads"]) == (cl, keep, threads)
    assert (plan["cl"] - 1) * plan["kc"] < k <= plan["cl"] * plan["kc"]
    assert plan["keep"] == (plan["kc"] <= TSM.TQ_U * plan["threads"])
    assert plan["room"] == 144
    slots = max_in * TSM.TQ_U * threads * 4
    assert slots <= TSM.TQ_SLOTS and plan["smem"] == 4 * 144 + slots


def test_k1_program_layout():
    """The program the kernel reads: a header a window, then its input
    rows, its ops packed one an int and its (slot, row) outputs at the
    offsets the header names."""
    windows = TSM.tq_windows(33, "dwt", 3, True)
    prog = TSM.tq_program(windows)
    for w, (ins, ops, outs) in enumerate(windows):
        ni, nops, nout, i0, o0, u0 = prog[TSM.TQ_HDR * w:
                                          TSM.TQ_HDR * w + 6]
        assert (ni, nops, nout) == (len(ins), len(ops), len(outs))
        assert prog[i0:i0 + ni] == list(ins)
        assert [(c >> 28, (c >> 14) & 0x3fff, c & 0x3fff)
                for c in prog[o0:o0 + nops]] == \
            [(k, i, max(j, 0)) for k, i, j in ops]
        assert prog[u0:u0 + 2 * nout] == [v for o in outs for v in o]


# ---------------------------------------------------------------------------
# K5: grouped MoE expert FFN over its work list
# ---------------------------------------------------------------------------


def k5_work_list_run(args, block_f=512):
    """K5 as the card walks its work list: each (expert, row group) entry
    of ``grouped_work`` computes its rows' gate / up products, the slabs'
    requantize and the down products summed slab by slab, the same
    operations as the plain version on that group's rows only; rows past
    the buckets' counts stay zero."""
    (qx, sx, zx, counts, qwg, swg, zwg, qsg, qwu, swu, zwu, qsu, qwd, swd,
     zwd, qsd) = args
    b, e, cap, d = qx.shape
    f = qwg.shape[-1]
    bf = TSM.grouped_block_f(block_f, f)
    flat = qx.reshape(-1, d)
    out = torch.zeros((b * e * cap, qwd.shape[-1]))
    for ei, rows in TSM.grouped_work(counts, cap, f // bf):
        assert len(rows) <= TSM.GROUP_ROWS
        idx = torch.tensor(rows)
        x = flat[idx]
        s, z = sx.reshape(-1)[idx], zx.reshape(-1)[idx]
        xs = x.sum(dim=1, dtype=torch.int32)

        def up(qw, sw, zw, qs):
            return TSM._epilogue(TSM.int_matmul(x, qw[ei]), s, z,
                                 sw[ei].reshape(1, -1).float(),
                                 zw[ei].reshape(1, -1).float(), xs,
                                 qs[ei].reshape(-1), d)

        a = TSM.silu(up(qwg, swg, zwg, qsg)) * up(qwu, swu, zwu, qsu)
        acc = torch.zeros((len(rows), qwd.shape[-1]))
        for j in range(f // bf):
            qa, sa, za = TS.token_quantize(a[:, j * bf:(j + 1) * bf])
            acc = acc + TSM._epilogue(
                TSM.int_matmul(qa, qwd[ei, j * bf:(j + 1) * bf]), sa[:, 0],
                za[:, 0], swd[ei].reshape(1, -1).float(),
                zwd[ei].reshape(1, -1).float(),
                qa.sum(dim=1, dtype=torch.int32), qsd[ei, j], bf)
        out[idx] = acc
    return out.reshape(b, e, cap, -1)


@pytest.mark.parametrize("counts,cap", [
    ([[10, 7, 1, 0], [0, 3, 10, 2]], 10),     # 17 rows in one expert
    ([[20, 0, 20, 5], [20, 1, 13, 0]], 20),   # 40 rows: two row groups
    ([[0, 0, 0, 0], [0, 2, 0, 0]], 3),        # one occupied expert
])
def test_k5_work_list_is_the_plain_grouped_ffn(counts, cap):
    """The work list K5 builds on the card from the counts (occupied
    experts in order, row groups of up to ``GROUP_ROWS`` kept rows, bucket
    by bucket) covers every kept row once, and the groups' products give
    the plain version's output: row groups change which rows share a
    weight pass, never an operation of a row."""
    from test_torch_cuda import grouped_case
    args = grouped_case(2, 4, cap, 32, 256, counts, "cpu")
    want = TSM.grouped_matmul_plain(*args)
    got = k5_work_list_run(args)
    assert torch.equal(got, want)
    work = TSM.grouped_work(args[3], cap, 1)
    kept = sorted(r for _, rows in work for r in rows)
    assert kept == sorted((i * 4 + e) * cap + c for i, row in
                          enumerate(counts) for e, n in enumerate(row)
                          for c in range(min(n, cap)))
    assert [e for e, _ in work] == sorted(e for e, _ in work)


@pytest.mark.parametrize("b,cap,tiles", [(2, 3, 1), (2, 4, 1), (8, 3, 4),
                                          (8, 4, 4), (2, 10, 4), (1, 1, 1)])
def test_k5_token_tiles(b, cap, tiles):
    """The token tiles K5 multiplies against each weight tile cover the
    most kept rows an expert can have (``b · cap``) up to a row group:
    Arctic's 2 x 3 and Kimi-K2's 2 x 4 take one tile of 8, eight prefill
    chunks four."""
    assert TSM.grouped_token_tiles(b, cap) == tiles
    assert 8 * tiles >= min(b * cap, TSM.GROUP_ROWS)


# ---------------------------------------------------------------------------
# every plan at the widths of the dense archs served at full width
# ---------------------------------------------------------------------------

SMEM_OPTIN = 232448        # the H100's opt-in shared memory a block (227 KB)
DENSE_ARCHS = ("deepseek-7b", "minicpm-2b", "mistral-nemo-12b", "qwen2-72b")


def _covers(parts: int, size: int, total: int) -> None:
    """``parts`` ranges of ``size`` cover ``total`` exactly: none empty."""
    assert parts >= 1 and size >= 1
    assert (parts - 1) * size < total <= parts * size


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_plans_at_the_dense_archs_widths(arch):
    """K1's row windows and launch, K2's, K3's, K4's and K6's plans at the
    full-width linear and attention shapes of the four dense archs the
    smoke serves (contraction lengths 2304, 5760, 11008 and 29568, one
    query head a kv head at 32 and 36 kv heads, the out-proj from
    ``q_dim``): ranges cover K exactly with no empty one, tiles cover N and
    the query rows, and K1's shared memory fits the 227 KB opt-in."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    d, qkv = cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim
    sites = [(d, qkv, False), (cfg.q_dim, d, False), (d, cfg.d_ff, True),
             (cfg.d_ff, d, False)]
    windows = TSM.tq_windows(128, "dwt", 3, True)
    max_in = max(len(w[0]) for w in windows)
    max_prog = max(len(i) + len(o) + 2 * len(u) for i, o, u in windows)
    for k, n, dual in sites:
        plan = TSM.tq_plan(k, max_in, max_prog)
        _covers(plan["cl"], plan["kc"], k)
        assert plan["cl"] <= TSM.MAX_CLUSTER
        assert plan["smem"] <= SMEM_OPTIN
        for spans in (2, 4, 8):          # paged, bucketed at 4 and 8 spans
            gp = TSM.gemm_plan(spans, k, n, dual, 132)
            _covers(gp["col_tiles"], TSM.GEMM_COLS // (2 if dual else 1), n)
            _covers(gp["n_split"], gp["split_k"], k)
            assert gp["split_k"] % TSM.GEMM_BK == 0
            assert gp["n_split"] <= TSM.MAX_SPLITS
        for m in (4, 8):                 # the bucketed and paged decode rows
            dp = TDM.decode_plan(m, k, n, 132)
            _covers(dp["strips"], dp["strip"], n)
            _covers(dp["n_split"], dp["split_k"], k)
            assert dp["split_k"] % TDM.STAGE_K == 0
            assert dp["n_split"] <= TDM.MAX_SPLIT
    rep, g = cfg.num_heads // cfg.num_kv_heads, cfg.num_kv_heads
    assert cfg.resolved_head_dim in TPA._HEAD_DIMS
    assert cfg.resolved_head_dim in TCA._HEAD_DIMS
    for n_pf, capacity in ((2, 136), (0, 136), (0, 32768)):
        plan = TPA.launch_plan(n_pf, 8, 128, rep, g, capacity, 132)
        if n_pf:
            _covers(plan["row_tiles"], TPA.PF_ROWS, 128 * rep)
        assert plan["n_split"] >= 1
        assert 8 * g * plan["n_split"] <= max(TPA.FILL * 132, 8 * g)
    for b, hi, s in ((4, 4, 136), (8, 64, 32768)):
        per, n_split = TCA.launch_plan(b, g, hi, s, 132)
        _covers(n_split, per, len(TCA.tiles(hi, s)))


# ---------------------------------------------------------------------------
# K8: the route of each row and the words a lane holds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,elem,x_off,g,nv", [
    (4096, 2, 0, 4, 4),       # the library's rows: 4 warps a row
    (1024, 2, 0, 1, 4),       # the KV shape: one warp
    (4096, 4, 0, 8, 4),       # f32
    (2304, 2, 0, 4, 4),       # minicpm-2b: 288 words, 3 a lane
    (8192, 4, 0, 8, 8),       # past 8 warps x 4 words
    (16384, 4, 0, 8, 16),     # 64 KB: the most a block holds
    (40, 2, 0, 1, 1),         # five words
    (1008, 2, 0, 1, 4),       # 126 words
    (16416, 4, 0, 1, 0),      # past 64 KB: the two passes
    (100, 2, 0, 1, 0),        # not whole words
    (1024, 2, 4, 1, 0),       # unaligned input
])
def test_k8_pack_plan(d, elem, x_off, g, nv):
    """K8's route: rows of whole, aligned 16-byte words up to 64 KB held in
    registers by the fewest warps (``g``) whose lanes hold at most
    ``LANE_TARGET`` words, or all ``WARPS`` past that (``nv``, the
    smallest template size that holds the row); every other row on the two
    passes."""
    plan = TQP.pack_plan(d, elem, 256 + x_off, 512)
    assert (plan["g"], plan["nv"]) == (g, nv)
    block = max(g, TQP.ROW_BLOCK) if nv else TQP.WARPS
    assert plan["rows_per_block"] * plan["g"] == block


@pytest.mark.parametrize("d,elem", [(4096, 2), (1024, 2), (4096, 4),
                                    (2304, 2), (2304, 4), (5760, 2),
                                    (8192, 2), (32768, 2), (16384, 4),
                                    (40, 2), (8, 2), (1000, 4)])
def test_k8_lanes_hold_each_word_once(d, elem):
    """Under the registers route every 16-byte word of a row sits on
    exactly one (warp, lane), each warp of the row holds some, a lane at
    most ``nv``, and each warp's j-th load covers contiguous words (its
    lanes' words are consecutive)."""
    plan = TQP.pack_plan(d, elem, 0, 0)
    assert plan["nv"] > 0
    held = TQP.lane_words(plan, d, elem)
    words = d * elem // 16
    flat = sorted(c for warp in held for lane in warp for c in lane)
    assert flat == list(range(words))
    assert all(any(lane for lane in warp) for warp in held)
    assert all(len(lane) <= plan["nv"] for warp in held for lane in warp)
    for warp in held:
        for j in range(plan["nv"]):
            col = [lane[j] for lane in warp if len(lane) > j]
            if col:
                assert col == list(range(col[0], col[0] + len(col)))
