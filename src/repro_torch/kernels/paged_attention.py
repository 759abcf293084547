"""Paged mixed-precision attention: K4 ``paged_ragged_attention`` (CUDA
source: ``csrc/paged_attention.cu``).

Replaces ``paged_ragged_attention`` and ``paged_decode_attention``
(``src/repro/kernels/paged_attention.py``): one launch walks the block
tables of ``n_pf`` prefill-chunk spans followed by ``S`` decode spans,
dequantizes the int8 hi pages and int4-nibble lo pages (f16 scale / zero
point), and applies the unified mask ``kv_pos <= q_pos AND kv_pos <
length``.  An all-decode step is the ``n_pf = 0`` case of the same kernel,
as the reference runs it, and :func:`paged_decode_attention` is that case
under the reference's name and signature.  Prefill spans attend to their
own chunk through the pages the step has just written (``write_ragged``
runs first).

Bound on the H100: bytes of the pages each span's length needs, but at the
serve path's sizes the kernel is latency-bound.  Each block gathers tiles of
``KV_TILE`` positions through the block table (two stages of
``cp.async``); prefill blocks own ``PF_ROWS`` query rows, decode blocks
one range of a decode span; a split span's ranges are merged in range order
by a second launch.  :func:`launch_plan` sizes the launch;
:func:`decode_ranges` is the split the card works out from the lengths.  The queries are
read in 16-byte vectors (a misaligned one is copied first).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda
from repro_torch.serving import kvcache as KV

_POOL_KEYS = ("k_hi", "v_hi", "k_hi_scale", "k_hi_zp", "v_hi_scale",
              "v_hi_zp", "k_lo", "v_lo", "k_lo_scale", "k_lo_zp",
              "v_lo_scale", "v_lo_zp")
# every config's head_dim (Kimi-K2: 112, PixArt-Σ: 72)
_HEAD_DIMS = (16, 32, 64, 72, 112, 128)
KV_TILE = 32          # positions a block gathers and scores per tile
PF_ROWS = 64          # query rows of a prefill block
MAX_REP = 8           # query heads per kv head (a decode block's rows)
FILL = 2              # K4 blocks an SM holds
SPLIT_FROM_TILES = 8  # a decode span is split over blocks from this many tiles
MIN_RANGE_TILES = 2   # tiles a range of a split span holds at least
MAX_SPLIT_SPANS = 256  # decode spans a split step may carry

_SIGNATURES = {"paged_attention": [
    cuda.VP, cuda.VP, cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.INT,
    cuda.INT, cuda.INT, cuda.INT, cuda.INT, cuda.INT,
    *([cuda.VP] * 12), cuda.VP, cuda.VP, cuda.VP, cuda.VP, cuda.FLT,
    cuda.INT, cuda.INT, cuda.VP, cuda.VP, cuda.VP, cuda.VP],
    "paged_attention_smem_bytes": [cuda.INT]}


def launch_plan(n_pf: int, s_slots: int, c_len: int, rep: int, g: int,
                capacity: int, sms: int) -> dict:
    """The launch's size: ``n_pf · g · row_tiles`` prefill blocks of
    ``PF_ROWS`` query rows, then ``s_slots · g · n_split`` decode blocks.
    In a mixed step the prefill blocks fill the card and walk as far, so
    decode spans stay whole (``n_split`` 1).  In an all-decode step whose
    tables map at least ``SPLIT_FROM_TILES`` tiles (``capacity``
    positions), each kv head gets ``n_split`` block slots a span, as many as
    one wave of ``FILL`` blocks an SM holds (``sms``); which span and range
    each slot takes is worked out on the card from the spans' lengths
    (:func:`decode_ranges`)."""
    row_tiles = -(-c_len * rep // PF_ROWS) if n_pf else 0
    tiles = -(-capacity // KV_TILE)
    n_split = 1
    if not n_pf and tiles >= SPLIT_FROM_TILES and s_slots <= MAX_SPLIT_SPANS:
        n_split = max(min(FILL * sms // (s_slots * g),
                          tiles // MIN_RANGE_TILES, 4096 // s_slots), 1)
    return dict(row_tiles=row_tiles, n_split=n_split)


def _range_count(tiles: int, total: int, spare: int) -> int:
    if tiles < SPLIT_FROM_TILES:
        return 1
    return min(1 + tiles * spare // total, tiles // MIN_RANGE_TILES)


def decode_ranges(lengths, n_split: int) -> list:
    """The decode blocks' work for one kv head, as K4 works it out on the
    card from the decode spans' lengths (``decode_slot`` in
    ``csrc/paged_attention.cu``): a list, in block-slot order, of ``(span,
    kv0, kv1, k)``, range ``[kv0, kv1)`` of a span cut into ``k`` ranges;
    slots past the list are unused.  Unsplit (``n_split`` 1), slot i walks
    span i whole.  Split: every span has one slot, and the other ``S ·
    (n_split - 1)`` go to the spans of at least ``SPLIT_FROM_TILES`` tiles
    in proportion to their tiles (``T`` the step's): a span of ``t`` tiles
    takes ``k = 1 + t·S·(n_split - 1) // T`` ranges, at most one every
    ``MIN_RANGE_TILES`` tiles, range ``r`` its tiles ``[t·r // k,
    t·(r+1) // k)``, in the slots after the spans before it.  A span of one
    range writes its output; the others' partials are merged in range order
    by the merge launch."""
    lengths = [int(n) for n in lengths]
    if n_split == 1:
        return [(i, 0, n, 1) for i, n in enumerate(lengths)]
    tiles = [-(-n // KV_TILE) for n in lengths]
    total, spare = max(sum(tiles), 1), len(lengths) * (n_split - 1)
    out = []
    for i, (n, t) in enumerate(zip(lengths, tiles)):
        k = _range_count(t, total, spare)
        out += [(i, t * r // k * KV_TILE, min(t * (r + 1) // k * KV_TILE, n),
                 k) for r in range(k)]
    return out


def _page(entry: dict, name: str, region: str, pages: torch.Tensor):
    """Dequantized f32 ``(spans, g, bs, hd)`` K or V of one page per span."""
    codes = entry[f"{name}_{region}"][pages]
    vals = codes.float() if region == "hi" else KV.unpack_nibbles(codes)
    out = KV.dequant_tokens(vals, entry[f"{name}_{region}_scale"][pages],
                            entry[f"{name}_{region}_zp"][pages],
                            torch.float32)
    return out.transpose(1, 2)


def _walk(entry, q, qpos, lengths, hi_table, lo_table, bs: int):
    """Online softmax over every logical block of each span's tables, one
    page at a time, in the Pallas kernel's order: block scores, block max,
    ``exp``, block sums, then the merge ``l·c_prev + l_blk·c_blk``.
    ``q``: (spans, g, rows, hd) f32, pre-scaled; ``qpos``: (spans, rows)."""
    nh, nl = hi_table.shape[1], lo_table.shape[1]
    spans, g, rows, hd = q.shape
    m = q.new_full((spans, g, rows), -1e30)
    l = q.new_zeros((spans, g, rows))
    o = q.new_zeros((spans, g, rows, hd))
    ar = torch.arange(bs, device=q.device)
    for blk in range(nh + nl):
        hi = blk < nh
        region = "hi" if hi else "lo"
        pages = (hi_table[:, blk] if hi else lo_table[:, blk - nh]).long()
        pos = (blk * bs if hi else nh * bs + (blk - nh) * bs) + ar
        k_pg, v_pg = (_page(entry, n, region, pages) for n in ("k", "v"))
        mask = (pos[None, None, :] <= qpos[:, :, None]) & \
            (pos[None, None, :] < lengths[:, None, None])      # (spans,r,bs)
        sc = torch.where(mask[:, None], q @ k_pg.transpose(-1, -2), -1e30)
        m_blk = sc.amax(dim=-1)
        p = torch.exp(sc - m_blk[..., None])
        l_blk = p.sum(dim=-1)
        o_blk = p @ v_pg
        m_new = torch.maximum(m, m_blk)
        c_prev = torch.exp(m - m_new)
        c_blk = torch.exp(m_blk - m_new)
        l = l * c_prev + l_blk * c_blk
        o = o * c_prev[..., None] + o_blk * c_blk[..., None]
        m = m_new
    return o / torch.clamp_min(l, 1e-30)[..., None]


_SMEM = {}


def _smem_bytes(lib, hd: int) -> int:
    if hd not in _SMEM:
        _SMEM[hd] = lib.paged_attention_smem_bytes(hd)
    return _SMEM[hd]


def paged_attention_plain(entry, q_pf, q_dec, q_starts, lengths, hi_table,
                          lo_table, block_size: int) -> tuple:
    """Plain version of K4: the page walk of the Pallas kernel (every
    logical block of the tables, masked, merged by online softmax), with
    the prefill spans' ``C·rep`` query rows and the decode spans' ``rep``
    rows batched per kv head.  ``n_pf`` may be 0.  Outputs keep ``q``'s
    dtype."""
    n_pf, c_len, h, hd = q_pf.shape
    s_slots = q_dec.shape[0]
    g = entry["k_lo"].shape[2]
    rep = h // g
    scale = 1.0 / math.sqrt(hd)
    lengths = lengths.to(q_dec.device)
    q_starts = q_starts.to(q_dec.device)
    out_pf = q_pf
    if n_pf:
        qg = (q_pf.float() * scale).reshape(n_pf, c_len, g, rep, hd) \
            .transpose(1, 2).reshape(n_pf, g, c_len * rep, hd)
        row = torch.arange(c_len * rep, device=q_pf.device) // rep
        o = _walk(entry, qg, q_starts[:n_pf, None] + row[None, :],
                  lengths[:n_pf], hi_table[:n_pf], lo_table[:n_pf],
                  block_size)
        out_pf = o.reshape(n_pf, g, c_len, rep, hd).transpose(1, 2) \
            .reshape(n_pf, c_len, h, hd).to(q_pf.dtype)
    qd = (q_dec.float() * scale).reshape(s_slots, g, rep, hd)
    dec_len = lengths[n_pf:]
    o = _walk(entry, qd, (dec_len - 1)[:, None].expand(s_slots, rep),
              dec_len, hi_table[n_pf:], lo_table[n_pf:], block_size)
    return out_pf, o.reshape(s_slots, 1, h, hd).to(q_dec.dtype)


def paged_ragged_attention(entry: dict, q_pf: torch.Tensor,
                           q_dec: torch.Tensor, q_starts: torch.Tensor,
                           lengths: torch.Tensor, hi_table: torch.Tensor,
                           lo_table: torch.Tensor, block_size: int) -> tuple:
    """K4.  ``entry``: one layer's pools (k_hi (NH, bs, g, hd) int8, k_lo
    (NL, bs, g, hd/2) uint8, ``*_scale``/``*_zp`` (N, bs, g) f16);
    ``q_pf``: (n_pf, C, h, hd); ``q_dec``: (S, 1, h, hd); ``q_starts`` /
    ``lengths``: (n_pf+S,) int32; ``hi_table`` (n_pf+S, nh) and
    ``lo_table`` (n_pf+S, nl) int32, unmapped blocks 0 (the null page).
    Returns ``(out_pf, out_dec)`` in ``q``'s dtype."""
    if q_dec.shape[0] < 1:
        raise ValueError("the unified step always carries the decode slots")
    if q_dec.device.type == "cpu":
        return paged_attention_plain(entry, q_pf, q_dec, q_starts, lengths,
                                     hi_table, lo_table, block_size)
    # the kernel loads queries in 16-byte vectors
    q_pf, q_dec = (q if q.is_contiguous() and q.data_ptr() % 16 == 0
                   else q.clone(memory_format=torch.contiguous_format)
                   for q in (q_pf, q_dec))
    n_pf, c_len, h, hd = q_pf.shape
    s_slots = q_dec.shape[0]
    g = entry["k_lo"].shape[2]
    bs = block_size
    nh, nl = hi_table.shape[1], lo_table.shape[1]
    if hd not in _HEAD_DIMS or h % g or h // g > MAX_REP or bs * g % 2:
        raise ValueError(f"K4 takes head_dim in {_HEAD_DIMS}, whole GQA "
                         f"groups of at most {MAX_REP} heads (a decode "
                         f"block's rows) and pages of an even number of "
                         f"(token, kv head) values (it gathers a token's "
                         f"f16 scale and zero point as the 4-byte pair that "
                         f"holds them, which must not leave the pool); got "
                         f"hd={hd}, h={h}, g={g}, bs={bs}")
    if q_pf.dtype not in (torch.bfloat16, torch.float32) or \
            q_dec.dtype != q_pf.dtype:
        raise ValueError("K4 takes bf16 or f32 queries of one dtype")
    ints = [t.to(torch.int32).contiguous()
            for t in (hi_table, lo_table, lengths, q_starts)]
    pools = [entry[k] for k in _POOL_KEYS]
    cuda.require_cuda(q_pf, q_dec, *pools, *ints)
    codes = _POOL_KEYS[:2] + _POOL_KEYS[6:8]
    if any(entry[k].data_ptr() % (16 if k in codes else 4)
           for k in _POOL_KEYS):
        raise ValueError("K4 gathers page codes in 16-byte chunks and f16 "
                         "scales in 4-byte pairs: the code pools must be "
                         "16-byte aligned and the scale pools 4-byte")
    lib = cuda.library("paged_attention", _SIGNATURES)
    dev = q_dec.device
    smem = _smem_bytes(lib, hd)
    if smem > cuda.smem_optin(dev):
        raise ValueError(f"K4 at head_dim {hd} needs {smem} bytes of shared "
                         f"memory a block (two raw tile stages, f32 K, V, "
                         f"query and score tiles); the card allows "
                         f"{cuda.smem_optin(dev)}")
    plan = launch_plan(n_pf, s_slots, c_len, h // g, g, (nh + nl) * bs,
                       cuda.sm_count(dev))
    out_pf = torch.empty_like(q_pf)
    out_dec = torch.empty_like(q_dec)
    part = None
    if plan["n_split"] > 1:
        part = torch.empty((g, s_slots * plan["n_split"], h // g, hd + 2),
                           dtype=torch.float32, device=dev)
    err = lib.paged_attention(
        q_pf.data_ptr(), q_dec.data_ptr(), int(q_pf.dtype == torch.bfloat16),
        n_pf, s_slots, c_len, h, g, hd, bs, nh, nl,
        *(t.data_ptr() for t in pools), *(t.data_ptr() for t in ints),
        1.0 / math.sqrt(hd), plan["row_tiles"], plan["n_split"],
        cuda.ptr(part), out_pf.data_ptr(),
        out_dec.data_ptr(), cuda.stream_ptr(q_dec))
    cuda.check(err, "paged_attention")
    paged_ragged_attention.launches += 1
    return out_pf, out_dec


paged_ragged_attention.launches = 0


def paged_decode_attention(entry: dict, q: torch.Tensor,
                           lengths: torch.Tensor, hi_table: torch.Tensor,
                           lo_table: torch.Tensor,
                           block_size: int) -> torch.Tensor:
    """Decode attention over one layer's paged pools, with the reference's
    signature (``repro.kernels.paged_attention.paged_decode_attention``):
    ``q`` (S, 1, h, hd), ``lengths`` (S,) int32 tokens cached per slot
    including the new one, tables (S, nh) / (S, nl).  This is K4 with no
    prefill spans (``n_pf = 0``): a CUDA tensor launches
    :func:`paged_ragged_attention`, whose count the launch is counted
    under, and a CPU tensor runs its plain version with no chunk rows."""
    q_pf = q.new_empty((0, 1, *q.shape[2:]))
    return paged_ragged_attention(entry, q_pf, q, lengths - 1, lengths,
                                  hi_table, lo_table, block_size)[1]
