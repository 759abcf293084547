"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda``: it needs a CUDA card and ``nvcc``, and
skips elsewhere.  The file imports neither JAX nor the reference, so it
runs on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` repeats these comparisons at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import stamp as TS
from repro_torch.kernels import cuda as kcuda
from repro_torch.kernels import cache_attention as TCA
from repro_torch.kernels import decode_matmul as TDM
from repro_torch.kernels import haar_dwt as THD
from repro_torch.kernels import int8_gemm as TIM
from repro_torch.kernels import ops as TO
from repro_torch.kernels import quant_pack as TQP
from repro_torch.kernels import ref as TR
from repro_torch.kernels import paged_attention as TPA
from repro_torch.kernels import stamp_matmul as TSM
from repro_torch.kernels import wht as TW
from repro_torch.serving import kvcache as TKV
from repro_torch.serving import paged_kvcache as TPKV

SPANS = [(16, 27), (0, 9), (29, 30), (8, 9)]   # two chunks, two decodes


def paged_pools(block_size, num_hi, spans, g=2, hd=16, seed=0):
    """CPU pools holding random K/V for ``spans`` = [(start, length)],
    written through the port's ``write_ragged``: each span owns its own hi
    and lo pages (page 0 stays the null page).  Returns ``(entry,
    hi_table, lo_table)`` with numpy int32 tables."""
    nh = num_hi // block_size
    max_len = max(length for _, length in spans)
    nl = max(-(-(max_len - num_hi) // block_size), 1)
    pcfg = TPKV.PagedCacheConfig(
        block_size=block_size, num_lo_blocks=len(spans) * nl + 1,
        num_hi_blocks=len(spans) * nh + 1, max_blocks_per_seq=nl,
        quant=TKV.KVCacheConfig(quantized=True, num_hi=num_hi))
    entry = TPKV.init_pools(g, hd, pcfg, device="cpu")
    ht = np.zeros((len(spans), nh), np.int32)
    lt = np.zeros((len(spans), nl), np.int32)
    pages, offs, ishi = [], [], []
    for i, (_, length) in enumerate(spans):
        ht[i] = 1 + i * nh + np.arange(nh)
        n_lo = max(-(-(length - num_hi) // block_size), 0)
        lt[i, :n_lo] = 1 + i * nl + np.arange(n_lo)
        for pos in range(length):
            is_hi, idx, off = TPKV.token_page_index(pos, pcfg)
            pages.append(ht[i, idx] if is_hi else lt[i, idx])
            offs.append(off)
            ishi.append(is_hi)
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((len(pages), g, hd)).astype(np.float32)
    v = rng.standard_normal((len(pages), g, hd)).astype(np.float32)
    TPKV.write_ragged(entry, torch.from_numpy(k), torch.from_numpy(v),
                      torch.tensor(pages, dtype=torch.int32),
                      torch.tensor(offs, dtype=torch.int32),
                      torch.tensor(ishi), pcfg)
    return entry, ht, lt


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA + nvcc")
    try:
        kcuda.nvcc()
    except RuntimeError:
        pytest.skip("needs CUDA + nvcc")
    return torch.device("cuda")


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("transform", ["dwt", "wht", "none"])
def test_cuda_stamp_chain_matches_plain(card, transform):
    """K1 codes / scales / zero points exact; K2 in f32 within 1e-5
    relative (the same f32 epilogue order; exp and the transform's
    divisions are correctly rounded on both sides)."""
    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((2, 33, 256), generator=gen, device=card)
    kw = dict(transform=transform, levels=3, skip_first=True, num_hi=4,
              hi_bits=8, lo_bits=4)
    got = TSM.stamp_transform_quantize(x, **kw)
    want = TSM.transform_quantize_plain(x, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    p = TS.prepare_linear(torch.randn((256, 96), generator=gen, device=card))
    u = TS.prepare_linear(torch.randn((256, 96), generator=gen, device=card))
    gkw = dict(transform=transform, levels=3, skip_first=True)
    w = (p.qw, p.sw, p.zw, p.qw_sum, None)
    for up in ((), (u.qw, u.sw, u.zw, u.qw_sum, None)):
        y = TSM.stamp_int_gemm(*got, 33, *w, *up, **gkw)
        yp = TSM.int_gemm_plain(*got, 33, *w, *up, **gkw)
        assert _rel(y, yp) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 7, 33, 100, 127, 128])
@pytest.mark.parametrize("k", [40, 100, 1000, 4100])
@pytest.mark.parametrize("transform", ["dwt", "wht", "none"])
def test_cuda_transform_quantize_shapes(card, s, k, transform):
    """K1's codes, scales and zero points exactly its plain version's: K
    off multiples of 16 and 32 (40, 100, 1000) and split over clusters of
    uneven ranges (4100: 8 ranges of 513 columns), odd and
    non-power-of-two spans, the sink row in and out of the transform, 1, 3
    and 8 spans, ``num_hi`` below and past the span, bf16 and f32."""
    gen = torch.Generator(device=card).manual_seed(s * k)
    for spans in (1, 3, 8):
        x = torch.randn((spans, s, k), generator=gen, device=card) * 3
        for dtype in (torch.bfloat16, torch.float32):
            xt = x.to(dtype)
            for skip in (True, False):
                for num_hi in (4, s + 1):
                    kw = dict(transform=transform, levels=3, skip_first=skip,
                              num_hi=num_hi, hi_bits=8, lo_bits=4)
                    got = TSM.stamp_transform_quantize(xt, **kw)
                    want = TSM.transform_quantize_plain(xt, **kw)
                    for a, b in zip(got, want):
                        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_transform_quantize_replays_from_a_graph(card):
    """K1 counts one launch a call, needs nothing of the host between its
    passes (a CUDA graph captures a call), and the replay gives the eager
    call's codes."""
    x = torch.randn((2, 128, 4096), device=card, dtype=torch.bfloat16)
    kw = dict(transform="dwt", levels=3, skip_first=True, num_hi=4,
              hi_bits=8, lo_bits=4)
    want = TSM.stamp_transform_quantize(x, **kw)   # copies the program
    torch.cuda.synchronize()
    before = TSM.stamp_transform_quantize.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = TSM.stamp_transform_quantize(x, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert TSM.stamp_transform_quantize.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_decode_matmul_matches_plain(card):
    """K3 in f32 within 1e-5 relative: exact int32 sums, same epilogue."""
    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((8, 512), generator=gen, device=card)
    p = TS.prepare_linear(torch.randn((512, 384), generator=gen, device=card))
    y = TDM.stamp_decode_matmul(x, p.qw, p.sw, p.zw, p.qw_sum)
    yp = TDM.decode_matmul_plain(x, p.qw, p.sw, p.zw, p.qw_sum)
    assert _rel(y, yp) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 17, 32, 64])
@pytest.mark.parametrize("k", [1000, 4096, 14336])
@pytest.mark.parametrize("n", [200, 6144])
def test_cuda_decode_matmul_tilings(card, m, k, n):
    """K3 against its plain version over its row tiles and cluster ranges:
    M from 1 to 64 rows (tiles of 8, the last one partial), K 1000 (not a
    multiple of the 32-row stage), 4096 and 14336 (cut into up to 8 ranges
    whose products meet in distributed shared memory), N 200 (4-byte
    copies, a partial strip) and 6144; bf16 activations with a bias, f32
    output within 1e-5 relative (exact int32 sums, the same epilogue
    order), bf16 within one bf16 step."""
    gen = torch.Generator(device=card).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=card).to(torch.bfloat16)
    p = TS.prepare_linear(torch.randn((k, n), generator=gen, device=card)
                          / k ** 0.5)
    bias = torch.randn(n, generator=gen, device=card)
    w = (p.qw, p.sw, p.zw, p.qw_sum, bias)
    y = TDM.stamp_decode_matmul(x, *w)
    yp = TDM.decode_matmul_plain(x, *w)
    torch.cuda.synchronize()
    assert y.shape == yp.shape == (m, n) and y.dtype == torch.float32
    assert _rel(y, yp) <= 1e-5
    _close_bf16(TDM.stamp_decode_matmul(x, *w, out_dtype=torch.bfloat16),
                TDM.decode_matmul_plain(x, *w, out_dtype=torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 9])
@pytest.mark.parametrize("k", [1024, 4096, 14336])
@pytest.mark.parametrize("ranks", [2, 4])
def test_cuda_decode_matmul_parts_summed_are_one_launch(card, m, k, ranks):
    """K3's parts mode on each rank's block of the rows (quantized with
    the whole rows' (min, max)), the parts summed and finished by its
    summed mode: the whole rows' K3 output bit for bit (bf16 and f32, with
    a bias), and each mode its plain version's; N 200 (a partial strip)
    and 6144."""
    gen = torch.Generator(device=card).manual_seed(m + k + ranks)
    x = torch.randn((m, k), generator=gen, device=card).to(torch.bfloat16)
    for n in (200, 6144):
        p = TS.prepare_linear(torch.randn((k, n), generator=gen, device=card)
                              / k ** 0.5)
        bias = torch.randn(n, generator=gen, device=card)
        c = k // ranks
        blocks = [x[:, r * c:(r + 1) * c].contiguous() for r in range(ranks)]
        st = torch.stack([TDM.decode_row_minmax(b) for b in blocks])
        stats = torch.stack([st[..., 0].amin(0), st[..., 1].amax(0)], -1)
        parts = []
        for r, b in enumerate(blocks):
            wq = p.qw[r * c:(r + 1) * c].contiguous()
            ws = wq.sum(dim=0, keepdim=True, dtype=torch.int32)
            got = TDM.stamp_decode_matmul_parts(b, wq, ws, stats)
            assert torch.equal(got, TDM.decode_parts_plain(b, wq, ws, stats))
            parts.append(got)
        summed = sum(parts)
        for od in (torch.bfloat16, torch.float32):
            got = TDM.stamp_decode_matmul_summed(summed, stats, p.sw, p.zw,
                                                 bias, out_dtype=od)
            assert torch.equal(got, TDM.stamp_decode_matmul(
                x, p.qw, p.sw, p.zw, p.qw_sum, bias, out_dtype=od))
            assert torch.equal(got, TDM.decode_summed_plain(
                summed, stats, p.sw, p.zw, bias, out_dtype=od))


@pytest.mark.cuda
def test_cuda_decode_matmul_accumulates_in_int32(card):
    """|codes| = 128 over K = 14336: row 0 quantizes to 7112 codes of -128,
    56 of 1 and 7168 of 127, and column 0 of the weight holds -128, 1 and
    -128 there, so their product is exactly 56: 1.2e8 cancelled to 56.  An
    f32 accumulator loses the +1s (and the output moves by 56 scales, a few
    f32 steps beside the zero-point terms); K3's int32 sums keep them, as
    the plain version does."""
    k, n = 14336, 256
    gen = torch.Generator(device=card).manual_seed(4)
    x = torch.randn((4, k), generator=gen, device=card)
    x[0, :7112], x[0, 7112:7168], x[0, 7168:] = 0.0, 129.0, 255.0
    qw = torch.randint(-128, 128, (k, n), generator=gen, device=card,
                       dtype=torch.int8)
    qw[:7112, 0], qw[7112:7168, 0], qw[7168:, 0] = -128, 1, -128
    qx = TDM.row_quantize8(x)[0]
    assert int(TSM.int_matmul(qx, qw)[0, 0]) == 56
    w = (qw, torch.ones((1, n), device=card), torch.zeros((1, n), device=card),
         qw.sum(dim=0, keepdim=True, dtype=torch.int32))
    y = TDM.stamp_decode_matmul(x, *w)
    yp = TDM.decode_matmul_plain(x, *w)
    torch.cuda.synchronize()
    assert torch.equal(y, yp)


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [4, 16])
def test_cuda_paged_attention_matches_plain(card, block_size):
    """K4 with f32 queries: the online softmax against the direct one
    within 1e-4 absolute (exp and summation order)."""
    entry, ht, lt = paged_pools(block_size, 16, SPANS, seed=5)
    entry = {k: v.to(card) for k, v in entry.items()}
    rng = np.random.default_rng(6)
    q_pf = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    q_dec = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    args = (entry, torch.from_numpy(q_pf).to(card),
            torch.from_numpy(q_dec).to(card),
            torch.tensor([s for s, _ in SPANS], dtype=torch.int32,
                         device=card),
            torch.tensor([l for _, l in SPANS], dtype=torch.int32,
                         device=card),
            torch.from_numpy(ht).to(card), torch.from_numpy(lt).to(card))
    got = TPA.paged_ragged_attention(*args, block_size)
    want = TPA.paged_attention_plain(*args, block_size)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4


def _close_bf16(got, want) -> None:
    """Every element within one bf16 step (2^-7 relative) of the plain
    version's, both written in bf16: the f32 values agree to rounding, so a
    rounding boundary between them moves an element by at most one step."""
    g, w = got.float(), want.float()
    assert bool(torch.isfinite(g).all())
    assert bool(((g - w).abs() <= 2 ** -7 * w.abs() + 1e-6).all()), \
        float((g - w).abs().max())


# prefill chunks (start, length): a first chunk shorter than its 128 rows and
# a continuation chunk; decode spans of 1 position, under a tile, several
# tiles, and long enough to be split over two blocks
K4_PREFILL = [(0, 100), (200, 328)]
K4_DECODE = [(0, 1), (32, 33), (76, 77), (599, 600)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("rep", [4, 7])
@pytest.mark.parametrize("block_size", [4, 16, 5])
def test_cuda_paged_attention_tilings(card, hd, rep, block_size):
    """K4's tiles, row tiles and split ranges against its plain version: a
    mixed step (two 128-row chunks and four decode spans, walked whole) and
    an all-decode step (its spans split into ranges merged in order), at
    head dims 128 and 64, 4 and 7 query heads per kv head, page sizes 4 and
    16, and 5 (odd: a token's f16 scale pair may start on the token before
    it); span lengths not multiples of the 32-position tile, up to 600
    positions (longer than one tile and one range).  f32 queries within 1e-4
    absolute (exp and summation order), bf16 within one bf16 step."""
    _paged_tiling_case(card, hd, rep, block_size)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 64])
@pytest.mark.parametrize("block_size", [4, 16, 5])
def test_cuda_paged_attention_one_query_head_a_kv_head(card, hd, block_size):
    """K4 at rep 1 (multi-head attention: deepseek-7b at head_dim 128,
    minicpm-2b at 64), the same mixed and all-decode steps and tolerances as
    :func:`test_cuda_paged_attention_tilings`."""
    _paged_tiling_case(card, hd, 1, block_size)


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [4, 16, 5])
def test_cuda_paged_attention_head_dim_112(card, block_size):
    """K4 at Kimi-K2's head_dim 112 with 8 query heads a kv head (its GQA
    group): the same steps and tolerances as the tilings above.  112 is no
    power of two: 7 sixteen-byte chunks a hi row, 56-byte lo rows gathered
    in 8-byte chunks, two key groups of 112 threads (32 idle) in the decode
    p.v."""
    _paged_tiling_case(card, 112, 8, block_size)


@pytest.mark.cuda
@pytest.mark.parametrize("rep", [1, 8])
@pytest.mark.parametrize("block_size", [4, 16, 5])
def test_cuda_paged_attention_head_dim_72(card, rep, block_size):
    """K4 at PixArt-Σ's head_dim 72, one query head a kv head (its
    multi-head attention) and a GQA group of 8: the same steps and
    tolerances as the tilings above.  72 is not a multiple of 16: a hi row
    is 9 eight-byte chunks, a lo row 36 bytes in 4-byte chunks, a row's 18
    float4 chunks dequantize as 4 rotated groups of 4 and a tail of 2, and
    the decode p.v runs three key groups of 72 threads (40 idle)."""
    _paged_tiling_case(card, 72, rep, block_size)


def _paged_tiling_case(card, hd, rep, block_size):
    g, c_len = 2, 128
    spans = K4_PREFILL + K4_DECODE
    entry, ht, lt = paged_pools(block_size, -(-16 // block_size) * block_size,
                                spans, g=g, hd=hd, seed=hd + rep + block_size)
    entry = {k: v.to(card) for k, v in entry.items()}
    ht, lt = torch.from_numpy(ht).to(card), torch.from_numpy(lt).to(card)
    plan = TPA.launch_plan(0, 4, c_len, rep, g,
                           (ht.shape[1] + lt.shape[1]) * block_size,
                           torch.cuda.get_device_properties(card)
                           .multi_processor_count)
    assert plan["n_split"] > 1      # the all-decode step splits its spans
    rng = np.random.default_rng(rep)
    q_pf = torch.from_numpy(rng.standard_normal(
        (2, c_len, g * rep, hd)).astype(np.float32)).to(card)
    q_dec = torch.from_numpy(rng.standard_normal(
        (4, 1, g * rep, hd)).astype(np.float32)).to(card)
    ints = dict(dtype=torch.int32, device=card)
    starts = torch.tensor([s for s, _ in spans], **ints)
    lengths = torch.tensor([n for _, n in spans], **ints)
    cases = [(q_pf, q_dec, starts, lengths, ht, lt),
             (q_pf[:0], q_dec, starts[2:], lengths[2:], ht[2:], lt[2:])]
    for qp, qd, st, ln, h_t, l_t in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = (entry, qp.to(dtype), qd.to(dtype), st, ln, h_t, l_t)
            got = TPA.paged_ragged_attention(*args, block_size)
            want = TPA.paged_attention_plain(*args, block_size)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert a.shape == b.shape and a.dtype == dtype
                if a.numel() == 0:     # the all-decode step's prefill part
                    continue
                if dtype == torch.float32:
                    assert float((a - b).abs().max()) <= 1e-4
                else:
                    _close_bf16(a, b)


def _gemm_weights(gen, k, n, dual, card):
    ws = [TS.prepare_linear(torch.randn((k, n), generator=gen, device=card)
                            / k ** 0.5) for _ in range(2 if dual else 1)]
    out = []
    for w in ws:
        out += [w.qw, w.sw, w.zw, w.qw_sum,
                torch.randn(n, generator=gen, device=card)]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("seg_len", [8, 128, 200])
def test_cuda_stamp_quant_segment_matmul_is_per_span(card, seg_len):
    """K1 → K2 over a flattened batch of three uniform spans (the twin of
    ``stamp_quant_segment_matmul_pallas``; 200 rows take the long-span
    chain) equals one call per span bit for bit (the spans fold onto the
    batch axis; K2's products are exact in int32 and its epilogue runs per
    element), and its plain version within 1e-5 relative; a length that
    is not whole spans raises."""
    gen = torch.Generator(device=card).manual_seed(seg_len)
    x = torch.randn((2, 3 * seg_len, 256), generator=gen, device=card)
    p = TS.prepare_linear(torch.randn((256, 96), generator=gen, device=card)
                          / 16.0)
    bias = torch.randn(96, generator=gen, device=card)
    kw = dict(transform="dwt", levels=3, skip_first=True, num_hi=4,
              out_dtype=torch.float32)
    w = (p.qw, p.sw, p.zw, p.qw_sum, bias)
    got = TO.stamp_quant_segment_matmul(x, *w, seg_len=seg_len, **kw)
    per = torch.cat([TO.stamp_quant_segment_matmul(
        x[:, i:i + seg_len], *w, seg_len=seg_len, **kw)
        for i in range(0, 3 * seg_len, seg_len)], dim=1)
    plain = TO.stamp_quant_segment_matmul(
        x.cpu(), *(t.cpu() for t in w), seg_len=seg_len, **kw)
    torch.cuda.synchronize()
    assert got.shape == (2, 3 * seg_len, 96)
    assert torch.equal(got, per)
    assert _rel(got.cpu(), plain) <= 1e-5
    with pytest.raises(ValueError):
        TO.stamp_quant_segment_matmul(x, *w, seg_len=seg_len + 1, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("span", [1, 16, 100, 128])
@pytest.mark.parametrize("transform", ["dwt", "wht", "none"])
@pytest.mark.parametrize("dual", [False, True])
def test_cuda_stamp_int_gemm_tilings(card, span, transform, dual):
    """K2 against its plain version over 2 spans: span lengths 1 to 128;
    K 256 (one k range: the epilogue in the main kernel), 1000 and 1024
    (split over two ranges of one cluster, their int32 products summed in
    distributed shared memory; 1000 is not a multiple of the 64-deep step,
    nor of 16, so it takes 4-byte copies), N 200 and 336 (not multiples of
    the column tile); single and dual; bf16 within one step, f32 within
    1e-5 relative (the same f32 epilogue order)."""
    gen = torch.Generator(device=card).manual_seed(span)
    kw = dict(transform=transform, levels=3, skip_first=True)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for k, n in ((256, 200), (1000, 200), (1024, 336)):
        x = torch.randn((2, span, k), generator=gen, device=card)
        qx, sx, zx = TSM.stamp_transform_quantize(x, num_hi=4, hi_bits=8,
                                                  lo_bits=4, **kw)
        w = _gemm_weights(gen, k, n, dual, card)
        assert TSM.gemm_plan(2, k, n, dual, sms)["n_split"] == \
            (1 if k == 256 else 2)
        for dtype in (torch.float32, torch.bfloat16):
            y = TSM.stamp_int_gemm(qx, sx, zx, span, *w, out_dtype=dtype,
                                   **kw)
            yp = TSM.int_gemm_plain(qx, sx, zx, span, *w, out_dtype=dtype,
                                    **kw)
            torch.cuda.synchronize()
            assert y.shape == yp.shape == (2, span, n) and y.dtype == dtype
            if dtype == torch.float32:
                assert _rel(y, yp) <= 1e-5
            else:
                _close_bf16(y, yp)


# llama3-8b's prefill sites: qkv and down single, gate/up dual
LONG_SITES = {False: [(4096, 6144), (14336, 4096)], True: [(4096, 14336)]}


@pytest.mark.cuda
@pytest.mark.parametrize("span", [129, 256, 512, 1024, 2048])
@pytest.mark.parametrize("transform", ["none", "dwt", "wht"])
@pytest.mark.parametrize("dual", [False, True])
def test_cuda_long_span_chain(card, span, transform, dual):
    """The K1 → K2 chain over spans longer than K2's 128-row tile, at
    llama3-8b's widths over 2 spans: K1's codes, scales and zero points
    and K2's f32 and bf16 outputs bit-equal to the plain versions.  Past
    ``MAX_SPAN`` rows K2 runs without a transform over 128-row tiles (the
    last one ragged) and the span link inverts with the bias and the dual's
    silu·mul; under the WHT past 257 rows the span link also runs the
    forward transform for K1."""
    gen = torch.Generator(device=card).manual_seed(span)
    kw = dict(transform=transform, levels=3, skip_first=True)
    qkw = dict(num_hi=4, hi_bits=8, lo_bits=4, **kw)
    for k, n in LONG_SITES[dual]:
        x = torch.randn((2, span, k), generator=gen, device=card,
                        dtype=torch.bfloat16)
        TSM.stamp_span_transform.launches = 0
        q = TSM.stamp_transform_quantize(x, **qkw)
        forward = TSM.stamp_span_transform.launches
        assert forward == int(not TSM.tq_fits(span, transform, 3, True))
        for got, want in zip(q, TSM.transform_quantize_plain(x, **qkw)):
            assert torch.equal(got, want)
        w = _gemm_weights(gen, k, n, dual, card)
        for dtype in (torch.float32, torch.bfloat16):
            y = TSM.stamp_int_gemm(*q, span, *w, out_dtype=dtype, **kw)
            yp = TSM.int_gemm_plain(*q, span, *w, out_dtype=dtype, **kw)
            torch.cuda.synchronize()
            assert y.shape == (2, span, n) and y.dtype == dtype
            assert torch.equal(y, yp), float((y.float() - yp.float())
                                             .abs().max())
        assert TSM.stamp_span_transform.launches == forward + \
            (0 if transform == "none" else 2)


# (N, dual, input dtype, output dtype) of the span link's cases
LINK_CASES = [(200, False, torch.float32, torch.bfloat16),
              (72, True, torch.float32, torch.bfloat16),
              (40, True, torch.bfloat16, torch.float32),
              (4096, False, torch.bfloat16, torch.float32)]


@pytest.mark.cuda
@pytest.mark.parametrize("span", [129, 300, 641, 2048, 5000, 12288])
def test_cuda_span_link_shapes(card, span):
    """The span link alone over 2 spans of 129 to 12288 rows, bit-equal to
    its plain version: forward and inverse; the Haar DWT at 1, 3 and 9
    levels and at the serve path's resolved levels (the forward's windows
    over one launch or the levels split over several through scratch), the
    WHT (its block in one launch or its stages over two, and the rows
    around it); single, and the dual with both biases; N of 40, 72, 200
    and 4096, bf16 and f32 in and out.  A dual Haar span one row past the
    9557 rows the link once refused runs too."""
    gen = torch.Generator(device=card).manual_seed(span)
    auto = TS.StampConfig(levels=None, num_hi_tokens=4).resolved_levels(span)
    for n, dual, dt_in, dt_out in LINK_CASES:
        x = torch.randn((2, span, n), generator=gen, device=card).to(dt_in)
        u = torch.randn((2, span, n), generator=gen, device=card).to(
            dt_in) if dual else None
        b = torch.randn(n, generator=gen, device=card)
        for tf, levels in (("dwt", 1), ("dwt", 3), ("dwt", 9),
                           ("dwt", auto), ("wht", 3)):
            for inverse in (False, True):
                kw = dict(transform=tf, levels=levels, skip_first=True,
                          inverse=inverse, out_dtype=dt_out)
                args = (x, u, b, -b)
                got = TSM.stamp_span_transform(*args, **kw)
                want = TSM.span_transform_plain(*args, **kw)
                torch.cuda.synchronize()
                assert got.shape == want.shape and got.dtype == dt_out
                assert torch.equal(got, want), (n, dual, tf, levels,
                                                inverse)
    if span == 12288:
        x = torch.randn((1, 9558, 40), generator=gen, device=card)
        kw = dict(transform="dwt", levels=3, skip_first=True, inverse=True)
        assert torch.equal(TSM.stamp_span_transform(x, x, x[0, 0], None,
                                                    **kw),
                           TSM.span_transform_plain(x, x, x[0, 0], None,
                                                    **kw))


@pytest.mark.cuda
def test_cuda_stamp_int_gemm_accumulates_in_int32(card):
    """|codes| = 128 over K = 14336: row 0 against column 0 sums 7112
    products of +16384, 56 of +1 and 7168 of -16256, exactly 56.  An f32
    accumulator loses the +1s beside 1.2e8 (and gives 0), a 16-bit one
    overflows; K2's int32 sums give 56, as the plain version does."""
    k, n, span = 14336, 128, 128
    gen = torch.Generator(device=card).manual_seed(3)
    qx = torch.randint(-128, 128, (span, k), generator=gen, device=card,
                       dtype=torch.int8)
    qw = torch.randint(-128, 128, (k, n), generator=gen, device=card,
                       dtype=torch.int8)
    qx[0, :7112], qw[:7112, 0] = -128, -128
    qx[0, 7112:7168], qw[7112:7168, 0] = 1, 1
    qx[0, 7168:], qw[7168:, 0] = -128, 127
    ones = torch.ones(span, device=card)
    w = (qw, torch.ones((1, n), device=card), torch.zeros((1, n), device=card),
         qw.sum(dim=0, keepdim=True, dtype=torch.int32))
    kw = dict(transform="none", levels=0, skip_first=False)
    y = TSM.stamp_int_gemm(qx, ones, ones * 0, span, *w, **kw)
    yp = TSM.int_gemm_plain(qx, ones, ones * 0, span, *w, **kw)
    torch.cuda.synchronize()
    assert float(y[0, 0, 0]) == 56.0
    assert torch.equal(y, yp)


def grouped_case(b, e, cap, d, f, counts, device, seed=0):
    """K5's inputs: token-quantized dispatch rows with the first
    ``counts[i][e]`` slots of each bucket kept, and stacked prepared
    expert weights with their column and slab sums."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, e * cap, d), generator=gen, device=device)
    qx, sx, zx = TS.token_quantize(x)
    ws = []
    for shape in ((e, d, f), (e, d, f), (e, f, d)):
        p = TS.prepare_linear(torch.randn(shape, generator=gen,
                                          device=device) * 0.05)
        ws.append(p)
    pg, pu, pd = ws
    return (qx.reshape(b, e, cap, d), sx.reshape(b, e, cap, 1),
            zx.reshape(b, e, cap, 1),
            torch.tensor(counts, dtype=torch.int32, device=device),
            pg.qw, pg.sw, pg.zw, pg.qw_sum, pu.qw, pu.sw, pu.zw, pu.qw_sum,
            pd.qw, pd.sw, pd.zw, TSM.down_slab_sums(pd.qw))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [768, 96, 1024])
def test_cuda_grouped_moe_matches_plain(card, f):
    """K5 in f32 within 1e-5 relative of its plain version: exact int32
    sums, the same f32 epilogues and slab order; buckets with more kept
    rows than one row chunk, empty buckets, rows past each count exactly
    zero; slabs of 256 (f = 768), 96 and 512 columns."""
    counts = [[10, 7, 1, 0], [0, 3, 10, 2]]
    args = grouped_case(2, 4, 10, 64, f, counts, card)
    got = TSM.stamp_quant_grouped_matmul(*args)
    want = TSM.grouped_matmul_plain(*args)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5
    for i, row in enumerate(counts):
        for e, n in enumerate(row):
            assert bool((got[i, e, n:] == 0).all())
    bf = TSM.stamp_quant_grouped_matmul(*args, out_dtype=torch.bfloat16)
    assert _rel(bf.float(), want) <= 2 ** -8


@pytest.mark.cuda
@pytest.mark.parametrize("f", [768, 1024])
@pytest.mark.parametrize("counts,cap", [
    ([[9, 0, 4, 0], [0, 0, 7, 0]], 9),       # 9 and 11 rows, 2 empty
    ([[10, 0, 0, 3], [10, 0, 0, 0]], 10),    # 20 rows in one expert
    ([[0, 0, 0, 0], [20, 0, 1, 0]], 20),     # 20 rows from one span
    ([[20, 0, 5, 0], [20, 0, 0, 0]], 20),    # 40 rows: two row groups
])
def test_cuda_grouped_moe_reads_each_weight_once(card, f, counts, cap):
    """K5 past one token tile (9 to 40 kept rows in an expert), with
    empty experts, at slab widths 256 (f = 768) and 512 (f = 1024): in f32
    within 1e-5 relative of its plain version (exact int32 sums, the same
    f32 epilogues in slab order), in bf16 within one bf16 step, rows past
    each count exactly zero; and the weight bytes it streams are each
    occupied expert's gate, up and down codes once for every 32 kept rows
    (``GROUP_ROWS``): once for up to 32."""
    d = 64
    args = grouped_case(2, 4, cap, d, f, counts, card)
    nbytes = torch.zeros(1, dtype=torch.int64, device=card)
    got = TSM.stamp_quant_grouped_matmul(*args, weight_bytes=nbytes)
    want = TSM.grouped_matmul_plain(*args)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5
    for i, row in enumerate(counts):
        for e, n in enumerate(row):
            assert bool((got[i, e, n:] == 0).all())
    rows = [sum(min(row[e], cap) for row in counts) for e in range(4)]
    passes = sum(-(-n // TSM.GROUP_ROWS) for n in rows)
    assert int(nbytes) == passes * 3 * d * f
    bf = TSM.stamp_quant_grouped_matmul(*args, out_dtype=torch.bfloat16)
    assert _rel(bf.float(), want) <= 2 ** -8


@pytest.mark.cuda
def test_cuda_wrappers_refuse_cpu_operands(card):
    """A CUDA activation with a weight left on the CPU raises; the wrapper
    never falls back to the plain version."""
    p = TS.prepare_linear(torch.randn((64, 32)))
    with pytest.raises(ValueError):
        TDM.stamp_decode_matmul(torch.randn((2, 64), device=card), p.qw,
                                p.sw, p.zw, p.qw_sum)


@pytest.mark.cuda
def test_cuda_grouped_moe_refuses_cpu_operands(card):
    """K5 with the dispatch codes on the card and the expert weights left
    on the CPU raises instead of running the plain version."""
    args = list(grouped_case(1, 2, 4, 32, 64, [[4, 1]], "cpu"))
    args[:4] = [t.to(card) for t in args[:4]]
    with pytest.raises(ValueError):
        TSM.stamp_quant_grouped_matmul(*args)


def cache_case(b, s, g, hd, h, num_hi, device, seed=0):
    """A contiguous packed cache of random K/V (``quantize_full``) and one
    random query token per row."""
    gen = torch.Generator(device=device).manual_seed(seed)
    k = torch.randn((b, s, g, hd), generator=gen, device=device)
    v = torch.randn((b, s, g, hd), generator=gen, device=device)
    q = torch.randn((b, 1, h, hd), generator=gen, device=device)
    return TKV.quantize_full(k, v, TKV.KVCacheConfig(num_hi=num_hi)), q


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lengths", [
    ((2, 288, 2, 64, 8, 32), (271, 271)),
    ((4, 136, 8, 128, 32, 4), (97, 98, 99, 100)),
    # head_dim 32, four query heads a kv head, one row just past hi
    ((2, 520, 4, 32, 16, 16), (17, 520)),
    # ragged: inside the hi region, inside the first tile, across ranges
    ((3, 2000, 2, 16, 4, 8), (5, 130, 2000)),
])
def test_cuda_cache_attention_matches_plain(card, shape, lengths):
    """K6 with f32 queries within 1e-5 of its plain version (relative to
    the output's largest magnitude: the sequence split and merge order
    differ from the Pallas block order), and with bf16 queries within one
    bf16 step of the plain version's bf16 output."""
    _cache_case_matches(card, shape, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lengths", [
    # Kimi-K2's group (8 query heads a kv head) at its head_dim, a bucketed
    # serve shape and ragged lengths across the hi region and the ranges
    ((4, 136, 8, 112, 64, 4), (97, 98, 99, 100)),
    ((3, 2000, 2, 112, 16, 64), (5, 130, 2000)),
])
def test_cuda_cache_attention_head_dim_112(card, shape, lengths):
    """K6 at head_dim 112 with rep 8, held as above: a hi row of 28 words
    read as 16-byte vectors, a lo row of 14 words as 8-byte ones, and the
    16 threads past the 112 features idle in the p.v sum."""
    _cache_case_matches(card, shape, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,lengths", [
    # PixArt-Σ's multi-head attention (16 heads of 72) at the bucketed
    # serve shape, and a GQA group of 8 with ragged lengths across the hi
    # region and the ranges
    ((4, 136, 16, 72, 16, 4), (97, 98, 99, 100)),
    ((3, 2000, 2, 72, 16, 64), (5, 130, 2000)),
])
def test_cuda_cache_attention_head_dim_72(card, shape, lengths):
    """K6 at head_dim 72, run as 128 with the queries' last 56 features
    zero, held as above: a hi row of 72 bytes copied in 8-byte chunks, a
    lo row of 36 bytes in 4-byte chunks through the 128 layout's swizzle."""
    _cache_case_matches(card, shape, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64, 72, 112, 128])
@pytest.mark.parametrize("rep", [1, 4, 8])
def test_cuda_cache_attention_head_dims_and_groups(card, hd, rep):
    """K6 at every head_dim and 1, 4 or 8 query heads a kv head, held as
    above, at lengths of 1, on the hi region's edge (64, 65), on a range's
    (192, 193: with 64 rows on a 132-SM card the ranges hold two tiles) and
    on a tile's inside a range (320, 321), and the whole cache."""
    _cache_case_matches(card, (8, 4000, 8, hd, 8 * rep, 64),
                        (1, 64, 65, 192, 193, 320, 321, 4000))


@pytest.mark.cuda
@pytest.mark.parametrize("hd,rep", [(128, 4), (112, 8), (72, 1)])
def test_cuda_cache_attention_far_zero_points(card, hd, rep):
    """K6 where every K token lies near 50, so its zero points (about
    -140 at 4 bits, -2500 at 8) fall outside the [-128, 127] the kernel
    takes off the codes in bf16 and the remainder goes through f32, held
    as above (queries at a tenth of the usual scale keep the scores' shared
    part near 5, as in real attention)."""
    gen = torch.Generator(device=card).manual_seed(5)
    b, s, g = 3, 700, 2
    k = torch.randn((b, s, g, hd), generator=gen, device=card) + 50.0
    v = torch.randn((b, s, g, hd), generator=gen, device=card)
    q = 0.1 * torch.randn((b, 1, g * rep, hd), generator=gen, device=card)
    entry = TKV.quantize_full(k, v, TKV.KVCacheConfig(num_hi=64))
    assert float(entry["k_zp"].float().min()) < -128
    _cache_entry_matches(card, entry, q, (1, 65, 700))


def _cache_case_matches(card, shape, lengths):
    b, s, g, hd, h, num_hi = shape
    entry, q = cache_case(b, s, g, hd, h, num_hi, card)
    _cache_entry_matches(card, entry, q, lengths)


def _cache_entry_matches(card, entry, q, lengths):
    length = torch.tensor(lengths, dtype=torch.int32, device=card)
    got = TCA.cache_decode_attention(entry, q, length)
    want = TR.cache_decode_attention_ref(entry, q, length)
    torch.cuda.synchronize()
    assert _rel(got, want) <= 1e-5
    qb = q.to(torch.bfloat16)
    got_b = TCA.cache_decode_attention(entry, qb, length).float()
    want_b = TR.cache_decode_attention_ref(entry, qb, length).float()
    assert bool(((got_b - want_b).abs() <=
                 2 ** -7 * want_b.abs() + 1e-6).all())


@pytest.mark.cuda
def test_cuda_cache_attention_refuses_cpu_operands(card):
    """K6 with the query on the card and the cache left on the CPU raises
    instead of running the plain version."""
    entry, q = cache_case(1, 40, 2, 16, 4, 8, "cpu")
    with pytest.raises(ValueError):
        TCA.cache_decode_attention(entry, q.to(card),
                                   torch.tensor([30], dtype=torch.int32,
                                                device=card))


# ---------------------------------------------------------------------------
# the standalone kernel library: K7 int8_matmul, K8 quantize_pack, K9
# haar_dwt_seq, K10 walsh_hadamard
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,levels", [
    ((2, 256, 96), 1), ((2, 256, 96), 5), ((3, 64, 4096), 3),
    # a chain of launches past five levels
    ((1, 512, 40), 7)])
def test_cuda_haar_dwt_matches_plain(card, dtype, shape, levels):
    """K9 forward and inverse equal to its plain version: the same f32
    operations in the same order (``-fmad=false``) and one cast; d = 96
    and 40 are not multiples of 128."""
    gen = torch.Generator(device=card).manual_seed(levels)
    x = torch.randn(shape, generator=gen, device=card).to(dtype)
    for inverse in (False, True):
        got = THD.haar_dwt_seq(x, levels, inverse)
        want = THD.haar_dwt_plain(x, levels, inverse)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,axis", [
    ((2, 256, 128), -2), ((2, 128, 256), -1), ((4, 2048, 128), -2),
    # the split sequence transform (two launches through f32 scratch)
    ((1, 16384, 128), -2), ((1, 100, 16384), -1)])
def test_cuda_wht_matches_plain(card, dtype, shape, axis):
    """K10 equal to its plain version along the sequence and the features:
    each stage is the same add and subtract on the same values, split or
    not, and the f32(1/sqrt n) scale comes once at the end."""
    gen = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=card).to(dtype)
    got = TW.walsh_hadamard(x, axis)
    want = TW.wht_plain(x, axis)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("n", [2, 32, 256, 2048, 16384])
def test_cuda_wht_lengths(card, dtype, axis, n):
    """K10 bit-equal to its plain version at transform lengths from 2 (one
    register phase, or one thread a vector) to 16384 (split along the
    sequence), with 384 columns or 5 and 100 rows: not whole blocks."""
    if axis == -2:
        shape = (2 if n < 16384 else 1, n, 384)
    else:
        shape = (3, 5, n) if n < 256 else (1, 100, n)
    gen = torch.Generator(device=card).manual_seed(n)
    x = torch.randn(shape, generator=gen, device=card).to(dtype)
    got = TW.walsh_hadamard(x, axis)
    want = TW.wht_plain(x, axis)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8, 3])
@pytest.mark.parametrize("shape", [(2, 256, 4096), (1, 64, 100),
                                   (3, 16, 48)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_quant_pack_matches_plain(card, bits, shape, dtype):
    """K8's codes, scales and zero points exactly the plain version's, on
    the 16-byte path (d = 4096) and the byte path (d = 100; 48 at 4
    bits)."""
    gen = torch.Generator(device=card).manual_seed(bits)
    x = (torch.randn(shape, generator=gen, device=card) * 3).to(dtype)
    got = TQP.quantize_pack(x, bits)
    want = TQP.quant_pack_plain(x, bits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _pack_exact(x, bits):
    got = TQP.quantize_pack(x, bits)
    want = TQP.quant_pack_plain(x, bits)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w), float((g.float() - w.float()).abs().max())


# (rows, d) of K8's routes: rows in one warp's registers (1024, and 40: five
# words), over 4 warps (4096, 2304 in bf16) and over 8 (8192 and up; f32
# from 2304 on, 16 words a lane at 16384 f32 and 32768 bf16), the two
# passes on rows past 64 KB (40000) or not whole 16-byte words (100, 1000
# and 6 in bf16 and f16), each with an odd row count (tail rows of a block)
K8_ROUTES = [(13, 4096), (37, 1024), (9, 2304), (7, 40), (5, 8192),
             (3, 16384), (3, 32768), (2, 40000), (11, 100), (5, 1000),
             (17, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("rows_d", K8_ROUTES)
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_quant_pack_routes(card, dtype, rows_d, bits):
    """K8 exact on every route of ``pack_plan``: rows held in one warp's
    registers or joined over several warps, and the two passes (16-byte or
    one value at a time), with tail rows."""
    rows, d = rows_d
    gen = torch.Generator(device=card).manual_seed(rows * d + bits)
    x = (torch.randn((1, rows, d), generator=gen, device=card) * 3 +
         0.5).to(dtype)
    _pack_exact(x, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quant_pack_bit_widths(card, bits, dtype):
    """Every width from 1 to 8 bits (packed only at 4) exact, at a
    registers-route row and a two-pass row."""
    gen = torch.Generator(device=card).manual_seed(bits)
    for d in (4096, 100):
        x = (torch.randn((2, 16, d), generator=gen, device=card) * 2).to(
            dtype)
        _pack_exact(x, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [2, 4, 6])
@pytest.mark.parametrize("bits", [4, 8])
def test_cuda_quant_pack_unaligned_input(card, offset, bits):
    """A contiguous view ``offset`` bf16 values into its buffer (4-byte
    aligned, not 16) takes the two passes and stays exact; the same values
    aligned take the registers route and give the same result."""
    gen = torch.Generator(device=card).manual_seed(offset)
    buf = torch.randn(offset + 4 * 64 * 1024, generator=gen,
                      device=card).bfloat16()
    x = buf[offset:].view(4, 64, 1024)
    assert x.data_ptr() % 16 and x.is_contiguous()
    assert TQP.pack_plan(1024, 2, x.data_ptr(), 0)["nv"] == 0
    _pack_exact(x, bits)
    for g, w in zip(TQP.quantize_pack(x, bits),
                    TQP.quantize_pack(x.clone(), bits)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [4, 8, 3])
def test_cuda_quant_pack_rounding_boundaries(card, bits):
    """The registers route's quotient and rounding at the values where they
    decide a code: f32 rows whose min and max set the scale, the rest at
    (k + 1/2) * scale for every code step k and 1 to 3 ulps either side, so
    each ``round(x / scale)`` sits on or next to a half-integer.  Rows with
    zero points near zero and at about -2^20 (the fast quantizer), and at
    about -1.5e7 (past 2^21: the per-value division).  Codes exact."""
    n = 2 ** bits - 1
    gen = torch.Generator().manual_seed(bits)
    rows = []
    for lo_scale in (0.0, 2.0 ** 20, 1.5e7):
        for _ in range(64):
            span = float(torch.rand(1, generator=gen)) * 10 + 0.01
            mn = -span * float(torch.rand(1, generator=gen)) + (
                lo_scale * span / n)
            mx = mn + span
            t_mn, t_mx = (torch.tensor(v, dtype=torch.float32)
                          for v in (mn, mx))
            s = torch.clamp_min((t_mx - t_mn) * torch.tensor(
                np.float32(1) / np.float32(n)), 1e-8).double()
            ks = torch.arange(-2 * n - 2, 2 * n + 2, dtype=torch.float64)
            ks = ks + torch.round(t_mn.double() / s)
            mids = ((ks + 0.5) * s).float()
            vals = [mids]
            for step in (1, 2, 3):
                up, down = mids.clone(), mids.clone()
                for _ in range(step):
                    up = torch.nextafter(up, torch.tensor(float("inf")))
                    down = torch.nextafter(down, torch.tensor(float("-inf")))
                vals += [up, down]
            v = torch.cat(vals)
            v = v[(v > t_mn) & (v < t_mx)]
            row = torch.full((2048,), float(t_mn))
            row[1] = t_mx
            row[2:2 + len(v)] = v
            rows.append(row)
    x = torch.stack(rows)[None].to(card)
    _pack_exact(x, bits)


@pytest.mark.cuda
@pytest.mark.parametrize("mnk", [(8, 6144, 4096), (256, 384, 128),
                                 (128, 256, 4096), (8, 5, 7), (64, 96, 80)])
def test_cuda_int8_matmul_matches_plain(card, mnk):
    """K7 equal to its plain version in f32, bf16 and f16: exact int32
    products and sums, the same f32 epilogue order (``-fmad=false``);
    M = 8 decode rows, N = 6144, and ragged tiles (N = 5, K = 7; K = 80)."""
    m, n, k = mnk
    gen = torch.Generator(device=card).manual_seed(m + n + k)
    qx = torch.randint(-128, 128, (m, k), generator=gen, device=card,
                       dtype=torch.int8)
    qw = torch.randint(-128, 128, (k, n), generator=gen, device=card,
                       dtype=torch.int8)
    sx = torch.rand((m, 1), generator=gen, device=card) * 0.1 + 1e-3
    zx = torch.randint(-128, 128, (m, 1), generator=gen, device=card).float()
    sw = torch.rand((1, n), generator=gen, device=card) * 1e-2 + 1e-4
    zw = torch.randint(-8, 9, (1, n), generator=gen, device=card).float()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = TIM.int8_matmul(qx, qw, sx, zx, sw, zw, out_dtype=dtype)
        want = TIM.int8_matmul_plain(qx, qw, sx, zx, sw, zw, out_dtype=dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 100, 256, 2048])
@pytest.mark.parametrize("k", [100, 128, 14336])
@pytest.mark.parametrize("n", [384, 14336])
def test_cuda_int8_matmul_tilings(card, m, k, n):
    """K7's tiles, stages and persistent walk against its plain version in
    f32, bf16 and f16, bit for bit: M 8 and 100 (one partial row tile), 256
    and 2048 (many tiles a block); K 100 (rows TMA cannot address: the
    wrapper's zero-padded copies), 128 (one stage) and 14336 (112 stages);
    N 384 and 14336 (3 and 112 column tiles)."""
    gen = torch.Generator(device=card).manual_seed(m + n + k)
    qx = torch.randint(-128, 128, (m, k), generator=gen, device=card,
                       dtype=torch.int8)
    qw = torch.randint(-128, 128, (k, n), generator=gen, device=card,
                       dtype=torch.int8)
    sx = torch.rand((m, 1), generator=gen, device=card) * 0.1 + 1e-3
    zx = torch.randint(-128, 128, (m, 1), generator=gen, device=card).float()
    sw = torch.rand((1, n), generator=gen, device=card) * 1e-2 + 1e-4
    zw = torch.randint(-8, 9, (1, n), generator=gen, device=card).float()
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = TIM.int8_matmul(qx, qw, sx, zx, sw, zw, out_dtype=dtype)
        want = TIM.int8_matmul_plain(qx, qw, sx, zx, sw, zw, out_dtype=dtype)
        torch.cuda.synchronize()
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_standalone_kernels_refuse_cpu_operands(card):
    """K7 with the weight codes left on the CPU raises; a CUDA tensor of a
    dtype K8-K10 do not take raises: no wrapper falls back to its plain
    version."""
    qx = torch.zeros((8, 64), dtype=torch.int8, device=card)
    ones = torch.ones((8, 1), device=card)
    with pytest.raises(ValueError):
        TIM.int8_matmul(qx, torch.zeros((64, 16), dtype=torch.int8), ones,
                        ones, torch.ones((1, 16)), torch.ones((1, 16)))
    x = torch.zeros((1, 16, 128), dtype=torch.float64, device=card)
    for fn in (TQP.quantize_pack, THD.haar_dwt_seq, TW.walsh_hadamard):
        with pytest.raises(ValueError):
            fn(x)
