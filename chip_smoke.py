#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and continued):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the ten kernels from the nine sources in ``src/repro_torch/csrc``
   (one ``nvcc`` per source, started together);
3. hold every kernel against its plain PyTorch version on the card at the
   serve paths' shapes and time kernel, plain version and a library
   yardstick with CUDA events (K4, K3, K1 and K6 over 200 calls, K2 over
   50, K7, K8, K9 and K10 over 20 and K5 over 10, each also replayed from
   CUDA graphs,
   ``graph_ms``: the device's time without the wrapper's host cost; the
   int8 GEMMs' yardstick ``torch._int_mm`` on the row-major weight and on
   its column-major copy, the faster counting, also replayed for K2, K3 and
   K7, as are SDPA beside K4 and K6 and the dense transform matmul beside
   K9 and K10): llama3-8b
   (C = 128 rows x 2 prefill spans, 8 decode slots, 32/8 heads, head_dim
   128, page size 4; for the bucketed engine K1/K2 at 4 and 8 spans of 128
   rows and K3 at 4 rows at every decode site), and Arctic-480B (K1/K2 and
   K3 at every linear site of its layer: QKV 7168 -> 9216, wo 7168 -> 7168,
   the dense residual's gate/up 7168 -> 4864 and down 4864 -> 7168; K4 at
   56/8 heads; K5 over 128 experts with the counts of a real routing of 2 x
   128 random tokens, and again at Kimi-K2's expert widths, 384 experts of
   7168 -> 2048 top-8, each beside ``torch._int_mm`` over the occupied
   experts, replayed from graphs too); the dense archs served at full
   width (``DENSE_ARCHS``: deepseek-7b, minicpm-2b, mistral-nemo-12b and
   qwen2-72b, widths from their configs): K1/K2 at each one's QKV (with
   qwen2-72b's bias), out-proj (from ``q_dim``), gate/up and down over 2
   spans, K3 at the same four sites over 8 decode rows, K4's mixed and
   all-decode steps and K6 at their multi-head widths (32 heads of 128, 36
   of 64, one query head a kv head); K4 at llama's and Arctic's head counts
   also over a long all-decode
   step (8 slots of 65 to 32768 cached tokens, split over blocks); K6 (the
   contiguous cache's decode attention) at the bucketed serve shape (4
   slots, cache 136, hi ``NUM_HI``) and at 8 slots x 32768 cached tokens
   (hi 64) with ragged lengths; K4 and K6 again at Kimi-K2's attention
   widths (64/8 heads, head_dim 112); then check a prefill, a mixed and an
   all-decode step on the card against the same steps on the CPU at the
   reduced size of each model, and one ``prefill`` and two ``decode_step``
   s of the bucketed path at reduced llama; then the standalone kernel
   library at llama3-8b's widths (K7 ``int8_matmul`` at 2048 rows through
   its qkv, gate and down shapes and at 8 rows, K8 ``quantize_pack`` at 4
   and 8 bits, K9 ``haar_dwt_seq`` at 3 and 5 levels up to 32768 tokens,
   K10 ``walsh_hadamard`` along the sequence, split and not, and the
   features; K8 also in f32, beside the ``copy_`` ceiling);
4. drive the kernel library's path through ``repro_torch.kernels.ops``: a
   (1, 2048, 4096) activation through ``haar_dwt_seq`` (3 levels),
   ``quantize_pack`` (8 bits), ``int8_matmul`` against ``prepare_linear``'s
   codes of a 4096 -> 14336 weight and the inverse ``haar_dwt_seq``, and a
   ``walsh_hadamard`` involution, with every kernel's launch count set to 0
   before it and read after, held against the same chain of plain versions;
   then serve llama3-8b at full width through the port's serve entry point
   (seeded init, PTQ on the card, paged unified fused engine with the paged
   attention kernel): 4 requests x 96 prompt tokens x 8 new tokens, with
   every kernel's launch count set to 0 before that run and read after;
   then the same model and requests through the bucketed engine (bucket
   128, contiguous cache, the packed-cache attention kernel), counts read
   around its own run; then Arctic-480B at full width, cut to
   ``ARCTIC_LAYERS`` layers (its widths, 128 experts, top-2 and the
   vocabulary as published), the same requests, counts read around its own
   run; then each of ``DENSE_ARCHS`` through the paged engine (qwen2-72b cut
   to ``QWEN2_LAYERS`` of its 80 layers, widths as published) and
   deepseek-7b through the bucketed engine too, counts read around each
   run; and the engine surface of the serving benchmark: llama3-8b in
   two-call steps (``two_call_phase``: equal ids to unified steps with
   plain attention, and K4's ``paged_decode_attention`` entry held to
   plain attention by teacher forcing), llama3-8b with the serve CLI's
   chaos plan, numerics guard, bounded queue, deadline and metrics / trace
   files (``robust_phase``; then a forced NaN row whose demotion must stop
   K1–K3), and Arctic with quant telemetry (``telemetry_phase``: the same
   ids and launches as without, its clip rates and router gauges
   printed); each serve phase prints its step phases' totals;
5. print ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one or outside a checkout.
``--serve-only PHASE,...`` runs only llama3-8b's paged phase and the named
serve phases (no kernels line, no final ok line).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12          # f32 outside the tensor cores

# main-path shapes (configs/llama3_8b.py; PTQ picks num_hi = 4 on 128-token
# calibration, so the serve path pages at block size 4)
D, D_FF, HEADS, KV_HEADS, HD = 4096, 14336, 32, 8, 128
C, SPANS, SLOTS, NUM_HI, BLOCK = 128, 2, 8, 4, 4
# Arctic-480B (configs/arctic_480b.py); one H100 holds 4 of its 35 layers
# (13.4 GB of int8 expert codes each), so the serve phase cuts depth only
A_D, A_FF, A_HEADS, A_QKV = 7168, 4864, 56, 7168 + 2 * 8 * 128
A_EXPERTS, A_TOPK, A_CF = 128, 2, 1.25
ARCTIC_LAYERS = 4
# the dense archs served at full width beside llama3-8b (their widths read
# from configs/<name>.py): each serve's depth, None for every layer.
# Qwen2-72B whole would take ~90 GiB, so its serve is cut to QWEN2_LAYERS of
# 80 layers (widths as published): 40 layers peaked at 41.62 GiB, about
# 0.82 GiB a layer, so 60 stay near 58 GiB, under 64
QWEN2_LAYERS = 60
DENSE_ARCHS = {"deepseek-7b": None, "minicpm-2b": None,
               "mistral-nemo-12b": None, "qwen2-72b": QWEN2_LAYERS}
# the multi-head (one query head a kv head) attention widths K4 and K6 are
# checked at: deepseek-7b's (32 heads of 128) and minicpm-2b's (36 of 64)
MHA_ARCHS = ("deepseek-7b", "minicpm-2b")
# Kimi-K2 (configs/kimi_k2_1t_a32b.py): its attention widths only, 64 query
# heads over 8 kv heads of head_dim 112 (K4 and K6 checks; no Kimi serve)
KIMI_HEADS, KIMI_HD = 64, 112
STAMP = dict(transform="dwt", levels=3, skip_first=True, num_hi=NUM_HI,
             hi_bits=8, lo_bits=4)
# timed calls: launches under 0.13 ms spread up to 1.5x between calls, so
# K4, K3 and K1 (tens of microseconds) are timed over 200 calls, K2 over 50
# and K7 (near a millisecond at 2048 rows) over 20
K4_ITERS, K3_ITERS, K2_ITERS, K7_ITERS = 200, 200, 50, 20
K1_ITERS = 200


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(torch, fn, iters: int = 10) -> float:
    """Mean ms per call over ``iters`` calls after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def timed_graph(torch, fn, calls: int, per_graph: int = 20) -> float:
    """Mean ms per call with the host out of the timing: ``per_graph``
    calls captured in one CUDA graph, replayed until ``calls`` calls ran.
    For a launch of a few microseconds the eager loop of :func:`timed`
    measures the wrapper's host cost (checks, ctypes, allocation); this
    measures the device's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    reps = max(calls // per_graph, 1)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / (reps * per_graph)
    del graph
    return ms


def bound(nbytes: float, ops: float, rate: float) -> tuple:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def close_bf16(torch, got, ref) -> float:
    """Max |got - ref| after checking every element within one bf16 step
    (2^-7 relative) of the plain version's result, both written in bf16:
    the f32 values agree to rounding, so a bf16 rounding boundary between
    them moves one element by at most one step."""
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    check(bool(torch.isfinite(g).all()), "kernel output not finite")
    check(bool((err <= 2 ** -7 * r.abs() + 1e-6).all()),
          f"kernel disagrees with its plain version: max err "
          f"{float(err.max())}")
    return float(err.max())


# --------------------------------------------------------------- phase 3 --


LLAMA_SITES = [("qkv", D, D + 2 * KV_HEADS * HD, False),
               ("gate_up", D, D_FF, True), ("down", D_FF, D, False)]
# every K1/K2 and K3 site of Arctic's layer: attention in and out, and the
# dense residual MLP (its gate and up share one shape in the decode region)
ARCTIC_SITES = [("arctic_qkv", A_D, A_QKV, False),
                ("arctic_wo", A_D, A_D, False),
                ("arctic_gate_up", A_D, A_FF, True),
                ("arctic_down", A_FF, A_D, False)]
LLAMA_DECODE_SITES = [("qkv", D, D + 2 * KV_HEADS * HD), ("gate", D, D_FF),
                      ("down", D_FF, D)]
# the bucketed engine's shapes: its prefill quantizes the whole right-padded
# batch at once (4 requests, up to max_batch 8 spans of C rows), and its
# decode linears take one row per request
BUCKETED_SPANS, BUCKETED_ROWS = (4, 8), 4
BUCKETED_DECODE_SITES = [("bucketed_qkv", D, D + 2 * KV_HEADS * HD),
                         ("bucketed_wo", D, D), ("bucketed_gate", D, D_FF),
                         ("bucketed_down", D_FF, D)]
ARCTIC_DECODE_SITES = [("arctic_qkv", A_D, A_QKV), ("arctic_wo", A_D, A_D),
                       ("arctic_gate", A_D, A_FF), ("arctic_down", A_FF, A_D)]


def dense_sites(cfg) -> tuple:
    """One layer's linear sites of the dense ``cfg``: K1/K2's ``(name, K,
    N, dual, bias)`` (QKV with its bias where the config has one, the
    out-proj from ``q_dim``, gate/up as one dual call, down) and K3's
    ``(name, K, N, bias)`` (gate and up one shape)."""
    tag = cfg.name.split("-")[0] + "_"
    d, qkv = cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim
    prefill = [(tag + "qkv", d, qkv, False, cfg.qkv_bias),
               (tag + "wo", cfg.q_dim, d, False, False),
               (tag + "gate_up", d, cfg.d_ff, True, False),
               (tag + "down", cfg.d_ff, d, False, False)]
    decode = [(tag + "qkv", d, qkv, cfg.qkv_bias),
              (tag + "wo", cfg.q_dim, d, False),
              (tag + "gate", d, cfg.d_ff, False),
              (tag + "down", cfg.d_ff, d, False)]
    return prefill, decode


def k1_row(torch, sm, x, name: str) -> dict:
    """K1 at one site: its codes, scales and zero points exactly the plain
    version's, and its times (eager and replayed from CUDA graphs) beside
    the bound of reading ``x`` and writing the codes and per-token pairs."""
    got = sm.stamp_transform_quantize(x, **STAMP)
    want = sm.transform_quantize_plain(x, **STAMP)
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          f"K1 codes differ at {name}")

    def call():
        return sm.stamp_transform_quantize(x, **STAMP)

    ms = timed(torch, call, iters=K1_ITERS)
    gms = timed_graph(torch, call, K1_ITERS)
    pms = timed(torch, lambda: sm.transform_quantize_plain(x, **STAMP))
    rows, k = x.shape[0] * x.shape[1], x.shape[2]
    b = bound(rows * k * x.element_size() + rows * k + rows * 8, 0,
              INT8_OPS_PER_S)
    return dict(site=name, max_abs_err=0.0, ms=ms, plain_ms=pms,
                bound_ms=b[0], bound_by=b[1], library_ms=None, graph_ms=gms)


def check_k1(torch, sm, sites, seed=0, spans=SPANS, tag="") -> list:
    """K1 alone at the K1/K2 sites ``[(name, K, N, dual)]`` over ``spans``
    spans of C rows (inputs drawn as :func:`check_stamp` draws its
    activations)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for name, k, *_ in sites:
        x = torch.randn((spans, C, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        out.append(k1_row(torch, sm, x, tag + name))
    return out


def check_stamp(torch, sm, ops_mod, prepare_linear, sites, seed=0,
                spans=SPANS, tag=""):
    """K1 (codes exact) and K2 (one bf16 step) at prefill linear sites
    ``[(name, K, N, dual[, bias])]`` over ``spans`` spans of C rows, and
    their times; ``tag`` prefixes the rows' site names; a site whose
    ``bias`` is true adds a random bias in K2's epilogue."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = spans * C
    k1, k2 = [], []
    for name, k, n, dual, *bias in sites:
        name = tag + name
        x = torch.randn((spans, C, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = [prepare_linear(torch.randn((k, n), generator=gen,
                                        device="cuda") / math.sqrt(k))
             for _ in range(2 if dual else 1)]
        qx, sx, zx = sm.stamp_transform_quantize(x, **STAMP)
        k1.append(k1_row(torch, sm, x, name))

        wargs = [w[0].qw, w[0].sw, w[0].zw, w[0].qw_sum,
                 torch.randn(n, generator=gen, device="cuda")
                 if bias and bias[0] else None]
        if dual:
            wargs += [w[1].qw, w[1].sw, w[1].zw, w[1].qw_sum, None]
        kw = dict(transform="dwt", levels=3, skip_first=True,
                  out_dtype=torch.bfloat16)
        y = sm.stamp_int_gemm(qx, sx, zx, C, *wargs, **kw)
        yp = sm.int_gemm_plain(qx, sx, zx, C, *wargs, **kw)
        err = close_bf16(torch, y, yp)
        kw32 = dict(kw, out_dtype=torch.float32)
        y32 = sm.stamp_int_gemm(qx, sx, zx, C, *wargs, **kw32)
        yp32 = sm.int_gemm_plain(qx, sx, zx, C, *wargs, **kw32)
        rel = float((y32 - yp32).abs().max() / yp32.abs().max())
        check(rel <= 1e-5, f"K2 f32 output off by {rel} (relative) at {name}")
        ms2 = timed(torch, lambda: sm.stamp_int_gemm(qx, sx, zx, C, *wargs,
                                                     **kw), iters=K2_ITERS)
        pms2 = timed(torch, lambda: sm.int_gemm_plain(qx, sx, zx, C, *wargs,
                                                      **kw), iters=3)
        # the yardstick on the (K, N) row-major weight the port keeps and on
        # its column-major copy (cuBLASLt's preferred layout); the faster
        # counts
        lib = int_mm_yardstick(torch, qx, [wi.qw for wi in w], K2_ITERS)
        gms2 = timed_graph(torch, lambda: sm.stamp_int_gemm(
            qx, sx, zx, C, *wargs, **kw), K2_ITERS, per_graph=10)
        nw = len(w)
        b2 = bound(rows * k + rows * 8 + nw * (k * n + 12 * n) + rows * n * 2
                   + (4 * n if wargs[4] is not None else 0),
                   2 * rows * k * n * nw, INT8_OPS_PER_S)
        k2.append(dict(site=name, max_abs_err=err, ms=ms2, plain_ms=pms2,
                       bound_ms=b2[0], bound_by=b2[1], graph_ms=gms2, **lib))
        # the composed op the model calls is the same chain
        yo = (ops_mod.stamp_quant_dual_matmul(x, *wargs[:4], *wargs[5:9],
                                              **STAMP)
              if dual else ops_mod.stamp_quant_matmul(x, *wargs[:5],
                                                      **STAMP))
        check(torch.equal(yo, y), f"ops chain differs from K1→K2 at {name}")
    return k1, k2


def check_decode(torch, dm, prepare_linear, sites, seed=1, rows=SLOTS):
    """K3 (one bf16 step, f32 within 1e-5 relative) over ``rows`` decode
    rows at the linear sites ``[(name, K, N[, bias])]`` (a true ``bias``
    adds a random one in the epilogue), and its times."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for name, k, n, *bias in sites:
        x = torch.randn((rows, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        p = prepare_linear(torch.randn((k, n), generator=gen, device="cuda")
                           / math.sqrt(k))
        w = (p.qw, p.sw, p.zw, p.qw_sum,
             torch.randn(n, generator=gen, device="cuda")
             if bias and bias[0] else None)
        y = dm.stamp_decode_matmul(x, *w, out_dtype=torch.bfloat16)
        yp = dm.decode_matmul_plain(x, *w, out_dtype=torch.bfloat16)
        err = close_bf16(torch, y, yp)
        y32 = dm.stamp_decode_matmul(x, *w)
        yp32 = dm.decode_matmul_plain(x, *w)
        rel = float((y32 - yp32).abs().max() / yp32.abs().max())
        check(rel <= 1e-5, f"K3 f32 output off by {rel} at {name}")
        def call():
            return dm.stamp_decode_matmul(x, *w, out_dtype=torch.bfloat16)

        ms = timed(torch, call, iters=K3_ITERS)
        pms = timed(torch, lambda: dm.decode_matmul_plain(
            x, *w, out_dtype=torch.bfloat16), iters=5)
        # torch._int_mm needs more than 16 rows: the rows padded to 32
        qx = torch.zeros((max(32, rows), k), dtype=torch.int8, device="cuda")
        lib = int_mm_yardstick(torch, qx, [p.qw], K3_ITERS)
        gms = timed_graph(torch, call, K3_ITERS)
        b = bound(rows * k * 2 + k * n + 12 * n + rows * n * 2,
                  2 * rows * k * n, INT8_OPS_PER_S)
        out.append(dict(site=name, max_abs_err=err, ms=ms, plain_ms=pms,
                        bound_ms=b[0], bound_by=b[1], graph_ms=gms, **lib))
    return out


def int_mm_yardstick(torch, qx, row_major, iters: int,
                     per_graph: int = 10) -> dict:
    """``torch._int_mm`` of ``qx`` against each (K, N) weight of
    ``row_major`` and against its column-major copy (cuBLASLt's preferred
    layout), eager and replayed from CUDA graphs; ``library_ms`` is the
    faster layout's eager time, ``library_graph_ms`` the faster graph
    time."""
    col_major = [m.t().contiguous().t() for m in row_major]
    times = {}
    for layout, mats in (("row_major", row_major), ("col_major", col_major)):
        def fn(mats=mats):
            return [torch._int_mm(qx, m) for m in mats]
        times[layout] = (timed(torch, fn, iters=iters),
                         timed_graph(torch, fn, iters, per_graph=per_graph))
    del col_major
    return dict(library_ms=min(t[0] for t in times.values()),
                library_row_major_ms=times["row_major"][0],
                library_col_major_ms=times["col_major"][0],
                library_graph_ms=min(t[1] for t in times.values()))


def _attention_case(torch, PKV, KV, n_pf: int, dtype, heads: int,
                    dec_lengths=None, capacity: int = C + 8, hd: int = HD,
                    kv_heads: int = KV_HEADS):
    """Pools holding random K/V for ``n_pf`` prefill spans (start 0, chunk
    C, lengths 96..) and SLOTS decode spans (lengths 97..104, or
    ``dec_lengths``), written through ``write_ragged`` at page size 4;
    ``heads`` query heads over ``kv_heads``; tables mapping ``capacity``
    positions a span (the serve path's 136, or the longest span); head_dim
    ``hd``."""
    gen = torch.Generator(device="cuda").manual_seed(2 + n_pf + heads)
    quant = KV.KVCacheConfig(quantized=True, num_hi=NUM_HI)
    dec_lengths = dec_lengths or [97 + j for j in range(SLOTS)]
    capacity = max(capacity, *dec_lengths)
    lo_per_seq = -(-(capacity - NUM_HI) // BLOCK)
    spans = n_pf + len(dec_lengths)
    pcfg = PKV.PagedCacheConfig(block_size=BLOCK,
                                num_lo_blocks=spans * lo_per_seq + 1,
                                num_hi_blocks=spans + 1,
                                max_blocks_per_seq=lo_per_seq, quant=quant)
    entry = PKV.init_pools(kv_heads, hd, pcfg, device="cuda")
    lengths = [96 + 4 * i for i in range(n_pf)] + list(dec_lengths)
    ht = torch.zeros((spans, 1), dtype=torch.int32)
    lt = torch.zeros((spans, lo_per_seq), dtype=torch.int32)
    pages, offs, ishi, ks, vs = [], [], [], [], []
    next_lo = 1
    for i, length in enumerate(lengths):
        ht[i, 0] = i + 1
        n_lo = -(-(length - NUM_HI) // BLOCK)
        lt[i, :n_lo] = torch.arange(next_lo, next_lo + n_lo)
        next_lo += n_lo
        for pos in range(length):
            is_hi, idx, off = PKV.token_page_index(pos, pcfg)
            pages.append(int(ht[i, 0]) if is_hi else int(lt[i, idx]))
            offs.append(off)
            ishi.append(is_hi)
    t = len(pages)
    k = torch.randn((t, kv_heads, hd), generator=gen, device="cuda")
    v = torch.randn((t, kv_heads, hd), generator=gen, device="cuda")
    PKV.write_ragged(entry, k.to(dtype), v.to(dtype),
                     torch.tensor(pages, device="cuda"),
                     torch.tensor(offs, device="cuda"),
                     torch.tensor(ishi, device="cuda"), pcfg)
    q_pf = torch.randn((n_pf, C, heads, hd), generator=gen, device="cuda",
                       dtype=dtype)
    q_dec = torch.randn((len(dec_lengths), 1, heads, hd), generator=gen,
                        device="cuda", dtype=dtype)
    starts = torch.tensor([0] * n_pf + [l - 1 for l in lengths[n_pf:]],
                          dtype=torch.int32, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return entry, q_pf, q_dec, starts, lens, ht.cuda(), lt.cuda(), lengths


def _attention_work(lengths, n_pf: int, heads: int, hd: int = HD,
                    kv_heads: int = KV_HEADS) -> tuple:
    """Bytes the spans' pages hold up to each length (K and V codes plus f16
    scale/zp), queries and outputs; and the flops the mask admits."""
    nbytes, flops = 0, 0
    per_tok_hi = kv_heads * (2 * hd + 8)          # k, v codes + 4 f16 params
    per_tok_lo = kv_heads * (hd + 8)
    for i, length in enumerate(lengths):
        pages_tok = -(-length // BLOCK) * BLOCK
        hi = min(pages_tok, NUM_HI)
        nbytes += hi * per_tok_hi + (pages_tok - hi) * per_tok_lo
        rows = C if i < n_pf else 1
        nbytes += 2 * 2 * rows * heads * hd       # q in, out (bf16)
        visible = sum(min(c + 1, length) for c in range(rows)) \
            if i < n_pf else length
        flops += 4 * hd * heads * visible
    return nbytes, flops


# K4 shapes: the serve path's mixed step (2 chunks + SLOTS decode spans) and
# all-decode step (tables of 136 positions), and a long all-decode step whose
# ragged spans (K6's long lengths) are split over blocks
ATTENTION_SHAPES = [("mixed", SPANS, None), ("all_decode", 0, None),
                    ("long_decode", 0, [32768, 30001, 24576, 16385, 8192,
                                        4097, 1024, 65])]


def check_attention(torch, pa, PKV, KV, heads=HEADS, prefix="", hd=HD,
                    kv_heads=KV_HEADS, shapes=ATTENTION_SHAPES):
    """K4 at ``shapes`` (mixed, all-decode, long all-decode steps) with
    ``heads`` query heads over ``kv_heads`` of head_dim ``hd``: bf16 within
    one bf16 step of its plain version, f32 within 1e-4; times beside the
    bound and an SDPA yardstick, each eager and replayed from graphs."""
    out = []
    for name, n_pf, dec_lengths in shapes:
        entry, q_pf, q_dec, starts, lens, ht, lt, lengths = \
            _attention_case(torch, PKV, KV, n_pf, torch.bfloat16, heads,
                            dec_lengths, hd=hd, kv_heads=kv_heads)
        args = (entry, q_pf, q_dec, starts, lens, ht, lt)
        o_pf, o_dec = pa.paged_ragged_attention(*args, BLOCK)
        p_pf, p_dec = pa.paged_attention_plain(*args, BLOCK)
        err = close_bf16(torch, torch.cat([o_pf.flatten(), o_dec.flatten()]),
                         torch.cat([p_pf.flatten(), p_dec.flatten()]))
        f32 = (entry, q_pf.float(), q_dec.float(), starts, lens, ht, lt)
        k32 = torch.cat([t.flatten() for t in
                         pa.paged_ragged_attention(*f32, BLOCK)])
        p32 = torch.cat([t.flatten() for t in
                         pa.paged_attention_plain(*f32, BLOCK)])
        abs32 = float((k32 - p32).abs().max())
        check(abs32 <= 1e-4, f"K4 f32 output off by {abs32} ({name})")
        ms = timed(torch, lambda: pa.paged_ragged_attention(*args, BLOCK),
                   iters=K4_ITERS)
        pms = timed(torch, lambda: pa.paged_attention_plain(*args, BLOCK),
                    iters=1 if dec_lengths else 3)
        sdpa = _sdpa_yardstick(torch, args, n_pf, heads, hd, kv_heads)
        lib = timed(torch, sdpa, iters=K4_ITERS)
        gms = timed_graph(torch, lambda: pa.paged_ragged_attention(
            *args, BLOCK), K4_ITERS)
        glib = timed_graph(torch, sdpa, K4_ITERS)
        nbytes, flops = _attention_work(lengths, n_pf, heads, hd, kv_heads)
        b = bound(nbytes, flops, BF16_FLOPS_PER_S)
        out.append(dict(site=prefix + name, max_abs_err=err, ms=ms,
                        plain_ms=pms,
                        bound_ms=b[0], bound_by=b[1], library_ms=lib,
                        graph_ms=gms, library_graph_ms=glib))
        del entry, args, f32, sdpa
        torch.cuda.empty_cache()
    return out


def _sdpa_yardstick(torch, args, n_pf: int, heads: int, hd: int = HD,
                    kv_heads: int = KV_HEADS):
    """One ``scaled_dot_product_attention`` call over the same spans with
    K/V dequantized up front (bf16, padded to the longest span)."""
    from repro_torch.kernels.ref import span_kv
    entry, q_pf, q_dec, starts, lens, ht, lt = args
    spans = lens.shape[0]
    kvs = [span_kv(entry, ht[i], lt[i]) for i in range(spans)]
    kv_len = max(k.shape[0] for k, _ in kvs)
    rows = C if n_pf else 1
    q = torch.zeros((spans, heads, rows, hd), dtype=torch.bfloat16,
                    device="cuda")
    k = torch.zeros((spans, kv_heads, kv_len, hd), dtype=torch.bfloat16,
                    device="cuda")
    v = torch.zeros_like(k)
    mask = torch.zeros((spans, 1, rows, kv_len), dtype=torch.bool,
                       device="cuda")
    pos = torch.arange(kv_len, device="cuda")
    for i, (kd, vd) in enumerate(kvs):
        k[i, :, :kd.shape[0]] = kd.transpose(0, 1).to(torch.bfloat16)
        v[i, :, :vd.shape[0]] = vd.transpose(0, 1).to(torch.bfloat16)
        length = int(lens[i])
        if i < n_pf:
            q[i] = q_pf[i].transpose(0, 1)
            qpos = int(starts[i]) + torch.arange(rows, device="cuda")
        else:
            q[i, :, :1] = q_dec[i - n_pf].transpose(0, 1)
            qpos = torch.full((rows,), length - 1, device="cuda")
        mask[i, 0] = (pos[None, :] <= qpos[:, None]) & (pos[None, :] < length)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask, enable_gqa=True)


# K5's sites: Arctic-480B's experts (the serve path's) and Kimi-K2's
# expert widths (configs/kimi_k2_1t_a32b.py: d 7168, moe_d_ff 2048, 384
# experts, top-8; the capacity factor is ModelConfig's default 1.25), each
# over 2 spans x 128 routed tokens: (site, d, f, experts, top-k, capacity
# factor, seed)
KIMI_D, KIMI_MOE_FF, KIMI_EXPERTS, KIMI_TOPK, KIMI_CF = 7168, 2048, 384, 8, \
    1.25
MOE_SHAPES = [("arctic_experts", A_D, A_FF, A_EXPERTS, A_TOPK, A_CF, 4),
              ("kimi_experts", KIMI_D, KIMI_MOE_FF, KIMI_EXPERTS, KIMI_TOPK,
               KIMI_CF, 12)]


def grouped_case(torch, sm, L, token_quantize, d, f, experts, topk, cf,
                 seed) -> tuple:
    """K5's inputs at one of ``MOE_SHAPES``: 2 spans x 128 random tokens
    routed by ``moe_route`` (group 128, top-``topk`` of ``experts``,
    capacity from ``cf``), their codes gathered into the (2, E, C, d)
    dispatch buffer as ``moe_ffn_fused`` does, and random int8 expert
    stacks with the prepared buffers' layout.  Returns the kernel's
    arguments."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((SPANS, C, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    gate_w = torch.randn((d, experts), generator=gen, device="cuda") \
        / math.sqrt(d)
    xg, valid, _ = L._moe_fold(x, 1024)
    combine, dispatch, counts = L.moe_route(xg, gate_w, topk, cf, valid)
    b, _, e, cap = combine.shape
    qd, sd, zd = token_quantize(xg)
    idx = dispatch.argmax(dim=1).reshape(b, e * cap, 1)

    def gather(t):
        return torch.gather(t, 1, idx.expand(-1, -1, t.shape[-1])
                            ).reshape(b, e, cap, -1)

    def stack(din, dout):
        q = torch.randint(-128, 128, (e, din, dout), generator=gen,
                          device="cuda", dtype=torch.int8)
        sc = torch.rand((e, 1, dout), generator=gen, device="cuda") * 2e-3
        zp = torch.randint(-8, 9, (e, 1, dout), generator=gen,
                           device="cuda").float()
        return q, sc + 1e-4, zp

    wg, wu, wd = stack(d, f), stack(d, f), stack(f, d)
    return (gather(qd), gather(sd), gather(zd), counts,
            *wg, wg[0].sum(dim=1, keepdim=True, dtype=torch.int32),
            *wu, wu[0].sum(dim=1, keepdim=True, dtype=torch.int32),
            *wd, sm.down_slab_sums(wd[0]))


def check_grouped(torch, sm, L, token_quantize, site="arctic_experts",
                  d=A_D, f=A_FF, experts=A_EXPERTS, topk=A_TOPK, cf=A_CF,
                  seed=4):
    """K5 at one of ``MOE_SHAPES`` (inputs from :func:`grouped_case`).
    Output exact against the plain version (f32 checked within 1e-5
    relative: the same int32 sums and f32 epilogue order); times, eager
    and replayed from CUDA graphs, beside the byte bound and a library
    yardstick: ``torch._int_mm`` for the gate, up and down GEMMs of every
    occupied expert (rows zero-padded to 32), summed, on the row-major
    weights and on column-major copies (the faster counts), also replayed
    from graphs."""
    args = grouped_case(torch, sm, L, token_quantize, d, f, experts, topk,
                        cf, seed)
    counts = args[3]
    wg, wu, wd = args[4:7], args[8:11], args[12:15]
    b, e, cap = args[0].shape[:3]
    y = sm.stamp_quant_grouped_matmul(*args)
    yp = sm.grouped_matmul_plain(*args)
    check(bool(torch.isfinite(y).all()), f"K5 output not finite at {site}")
    err = float((y - yp).abs().max())
    rel = err / float(yp.abs().max())
    check(rel <= 1e-5, f"K5 f32 output off by {rel} (relative) at {site}")
    del y, yp
    per_expert = counts.clamp(0, cap).sum(dim=0)
    if hasattr(sm, "GROUP_ROWS"):
        # the weight bytes K5 streams: each occupied expert's gate, up and
        # down codes once for every GROUP_ROWS kept rows
        nb = torch.zeros(1, dtype=torch.int64, device="cuda")
        sm.stamp_quant_grouped_matmul(*args, weight_bytes=nb)
        passes = int((-(-per_expert // sm.GROUP_ROWS)).sum())
        check(int(nb) == passes * 3 * d * f,
              f"K5 streamed {int(nb)} weight bytes at {site}, not "
              f"{passes} x {3 * d * f}")

    def call():
        return sm.stamp_quant_grouped_matmul(*args)

    ms = timed(torch, call)
    gms = timed_graph(torch, call, 20, per_graph=2)
    pms = timed(torch, lambda: sm.grouped_matmul_plain(*args), iters=1)
    occupied = torch.nonzero(counts.sum(dim=0) > 0).flatten().tolist()
    pad = torch.zeros((32, d), dtype=torch.int8, device="cuda")
    pad_f = torch.zeros((32, f), dtype=torch.int8, device="cuda")

    def library(stacks):
        for ei in occupied:
            torch._int_mm(pad, stacks[0][ei])
            torch._int_mm(pad, stacks[1][ei])
            torch._int_mm(pad_f, stacks[2][ei])

    # the yardstick on the (K, N) row-major expert weights K5 reads and on
    # column-major copies of the occupied experts' (cuBLASLt's preferred
    # layout), as at K2's and K7's sites; the faster counts
    row_major = (wg[0], wu[0], wd[0])
    lib_row = timed(torch, lambda: library(row_major), iters=5)
    lib_row_g = timed_graph(torch, lambda: library(row_major), 3,
                            per_graph=1)
    col_major = [{ei: t[ei].t().contiguous().t() for ei in occupied}
                 for t in row_major]
    lib_col = timed(torch, lambda: library(col_major), iters=5)
    lib_col_g = timed_graph(torch, lambda: library(col_major), 5,
                            per_graph=1)
    del col_major
    rows = int(counts.sum())
    nf = f // sm.grouped_block_f(512, f)
    # per occupied expert: its codes, gate/up scale, zero point and column
    # sums, down scale and zero point and slab sums; per kept row: its codes
    # with scale and zero point; the whole f32 output
    nbytes = (len(occupied) * (3 * d * f + 4 * (6 * f + 2 * d + nf * d))
              + rows * (d + 8) + b * e * cap * d * 4 + counts.numel() * 4)
    b5 = bound(nbytes, 2 * rows * 3 * d * f, INT8_OPS_PER_S)
    print(f"[chip_smoke] K5 {site} routing: {rows} kept rows of "
          f"{b * C * topk} choices, {len(occupied)} of {e} experts occupied "
          f"(per span {(counts > 0).sum(dim=1).tolist()}), capacity {cap}, "
          f"at most {int(per_expert.max())} rows an expert")
    return [dict(site=site, max_abs_err=err, ms=ms, plain_ms=pms,
                 bound_ms=b5[0], bound_by=b5[1], graph_ms=gms,
                 library_ms=min(lib_row, lib_col),
                 library_row_major_ms=lib_row, library_col_major_ms=lib_col,
                 library_graph_ms=min(lib_row_g, lib_col_g),
                 library_row_major_graph_ms=lib_row_g,
                 library_col_major_graph_ms=lib_col_g)]


def check_grouped_all(torch, sm, L, token_quantize) -> list:
    """K5 at every site of ``MOE_SHAPES``, each site's stacks freed before
    the next (Arctic's and Kimi-K2's take 13.4 and 16.9 GB of codes, and
    as much again in the yardstick's column-major copies)."""
    rows = []
    for site, d, f, experts, topk, cf, seed in MOE_SHAPES:
        rows += check_grouped(torch, sm, L, token_quantize, site, d, f,
                              experts, topk, cf, seed)
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# K6 shapes: the bucketed serve path's (4 slots at decode lengths 97..104 of
# a 136-token cache) and a long cache with ragged per-slot lengths
CACHE_SHAPES = [("serve", 4, 136, NUM_HI, [97, 99, 102, 104]),
                ("long", 8, 32768, 64, [32768, 30001, 24576, 16385, 8192,
                                        4097, 1024, 65])]


def check_cache_attention(torch, ca, ref, KV, heads=HEADS, hd=HD,
                          prefix="", kv_heads=KV_HEADS):
    """K6 against its plain version (f32 queries within 1e-5 relative to the
    output's largest magnitude; bf16 within one bf16 step) at
    ``CACHE_SHAPES``, ``heads`` query heads over ``kv_heads`` of head_dim
    ``hd`` (llama's 32 over 8 of 128 unless given), and its times beside
    the byte bound of the tokens each row's length needs and an SDPA
    yardstick over pre-dequantized bf16 K/V (one call, boolean length
    mask), each eager and replayed from CUDA graphs."""
    out = []
    for name, b, cap, hi, lengths in CACHE_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(7)
        k = torch.randn((b, cap, kv_heads, hd), generator=gen, device="cuda")
        v = torch.randn((b, cap, kv_heads, hd), generator=gen, device="cuda")
        entry = KV.quantize_full(k.bfloat16(), v.bfloat16(),
                                 KV.KVCacheConfig(num_hi=hi))
        del k, v
        q = torch.randn((b, 1, heads, hd), generator=gen, device="cuda")
        length = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        got = ca.cache_decode_attention(entry, q, length)
        want = ref.cache_decode_attention_ref(entry, q, length)
        rel = float((got - want).abs().max() / want.abs().max())
        check(rel <= 1e-5, f"K6 f32 output off by {rel} (relative, {name})")
        qb = q.bfloat16()
        err = close_bf16(torch, ca.cache_decode_attention(entry, qb, length),
                         ref.cache_decode_attention_ref(entry, qb, length))

        def call():
            return ca.cache_decode_attention(entry, qb, length)

        ms = timed(torch, call, iters=20)
        gms = timed_graph(torch, call, K4_ITERS)
        pms = timed(torch, lambda: ref.cache_decode_attention_ref(
            entry, qb, length), iters=3)
        kd, vd = (t.transpose(1, 2).contiguous() for t in
                  KV.dequantize_full(entry, KV.KVCacheConfig(num_hi=hi)))
        mask = (torch.arange(cap, device="cuda")[None, :] <
                length[:, None])[:, None, None, :]
        qs = qb.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        def library():
            return sdpa(qs, kd, vd, attn_mask=mask, enable_gqa=True)

        lib = timed(torch, library, iters=20)
        lib_gms = timed_graph(torch, library, K4_ITERS)
        del kd, vd
        # each row reads the hi and lo codes, scales and zero points of the
        # tokens its length covers; q in, out (bf16)
        nbytes, flops = 0, 0
        for n in lengths:
            n_hi = min(n, hi)
            nbytes += kv_heads * (n_hi * 2 * hd + (n - n_hi) * hd + n * 8)
            flops += 4 * hd * heads * n
        nbytes += 2 * 2 * b * heads * hd
        bd = bound(nbytes, flops, BF16_FLOPS_PER_S)
        out.append(dict(site=f"{prefix}{name} (b={b}, cap={cap}, hi={hi})",
                        max_abs_err=err, ms=ms, plain_ms=pms,
                        bound_ms=bd[0], bound_by=bd[1], library_ms=lib,
                        graph_ms=gms, library_graph_ms=lib_gms))
        del entry
    return out


# --------------------------------------- phase 3: the standalone library --

# K7-K10 at llama3-8b's widths (d 4096, d_ff 14336, 8 kv heads x 128)
DWT_SHAPES = [("b4_s2048_l3", (4, 2048, D), 3),
              ("b1_s32768_l5", (1, 32768, D), 5)]
WHT_SHAPES = [("seq_b4_s2048", (4, 2048, D), -2),
              ("seq_split_b1_s16384", (1, 16384, 1024), -2),
              ("feature_b4_s2048", (4, 2048, D), -1)]
# K8: the library's activation at 4 and 8 bits, the KV shape, and the 4-bit
# activation in f32
PACK_SHAPES = [("b4_s2048_4bit", (4, 2048, D), 4, "bfloat16"),
               ("b4_s2048_8bit", (4, 2048, D), 8, "bfloat16"),
               ("kv_b8_s4096_4bit", (8, 4096, KV_HEADS * HD), 4, "bfloat16"),
               ("b4_s2048_4bit_f32", (4, 2048, D), 4, "float32")]
GEMM_SHAPES = [("qkv_m2048", 2048, D, D + 2 * KV_HEADS * HD),
               ("gate_m2048", 2048, D, D_FF), ("down_m2048", 2048, D_FF, D),
               ("qkv_m8", 8, D, D + 2 * KV_HEADS * HD)]
MAX_DENSE = 16384     # the largest dense transform matrix timed (512 MiB)


def exact(torch, got, want, what: str) -> None:
    check(got.dtype == want.dtype and got.shape == want.shape and
          torch.equal(got, want), f"{what} differs from its plain version")


def _dense(torch, fn, n: int, dtype):
    """The (n, n) matrix of a transform along the sequence axis: ``fn`` of
    the identity, in ``dtype`` (the library yardstick's operand)."""
    return fn(torch.eye(n, device="cuda")[None])[0].to(dtype)


def transform_rows(torch, gen, kernel, plain, name, shape, arg, flops,
                   dense, left=True, exact_bf16=False):
    """One transform site: the kernel exact against its plain version in
    f32, and in bf16 exact (``exact_bf16``) or within one bf16 step; times
    of kernel (eager and replayed from CUDA graphs), plain version and the
    dense transform matmul ``dense()`` (``None``: no yardstick) beside the
    bound of one HBM read and write."""
    x32 = torch.randn(shape, generator=gen, device="cuda")
    exact(torch, kernel(x32, *arg), plain(x32, *arg), f"{name} (f32)")
    x = x32.bfloat16()
    del x32
    got, want = kernel(x, *arg), plain(x, *arg)
    if exact_bf16:
        exact(torch, got, want, f"{name} (bf16)")
        err = 0.0
    else:
        err = close_bf16(torch, got, want)

    def call():
        return kernel(x, *arg)

    ms = timed(torch, call, iters=20)
    gms = timed_graph(torch, call, 20, per_graph=10)
    pms = timed(torch, lambda: plain(x, *arg), iters=3)
    lib = lib_gms = None
    if dense is not None:
        mat = dense()

        def library():
            return torch.matmul(mat, x) if left else torch.matmul(x, mat)

        lib = timed(torch, library, iters=10)
        lib_gms = timed_graph(torch, library, 20, per_graph=10)
        del mat
    b = bound(2 * x.numel() * 2, flops * x.numel(), F32_FLOPS_PER_S)
    return dict(site=name, max_abs_err=err, ms=ms, plain_ms=pms,
                bound_ms=b[0], bound_by=b[1], library_ms=lib, graph_ms=gms,
                library_graph_ms=lib_gms)


def check_wht(torch, wt, gen) -> list:
    """K10 at ``WHT_SHAPES``, bit-equal to its plain version in f32 and
    bf16, beside the dense Hadamard ``torch.matmul`` (up to ``MAX_DENSE``)."""
    rows = []
    for name, shape, axis in WHT_SHAPES:
        n = shape[-1] if axis == -1 else shape[1]
        dense = None if n > MAX_DENSE else (
            lambda: _dense(torch, lambda e: wt.wht_plain(e, -2), n,
                           torch.bfloat16))
        rows.append(transform_rows(
            torch, gen, wt.walsh_hadamard, wt.wht_plain, name, shape,
            (axis,), int(math.log2(n)) + 1, dense, left=axis == -2,
            exact_bf16=True))
        torch.cuda.empty_cache()
    return rows


def copy_ceiling(torch, x, bits: int):
    """K8's ceiling: one device-to-device ``copy_`` that reads and writes
    as many bytes in all as quantizing and packing ``x`` at ``bits`` does
    (the activation read, the codes and the per-row scale and zero point
    written).  Not a port of anything: it shows what one bandwidth-bound
    pass reaches on the card."""
    rows = x.numel() // x.shape[-1]
    moved = x.numel() * x.element_size() + rows * 8 + (
        x.numel() // 2 if bits == 4 else x.numel())
    src = torch.empty(moved // 2, dtype=torch.uint8, device=x.device)
    dst = torch.empty_like(src)
    return lambda: dst.copy_(src)


def check_standalone(torch, hd, wt, qp, im) -> dict:
    """K7-K10 against their plain versions at llama3-8b's widths: K7 exact
    (f32 and bf16 outputs), K8's codes, scales and zero points exact, K9
    exact in f32 and within one bf16 step in bf16, K10 exact in both; times
    of kernel, plain version and library yardstick (a dense transform
    matmul, or ``torch._int_mm`` with rows padded to 32; none for K8)
    beside the bound of one HBM read and write (or the int8 peak)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = {"haar_dwt_seq": [], "walsh_hadamard": [], "quantize_pack": [],
            "int8_matmul": []}
    for name, shape, levels in DWT_SHAPES:
        for inverse in (False, True):
            s = shape[1]
            dense = None if s > MAX_DENSE else (
                lambda: _dense(torch, lambda e: hd.haar_dwt_plain(
                    e, levels, inverse), s, torch.bfloat16))
            # a pair's add, subtract and two scales over a band halving
            # each level: < 4 flops a value
            rows["haar_dwt_seq"].append(transform_rows(
                torch, gen, hd.haar_dwt_seq, hd.haar_dwt_plain,
                f"{name}_{'inverse' if inverse else 'forward'}", shape,
                (levels, inverse), 4, dense))
            torch.cuda.empty_cache()
    rows["walsh_hadamard"] = check_wht(torch, wt, gen)
    rows["quantize_pack"] = check_pack(torch, qp, gen)
    rows["int8_matmul"] = check_int8_gemm(torch, im, gen)
    return rows


def check_pack(torch, qp, gen) -> list:
    """K8 at ``PACK_SHAPES``: codes, scales and zero points exactly the
    plain version's; times (eager and replayed from CUDA graphs) beside the
    byte bound, the plain version and the copy ceiling
    (:func:`copy_ceiling`, replayed: ``copy_graph_ms``).  No PyTorch call
    quantizes and packs, so there is no library yardstick."""
    out = []
    for name, shape, bits, dtype in PACK_SHAPES:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(
            getattr(torch, dtype))
        for g, w in zip(qp.quantize_pack(x, bits), qp.quant_pack_plain(x,
                                                                       bits)):
            exact(torch, g, w, f"K8 at {name}")

        def call():
            return qp.quantize_pack(x, bits)

        ms = timed(torch, call, iters=20)
        gms = timed_graph(torch, call, 20, per_graph=10)
        cms = timed_graph(torch, copy_ceiling(torch, x, bits), 20,
                          per_graph=10)
        pms = timed(torch, lambda: qp.quant_pack_plain(x, bits), iters=5)
        n_rows = x.numel() // shape[-1]
        code_bytes = x.numel() // 2 if bits == 4 else x.numel()
        b = bound(x.numel() * x.element_size() + code_bytes + n_rows * 8, 0,
                  F32_FLOPS_PER_S)
        out.append(dict(site=name, max_abs_err=0.0, ms=ms, plain_ms=pms,
                        bound_ms=b[0], bound_by=b[1], library_ms=None,
                        graph_ms=gms, copy_graph_ms=cms))
        del x
        torch.cuda.empty_cache()
    return out


def check_int8_gemm(torch, im, gen) -> list:
    """K7 at ``GEMM_SHAPES``, exact against its plain version in f32 and
    bf16, timed eager and replayed from CUDA graphs beside ``torch._int_mm``
    on the row-major weight and on its column-major copy (rows padded to
    32 where fewer: ``_int_mm`` needs more than 16)."""
    out = []
    for name, m, k, n in GEMM_SHAPES:
        qx = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        qw = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        sx = torch.rand((m, 1), generator=gen, device="cuda") * 0.1 + 1e-3
        zx = torch.randint(-128, 128, (m, 1), generator=gen,
                           device="cuda").float()
        sw = torch.rand((1, n), generator=gen, device="cuda") * 1e-2 + 1e-4
        zw = torch.randint(-8, 9, (1, n), generator=gen, device="cuda").float()
        args = (qx, qw, sx, zx, sw, zw)
        for dtype in (torch.float32, torch.bfloat16):
            exact(torch, im.int8_matmul(*args, out_dtype=dtype),
                  im.int8_matmul_plain(*args, out_dtype=dtype),
                  f"K7 at {name} ({dtype})")

        def call():
            return im.int8_matmul(*args)

        ms = timed(torch, call, iters=K7_ITERS)
        gms = timed_graph(torch, call, K7_ITERS, per_graph=10)
        pms = timed(torch, lambda: im.int8_matmul_plain(*args), iters=3)
        pad = qx if m > 16 else torch.cat(
            [qx, torch.zeros((32 - m, k), dtype=torch.int8, device="cuda")])
        lib = int_mm_yardstick(torch, pad, [qw], K7_ITERS)
        b = bound(m * k + k * n + 8 * m + 8 * n + 2 * m * n, 2 * m * n * k,
                  INT8_OPS_PER_S)
        out.append(dict(site=name, max_abs_err=0.0, ms=ms, plain_ms=pms,
                        bound_ms=b[0], bound_by=b[1], graph_ms=gms, **lib))
        del qx, qw, pad
        torch.cuda.empty_cache()
    return out


def library_phase(torch, ops, prepare_linear, hd, wt, qp, im) -> dict:
    """The kernel library's path through ``repro_torch.kernels.ops`` at
    llama3-8b's width: a (1, 2048, 4096) bf16 activation -> 3-level Haar
    DWT -> 8-bit per-token quantize -> int8 GEMM against ``prepare_linear``'s
    codes of a 4096 -> 14336 weight -> inverse DWT, and a Walsh-Hadamard
    involution (the chain of ``test_quantize_then_matmul_approximates_float``
    with the transform around it).  Launch counts are set to 0 just before
    and read just after; the same chain of plain versions gives the same
    bits, and the product is within 2% of the float matmul it replaces."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((1, 2048, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    p = prepare_linear(torch.randn((D, D_FF), generator=gen, device="cuda")
                       / math.sqrt(D))

    def chain(dwt, pack, gemm, wht):
        y = dwt(x, 3, False)
        q, s, z = pack(y, 8)
        out = gemm(q[0], p.qw, s[0], z[0], p.sw, p.zw, torch.bfloat16)
        return y, out, dwt(out[None], 3, True), wht(wht(x, -2), -2)

    ops.reset_launch_counts()
    got = chain(ops.haar_dwt_seq, ops.quantize_pack, ops.int8_matmul,
                ops.walsh_hadamard)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = chain(hd.haar_dwt_plain, qp.quant_pack_plain, im.int8_matmul_plain,
                 wt.wht_plain)
    for what, g, w in zip(("DWT", "quantized GEMM", "inverse DWT",
                           "WHT involution"), got, want):
        check(bool(torch.isfinite(g).all()), f"library path: {what} not "
                                             f"finite")
        exact(torch, g, w, f"library path: {what}")
    wd = (p.qw.float() - p.zw) * p.sw
    rels = []
    for g, ref in ((got[1], got[0][0].float() @ wd),
                   (got[2][0], x[0].float() @ wd), (got[3], x)):
        rels.append(float(torch.linalg.norm(g.float() - ref.float()) /
                          torch.linalg.norm(ref.float())))
    check(max(rels[:2]) < 0.02 and rels[2] < 2 ** -7,
          f"library path outputs off the float computation: {rels}")
    print(f"[library] x {tuple(x.shape)} -> dwt -> 8-bit pack -> int8 GEMM "
          f"{D}->{D_FF} -> inverse dwt; wht twice: relative error vs float "
          f"(gemm, token domain, involution) {rels}; "
          f"launches={json.dumps(counts)}")
    return counts


def to_device(x, device):
    """A nest of dicts and lists of tensors, moved to ``device``."""
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [to_device(v, device) for v in x]
    return x.to(device)


def reduced_fused(lm, cfg_mod, ptq, pipeline, arch: str) -> tuple:
    """``arch`` at its reduced size on the CPU, PTQ'd from seed 0 and
    prepared for fused execution with every kernel switch on: ``(cfg,
    prepared params, serve config)``."""
    cfg = cfg_mod.get_reduced(arch)
    params = lm.init_params(cfg, seed=0, device="cpu")
    calib = pipeline.calibration_batches(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=128, global_batch=4), 2)
    sparams, serve, _ = ptq.calibrate_and_quantize(params, calib, cfg,
                                                   device="cpu")
    serve = dataclasses.replace(
        serve, stamp=dataclasses.replace(serve.stamp, execution="fused"),
        fused_cache_attention=True, fused_decode_matmul=True)
    return cfg, lm.prepare_fused_weights(sparams, serve.stamp), serve


def check_bucketed_against_cpu(torch, lm, cfg_mod, ptq, pipeline):
    """The bucketed path at reduced llama on the card (kernels) against the
    CPU (plain versions): a right-padded ``prefill`` of three prompts (32,
    20 and 9 tokens) and two ``decode_step`` s at per-slot positions, each
    device on its own cache, both fed the CPU run's tokens.  Logits agree
    within 5e-2."""
    cfg, prepared, serve = reduced_fused(lm, cfg_mod, ptq, pipeline,
                                         "llama3-8b")
    serve = dataclasses.replace(serve, cache_capacity=48)
    tokens = torch.randint(0, cfg.vocab_size, (3, 32),
                           generator=torch.Generator().manual_seed(5),
                           dtype=torch.int32)
    lens = torch.tensor([32, 20, 9], dtype=torch.int32)

    def run(device, feed):
        params = to_device(prepared, device)
        logits, cache = lm.prefill(params, tokens.to(device), cfg, serve,
                                   last_pos=(lens - 1).to(device))
        out = [logits.cpu()]
        for n in range(2):
            tok = out[-1].argmax(dim=-1).to(torch.int32) if feed is None \
                else feed[n]
            logits, cache = lm.decode_step(params, cache, tok.to(device),
                                           (lens + n).to(device), cfg, serve)
            out.append(logits.cpu())
        return out

    ref = run("cpu", None)
    feed = [r.argmax(dim=-1).to(torch.int32) for r in ref[:2]]
    errs = []
    for n, (want, got) in enumerate(zip(ref, run("cuda", feed))):
        check(bool(torch.isfinite(got).all()),
              f"bucketed step {n}: logits on the card not finite")
        errs.append(float((got - want).abs().max()))
        check(errs[-1] <= 5e-2, f"bucketed step {n} on the card is "
                                f"{errs[-1]} away from the CPU")
    return errs


def check_step_against_cpu(torch, lm, cfg_mod, ptq, pipeline, arch):
    """The serve path's steps on the card (kernels) against the same steps
    on the CPU (plain versions) at the reduced size of ``arch``.  Each device
    fills its own pools over three steps, as the engine would: prefills of
    requests 0 and 1; prefills of 2 and 3 beside decodes of 0 and 1 (a
    mixed step); and decodes of all four (``n_pf = 0``, which runs
    ``paged_decode_step``).  Prefill logits and the live decode slots'
    logits agree within a bf16 tolerance of 5e-2."""
    from repro_torch.serving import paged_kvcache as PKV
    cfg, prepared, serve = reduced_fused(lm, cfg_mod, ptq, pipeline, arch)
    bs, c_len, slots, per_seq = serve.kv.num_hi, 32, 4, 16
    pcfg = PKV.PagedCacheConfig(block_size=bs,
                                num_lo_blocks=1 + slots * per_seq,
                                num_hi_blocks=1 + slots,
                                max_blocks_per_seq=per_seq, quant=serve.kv)
    serve = dataclasses.replace(serve, paged=pcfg)
    prompt = [29, 32, 25, 31]
    rng = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (slots, c_len + 2),
                           generator=rng, dtype=torch.int32)
    # request r sits in slot r and owns hi page r + 1 and lo pages
    # 1 + 16 r .. 16 r + 16 (page 0 is the null page)
    ht = torch.arange(1, slots + 1, dtype=torch.int32)[:, None]
    lt = (1 + per_seq * torch.arange(slots, dtype=torch.int32)[:, None]
          + torch.arange(per_seq, dtype=torch.int32))

    def target(r, pos):
        is_hi, idx, off = PKV.token_page_index(pos, pcfg)
        return int(ht[r, idx]) if is_hi else int(lt[r, idx]), off, is_hi

    def step(pf: list, dec: dict) -> dict:
        """Prefill requests ``pf`` from position 0; decode slot ``s`` at
        position ``dec[s]``; other slots are null-page dummies."""
        writes = [target(r, pos) if pos < prompt[r] else (0, 0, False)
                  for r in pf for pos in range(c_len)]
        writes += [target(s, dec[s]) if s in dec else (0, 0, False)
                   for s in range(slots)]
        pf_tokens = torch.zeros((len(pf), c_len), dtype=torch.int32)
        for i, r in enumerate(pf):
            pf_tokens[i, :prompt[r]] = tokens[r, :prompt[r]]
        live = torch.tensor([s in dec for s in range(slots)])
        return dict(
            pf_tokens=pf_tokens,
            pf_start=torch.zeros(len(pf), dtype=torch.int32),
            pf_length=torch.tensor([prompt[r] for r in pf],
                                   dtype=torch.int32),
            pf_last_index=torch.tensor([prompt[r] - 1 for r in pf],
                                       dtype=torch.int32),
            dec_tokens=torch.stack([tokens[s, dec.get(s, 0)]
                                    for s in range(slots)]) * live,
            dec_positions=torch.tensor([dec.get(s, 0) for s in range(slots)],
                                       dtype=torch.int32),
            hi_table=torch.cat([ht[pf], ht * live[:, None]]),
            lo_table=torch.cat([lt[pf], lt * live[:, None]]),
            pages=torch.tensor([w[0] for w in writes], dtype=torch.int32),
            offsets=torch.tensor([w[1] for w in writes], dtype=torch.int32),
            is_hi=torch.tensor([w[2] for w in writes]))

    plan = [step([0, 1], {}),
            step([2, 3], {0: prompt[0], 1: prompt[1]}),
            step([], {s: prompt[s] + (s < 2) for s in range(slots)})]

    def run(device):
        params, pools, out = to_device(prepared, device), lm.init_paged_cache(
            cfg, pcfg, device=device), []
        for inputs in plan:
            pf, dec, pools = lm.paged_unified_step(
                params, pools, **to_device(inputs, device), cfg=cfg,
                serve=serve)
            live = inputs["hi_table"][len(inputs["pf_tokens"]):, 0] > 0
            out.append(torch.cat([pf.cpu(), dec.cpu()[live]]))
        return out

    errs = []
    for n, (ref, got) in enumerate(zip(run("cpu"), run("cuda"))):
        check(got.shape == ref.shape and got.shape[0] == (2, 4, 4)[n],
              f"step {n}: {tuple(got.shape)} logit rows")
        check(bool(torch.isfinite(got).all()),
              f"step {n}: logits on the card not finite")
        errs.append(float((got - ref).abs().max()))
        check(errs[-1] <= 5e-2, f"step {n} on the card is {errs[-1]} away "
                                f"from the same step on the CPU")
    return errs


# --------------------------------------------------------------- main -----


def main() -> None:
    # ``--serve-only NAME,...`` (for iterating on the card) skips phase 3,
    # the card-vs-CPU checks and the serve phases not named, and prints no
    # kernels line and no final ok line
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-only":
        only = set(sys.argv[2].split(","))
    elif len(sys.argv) > 1:
        fail("usage: chip_smoke.py [--serve-only PHASE,...]")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("run from the root of a checkout: src/repro_torch is missing")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    smi = nvidia_smi()
    print(smi)
    print(f"[chip_smoke] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    logs = kcuda.build(verbose=True)
    print(f"[chip_smoke] built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas:{name}] {line.strip()}")

    from repro_torch.core.stamp import prepare_linear, token_quantize
    from repro_torch.kernels import cache_attention as ca
    from repro_torch.kernels import decode_matmul as dm
    from repro_torch.kernels import haar_dwt as hd
    from repro_torch.kernels import int8_gemm as im
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels import ref
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import stamp_matmul as sm
    from repro_torch.kernels import wht as wt
    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.serving import kvcache as KV
    from repro_torch.serving import paged_kvcache as PKV
    if only is not None:
        from repro_torch.launch import serve
        serve_phases(torch, serve, ops, configs, only, set())
        print("[chip_smoke] partial run (--serve-only): no kernels line")
        return
    with torch.inference_mode():
        k1, k2 = check_stamp(torch, sm, ops, prepare_linear, LLAMA_SITES)
        a1, a2 = check_stamp(torch, sm, ops, prepare_linear, ARCTIC_SITES,
                             seed=5)
        k1, k2 = k1 + a1, k2 + a2
        for spans in BUCKETED_SPANS:
            b1, b2 = check_stamp(torch, sm, ops, prepare_linear, LLAMA_SITES,
                                 seed=7 + spans, spans=spans,
                                 tag=f"bucketed{spans}_")
            k1, k2 = k1 + b1, k2 + b2
        k3 = check_decode(torch, dm, prepare_linear, LLAMA_DECODE_SITES)
        k3 += check_decode(torch, dm, prepare_linear, ARCTIC_DECODE_SITES,
                           seed=6)
        k3 += check_decode(torch, dm, prepare_linear, BUCKETED_DECODE_SITES,
                           seed=8, rows=BUCKETED_ROWS)
        k4 = check_attention(torch, pa, PKV, KV)
        k4 += check_attention(torch, pa, PKV, KV, heads=A_HEADS,
                              prefix="arctic_")
        k4 += check_attention(torch, pa, PKV, KV, heads=KIMI_HEADS,
                              prefix="kimi_", hd=KIMI_HD)
        for i, arch in enumerate(DENSE_ARCHS):
            prefill, decode = dense_sites(configs.get_config(arch))
            d1, d2 = check_stamp(torch, sm, ops, prepare_linear, prefill,
                                 seed=20 + i)
            k1, k2 = k1 + d1, k2 + d2
            k3 += check_decode(torch, dm, prepare_linear, decode,
                               seed=30 + i)
            torch.cuda.empty_cache()
        for arch in MHA_ARCHS:
            cfg = configs.get_config(arch)
            tag = cfg.name.split("-")[0] + "_"
            k4 += check_attention(torch, pa, PKV, KV, heads=cfg.num_heads,
                                  prefix=tag, hd=cfg.resolved_head_dim,
                                  kv_heads=cfg.num_kv_heads,
                                  shapes=ATTENTION_SHAPES[:2])
        k5 = check_grouped_all(torch, sm, L, token_quantize)
        k6 = check_cache_attention(torch, ca, ref, KV)
        k6 += check_cache_attention(torch, ca, ref, KV, heads=KIMI_HEADS,
                                    hd=KIMI_HD, prefix="kimi_")
        for arch in MHA_ARCHS:
            cfg = configs.get_config(arch)
            k6 += check_cache_attention(
                torch, ca, ref, KV, heads=cfg.num_heads,
                hd=cfg.resolved_head_dim, kv_heads=cfg.num_kv_heads,
                prefix=cfg.name.split("-")[0] + "_")
            torch.cuda.empty_cache()
        torch.cuda.empty_cache()
        std = check_standalone(torch, hd, wt, qp, im)
        torch.cuda.empty_cache()
    for rows in (k1, k2, k3, k4, k5, k6, *std.values()):
        for r in rows:
            print(f"[kernel] {json.dumps(r)}")

    from repro_torch.core import ptq
    from repro_torch.data import pipeline
    from repro_torch.launch import serve
    from repro_torch.models import lm
    for arch in ("llama3-8b", "arctic-480b", *DENSE_ARCHS):
        with torch.inference_mode():
            step_errs = check_step_against_cpu(torch, lm, configs, ptq,
                                               pipeline, arch)
        print(f"[chip_smoke] {arch} (reduced) steps card vs CPU (prefill, "
              f"mixed, all-decode): max |logit diff| {step_errs} (bound "
              f"5e-2)")
    with torch.inference_mode():
        errs = check_bucketed_against_cpu(torch, lm, configs, ptq, pipeline)
    print(f"[chip_smoke] llama3-8b (reduced) bucketed prefill + 2 decode "
          f"steps card vs CPU: max |logit diff| {errs} (bound 5e-2)")

    # which kernels each path must launch, and which it must not: the
    # library path runs only the standalone kernels, the serve paths none
    standalone = set(std)
    serving = {k.__name__ for k in ops.KERNELS} - standalone
    with torch.inference_mode():
        paths = {"kernel_library": (library_phase(torch, ops, prepare_linear,
                                                  hd, wt, qp, im), serving)}
    torch.cuda.empty_cache()
    paths.update(serve_phases(torch, serve, ops, configs, None, standalone))
    for path, (counts, absent) in paths.items():
        for name, n in counts.items():
            if name in absent:
                check(n == 0, f"the {path} serve path launched {name}")
            else:
                check(n > 0, f"kernel {name} was not launched by the {path} "
                             f"serve path")
    launches = {p: counts for p, (counts, _) in paths.items()}

    def total(rows, key):
        vals = [r.get(key) for r in rows]
        return None if any(v is None for v in vals) else sum(vals)

    def entry(name, source, replaces, rows):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(c[name] for c in launches.values()),
                "launches_by_path": {p: c[name]
                                     for p, c in launches.items()},
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": sum(r["ms"] for r in rows),
                "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                "bound_by": rows[0]["bound_by"],
                "library_ms": total(rows, "library_ms"),
                "graph_ms": total(rows, "graph_ms"),
                "library_graph_ms": total(rows, "library_graph_ms"),
                "per_shape": rows}

    src = "src/repro_torch/csrc/"
    # K1 and K2 each do one half of both Pallas kernels: K1 the transform
    # and quantize of the single and the dual matmul, K2 both GEMM modes
    stamp_rows = ("src/repro/kernels/stamp_matmul.py:222, "
                  "src/repro/kernels/stamp_matmul.py:276")
    # K4's summary is its prefill-carrying (mixed) step at every width
    mixed = [r for r in k4 if r["site"].endswith("mixed")]
    kernels = [
        entry("stamp_transform_quantize", src + "stamp_matmul.cu",
              stamp_rows, k1),
        entry("stamp_int_gemm", src + "stamp_matmul.cu", stamp_rows, k2),
        entry("stamp_decode_matmul", src + "decode_matmul.cu",
              "src/repro/kernels/decode_matmul.py:72", k3),
        entry("paged_ragged_attention", src + "paged_attention.cu",
              "src/repro/kernels/paged_attention.py:311, "
              "src/repro/kernels/paged_attention.py:141", mixed),
        entry("stamp_quant_grouped_matmul", src + "grouped_matmul.cu",
              "src/repro/kernels/stamp_matmul.py:438", k5),
        entry("cache_decode_attention", src + "cache_attention.cu",
              "src/repro/kernels/cache_attention.py:91", k6),
        entry("int8_matmul", src + "int8_matmul.cu",
              "src/repro/kernels/int8_matmul.py:56", std["int8_matmul"]),
        entry("quantize_pack", src + "quant_pack.cu",
              "src/repro/kernels/quant_pack.py:44", std["quantize_pack"]),
        entry("haar_dwt_seq", src + "haar_dwt.cu",
              "src/repro/kernels/haar_dwt.py:63", std["haar_dwt_seq"]),
        entry("walsh_hadamard", src + "wht.cu",
              "src/repro/kernels/wht.py:47", std["walsh_hadamard"]),
    ]
    kernels[3]["per_shape"] = k4
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def serve_phase(torch, serve, ops, arch: str, cfg, kind: str = "paged",
                extra=(), label=None, attention: bool = True,
                before=None, after=None) -> tuple:
    """Serve ``arch`` (``cfg`` overrides its config) through the serve
    entry point and the ``kind`` of engine: 4 requests x 96 prompt tokens x
    8 new tokens, unified steps, fused execution and (``attention``) the
    cache attention kernel, with the CLI flags ``extra`` appended.  Every
    kernel's launch count is set to 0 just before the run and read just
    after.  ``before(engine)`` runs before the requests are submitted,
    ``after(engine, res, sargs)`` after the run.  Returns ``(counts,
    res)``, ``res`` as ``serve.serve_requests`` returns it."""
    label = label or arch
    argv = ["--arch", arch, "--engine", kind, "--step-mode", "unified",
            "--execution", "fused", "--device", "cuda", "--requests", "4",
            "--prompt-len", "96", "--max-new", "8",
            *(["--fused-cache-attention"] if attention else []), *extra]
    sargs = serve.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, cfg, report = serve.build(sargs, cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if before is not None:
        before(engine)
    ops.reset_launch_counts()
    res = serve.serve_requests(engine, cfg, sargs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    arch = label
    print(f"[serve] {arch} engine={kind} step={sargs.step_mode} "
          f"layers={cfg.num_layers} "
          f"d_model={cfg.d_model} "
          f"experts={cfg.num_experts} num_hi={report.num_hi} "
          f"setup={setup_s:.1f}s requests={res['requests']} "
          f"tokens={res['tokens']} seconds={res['seconds']:.3f} "
          f"tok/s={res['tokens_per_s']:.2f} "
          f"ttft_p50={res['ttft_p50_s']:.3f}s steps={res['steps']} "
          f"peak_mem={peak_gb:.2f}GiB launches={json.dumps(counts)}")
    print(f"[serve] {arch} engine={kind} stats {json.dumps(res['stats'])}")
    # the engine's step phases (host clock, each ending in a transfer or
    # in host work): where a step's time goes
    phases = engine.metrics.snapshot()["histograms"]
    print(f"[serve] {arch} engine={kind} step phases (count, total ms): "
          + json.dumps({k.split('"')[1]: (v["count"],
                                          round(v["sum"] * 1e3, 3))
                        for k, v in phases.items()
                        if k.startswith("step_phase_s")}))
    if sargs.numerics_guard:
        # the guard quarantines every non-finite row: only injected ones
        injected = engine.fault.injected["nan"] if engine.fault else 0
        check(res["stats"]["nan_quarantines"] == injected,
              f"{arch}: the numerics guard quarantined "
              f"{res['stats']['nan_quarantines']} requests for "
              f"{injected} injected NaN rows")
    else:
        check(res["stats"]["nonfinite_logit_rows"] == 0,
              f"{arch}: non-finite logits in the serve phase")
    if after is not None:
        after(engine, res, sargs)
    else:
        check(res["requests"] == 4 and all(len(t) == 8 for t in
                                           res["outputs"].values()),
              f"{arch} serve phase did not finish 4 requests x 8 tokens")
    # the reference's greedy pick spans the padded vocabulary (its logits'
    # pad columns are not masked), so ids up to padded_vocab are its range
    ids = [t for toks in res["outputs"].values() for t in toks]
    check(all(0 <= t < cfg.padded_vocab for t in ids),
          f"{arch}: token ids outside the padded vocabulary")
    print(f"[serve] {arch} engine={kind} generated ids in the vocabulary's "
          f"pad: {sum(t >= cfg.vocab_size for t in ids)} of {len(ids)} "
          f"(vocab {cfg.vocab_size}, padded to {cfg.padded_vocab})")
    del engine
    gc.collect()       # the engine and its scheduler's callbacks form a cycle
    torch.cuda.empty_cache()
    return counts, res


# --------------------------------------------------------- serve phases --

# the llama3-8b phase of the robustness and observability flags: the
# serve CLI's seeded chaos plan, the numerics guard, a bounded queue that
# sheds a third of the 12 requests, a deadline no request should reach,
# and the three output files
ROBUST_REQUESTS, ROBUST_WAITING, ROBUST_DEADLINE_S = 12, 8, 600.0
# teacher-forced rows whose own top-1 / top-2 margin exceeds this must
# pick the forced token (the engine tests' rule)
DECISIVE = 0.1
TERMINAL = ("finished", "failed", "cancelled", "rejected")


def serve_phases(torch, serve, ops, configs, only, standalone) -> dict:
    """Phase 4's serve runs.  Returns ``{path: (counts, kernels the path
    must not launch)}``; ``only`` (a set of path names) runs llama3-8b's
    unified phase and those named."""
    dense = {"stamp_quant_grouped_matmul"} | standalone
    paged = dense | {"cache_decode_attention"}
    arctic_cfg = dataclasses.replace(configs.get_config("arctic-480b"),
                                     num_layers=ARCTIC_LAYERS)
    paths, runs = {}, {}

    def want(name):
        return only is None or name in only

    counts, runs["llama3-8b"] = serve_phase(torch, serve, ops, "llama3-8b",
                                            None)
    paths["llama3-8b"] = (counts, paged)
    if want("llama3-8b:bucketed"):
        paths["llama3-8b:bucketed"] = (serve_phase(
            torch, serve, ops, "llama3-8b", None, kind="bucketed")[0],
            dense | {"paged_ragged_attention"})
    if want("llama3-8b:two_call"):
        paths.update(two_call_phase(torch, serve, ops, runs["llama3-8b"],
                                    paged))
    if want("llama3-8b:robust"):
        paths["llama3-8b:robust"] = (robust_phase(torch, serve, ops),
                                     paged)
    if want("arctic-480b") or want("arctic-480b:telemetry"):
        counts, runs["arctic"] = serve_phase(torch, serve, ops,
                                             "arctic-480b", arctic_cfg)
        paths["arctic-480b"] = (counts, standalone |
                                {"cache_decode_attention"})
    if want("arctic-480b:telemetry"):
        paths["arctic-480b:telemetry"] = (telemetry_phase(
            torch, serve, ops, arctic_cfg, counts, runs["arctic"]),
            standalone | {"cache_decode_attention"})
    for arch, layers in DENSE_ARCHS.items():
        if not want(arch):
            continue
        cfg = None if layers is None else dataclasses.replace(
            configs.get_config(arch), num_layers=layers)
        paths[arch] = (serve_phase(torch, serve, ops, arch, cfg)[0], paged)
        if arch == "deepseek-7b":
            paths[arch + ":bucketed"] = (
                serve_phase(torch, serve, ops, arch, None,
                            kind="bucketed")[0],
                dense | {"paged_ragged_attention"})
    return paths


def two_call_phase(torch, serve, ops, unified: dict, paged: set) -> dict:
    """llama3-8b through the two-call step mode at full width.  Without the
    cache attention kernel both step modes attend a chunk to its raw K/V
    and the decode slots to the dequantized pages, so two-call and unified
    must give the same ids.  With the kernel, a unified chunk reads its own
    quantized pages through K4 where a two-call chunk still attends to its
    raw K/V (as in the reference: the chunk attention has two references),
    so its ids are only reported beside the unified phase's; the two-call
    run with the kernel (K4's ``n_pf = 0`` entry on the decode slots) is
    held to the two-call run without it by the engine tests' rule:
    teacher-forced to its tokens, every row whose own top-1 / top-2 margin
    exceeds ``DECISIVE`` picks the forced token.  Returns the two-call
    paths' launch counts."""
    two_call = ["--step-mode", "two_call"]
    uni_counts, uni = serve_phase(torch, serve, ops, "llama3-8b", None,
                                  attention=False,
                                  label="llama3-8b:unified:plain_attention")
    two_counts, two = serve_phase(torch, serve, ops, "llama3-8b", None,
                                  extra=two_call, attention=False,
                                  label="llama3-8b:two_call:plain_attention")
    check(two["outputs"] == uni["outputs"],
          f"two-call ids differ from unified ones with plain attention: "
          f"{two['outputs']} vs {uni['outputs']}")
    print("[two_call] plain attention: two-call ids equal the unified "
          "engine's on all 4 requests")
    counts, free = serve_phase(torch, serve, ops, "llama3-8b", None,
                               extra=two_call, label="llama3-8b:two_call")
    for name, other in (("two-call plain-attention", two),
                        ("unified (attention kernel)", unified)):
        same = sum(free["outputs"][u] == other["outputs"][u]
                   for u in other["outputs"])
        print(f"[two_call] free-running ids equal to the {name} run's: "
              f"{same} of {len(other['outputs'])} requests")
    rows = []

    def force(engine):
        to_host, next_token = engine._to_host, engine._next_token

        def host(logits, telem):
            engine._top2 = [b.float().topk(2, dim=-1).values.cpu().numpy()
                            for b in logits]
            return to_host(logits, telem)

        def pick(sreq, tok, finite):
            top2 = engine._top2[0]
            row = 0 if top2.shape[0] == 1 else sreq.slot
            forced = two["outputs"][sreq.uid][len(sreq.generated)]
            rows.append((sreq.uid, len(sreq.generated), int(tok), forced,
                         float(top2[row, 0] - top2[row, 1])))
            return next_token(sreq, forced, finite)

        engine._to_host, engine._next_token = host, pick

    serve_phase(torch, serve, ops, "llama3-8b", None, extra=two_call,
                label="llama3-8b:two_call:forced", before=force)
    parted = [r for r in rows if r[2] != r[3]]
    decisive = [r for r in rows if r[4] > DECISIVE]
    print(f"[two_call] attention kernel, teacher-forced to the "
          f"plain-attention two-call tokens: {len(rows)} rows, "
          f"{len(decisive)} decisive (own margin > {DECISIVE}), own pick "
          f"parted on {len(parted)} (uid, index, margin): "
          f"{[(u, i, round(m, 4)) for u, i, _, _, m in parted]}")
    check(len(rows) == 32, "the forced two-call run did not pick 32 tokens")
    check(all(r[2] == r[3] for r in decisive),
          f"the attention kernel parted from plain attention on a decisive "
          f"row: {[r for r in decisive if r[2] != r[3]]}")
    absent = paged | {"paged_ragged_attention"}
    return {"llama3-8b:two_call": (counts, paged),
            "llama3-8b:unified:plain_attention": (uni_counts, absent),
            "llama3-8b:two_call:plain_attention": (two_counts, absent)}


def _parse_prometheus(text: str) -> int:
    """Number of samples in Prometheus text; fails on a malformed line."""
    n = 0
    for line in text.splitlines():
        if not line or line.startswith("# "):
            continue
        name, _, value = line.rpartition(" ")
        try:
            float(value)
        except ValueError:
            name = ""
        check(bool(name), f"malformed Prometheus sample: {line!r}")
        n += 1
    return n


def robust_phase(torch, serve, ops) -> dict:
    """llama3-8b at full width with the serve CLI's robustness and
    observability flags: ``--chaos 0`` (the CLI's seeded fault plan),
    ``--numerics-guard``, ``--max-waiting``, ``--deadline-s`` and the
    metrics / trace files.  Checks the files parse back, every request is
    terminal, no page or slot leaked, and prints the ``[serve:lifecycle]``
    line; then forces one NaN row on the same engine and checks the
    demotion it causes stops K1–K3 launches (the reference's demotion keeps
    the cache attention as configured, so K4 goes on).  Returns the chaos
    run's launch counts."""
    import tempfile
    from repro_torch.serving.faults import FaultPlan
    with tempfile.TemporaryDirectory() as tmp:
        files = {k: str(Path(tmp) / f"robust.{k}")
                 for k in ("json", "prom", "trace")}
        extra = ["--chaos", "0", "--numerics-guard", "--requests",
                 str(ROBUST_REQUESTS), "--max-waiting", str(ROBUST_WAITING),
                 "--deadline-s", str(ROBUST_DEADLINE_S), "--metrics-json",
                 files["json"], "--metrics-prom", files["prom"],
                 "--trace-out", files["trace"]]

        def after(engine, res, sargs):
            st = res["stats"]
            print(serve.lifecycle_line(st))
            for line in serve.write_outputs(engine, sargs):
                print(line)
            check(res["requests"] == ROBUST_REQUESTS and all(
                s in TERMINAL for s in res["status"].values()),
                "a robust-phase request did not reach one terminal state")
            check(st["shed"] == ROBUST_REQUESTS - ROBUST_WAITING,
                  f"expected {ROBUST_REQUESTS - ROBUST_WAITING} requests "
                  f"shed, got {st['shed']}")
            check(engine.sched.quiescent(), "pages or slots leaked")
            with open(files["json"]) as f:
                snap = json.load(f)
            check(snap["counters"]["finished"] == st["finished"],
                  "metrics JSON disagrees with the engine's stats")
            with open(files["prom"]) as f:
                n_prom = _parse_prometheus(f.read())
            with open(files["trace"]) as f:
                trace = json.load(f)
            terminals = [e for e in trace["traceEvents"] if e["ph"] == "i"
                         and e["name"].startswith("terminal")]
            check(len(terminals) == ROBUST_REQUESTS,
                  "the trace lacks a terminal mark per request")
            print(f"[robust] files parse: {len(snap['counters'])} counters, "
                  f"{n_prom} Prometheus samples, "
                  f"{len(trace['traceEvents'])} trace events; injected "
                  f"{json.dumps(engine.fault.injected)}; statuses "
                  f"{json.dumps(res['status'])}")
            demotion_run(torch, ops, engine, FaultPlan)

        counts, _ = serve_phase(torch, serve, ops, "llama3-8b", None,
                                extra=extra, label="llama3-8b:robust",
                                after=after)
    return counts


def demotion_run(torch, ops, engine, FaultPlan) -> None:
    """Four more requests on the robust engine with a NaN forced into the
    first one's second token: the guard quarantines it, the engine demotes
    to reference execution on its kept packed weights, and no K1, K2 or K3
    launch follows."""
    uid = engine._uid + 1
    engine.fault = FaultPlan(seed=0, nan_faults=frozenset({(uid, 1)}))
    engine.sched.alloc.fault = engine.fault.exhausted
    at_demotion = {}
    demote = engine._maybe_demote

    def snapshot():
        at_demotion.update(ops.launch_counts())
        demote()

    engine._maybe_demote = snapshot
    import numpy as np
    rng = np.random.default_rng(1)
    ops.reset_launch_counts()
    for _ in range(4):
        engine.submit(rng.integers(0, engine.cfg.vocab_size, 96),
                      max_new_tokens=8)
    done = engine.run()
    torch.cuda.synchronize()
    end = ops.launch_counts()
    st = engine.stats
    check(st["demotions"] == 1 and engine.serve.stamp.execution ==
          "reference", "the forced NaN row did not demote the engine")
    check(sorted(r.status for r in done).count("failed") == 1,
          "the demotion run did not fail exactly the poisoned request")
    moved = {k: end[k] - at_demotion[k] for k in end}
    print(f"[robust] demotion: launches up to it "
          f"{json.dumps(at_demotion)}, after it {json.dumps(moved)}")
    for k in ("stamp_transform_quantize", "stamp_int_gemm",
              "stamp_decode_matmul"):
        check(at_demotion[k] > 0 and moved[k] == 0,
              f"{k} launched after the demotion ({moved[k]})")
    check(moved["paged_ragged_attention"] > 0,
          "the cache attention stopped after the demotion")
    check(engine.sched.quiescent(), "pages or slots leaked (demotion run)")


def telemetry_phase(torch, serve, ops, cfg, counts: dict, run: dict) -> dict:
    """Arctic-480B (``cfg``) with ``--quant-telemetry``: the same ids and
    the same launches as the Arctic phase (the telemetry's reductions are
    plain PyTorch beside the kernels), and the per-site clip rates and
    router gauges printed.  Returns the run's launch counts."""

    def after(engine, res, sargs):
        snap = engine.metrics.snapshot()
        g = snap["gauges"]
        clip = {k: g[k] for k in g if k.startswith("quant_clip_rate")}
        cov = {k: g[k] for k in g if k.startswith("quant_hi_coverage")}
        experts = [g[k] for k in g if k.startswith("moe_expert_tokens")]
        print(f"[obs] arctic-480b quant clip rates {json.dumps(clip)}; hi "
              f"coverage {json.dumps(cov)}")
        print(f"[obs] arctic-480b router: occupancy "
              f"{g['moe_capacity_occupancy']:.4f} drop rate "
              f"{g['moe_drop_rate']:.4f} dropped (run) "
              f"{snap['counters']['moe_dropped_tokens']:.0f} expert tokens "
              f"(last step) min {min(experts):.0f} max {max(experts):.0f} "
              f"over {len(experts)} experts")
        check(clip and len(experts) == engine.cfg.num_experts,
              "quant telemetry published no site or router gauges")
        check(res["outputs"] == run["outputs"],
              "quant telemetry changed Arctic's tokens")

    tele, _ = serve_phase(torch, serve, ops, "arctic-480b", cfg,
                          extra=["--quant-telemetry"],
                          label="arctic-480b:telemetry", after=after)
    check(tele == counts, f"quant telemetry changed Arctic's launches: "
                          f"{tele} vs {counts}")
    return tele


if __name__ == "__main__":
    main()
