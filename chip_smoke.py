#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught and continued):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the eleven kernels from the ten sources in
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, started together);
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
   experts, replayed from graphs too, and at Jamba's, 16 experts of 8192
   -> 24576 top-2); the long-span K1 -> K2 chain (``check_long_spans``:
   one span of 129 to 2048 rows at llama3-8b's qkv, gate/up and down, for
   transforms none, dwt and wht, bit-equal to the plain versions; at 1024
   and 2048 rows the chain through ``ops`` timed beside its bound and
   ``torch._int_mm``, printed as ``[long_span]`` lines, and the span link
   ``stamp_span_transform`` alone: the inverse Haar DWT at 3 levels and at
   the serve path's resolved levels, the inverse and forward WHT, beside
   the dense transform matmul, printed as ``[span_link]`` lines; and the
   dual chain over one span of ``PAST_LIMIT`` rows, bit-equal); the dense
   archs served at full
   width (``DENSE_ARCHS``: deepseek-7b, minicpm-2b, mistral-nemo-12b and
   qwen2-72b, widths from their configs): K1/K2 at each one's QKV (with
   qwen2-72b's bias), out-proj (from ``q_dim``), gate/up and down over 2
   spans, K3 at the same four sites over 8 decode rows, K4's mixed and
   all-decode steps and K6 at their multi-head widths (32 heads of 128, 36
   of 64, one query head a kv head); the MoE, hybrid and SSM archs served
   at full width (``NEW_ARCHS``, :func:`arch_sites`): K1/K2 and K3 at
   Kimi-K2's QKV 7168 -> 8960, out-proj and dense first layer (gate/up
   7168 -> 18432, down), Jamba's QKV 8192 -> 10240, out-proj, Mamba
   in_proj 8192 -> 33280 and out_proj 16384 -> 8192, gate/up 8192 ->
   24576 and down, and Mamba2's in_proj 2048 -> 8512 (not a multiple of
   K2's 128 columns) and out_proj 4096 -> 2048; K4's mixed and all-decode
   steps at Jamba's 64/8 heads of 128; K4 at llama's and Arctic's head counts
   also over a long all-decode
   step (8 slots of 65 to 32768 cached tokens, split over blocks); K6 (the
   contiguous cache's decode attention) at the bucketed serve shape (4
   slots, cache 136, hi ``NUM_HI``) and at 8 slots x 32768 cached tokens
   (hi 64) with ragged lengths; K4 and K6 again at Kimi-K2's attention
   widths (64/8 heads, head_dim 112); the multimodal stacks' kernels:
   K1/K2 and K3 at seamless-m4t-large-v2's decoder sites (1024 -> 3072,
   gate/up 1024 -> 8192, down 8192 -> 1024) and pixart-sigma's (1152 ->
   3456, gate/up 1152 -> 4608, down 4608 -> 1152), K4's mixed and
   all-decode steps and K6 (serve shape and 8 x 32768 cached tokens) at
   pixart's 16/16 heads of head_dim 72 beside SDPA, the long-span chain
   at llava-next-mistral-7b's prefill (4 spans of 576 patch rows and 64
   tokens at its qkv, gate/up and down, bit-equal, timed,
   ``check_patch_spans``) and ``stamp_quant_segment_matmul`` against its
   per-span calls (``check_segment``); then check a prefill, a mixed and
   an all-decode step on the card against the same steps on the CPU at the
   reduced size of each model (Kimi-K2, Jamba, Mamba2 and pixart
   included, the Mamba layers' state in the slot-dense pool), one
   ``prefill`` and two ``decode_step`` s of the bucketed path at reduced
   llama, and the same through the model API at reduced llava (patches)
   and seamless (frames, PTQ'd with them) over three seeds: every prefill
   and decode sub-block teacher-forced at the served 8/4 mix, the whole
   steps at 8 bits, seamless's encoder layer by layer
   (``check_model_api_against_cpu``); then the standalone kernel
   library at llama3-8b's widths (K7 ``int8_matmul`` at 2048 rows through
   its qkv, gate and down shapes and at 8 rows, K8 ``quantize_pack`` at 4
   and 8 bits, K9 ``haar_dwt_seq`` at 3 and 5 levels up to 32768 tokens,
   K10 ``walsh_hadamard`` along the sequence, split and not, and the
   features; K8 also in f32, beside the ``copy_`` ceiling); then the
   serving split's kernel modes at the serve pair's shapes
   (``check_split_modes``, ``[split_mode]`` lines): K1's statistics and
   given-statistics modes on each of 2 ranks' blocks of llama3-8b's
   row-parallel inputs (wo over 4096, down over 14336; 128 and 320 rows,
   the second through the span link), exact against the plain versions
   and the whole rows' codes; K2's parts and summed modes on those blocks'
   codes, exact against the plain versions, the summed parts finished
   equal to the whole rows' K1 -> K2 bit for bit (``torch._int_mm`` timed
   beside the parts); K3's statistics, parts and summed modes on decode
   rows' blocks, the summed parts equal to the whole rows' K3 bit for bit
   (``torch.aminmax`` timed beside the statistics); K6's block mode over 2
   sequence blocks of a 336-position
   cache and its merge of the ranks' states, against the whole-cache K6
   and the plain versions (a block past every length: m = -inf, l = 0);
   each timed beside its bound (the ``kernels`` line's ``modes``);
4. drive the kernel library's path through ``repro_torch.kernels.ops``: a
   (1, 2048, 4096) activation through ``haar_dwt_seq`` (3 levels),
   ``quantize_pack`` (8 bits), ``int8_matmul`` against ``prepare_linear``'s
   codes of a 4096 -> 14336 weight and the inverse ``haar_dwt_seq``, and a
   ``walsh_hadamard`` involution, with every kernel's launch count set to 0
   before it and read after, held against the same chain of plain versions;
   then the paper runners of ``repro_torch.paper.run`` at the reference's
   sizes (``paper_phase``: Tables 1, 3 and 4, Figs. 3, 4b and 7, counts
   read around their card run; every row held against the same row on the
   CPU, Table 4's fused sites, K1 -> K2 -> span link at 256 rows, against
   the port's reference path, Table 3's block on K9 / K10 against the
   plain block and timed apart, printed as ``[paper]`` lines with the
   phase's seconds); then serve llama3-8b at full width through the port's
   serve entry point (seeded init, PTQ on the card, paged unified fused
   engine with the paged attention kernel): 4 requests x 96 prompt tokens
   x 8 new tokens, with every kernel's launch count set to 0 before that
   run and read after;
   then the same model at ``--prefill-chunk 256`` with 4 prompts of 400
   tokens (the long-span chain) and through the bucketed engine at
   ``--bucket 512`` on the same prompts; then the same model and 96-token
   requests through the bucketed engine (bucket
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
   plain attention by teacher forcing), Kimi-K2 (``KIMI_LAYERS`` of 61
   layers), Jamba-1.5-Large (``JAMBA_LAYERS`` of 72) and Mamba2-1.3B (all
   48) at full width through the paged engine, llama3-8b with the serve
   CLI's
   chaos plan, numerics guard, bounded queue, deadline and metrics / trace
   files (``robust_phase``; then a forced NaN row whose demotion must stop
   K1–K3), and Arctic with quant telemetry (``telemetry_phase``: the same
   ids and launches as without, its clip rates and router gauges
   printed); each serve phase prints its step phases' totals; then
   pixart-sigma whole (28 layers, head_dim 72) through the paged engine
   (K1–K4) and the bucketed one (K6), and llava-next-mistral-7b whole (32
   layers) and seamless-m4t-large-v2 whole (24 + 24 layers) through the
   model API (``model_api_phase``: seeded init, int4 weights, llava's
   config by hand as the reference's PTQ refuses its patch batch,
   seamless PTQ'd on 2 batches of 128 tokens and 32 frames; the prefill
   of 4 rows — 576 patch rows and 64 tokens, or 128 tokens beside 32
   frames — and 8 decode steps, counts read around them, printed as
   ``[model_api]`` lines with tokens/s, prefill seconds and peak memory);
   then the training path (``train_phase``, which launches no kernel:
   every launch count set to 0 before it and each required to stay 0):
   minicpm-2b whole at full width (40 layers, d 2304, padded vocabulary
   122880, f32 weights and AdamW moments) trained ``TRAIN_STEPS`` steps of
   4 x 512 tokens under its WSD schedule through ``repro_torch.launch.
   train.train`` (every loss finite, the last below the first; median step
   ms, tokens/s and peak memory printed as ``[train]`` lines), one
   ``build_step`` step of it cut to 2 layers on the card against the same
   step on the CPU, the checkpoint manager's snapshot, write and restore
   seconds on that cut's state, the reference test's crash-and-restart
   run through ``python -m repro_torch.launch.train --device cuda`` (the
   final loss and every leaf of the final checkpoint equal to a clean
   run's), and Table 2 (its LM trained on the card, its rows against the
   same parameters on the CPU, ``[table2]`` lines); then the sharded
   trainer (``shard_phase``, which launches no kernel either: the ranks'
   counts read around their runs): ``repro_torch.launch.train.train``
   under ``torch.distributed.run --nproc-per-node 1`` on NCCL (a ``(1,
   1)`` mesh), minicpm-2b whole for the train phase's steps, every
   parameter's CRC32 and every loss equal to the one-device run's, its
   median step ms, tokens/s, peak memory, training state, idle share and
   collectives a step (a ``torch.profiler`` trace of two more steps)
   beside the one-device step's; then two ranks sharing the card over
   gloo (NCCL refuses two ranks on one card) on a ``(1, 2)`` and a ``(2,
   1)`` mesh, minicpm-2b at full width cut to ``PAIR_LAYERS`` layers,
   each held against the one-device step on rank 0 (``[shard]`` lines,
   each rank's bytes of training state; on ``(1, 2)`` its dot FLOPs and
   its first step's peak held to the dry run's); then the serve pair
   (``serve_pair_phase``: two gloo ranks on the card on a ``(1, 2)`` mesh,
   llama3-8b at full width cut to ``PAIR_LAYERS`` layers, fused STaMP
   over int8 weights prepared whole and cut to each rank's blocks, K3 and
   K6; prompts of 128 and 320 tokens, then 16 teacher-forced decode
   steps, the launch counts set to 0 before and read after; rank 0 holds
   the prefill logits to one device's bit for bit, every step's within
   ``SERVE_LOGIT_REL`` and the greedy tokens under the margin rule, at
   the served mix and at 8 bits; each rank's row-parallel K1 codes and
   K1 -> K2 product through gloo's all-reduces exact, its ``FlopCounterMode`` count of the
   dry run's serve cells equal to the dry run's on a fake ``(1, 2)``
   group; ``[shard] serve pair`` line); then the Mamba pair, its own
   path (mamba2-1.3b at full width cut to 24 of its 48 layers, its mixers
   split over their heads on the same ``(1, 2)`` mesh: prompts of 128 and 512
   tokens and 16 decode steps at both mixes, every step's logits one
   device's bit for bit, the first layer's state and conv blocks
   one device's bit for bit, each rank's first ``in_proj`` K1 codes one
   device's and its z / x B C / dt columns of the product one device's
   columns, its ``out_proj`` K1 codes and product the whole rows',
   FLOPs the dry run's; ``[shard] mamba pair`` line; and, in the shard
   phase, 16 layers' two training steps of 4 x 512 tokens against one device's
   within ``MAMBA_TRAIN_BOUNDS`` (loss, grad norm, the share of elements
   past lr after the first step, and the first step's gradient of each
   leaf and each of ``in_proj``'s column parts), its peak and FLOPs the
   dry run's, ``[shard] mamba pair train`` lines); then the dry-run tools
   (``dryrun_phase``, which launches no kernel: counts set to 0 before it
   and each required to stay 0): ``python -m repro_torch.launch.dryrun``
   on minicpm-2b ``train_4k`` (16 x 16) and mamba2-1.3b ``long_500k``
   (2 x 16 x 16) in subprocesses, each ``ok`` with its record, and the
   dry run of minicpm-2b whole on one device, its train step (the train
   phase's, whose ``FlopCounterMode`` count, peak memory and median step
   it reuses) and a prefill of 4 x 512 tokens under ``make_serve_config``
   (timed on the card here), each held to the card's FLOPs exactly, its
   peak within ``DRYRUN_PEAK_REL`` and its roofline step time no longer
   than the measured one (``[dryrun]`` lines);
5. print ``{"kernels": [...]}``, the ``nvidia-smi`` line, and last
   ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one or outside a checkout.
``--serve-only PHASE,...`` runs only llama3-8b's paged phase and the named
serve phases (no kernels line, no final ok line); ``--split-only`` the
build, ``check_split_modes``, both serve pairs and the Mamba pair's
training (no kernels line, no final ok line).
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
# the MoE, hybrid and pure-SSM archs served at full width, each with its
# depth: Kimi-K2 cut to its dense first layer and 3 MoE layers (16.9 GB of
# int8 expert codes a layer), Jamba to one period of 8 (1 attention and 7
# Mamba layers, 4 of them MoE), Mamba2 whole
KIMI_LAYERS, JAMBA_LAYERS = 4, 8
NEW_ARCHS = {"kimi-k2-1t-a32b": KIMI_LAYERS,
             "jamba-1.5-large-398b": JAMBA_LAYERS, "mamba2-1.3b": None}
# K4 is also checked at Jamba's attention widths, 64 query heads over 8
# kv heads of 128 (mixed and all-decode steps)
JAMBA = "jamba-1.5-large-398b"
# the long-span serve phases' prompts: two chunks of 256 rows, or one
# bucket of 512
LONG_PROMPT = 400
# the multi-head (one query head a kv head) attention widths K4 and K6 are
# checked at: deepseek-7b's (32 heads of 128) and minicpm-2b's (36 of 64)
MHA_ARCHS = ("deepseek-7b", "minicpm-2b")
# Kimi-K2 (configs/kimi_k2_1t_a32b.py): its attention widths, 64 query
# heads over 8 kv heads of head_dim 112 (K4 and K6 checks)
KIMI_HEADS, KIMI_HD = 64, 112
# the reference's multimodal stacks, all three whole: llava (32 layers,
# mistral-7b's widths) and seamless (24 decoder and 24 encoder layers)
# through the model API (``lm.prefill`` on a batch dict, then
# ``lm.decode_step``: no engine takes patches or frames), pixart (28
# layers, 16 heads of head_dim 72) through the paged and bucketed engines
LLAVA, SEAMLESS, PIXART = ("llava-next-mistral-7b", "seamless-m4t-large-v2",
                           "pixart-sigma")
MM_REQUESTS, MM_STEPS = 4, 8
# prompt tokens beside llava's 576 patch rows and beside seamless's frames
# (128 // frame_ratio = 32); llava's STaMP is set by hand (its PTQ raises
# on a patch batch, as the reference's does): 64 rows at 8 bits
LLAVA_PROMPT, SEAMLESS_PROMPT, LLAVA_NUM_HI = 64, 128, 64
# the batches of the model API's card-vs-CPU checks at reduced size
API_SEEDS = (5, 6, 7)
# llava's prefill spans, 576 + 64 rows (five K2 tiles: the long-span
# chain), under the DWT at the levels StampConfig resolves for 640 rows
# over 64 at 8 bits: ceil(log2(640 / 64)) = 4
PATCH_SPAN = 640
PATCH_STAMP = dict(transform="dwt", levels=4, skip_first=True, num_hi=64,
                   hi_bits=8, lo_bits=4)
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


def arch_sites(cfg) -> tuple:
    """One of each linear site that ``cfg``'s layers run: K1/K2's ``(name,
    K, N, dual, bias)`` and K3's ``(name, K, N, bias)``.  Attention: QKV
    (with its bias where the config has one) and the out-proj from
    ``q_dim``; Mamba: ``in_proj`` (d to 2·d_inner + 2·state + heads) and
    ``out_proj``; a dense MLP: gate/up as one dual call (one shape in
    decode) and down.  The MoE experts are K5's (:func:`check_grouped`)."""
    tag = cfg.name.split("-")[0] + "_"
    specs = set(cfg.layer_specs())
    d, qkv = cfg.d_model, cfg.q_dim + 2 * cfg.kv_dim
    prefill, decode = [], []
    if any(s.mixer == "attn" for s in specs):
        prefill += [(tag + "qkv", d, qkv, False, cfg.qkv_bias),
                    (tag + "wo", cfg.q_dim, d, False, False)]
        decode += [(tag + "qkv", d, qkv, cfg.qkv_bias),
                   (tag + "wo", cfg.q_dim, d, False)]
    if any(s.mixer == "mamba" for s in specs):
        di = cfg.d_inner
        n_in = 2 * di + 2 * cfg.ssm_state + cfg.ssm_heads
        prefill += [(tag + "in_proj", d, n_in, False, False),
                    (tag + "out_proj", di, d, False, False)]
        decode += [(tag + "in_proj", d, n_in, False),
                   (tag + "out_proj", di, d, False)]
    if any(s.ffn == "mlp" for s in specs):
        prefill += [(tag + "gate_up", d, cfg.d_ff, True, False),
                    (tag + "down", cfg.d_ff, d, False, False)]
        decode += [(tag + "gate", d, cfg.d_ff, False),
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


# the long-span chain (spans over K2's 128-row tile): every span length
# is checked at llama3-8b's three sites and each transform, bit-equal to
# the plain version; 1024 and 2048 rows are also timed (one span, dwt)
LONG_SPANS, LONG_TIMED = (129, 256, 512, 1024, 2048), (1024, 2048)
LONG_ITERS = 20
# one span past the 9557 rows the span link's first design refused (its
# whole span in shared memory), checked through the dual chain
PAST_LIMIT = 9558


def check_long_spans(torch, sm, ops_mod, prepare_linear) -> tuple:
    """The K1 → K2 chain over one span of 129 to 2048 rows at llama3-8b's
    qkv, gate/up (dual) and down sites, for transforms none, dwt and wht:
    K1's codes, scales and zero points and K2's bf16 and f32 outputs
    bit-equal to the plain versions (beyond ``MAX_SPAN`` rows K2 runs
    without a transform over 128-row tiles and the span link inverts; under
    the WHT beyond 257 rows the span link also runs the forward transform
    before K1).  At ``LONG_TIMED`` rows under the Haar DWT: the whole
    chain through ``ops`` (eager and graph-replayed) beside its bound and
    ``torch._int_mm`` on the same codes, and the span link alone
    (:func:`_link_rows`) beside its bound, its plain version and the dense
    transform matmul.  Then one span past the old limit
    (:func:`check_past_old_limit`).  Returns ``(link rows, chain
    rows)``."""
    gen = torch.Generator(device="cuda").manual_seed(40)
    weights = {}
    for name, k, n, dual in LLAMA_SITES:
        weights[name] = [prepare_linear(torch.randn(
            (k, n), generator=gen, device="cuda") / math.sqrt(k))
            for _ in range(2 if dual else 1)]
    link, chain = [], []
    for s in LONG_SPANS:
        for tf in ("none", "dwt", "wht"):
            st = dict(STAMP, transform=tf)
            for name, k, n, dual in LLAMA_SITES:
                w = weights[name]
                x = torch.randn((1, s, k), generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                q = sm.stamp_transform_quantize(x, **st)
                qp = sm.transform_quantize_plain(x, **st)
                check(all(torch.equal(a, b) for a, b in zip(q, qp)),
                      f"K1 chain codes differ at {name} s={s} {tf}")
                bias = torch.randn(n, generator=gen, device="cuda")
                wargs = [w[0].qw, w[0].sw, w[0].zw, w[0].qw_sum, bias]
                if dual:
                    wargs += [w[1].qw, w[1].sw, w[1].zw, w[1].qw_sum, None]
                for dt in (torch.bfloat16, torch.float32):
                    kw = dict(transform=tf, levels=3, skip_first=True,
                              out_dtype=dt)
                    y = sm.stamp_int_gemm(*q, s, *wargs, **kw)
                    yp = sm.int_gemm_plain(*q, s, *wargs, **kw)
                    check(bool(torch.isfinite(y).all()) and
                          torch.equal(y, yp),
                          f"K2 chain differs from its plain version at "
                          f"{name} s={s} {tf} {dt}: max err "
                          f"{float((y.float() - yp.float()).abs().max())}")
                if s in LONG_TIMED and tf == "dwt":
                    link += _link_rows(torch, sm, q, x, s, wargs, name,
                                       (3, _resolved_levels(s, NUM_HI)))
                    chain.append(_chain_row(torch, sm, ops_mod, x, q, w,
                                            wargs, name, s))
                del x, q, qp
        torch.cuda.empty_cache()
    check_past_old_limit(torch, sm, weights["gate_up"], gen)
    return link, chain


def check_past_old_limit(torch, sm, w, gen) -> None:
    """The dual chain over one span of ``PAST_LIMIT`` rows (past the 9557
    rows the span link once held for the dual under the DWT) at llama3-8b's
    gate/up, at the levels the serve path resolves for it (so the forward
    link runs before K1 too, its levels over several launches): K1's codes
    and the bf16 output bit-equal to the plain versions."""
    s = PAST_LIMIT
    st = dict(STAMP, levels=_resolved_levels(s, NUM_HI))
    x = torch.randn((1, s, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    sm.stamp_span_transform.launches = 0
    q = sm.stamp_transform_quantize(x, **st)
    forward = sm.stamp_span_transform.launches
    check(forward > 0 and all(torch.equal(a, b) for a, b in zip(
        q, sm.transform_quantize_plain(x, **st))),
          f"K1 codes differ past the old limit ({s} rows)")
    bias = torch.randn(D_FF, generator=gen, device="cuda")
    wargs = [w[0].qw, w[0].sw, w[0].zw, w[0].qw_sum, bias,
             w[1].qw, w[1].sw, w[1].zw, w[1].qw_sum, None]
    kw = dict(transform="dwt", levels=st["levels"], skip_first=True,
              out_dtype=torch.bfloat16)
    y = sm.stamp_int_gemm(*q, s, *wargs, **kw)
    yp = sm.int_gemm_plain(*q, s, *wargs, **kw)
    check(bool(torch.isfinite(y).all()) and torch.equal(y, yp),
          f"the dual chain differs from its plain version at {s} rows")
    print(f"[long_span] past the old limit: {s} rows, levels "
          f"{st['levels']}, forward link launches {forward}, bit-equal")
    del x, q, y, yp
    torch.cuda.empty_cache()


def _resolved_levels(s: int, num_hi: int) -> int:
    """The levels ``StampConfig`` resolves for spans of ``s`` rows over
    ``num_hi`` rows at 8 bits: ``ceil(log2(s / num_hi))``."""
    return max(1, math.ceil(math.log2(max(s / max(num_hi, 1), 2))))


def _link_case(torch, sm, name, args, kw, dense, flops) -> dict:
    """One span link call: bit-equal to its plain version, timed eager and
    replayed from CUDA graphs beside its plain version, the dense transform
    ``torch.matmul`` (``dense()``: the (s, s) matrix and its operand, the
    same values) and its byte bound (each input read once, the output
    written once)."""
    def call():
        return sm.stamp_span_transform(*args, **kw)

    got = call()
    want = sm.span_transform_plain(*args, **kw)
    check(torch.equal(got, want),
          f"span link differs from its plain version at {name}: max err "
          f"{float((got.float() - want.float()).abs().max())}")
    ms = timed(torch, call, iters=LONG_ITERS)
    gms = timed_graph(torch, call, LONG_ITERS, per_graph=10)
    pms = timed(torch, lambda: sm.span_transform_plain(*args, **kw),
                iters=3)
    mat, operand = dense()

    def library():
        return torch.matmul(mat, operand)

    lib = timed(torch, library, iters=5)
    lib_gms = timed_graph(torch, library, 10, per_graph=5)
    del mat, operand
    ins = [a for a in args[:2] if a is not None]
    nbytes = sum(a.numel() * a.element_size() for a in ins) + \
        got.numel() * got.element_size() + \
        sum(4 * a.numel() for a in args[2:] if a is not None)
    b = bound(nbytes, flops * got.numel() * len(ins), F32_FLOPS_PER_S)
    row = dict(site=name, max_abs_err=0.0, ms=ms, plain_ms=pms,
               bound_ms=b[0], bound_by=b[1], library_ms=lib, graph_ms=gms,
               library_graph_ms=lib_gms,
               launches_a_call=None)
    sm.stamp_span_transform.launches = 0
    call()
    row["launches_a_call"] = sm.stamp_span_transform.launches
    print(f"[span_link] {json.dumps(row)}")
    return row


def _link_rows(torch, sm, q, x, s, wargs, name, levels) -> list:
    """The span link alone at a site: the inverse transform of K2's f32
    products (gate and up for the dual) with the bias, bf16 out, under the
    Haar DWT at each of ``levels`` and under the WHT; and at single sites
    the forward WHT of the bf16 activation ``x`` into f32 (K1's input).
    The library yardstick is the dense (s, s) transform ``torch.matmul``
    on the same f32 products (the gate's and up's side by side), or on the
    bf16 activation for the forward: it computes the transform only, not
    the bias, ``silu(g)·u`` or the cast."""
    pre = dict(transform="none", levels=3, skip_first=True,
               out_dtype=torch.float32)
    g = sm.stamp_int_gemm(*q, s, *wargs[:4], **pre)
    u = sm.stamp_int_gemm(*q, s, *wargs[5:9], **pre) if len(wargs) > 5 \
        else None
    both = g if u is None else torch.cat([g, u], dim=-1)
    T = sm.T
    rows = []
    for tf, lv in [("dwt", lv) for lv in levels] + [("wht", 3)]:
        kw = dict(transform=tf, levels=lv, skip_first=True, inverse=True,
                  out_dtype=torch.bfloat16)

        def dense(tf=tf, lv=lv):
            mat = _dense(torch, lambda e: T.inverse_sequence_transform(
                e, tf, axis=-2, levels=lv, skip_first=True), s,
                torch.float32)
            return mat, both

        tag = f"dwt{lv}" if tf == "dwt" else tf
        rows.append(_link_case(torch, sm, f"long_{name}_s{s}_{tag}_inverse",
                               (g, u, wargs[4], None), kw, dense,
                               4 if tf == "dwt" else
                               int(math.log2(s)) + 1))
    if u is None:
        kw = dict(transform="wht", levels=3, skip_first=True,
                  out_dtype=torch.float32)

        def dense_fwd():
            return _dense(torch, lambda e: T.sequence_transform(
                e, "wht", axis=-2, skip_first=True), s, torch.bfloat16), x

        rows.append(_link_case(torch, sm, f"long_{name}_s{s}_wht_forward",
                               (x,), kw, dense_fwd, int(math.log2(s)) + 1))
    del g, u, both
    torch.cuda.empty_cache()
    return rows


def _chain_row(torch, sm, ops_mod, x, q, w, wargs, name, s,
               st=STAMP) -> dict:
    """The whole chain from the bf16 activation (its spans of ``s`` rows)
    through ``ops`` (K1, K2 without a transform, the span link) under the
    STaMP settings ``st``, its bound (read the activation and the weights
    once, write the output; the int8 products at the card's int8 rate) and
    ``torch._int_mm`` of the same codes."""
    dual = len(w) > 1

    def call():
        if dual:
            return ops_mod.stamp_quant_dual_matmul(x, *wargs[:4],
                                                   *wargs[5:9], wargs[4],
                                                   None, **st)
        return ops_mod.stamp_quant_matmul(x, *wargs[:5], **st)

    ms = timed(torch, call, iters=LONG_ITERS)
    gms = timed_graph(torch, call, LONG_ITERS, per_graph=10)
    k, n = w[0].qw.shape
    rows = x.shape[0] * x.shape[1]
    b = bound(rows * k * 2 + len(w) * (k * n + 12 * n) +
              (4 * n if wargs[4] is not None else 0) + rows * n * 2,
              2 * rows * k * n * len(w), INT8_OPS_PER_S)
    lib = int_mm_yardstick(torch, q[0], [wi.qw for wi in w], LONG_ITERS)
    row = dict(site=f"long_{name}_s{s}", ms=ms, graph_ms=gms, bound_ms=b[0],
               bound_by=b[1], **lib)
    print(f"[long_span] {json.dumps(row)}")
    return row


def check_patch_spans(torch, sm, ops_mod, prepare_linear) -> tuple:
    """The long-span chain at llava's prefill: ``MM_REQUESTS`` spans of
    ``PATCH_SPAN`` rows (576 patch rows and a 64-token prompt: five K2
    tiles, not a power of two) at its qkv, gate/up and down (mistral-7b's
    widths, which are llama3-8b's), under ``PATCH_STAMP``: K1's codes,
    scales and zero points and K2's bf16 and f32 outputs bit-equal to the
    plain versions; then the chain through ``ops`` and the span link alone
    timed as :func:`check_long_spans` times them.  Returns ``(link rows,
    chain rows)``."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    st, s = PATCH_STAMP, PATCH_SPAN
    link, chain = [], []
    for name, k, n, dual in LLAMA_SITES:
        w = [prepare_linear(torch.randn((k, n), generator=gen,
                                        device="cuda") / math.sqrt(k))
             for _ in range(2 if dual else 1)]
        x = torch.randn((MM_REQUESTS, s, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        q = sm.stamp_transform_quantize(x, **st)
        qp = sm.transform_quantize_plain(x, **st)
        check(all(torch.equal(a, b) for a, b in zip(q, qp)),
              f"K1 codes differ at llava's {name} ({MM_REQUESTS} x {s})")
        wargs = [w[0].qw, w[0].sw, w[0].zw, w[0].qw_sum, None]
        if dual:
            wargs += [w[1].qw, w[1].sw, w[1].zw, w[1].qw_sum, None]
        for dt in (torch.bfloat16, torch.float32):
            kw = dict(transform="dwt", levels=st["levels"], skip_first=True,
                      out_dtype=dt)
            y = sm.stamp_int_gemm(*q, s, *wargs, **kw)
            yp = sm.int_gemm_plain(*q, s, *wargs, **kw)
            check(bool(torch.isfinite(y).all()) and torch.equal(y, yp),
                  f"the chain differs from its plain version at llava's "
                  f"{name} ({dt}): max err "
                  f"{float((y.float() - yp.float()).abs().max())}")
        link += _link_rows(torch, sm, q, x, s, wargs, "llava_" + name,
                           (3, _resolved_levels(s, st["num_hi"])))
        chain.append(_chain_row(torch, sm, ops_mod, x, q, w, wargs,
                                "llava_" + name, s, st=st))
        del x, q, qp
        torch.cuda.empty_cache()
    return link, chain


def check_segment(torch, sm, ops_mod, prepare_linear) -> None:
    """``stamp_quant_segment_matmul``, the twin of
    ``stamp_quant_segment_matmul_pallas``
    (src/repro/kernels/stamp_matmul.py:345): a flattened batch of 2 rows x
    ``SPANS`` spans of C rows at pixart-sigma's qkv (1152 -> 3456) through
    K1 -> K2, bit-equal to one call per span and, in bf16, within one bf16
    step of its plain version; a length that is not whole spans raises.
    Timed (eager and replayed from graphs) beside its bound (the
    function's bytes: read the activation and the weights with their
    scales once, write the output; its int8 operations), its plain version
    and ``torch._int_mm`` on its codes, printed as a ``[segment]`` line."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    k, n = 1152, 3456
    x = torch.randn((2, SPANS * C, k), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    p = prepare_linear(torch.randn((k, n), generator=gen, device="cuda")
                       / math.sqrt(k))
    w = (p.qw, p.sw, p.zw, p.qw_sum, None)
    got = ops_mod.stamp_quant_segment_matmul(x, *w, seg_len=C, **STAMP)
    per = torch.cat([ops_mod.stamp_quant_segment_matmul(
        x[:, i:i + C], *w, seg_len=C, **STAMP)
        for i in range(0, SPANS * C, C)], dim=1)
    check(torch.equal(got, per),
          "the segment matmul differs from its per-span calls")
    plain = ops_mod.stamp_quant_segment_matmul(
        x.cpu(), *(t.cpu() if t is not None else None for t in w),
        seg_len=C, **STAMP)
    err = close_bf16(torch, got.cpu(), plain)
    try:
        ops_mod.stamp_quant_segment_matmul(x, *w, seg_len=C + 1, **STAMP)
        fail("the segment matmul took a length of no whole spans")
    except ValueError:
        pass

    def call():
        return ops_mod.stamp_quant_segment_matmul(x, *w, seg_len=C, **STAMP)

    def plain_call():
        # the plain versions of K1 and K2 on the card, spans folded
        q = sm.transform_quantize_plain(x.reshape(-1, C, k), **STAMP)
        return sm.int_gemm_plain(*q, C, *w, transform="dwt", levels=3,
                                 skip_first=True, out_dtype=torch.bfloat16)

    rows = x.shape[0] * x.shape[1]
    b = bound(rows * k * 2 + k * n + 12 * n + rows * n * 2,
              2 * rows * k * n, INT8_OPS_PER_S)
    qx = sm.stamp_transform_quantize(x.reshape(-1, C, k), **STAMP)[0]
    row = dict(site="segment_pixart_qkv", max_abs_err=err,
               ms=timed(torch, call, iters=K2_ITERS),
               graph_ms=timed_graph(torch, call, K2_ITERS, per_graph=10),
               plain_ms=timed(torch, plain_call, iters=3),
               bound_ms=b[0], bound_by=b[1],
               **int_mm_yardstick(torch, qx, [p.qw], K2_ITERS))
    print(f"[segment] pixart qkv 2 x {SPANS} x {C} rows, per-span "
          f"bit-equal: {json.dumps(row)}")


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
# Jamba-1.5-Large (configs/jamba_1_5_large_398b.py): 16 experts of
# 8192 -> 24576, top-2
J_D, J_FF, J_EXPERTS, J_TOPK, J_CF = 8192, 24576, 16, 2, 1.25
MOE_SHAPES = [("arctic_experts", A_D, A_FF, A_EXPERTS, A_TOPK, A_CF, 4),
              ("kimi_experts", KIMI_D, KIMI_MOE_FF, KIMI_EXPERTS, KIMI_TOPK,
               KIMI_CF, 12),
              ("jamba_experts", J_D, J_FF, J_EXPERTS, J_TOPK, J_CF, 13)]


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
    the next (Arctic's, Kimi-K2's and Jamba's take 13.4, 16.9 and 9.7 GB
    of codes, and as much again in the yardstick's column-major
    copies)."""
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


# ------------------------------------- phase 3: the serving split's modes --

# K1's and K3's statistics modes, K2's parts and summed modes and K6's
# block mode at the serve pair's
# shapes (llama3-8b on 2 model ranks): each rank's block of the
# row-parallel inputs (wo over q_dim 4096, down over d_ff 14336; prompts
# of SERVE_PROMPTS rows, decode rows of 1 and SLOTS) and each rank's block
# of the pair's cache (SERVE_PROMPTS[-1] + SERVE_STEPS positions, hi 64)
SPLIT_RANKS = 2


def _two_blocks(x, k):
    return [x[..., r * k // SPLIT_RANKS:(r + 1) * k // SPLIT_RANKS]
            .contiguous() for r in range(SPLIT_RANKS)]


def check_split_modes(torch, sm, dm, ca, ref, KV, ops, prepare_linear
                      ) -> dict:
    """The new modes against their plain versions on the card, timed
    (eager and from CUDA graphs) beside their bounds and, where one
    PyTorch call computes the same function, its time: K1's statistics
    (exact; ``torch.aminmax`` where the rows come transformed, past 128)
    and given-statistics (codes exact, and the whole rows' block) modes,
    K2's parts (exact; ``torch._int_mm`` on the block's codes) and summed
    modes (the ranks' parts summed and finished: the whole rows' K2
    output bit for bit), K3's statistics mode (exact; ``torch.aminmax``),
    parts mode (exact) and summed mode (the ranks' parts summed and
    finished: the whole rows' K3 output bit for bit), K6's block mode and
    its merge over the ranks' states (f32 queries within 1e-5 of the
    whole-cache kernel; a block past every length m = -inf, l = 0).
    Returns ``{kernel: rows}``."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    k1, k2, k3, k6 = [], [], [], []

    def aminmax_lib(x):
        """``torch.aminmax`` over the rows of ``x``: eager and graph ms."""
        def call():
            return torch.aminmax(x, dim=-1)
        return dict(library_ms=timed(torch, call, iters=K3_ITERS),
                    library_graph_ms=timed_graph(torch, call, K3_ITERS))

    for name, k in (("wo", D), ("down", D_FF)):
        p = prepare_linear(torch.randn((k, D), generator=gen, device="cuda")
                           / math.sqrt(k))
        bias = torch.randn((D,), generator=gen, device="cuda")
        for s in SERVE_PROMPTS:
            levels = max(1, math.ceil(math.log2(max(s / 64, 2))))
            kw = dict(transform="dwt", levels=levels, skip_first=True,
                      num_hi=64, hi_bits=8, lo_bits=4)
            x = torch.randn((1, s, k), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            long = not sm.tq_fits(s, "dwt", levels, True)
            qk = dict(kw, transform="none") if long else kw
            whole = ops._quantize(x, **kw)
            blocks = _two_blocks(x, k)
            if long:
                blocks = [sm.stamp_span_transform(
                    b, transform="dwt", levels=levels, skip_first=True)
                    for b in blocks]
            stats = [sm.stamp_transform_quantize(b, stats_only=True, **qk)
                     for b in blocks]
            for b, st in zip(blocks, stats):
                check(torch.equal(st, sm.transform_quantize_plain(
                    b, stats_only=True, **qk)),
                      f"K1's statistics differ from the plain version's "
                      f"({name}, {s} rows)")
            st = torch.stack(stats)
            given = torch.stack([st[..., 0].amin(0), st[..., 1].amax(0)], -1)
            c = k // SPLIT_RANKS
            parts, wblocks = [], []
            for r, b in enumerate(blocks):
                got = sm.stamp_transform_quantize(b, row_stats=given, **qk)
                want = sm.transform_quantize_plain(b, row_stats=given, **qk)
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"K1's given statistics differ from the plain "
                      f"version's ({name}, {s} rows)")
                check(torch.equal(got[0], whole[0][:, r * c:(r + 1) * c])
                      and torch.equal(got[1], whole[1]),
                      f"K1's block codes differ from the whole rows' "
                      f"({name}, {s} rows)")
                wq = p.qw[r * c:(r + 1) * c].contiguous()
                wblocks.append((got[0], wq, wq.sum(dim=0, keepdim=True,
                                                   dtype=torch.int32)))
                parts.append(sm.stamp_int_gemm_parts(got[0], s,
                                                     *wblocks[-1][1:]))
                check(torch.equal(parts[-1], sm.int_gemm_parts_plain(
                    *wblocks[-1])), f"K2's parts differ from the plain "
                                    f"version's ({name}, {s} rows)")
            summed = sum(parts)
            gkw = dict(transform="dwt", levels=levels, skip_first=True,
                       out_dtype=torch.bfloat16)
            y = sm.stamp_int_gemm_summed(summed, whole[1], whole[2], s, p.sw,
                                         p.zw, bias, **gkw)
            one = ops.stamp_quant_matmul(x, p.qw, p.sw, p.zw, p.qw_sum, bias,
                                         **kw)
            check(torch.equal(y, one),
                  f"K2's summed parts differ from the whole rows' K2 "
                  f"({name}, {s} rows)")
            check(torch.equal(y, sm.int_gemm_summed_plain(
                summed, whole[1], whole[2], s, p.sw, p.zw, bias, **gkw)),
                  f"K2's summed mode differs from the plain version's "
                  f"({name}, {s} rows)")
            b0 = blocks[0]
            rows, isz = s, b0.element_size()

            def stats_call():
                return sm.stamp_transform_quantize(b0, stats_only=True,
                                                   **qk)

            def given_call():
                return sm.stamp_transform_quantize(b0, row_stats=given,
                                                   **qk)

            for mode, call, plain, nbytes in (
                    ("stats", stats_call, lambda: sm.transform_quantize_plain(
                        b0, stats_only=True, **qk), rows * c * isz + rows * 8),
                    ("given", given_call, lambda: sm.transform_quantize_plain(
                        b0, row_stats=given, **qk),
                     rows * c * isz + rows * 8 + rows * c + rows * 8)):
                bd = bound(nbytes, 0, INT8_OPS_PER_S)
                # past 128 rows the rows come transformed: the statistics
                # are then a row min / max, one library call
                lib = aminmax_lib(b0) if mode == "stats" and long else \
                    dict(library_ms=None, library_graph_ms=None)
                k1.append(dict(site=f"{name}_block_{s} ({mode})",
                               max_abs_err=0.0,
                               ms=timed(torch, call, iters=K1_ITERS),
                               plain_ms=timed(torch, plain, iters=5),
                               bound_ms=bd[0], bound_by=bd[1],
                               graph_ms=timed_graph(torch, call, K1_ITERS),
                               **lib))
            q0, wq0, qs0 = wblocks[0]
            pb = (s + 1) * (D + 1) * 4

            def parts_call():
                return sm.stamp_int_gemm_parts(q0, s, wq0, qs0)

            def summed_call():
                return sm.stamp_int_gemm_summed(summed, whole[1], whole[2], s,
                                                p.sw, p.zw, bias, **gkw)

            def int_mm():
                return torch._int_mm(q0, wq0)

            for mode, call, plain, nbytes, ops_, lib in (
                    ("parts", parts_call,
                     lambda: sm.int_gemm_parts_plain(q0, wq0, qs0),
                     s * c + c * D + D * 4 + pb, 2 * s * c * D, int_mm),
                    ("summed", summed_call,
                     lambda: sm.int_gemm_summed_plain(
                         summed, whole[1], whole[2], s, p.sw, p.zw, bias,
                         **gkw),
                     pb + s * 8 + D * 12 + s * D * 2, 0, None)):
                bd = bound(nbytes, ops_, INT8_OPS_PER_S)
                k2.append(dict(
                    site=f"{name}_block_{s} ({mode})", max_abs_err=0.0,
                    ms=timed(torch, call, iters=K1_ITERS),
                    plain_ms=timed(torch, plain, iters=3),
                    bound_ms=bd[0], bound_by=bd[1],
                    graph_ms=timed_graph(torch, call, K1_ITERS),
                    library_ms=lib and timed(torch, lib, iters=K1_ITERS),
                    library_graph_ms=lib and timed_graph(torch, lib,
                                                         K1_ITERS)))
        for m in (1, SLOTS):
            x = torch.randn((m, k), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            blocks = _two_blocks(x, k)
            stats = [dm.decode_row_minmax(b) for b in blocks]
            for b, st in zip(blocks, stats):
                check(torch.equal(st, dm.row_minmax_plain(b)),
                      f"K3's statistics differ from the plain version's "
                      f"({name}, {m} rows)")
            st = torch.stack(stats)
            given = torch.stack([st[..., 0].amin(0), st[..., 1].amax(0)], -1)
            c = k // SPLIT_RANKS
            wq = p.qw[:c].contiguous()
            w = (wq, p.sw, p.zw, wq.sum(dim=0, keepdim=True,
                                        dtype=torch.int32))
            # the parts mode on each rank's block, the parts summed and
            # finished by the summed mode: the whole rows' K3 output (and
            # each mode its plain version's) bit for bit
            parts = []
            for r, b in enumerate(blocks):
                wr = p.qw[r * c:(r + 1) * c].contiguous()
                wsum = wr.sum(dim=0, keepdim=True, dtype=torch.int32)
                got_p = dm.stamp_decode_matmul_parts(b, wr, wsum, given)
                check(torch.equal(got_p, dm.decode_parts_plain(
                    b, wr, wsum, given)), f"K3's parts mode differs from "
                    f"the plain version's ({name}, {m} rows)")
                parts.append(got_p)
            summed = parts[0] + parts[1]
            for od in (torch.bfloat16, torch.float32):
                got_s = dm.stamp_decode_matmul_summed(summed, given, p.sw,
                                                      p.zw, bias,
                                                      out_dtype=od)
                check(torch.equal(got_s, dm.stamp_decode_matmul(
                    x, p.qw, p.sw, p.zw, p.qw_sum, bias, out_dtype=od)) and
                      torch.equal(got_s, dm.decode_summed_plain(
                          summed, given, p.sw, p.zw, bias, out_dtype=od)),
                      f"K3's summed parts differ from the whole rows' K3 "
                      f"({name}, {m} rows, {od})")
            b0 = blocks[0]

            def stats_call():
                return dm.decode_row_minmax(b0)

            def parts_call():
                return dm.stamp_decode_matmul_parts(b0, w[0], w[3], given)

            def summed_call():
                return dm.stamp_decode_matmul_summed(
                    summed, given, p.sw, p.zw, out_dtype=torch.bfloat16)

            pb = (m + 1) * (D + 1) * 4
            for mode, call, plain, nbytes, ops_ in (
                    ("stats", stats_call, lambda: dm.row_minmax_plain(b0),
                     m * c * 2 + m * 8, 0),
                    ("parts", parts_call, lambda: dm.decode_parts_plain(
                        b0, w[0], w[3], given),
                     m * c * 2 + m * 8 + c * D + 4 * D + pb, 2 * m * c * D),
                    ("summed", summed_call, lambda: dm.decode_summed_plain(
                        summed, given, p.sw, p.zw,
                        out_dtype=torch.bfloat16),
                     pb + m * 8 + 8 * D + m * D * 2, 0)):
                bd = bound(nbytes, ops_, INT8_OPS_PER_S)
                lib = aminmax_lib(b0) if mode == "stats" else \
                    dict(library_ms=None, library_graph_ms=None)
                k3.append(dict(site=f"{name}_block_m{m} ({mode})",
                               max_abs_err=0.0,
                               ms=timed(torch, call, iters=K3_ITERS),
                               plain_ms=timed(torch, plain, iters=5),
                               bound_ms=bd[0], bound_by=bd[1],
                               graph_ms=timed_graph(torch, call, K3_ITERS),
                               **lib))
    cap = SERVE_PROMPTS[-1] + SERVE_STEPS
    kvc = KV.KVCacheConfig()
    kk = torch.randn((1, cap, KV_HEADS, HD), generator=gen, device="cuda")
    vv = torch.randn((1, cap, KV_HEADS, HD), generator=gen, device="cuda")
    whole = KV.quantize_full(kk.bfloat16(), vv.bfloat16(), kvc)
    q = torch.randn((1, 1, HEADS, HD), generator=gen, device="cuda")

    from repro_torch.sharding import SeqGroup
    blocks = []
    for r in range(SPLIT_RANKS):
        # rank r's block over a sequence group of the model ranks alone
        blk = KV.seq_block(kvc, cap, SeqGroup(None, r, SPLIT_RANKS, r,
                                              SPLIT_RANKS))
        blocks.append((blk, KV.quantize_full(kk.bfloat16(), vv.bfloat16(),
                                             kvc, block=blk)))
    for length in (cap, 200, 20):
        ln = torch.tensor([length], dtype=torch.int32, device="cuda")
        states, plains = [], []
        for blk, entry in blocks:
            pos = (blk.hi0, blk.lo0)
            states.append(ca.cache_decode_attention(entry, q, ln, pos))
            plains.append(ref.cache_block_attention_ref(entry, q, ln, *pos))
        got = ca.merge_states(torch.stack(states), q.dtype)
        want = ca.cache_decode_attention(whole, q, ln)
        plain = ref.merge_states_ref(torch.stack(plains), q.dtype)
        rel = max(float((got - want).abs().max() / want.abs().max()),
                  float((got - plain).abs().max() / plain.abs().max()))
        check(rel <= 1e-5, f"K6's block mode merged off by {rel} "
                           f"(length {length})")
        if length <= 32:
            check(float(states[1][..., 0].max()) == -math.inf and
                  float(states[1][..., 1].abs().max()) == 0.0,
                  "K6's empty block is not m = -inf, l = 0")
        blk, entry = blocks[0]
        n_tok = min(length, blk.hi0 + blk.hi_n) - blk.hi0 + \
            max(min(length, blk.lo0 + blk.lo_n) - blk.lo0, 0)
        n_hi = max(min(length, blk.hi0 + blk.hi_n) - blk.hi0, 0)
        nbytes = KV_HEADS * (n_hi * 2 * HD + (n_tok - n_hi) * HD
                             + n_tok * 8) + HEADS * HD * 4 + \
            HEADS * (HD + 2) * 4
        bd = bound(nbytes, 4 * HD * HEADS * n_tok, BF16_FLOPS_PER_S)
        st = torch.stack(states)

        def block_call():
            return ca.cache_decode_attention(entry, q, ln, (blk.hi0, blk.lo0))

        def merge_call():
            return ca.merge_states(st, q.dtype)

        k6.append(dict(site=f"block_cap{cap}_len{length} (block)",
                       max_abs_err=rel, ms=timed(torch, block_call, 20),
                       plain_ms=timed(torch, lambda: ref.
                                      cache_block_attention_ref(
                                          entry, q, ln, blk.hi0, blk.lo0), 3),
                       bound_ms=bd[0], bound_by=bd[1], library_ms=None,
                       graph_ms=timed_graph(torch, block_call, K4_ITERS)))
        mb = bound(st.numel() * 4 + HEADS * HD * 4, 0, BF16_FLOPS_PER_S)
        k6.append(dict(site=f"merge_{SPLIT_RANKS}_len{length} (merge)",
                       max_abs_err=rel, ms=timed(torch, merge_call, 20),
                       plain_ms=timed(torch, lambda: ref.merge_states_ref(
                           st, q.dtype), 3),
                       bound_ms=mb[0], bound_by=mb[1], library_ms=None,
                       graph_ms=timed_graph(torch, merge_call, K4_ITERS)))
    for rows in (k1, k2, k3, k6):
        for r in rows:
            print(f"[split_mode] {json.dumps(r)}")
    return {"stamp_transform_quantize": k1, "stamp_int_gemm": k2,
            "stamp_decode_matmul": k3, "cache_decode_attention": k6}


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


# the paper phase (``repro_torch.paper``): the kernels its path launches
# (Table 4's fused rows at 256 rows: K1 -> K2 -> span link; Table 3's
# block: K9 and K10), the tolerance of a card row's SQNR against the same
# row on the CPU, and Table 3's block held against its plain version
PAPER_KERNELS = {"stamp_transform_quantize", "stamp_int_gemm",
                 "stamp_span_transform", "haar_dwt_seq", "walsh_hadamard"}
RTN_CODES_KERNELS = {"stamp_transform_quantize", "stamp_int_gemm",
                     "stamp_span_transform"}
PAPER_SQNR_DB = 0.05
PAPER_BLOCK_REL = 1e-4
PAPER_FUSED_REL = 1e-4


def _sqnr_of(derived: str):
    fields = dict(kv.split("=") for kv in derived.split(","))
    return float(fields["sqnr_db"]) if "sqnr_db" in fields else None


def _rel_norm(torch, got, want) -> float:
    return float(torch.linalg.norm((got - want).float()) /
                 torch.linalg.norm(want.float()))


def table3_parts(torch, T3, hd, wt) -> dict:
    """Table 3's block at the reference's (2, 1024, 512) taken apart on the
    card: each transformed block held against the same block on the plain
    transforms (within ``PAPER_BLOCK_REL`` relative), and the times of each
    block, of K9 (forward + inverse, 3 levels) and K10 (sequence and
    feature axis, twice each: forward and inverse) alone and of the block's
    two GEMMs with silu, eager and replayed from CUDA graphs."""
    from repro_torch.paper.common import lvm_activations
    dev = torch.device("cuda")
    x = lvm_activations(2, (32, 32), 512, seed=0, device=dev)
    w1, w2 = T3.block_weights(512, dev)
    out = {"shape": list(x.shape), "rel_err": {}, "ms": {}, "graph_ms": {}}
    for tf in ("none",) + T3.TRANSFORMS:
        got = T3.block_forward(tf, x, w1, w2)
        want = T3.block_forward(tf, x, w1, w2, dwt=hd.haar_dwt_plain,
                                wht=wt.wht_plain)
        check(bool(torch.isfinite(got).all()), f"table3 {tf}: not finite")
        rel = _rel_norm(torch, got, want)
        check(rel <= PAPER_BLOCK_REL, f"table3 {tf}: the block on K9 / K10 "
              f"is {rel} from the plain block (bound {PAPER_BLOCK_REL})")
        out["rel_err"][tf] = rel
    parts = {f"block_{tf}": (lambda tf=tf: T3.block_forward(tf, x, w1, w2))
             for tf in ("none",) + T3.TRANSFORMS}
    parts.update({
        "k9_fwd_inv": lambda: hd.haar_dwt_seq(hd.haar_dwt_seq(x, 3), 3,
                                              inverse=True),
        "k10_seq_x2": lambda: wt.walsh_hadamard(wt.walsh_hadamard(x, -2), -2),
        "k10_feat_x2": lambda: wt.walsh_hadamard(wt.walsh_hadamard(x, -1),
                                                 -1),
        "gemms_silu": lambda: torch.nn.functional.silu(x @ w1) @ w2})
    for name, fn in parts.items():
        out["ms"][name] = timed(torch, fn, iters=20)
        out["graph_ms"][name] = timed_graph(torch, fn, 40, per_graph=10)
    # bounds: each transform call reads and writes x once (f32); the GEMMs
    # run in f32 outside the tensor cores (TF32 off), 2·M·N·K each
    b, s, d = x.shape
    io = 2 * x.numel() * x.element_size()
    out["bound_ms"] = {
        "k9_fwd_inv": bound(2 * io, 0, F32_FLOPS_PER_S),
        "k10_seq_x2": bound(2 * io, 0, F32_FLOPS_PER_S),
        "k10_feat_x2": bound(2 * io, 0, F32_FLOPS_PER_S),
        "gemms_silu": bound(io + (w1.numel() + w2.numel()) * 4,
                            4.0 * b * s * d * 4 * d, F32_FLOPS_PER_S)}
    return out


def rtn_codes_site(torch) -> dict:
    """A fused STaMP linear on 4-bit RTN weight codes (``w_quant``) at 256
    rows of 128 -> 256 on the card, beside the reference path on the same
    codes dequantized: the codes go through K1 -> K2 -> span link as they
    are."""
    import dataclasses as dc
    from repro_torch.core import quant as Q
    from repro_torch.core.stamp import StampConfig, stamp_linear
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn((1, 256, 128), generator=gen, device="cuda")
    wq = Q.rtn_quantize_weight(torch.randn((128, 256), generator=gen,
                                           device="cuda") * 0.05, bits=4)
    cfg = StampConfig(num_hi_tokens=64)
    return dict(name="rtn_w4_codes",
                ref=stamp_linear(x, None, None, cfg, w_quant=wq),
                fused=stamp_linear(x, None, None,
                                   dc.replace(cfg, execution="fused"),
                                   w_quant=wq))


def paper_phase(torch, ops, hd, wt) -> dict:
    """The paper runners of ``repro_torch.paper.run`` on the card at the
    reference's sizes (Tables 1, 3, 4, Figs. 3, 4b, 7; Table 2 runs in the
    train phase) and a fused linear
    on RTN codes (:func:`rtn_codes_site`, which must launch each of
    ``RTN_CODES_KERNELS``), every kernel's launch count set to 0 just
    before and read just after; then each accuracy row held against the
    same row of the CPU plain path (``sqnr_db`` within ``PAPER_SQNR_DB``;
    Fig. 3's host statistics equal), Table 4's fused sites (K1 -> K2 ->
    the span link at 256 rows, the gate/up pair through the dual link) and
    the linear on RTN codes against the port's reference path on the card
    (within ``PAPER_FUSED_REL`` relative), and Table 3's block against its
    plain version (:func:`table3_parts`).  Prints ``[paper]`` lines and
    the phase's seconds."""
    import importlib
    from repro_torch.paper import run as paper_run
    from repro_torch.paper import table3_overhead as T3
    from repro_torch.paper import table4_sites as T4
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    # Table 2 trains its LM first: the train phase runs it (with autograd,
    # which this phase's inference mode refuses) and holds it card vs CPU
    mods = {name.rsplit(".", 1)[1]: importlib.import_module(name)
            for name in paper_run.MODULES if not name.endswith("table2_llm")}
    ops.reset_launch_counts()
    card = {}
    for name, m in mods.items():
        if m is T4:             # the same rows as T4.run, its sites kept
            sites = T4.fused_sites(dev)
            card[name] = T4.ablation_rows(dev) + T4.fused_site_rows(sites)
        else:
            card[name] = m.run(device=dev)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    sites.append(rtn_codes_site(torch))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    rtn = {k: counts[k] - before[k] for k in counts}
    check(all(rtn[k] > 0 for k in RTN_CODES_KERNELS),
          f"paper rtn_w4_codes: the fused linear on RTN codes launched "
          f"{rtn}, not each of {sorted(RTN_CODES_KERNELS)}")
    run_s = time.perf_counter() - t0
    worst = 0.0
    for name, m in mods.items():
        if name == "table3_overhead":
            continue            # no accuracy rows: held by table3_parts
        cpu = m.run(device="cpu")
        check([r["name"] for r in card[name]] == [r["name"] for r in cpu],
              f"paper {name}: card and CPU rows differ in name")
        for g, c in zip(card[name], cpu):
            sg, sc = _sqnr_of(g["derived"]), _sqnr_of(c["derived"])
            if sg is None:
                check(name != "fig3_energy" or g["derived"] == c["derived"],
                      f"paper {g['name']}: {g['derived']} on the card, "
                      f"{c['derived']} on the CPU")
                continue
            worst = max(worst, abs(sg - sc))
            check(abs(sg - sc) <= PAPER_SQNR_DB,
                  f"paper {g['name']}: sqnr {sg} dB on the card, {sc} on "
                  f"the CPU (bound {PAPER_SQNR_DB})")
    fused = {}
    for site in sites:
        check(bool(torch.isfinite(site["fused"]).all()),
              f"paper fused {site['name']}: not finite")
        rel = _rel_norm(torch, site["fused"], site["ref"])
        check(rel <= PAPER_FUSED_REL, f"paper fused {site['name']}: {rel} "
              f"from the reference path (bound {PAPER_FUSED_REL})")
        fused[site["name"]] = rel
    parts = table3_parts(torch, T3, hd, wt)
    for name, rows in card.items():
        for r in rows:
            print(f"[paper] {json.dumps(r)}")
    print(f"[paper] {json.dumps({'fused_rel_err': fused})}")
    print(f"[paper] {json.dumps({'table3_parts': parts})}")
    print(f"[paper] {json.dumps({'launches': counts})}")
    print(f"[paper] card rows in {run_s:.1f}s; sqnr card vs CPU within "
          f"{worst:.4f} dB (bound {PAPER_SQNR_DB}); phase "
          f"{time.perf_counter() - t0:.1f}s")
    return counts


# ---------------------------------------------------------- train phase --

# minicpm-2b whole at full width (40 layers, d 2304, padded vocab 122880)
# trains TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens under its WSD
# schedule; the card-vs-CPU step cuts it to STEP_LAYERS layers and one row
# of STEP_SEQ tokens
TRAIN_ARCH = "minicpm-2b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 10, 4, 512
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
STEP_LAYERS, STEP_SEQ, STEP_LR = 2, 128, 3e-4
# card against CPU after one step: loss and grad norm relative, every
# parameter within 2 lr of the CPU's (AdamW's first step moves an element
# by lr·g / (|g| + eps): about lr, either way for a gradient within the
# devices' bf16 noise of zero) and all but STEP_FLIP_FRAC within lr (the
# full vocabulary's tied head gives most embedding rows gradients near
# eps, whose steps differ in their last digits: 14% of the elements sat
# more than 1e-3 lr apart and 0.09% more than lr on an NVIDIA H100 80GB
# HBM3 at 700.00 W)
STEP_LOSS_REL, STEP_GNORM_REL, STEP_FLIP_FRAC = 2e-3, 3e-2, 0.02
# Table 2's rows card against CPU on the card-trained parameters;
# FlatQuant-lite's rows within the paper phase's bound (its 100 Adam steps
# take the devices' last bits to other fits: 0.02 dB apart on an NVIDIA
# H100 80GB HBM3 at 700.00 W); perplexities within 5× their measured gap
# (3.0e-4 there), A4 with STaMP apart from A4 uniform by more (0.48%
# there) and the three in the CPU's order
TABLE2_SQNR_DB, TABLE2_PPL_REL = 0.01, 1.5e-3
# steps of the full-width model profiled after its run
PROFILE_STEPS = 2
# the reference test's crash-and-restart run, on the card
RESUME_ARGS = ["--arch", TRAIN_ARCH, "--reduced", "--steps", "12",
               "--global-batch", "2", "--seq", "64", "--ckpt-every", "4"]


def train_full_width(torch, configs, TTRAIN) -> dict:
    """The trainer's entry point on minicpm-2b whole: every loss finite,
    the last below the first; median step ms, tokens/s, peak memory."""
    from repro_torch import tree as TR
    cfg = configs.get_config(TRAIN_ARCH)
    check(cfg.schedule == "wsd", f"{TRAIN_ARCH} trains with {cfg.schedule}")
    tc = TTRAIN.TrainConfig(steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                            seq=TRAIN_SEQ, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                            log_every=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = TTRAIN.train(cfg, tc, verbose=True, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in TR.leaves(out["params"]))
    losses, times = out["losses"], out["step_times"]
    crcs = leaf_crcs(out["params"])
    profile = profile_steps(torch, TTRAIN, cfg, tc, out)
    flops = flop_count_step(torch, TTRAIN, cfg, tc, out)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x)
                                            for x in losses),
          f"{TRAIN_ARCH} training: losses {losses}")
    check(losses[-1] < losses[0],
          f"{TRAIN_ARCH} training: the loss did not fall ({losses})")
    med = sorted(times[1:])[len(times[1:]) // 2]
    row = dict(arch=TRAIN_ARCH, layers=cfg.num_layers, d_model=cfg.d_model,
               padded_vocab=cfg.padded_vocab, params=n_params,
               steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               first_step_ms=times[0] * 1e3, median_step_ms=med * 1e3,
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / med,
               peak_gib=peak, base_gib=base, first_loss=losses[0],
               last_loss=losses[-1], run_s=run_s, flop_counter_flops=flops)
    print(f"[train] {json.dumps(row)}")
    print(f"[train] losses {json.dumps(losses)}")
    return dict(row, losses=losses, crcs=crcs, profile=profile)


def leaf_crcs(tree) -> dict:
    """Each leaf's CRC32 by path, gathered whole where it is sharded
    (copied to the host one leaf at a time, summed in eight threads)."""
    import zlib
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch import sharding as SH
    from repro_torch import tree as TR
    with ThreadPoolExecutor(8) as pool:
        crcs = {TR.path_name(path): pool.submit(
            zlib.crc32, SH.gather_full(t).detach().cpu().contiguous()
            .numpy()) for path, t in TR.flatten_with_paths(tree)}
        return {k: f.result() for k, f in crcs.items()}


def profile_steps(torch, TTRAIN, cfg, tc, out, policy=None,
                  tag: str = "[train]") -> dict:
    """``PROFILE_STEPS`` more steps of the trained model under
    ``torch.profiler``: the device's busy and idle share of their wall
    time, the ops that take the most device time, and the collectives
    (NCCL kernels on the device, ``c10d`` calls on the host) a step.
    Under a sharding ``policy`` each step takes its rows of the batch."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import optim
    from repro_torch.data.pipeline import DataConfig, DataIterator
    sched = optim.make_schedule(cfg.schedule, tc.lr, tc.warmup, tc.steps)
    step = TTRAIN.build_step(cfg, policy, optim.AdamWConfig(
        lr=tc.lr, schedule=sched), False)
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=tc.seq,
                                   global_batch=tc.global_batch), step=tc.steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            batch = next(data)
            if policy is not None:
                batch = policy.batch_rows(batch)
            batch = {k: torch.from_numpy(v).cuda() for k, v in
                     batch.items()}
            m = step(out["params"], out["opt_state"], None, batch)[3]
            float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    # the device's busy time: its kernels' spans; the ops: host-side
    # events, each with the device time of the kernels it launched
    events = prof.events()
    busy = sum(e.time_range.elapsed_us() for e in events
               if e.device_type.name == "CUDA") / 1e6
    top = sorted((e for e in prof.key_averages()
                  if e.device_type.name == "CPU"), key=dev,
                 reverse=True)[:12]
    nccl = [e for e in events if "nccl" in e.name.lower()]
    row = dict(steps=PROFILE_STEPS, wall_ms=wall * 1e3 / PROFILE_STEPS,
               device_busy_ms=busy * 1e3 / PROFILE_STEPS,
               idle_share=1 - busy / wall,
               nccl_kernels_per_step=sum(
                   e.device_type.name == "CUDA" for e in nccl) / PROFILE_STEPS,
               collective_calls_per_step=sum(
                   e.device_type.name == "CPU" and e.name.startswith("c10d::")
                   for e in events) / PROFILE_STEPS,
               nccl_names=sorted({e.name for e in nccl})[:8],
               top=[(e.key, round(dev(e) / 1e3 / PROFILE_STEPS, 3), e.count)
                    for e in top])
    print(f"{tag} profile {json.dumps(row)}")
    check(busy <= wall, f"profile: the device's kernels span {busy:.3f} s "
          f"of a {wall:.3f} s wall")
    return row


def flop_count_step(torch, TTRAIN, cfg, tc, out) -> int:
    """``FlopCounterMode``'s count of one more step of the trained model
    (the dry run's yardstick: :func:`dryrun_phase`)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch import optim
    from repro_torch.data.pipeline import DataConfig, DataIterator
    sched = optim.make_schedule(cfg.schedule, tc.lr, tc.warmup, tc.steps)
    step = TTRAIN.build_step(cfg, None, optim.AdamWConfig(
        lr=tc.lr, schedule=sched), False)
    data = DataIterator(DataConfig(vocab_size=cfg.vocab_size, seq_len=tc.seq,
                                   global_batch=tc.global_batch),
                        step=tc.steps + PROFILE_STEPS)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
    with FlopCounterMode(display=False) as fc:
        step(out["params"], out["opt_state"], None, batch)
    torch.cuda.synchronize()
    return fc.get_total_flops()


def step_against_cpu(torch, lm, configs, TTRAIN, optim) -> dict:
    """One ``build_step`` of minicpm-2b at full width, cut to STEP_LAYERS
    layers, on the card and on the CPU from the same parameters and batch:
    loss, grad norm and the parameters after the step (untimed: it runs
    beside the crash-and-restart subprocesses)."""
    from repro_torch import tree as TR
    from repro_torch.data.pipeline import DataConfig, markov_batch
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              num_layers=STEP_LAYERS)
    sched = optim.make_schedule(cfg.schedule, STEP_LR, 1, 10)
    opt_cfg = optim.AdamWConfig(lr=STEP_LR, schedule=sched)
    init = lm.init_params(cfg, 0, device="cpu")
    data = markov_batch(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=STEP_SEQ, global_batch=1), 0)
    outs = {}
    for dev in ("cpu", "cuda"):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
        # a copy on each device: the step updates its parameters in place
        params = TR.tree_map(lambda t: t.to(dev, copy=True), init)
        for leaf in TR.leaves(params):
            leaf.requires_grad_(True)
        state = optim.adamw_init(params, opt_cfg)
        err = {"_": torch.zeros((), device=dev)}
        params, state, _, m = TTRAIN.build_step(cfg, None, opt_cfg, False)(
            params, state, err, batch)
        loss, gnorm, lr = (float(m["loss"]), float(m["grad_norm"]),
                           float(m["lr"]))
        outs[dev] = dict(params=to_device(params, "cpu"), loss=loss,
                         gnorm=gnorm, lr=lr)
        del params, state
        torch.cuda.empty_cache()
    cpu, card = outs["cpu"], outs["cuda"]
    flips = far = total = 0
    worst = 0.0
    for (path, a), (_, b) in zip(TR.flatten_with_paths(cpu["params"]),
                                 TR.flatten_with_paths(card["params"])):
        d = (a.detach().float() - b.detach().float()).abs()
        worst = max(worst, float(d.max()))
        flips += int((d > cpu["lr"]).sum())
        far += int((d > 1e-3 * cpu["lr"]).sum())
        total += d.numel()
    row = dict(arch=TRAIN_ARCH, layers=STEP_LAYERS, seq=STEP_SEQ,
               loss_cpu=cpu["loss"], loss_card=card["loss"],
               gnorm_cpu=cpu["gnorm"], gnorm_card=card["gnorm"],
               lr=cpu["lr"], max_param_diff=worst, flip_frac=flips / total,
               past_1e3_lr_frac=far / total)
    print(f"[train] step card vs CPU {json.dumps(row)}")
    check(abs(card["loss"] - cpu["loss"]) <= STEP_LOSS_REL * cpu["loss"],
          f"train step: loss {card['loss']} on the card, {cpu['loss']} on "
          f"the CPU")
    check(abs(card["gnorm"] - cpu["gnorm"]) <= STEP_GNORM_REL * cpu["gnorm"],
          f"train step: grad norm {card['gnorm']} on the card, "
          f"{cpu['gnorm']} on the CPU")
    check(card["lr"] == cpu["lr"] and
          worst <= 2 * cpu["lr"] * (1 + 1e-3) and
          flips <= STEP_FLIP_FRAC * total,
          f"train step: parameters after the step {worst} apart "
          f"({flips / total:.4f} past lr)")
    return row


def checkpoint_seconds(torch, lm, configs, optim) -> dict:
    """The checkpoint manager on the STEP_LAYERS cut's full training state
    (parameters and both moments, f32, on the card): the async save's host
    snapshot (what the training loop waits for), its background write, and
    a restore onto the card checked bit for bit."""
    import shutil
    import tempfile
    from repro_torch import tree as TR
    from repro_torch.checkpoint.manager import CheckpointManager
    cfg = dataclasses.replace(configs.get_config(TRAIN_ARCH),
                              num_layers=STEP_LAYERS)
    params = lm.init_params(cfg, 0, device="cuda")
    state = {"params": params,
             "opt": optim.adamw_init(params, optim.AdamWConfig())}
    nbytes = sum(t.numel() * t.element_size() for t in TR.leaves(state))
    tmp = tempfile.mkdtemp(prefix="ckpt_")
    try:
        mgr = CheckpointManager(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save_async(1, state, extra={"step": 1})
        snap = time.perf_counter() - t0
        mgr.wait()
        write = time.perf_counter() - t0 - snap
        t0 = time.perf_counter()
        back, extra = mgr.restore(state, device="cuda")
        torch.cuda.synchronize()
        restore = time.perf_counter() - t0
        check(extra == {"step": 1} and all(
            torch.equal(a, b) for a, b in zip(TR.leaves(state),
                                              TR.leaves(back))),
              "checkpoint: the restored state differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del state, back, params
    torch.cuda.empty_cache()
    row = dict(gib=nbytes / 2 ** 30, snapshot_s=snap, write_s=write,
               restore_s=restore)
    print(f"[train] checkpoint {json.dumps(row)}")
    return row


def resume_on_card(during=(None, None)) -> dict:
    """``tests/test_distributed.py``'s crash-and-restart run through
    ``python -m repro_torch.launch.train --device cuda``: the crash (exit
    17) and a clean run side by side, then the restart, which resumes from
    step 4; the final loss equal to the clean run's, and the last
    checkpoint's every leaf CRC too.  ``during[0]()`` runs in this process
    while the first two run, ``during[1]()`` while the restart does."""
    import os
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="resume_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cuda", *RESUME_ARGS]

    def start(name, *extra):
        return subprocess.Popen(base + ["--ckpt-dir", str(tmp / name),
                                        *extra], env=env, cwd=ROOT,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    procs = {}
    try:
        procs["crash"] = start("crash", "--fail-at-step", "6")
        procs["clean"] = start("clean")
        if during[0] is not None:
            during[0]()
        out = {k: p.communicate(timeout=300) for k, p in procs.items()}
        check(procs["crash"].returncode == 17,
              f"resume: the crash run exited {procs['crash'].returncode}: "
              f"{out['crash'][1][-800:]}")
        check(procs["clean"].returncode == 0,
              f"resume: the clean run failed: {out['clean'][1][-800:]}")
        procs["resumed"] = start("crash")
        if during[1] is not None:
            during[1]()
        out["resumed"] = procs["resumed"].communicate(timeout=300)
        check(procs["resumed"].returncode == 0,
              f"resume: the restart failed: {out['resumed'][1][-800:]}")
        check("[restore] resumed from step 4" in out["resumed"][0],
              "resume: the restart did not resume from step 4")
        final = {k: out[k][0].strip().splitlines()[-1]
                 for k in ("resumed", "clean")}
        crcs = {k: {n: v["crc32"] for n, v in json.loads(
            (tmp / d / "step_00000012" / "index.json").read_text()
        )["leaves"].items()} for k, d in (("resumed", "crash"),
                                          ("clean", "clean"))}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    check(final["resumed"].split()[2] == final["clean"].split()[2],
          f"resume: {final['resumed']!r} after the restart, "
          f"{final['clean']!r} clean")
    same = sum(crcs["resumed"][n] == c for n, c in crcs["clean"].items())
    check(same == len(crcs["clean"]),
          f"resume: {len(crcs['clean']) - same} of {len(crcs['clean'])} "
          f"leaves of the final checkpoint differ from the clean run's")
    row = dict(final=final["resumed"], leaves=len(crcs["clean"]),
               seconds=time.perf_counter() - t0)
    print(f"[train] resume on the card {json.dumps(row)}")
    return row


def table2_on_card(torch) -> dict:
    """Table 2 on the card (its LM trained there, 400 steps), then its
    evaluation on the card-trained parameters held against the same
    parameters on the CPU, QuaRot on the same signs: SQNR within
    TABLE2_SQNR_DB, perplexities within TABLE2_PPL_REL and in the CPU's
    order, A4 with STaMP apart from A4 uniform by more than that."""
    from repro_torch.core.feature_transforms import rademacher_signs
    from repro_torch.paper import table2_llm as T2
    t0 = time.perf_counter()
    params = T2._trained("cuda")
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    gen = torch.Generator()
    gen.manual_seed(1)
    signs = rademacher_signs(T2.CFG.d_model, gen)
    card = T2.evaluate(params, "cuda", signs=signs.cuda())
    cpu = T2.evaluate(to_device(params, "cpu"), "cpu", signs=signs)
    check([r["name"] for r in card] == [r["name"] for r in cpu],
          "table2: card and CPU rows differ in name")
    worst = {"sqnr_db": 0.0, "ppl": 0.0}
    for g, c in zip(card, cpu):
        kind, vg = g["derived"].split("=")
        vc = float(c["derived"].split("=")[1])
        err = abs(float(vg) - vc) if kind == "sqnr_db" else \
            abs(float(vg) - vc) / vc
        worst[kind] = max(worst[kind], err)
        bound = TABLE2_PPL_REL if kind == "ppl" else \
            PAPER_SQNR_DB if "flatquant" in g["name"] else TABLE2_SQNR_DB
        check(err <= bound, f"table2 {g['name']}: {g['derived']} on the "
              f"card, {c['derived']} on the CPU (bound {bound})")
        print(f"[table2] {json.dumps(g)}")
    ppl = {dev: {r["name"]: float(r["derived"].split("=")[1]) for r in rows
                 if "/ppl_" in r["name"]} for dev, rows in (("card", card),
                                                            ("cpu", cpu))}
    check(sorted(ppl["card"], key=ppl["card"].get)
          == sorted(ppl["cpu"], key=ppl["cpu"].get),
          f"table2: the card's perplexities {ppl['card']} stand in another "
          f"order than the CPU's {ppl['cpu']}")
    uni, stamp = (ppl["card"][f"table2/ppl_a4_{k}"] for k in ("uniform",
                                                              "stamp"))
    check(abs(uni - stamp) > TABLE2_PPL_REL * stamp,
          f"table2: A4 with STaMP ({stamp}) within the bound of A4 uniform "
          f"({uni})")
    T2._trained.cache_clear()
    row = dict(train_s=train_s, worst=worst,
               phase_s=time.perf_counter() - t0)
    print(f"[table2] card vs CPU {json.dumps(row)}")
    return row


def train_phase(torch, ops) -> dict:
    """The training path on the card (no kernel: training runs the plain
    PyTorch forward and its autograd, as the reference trains through
    plain XLA), every kernel's launch count set to 0 just before and read
    just after: minicpm-2b whole at full width, the checkpoint's seconds
    and Table 2, each alone on the card, then the crash-and-restart run's
    subprocesses with one step against the CPU beside them.  Returns the
    counts."""
    from repro_torch import configs, optim
    from repro_torch.launch import train as TTRAIN
    from repro_torch.models import lm
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    full = train_full_width(torch, configs, TTRAIN)
    checkpoint_seconds(torch, lm, configs, optim)
    table2_on_card(torch)
    # the crash-and-restart subprocesses (small, on the same card) run
    # beside the one step against the CPU, whose check is numerical only:
    # nothing timed above shares the card or the host with them
    resume_on_card((lambda: step_against_cpu(torch, lm, configs, TTRAIN,
                                             optim), None))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"[train] phase {time.perf_counter() - t0:.1f}s launches "
          f"{json.dumps(counts)}")
    return counts, full


# ---------------------------------------------------------- shard phase --

# the sharded trainer on a one-rank NCCL group: TRAIN_ARCH whole at full
# width, the train phase's run (TRAIN_STEPS steps of TRAIN_BATCH x
# TRAIN_SEQ tokens), through torchrun; its parameters must be the
# one-device run's bit for bit
SHARD_TIMEOUT_S = 600
# two ranks sharing the card: NCCL refuses them ("Duplicate GPU detected")
# and gloo takes CUDA tensors in every collective the step makes
# (tools/probe_gloo_cuda.py; the pair first checks the two the model
# split adds: all_reduce with MAX, and a bf16 sum), so the pair runs over
# gloo, by design: TRAIN_ARCH at full width cut to PAIR_LAYERS layers,
# PAIR_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens on a (1, 2) mesh (the
# model axis splits the compute: each rank its half of the linears, 18 of
# the 36 heads, half the vocabulary) and a (2, 1) mesh (the batch split),
# each held against the one-device step on rank 0: the loss within
# PAIR_LOSS_REL and the grad norm within PAIR_GNORM_REL each step, the
# parameters after the first within 2 lr and all but PAIR_FLIP_FRAC
# within lr, as the train phase holds its card-vs-CPU step (the CPU
# tests' 1e-3 lr does not carry to full width: the tied 122 880-row
# embedding's rows of tokens absent from the batch have gradients near
# zero, whose first AdamW steps take the data halves' bf16 roundings to
# other signs: 5.8% of the elements sat past 1e-3 lr on an NVIDIA H100
# 80GB HBM3 at 700.00 W).  Each rank's FlopCounterMode count of one step
# on the (1, 2) mesh must equal the dry run's of the same cell on a fake
# (1, 2) group, and its first step's peak above the training state must
# lie within DRYRUN_PEAK_REL of the dry run's temporaries (its peak less
# its arguments).
PAIR_LAYERS, PAIR_STEPS = 2, 3
PAIR_LOSS_REL, PAIR_GNORM_REL, PAIR_FLIP_FRAC = 1e-3, 1e-2, 0.02
PAIR_BOUNDS = dict(loss=PAIR_LOSS_REL, gnorm=PAIR_GNORM_REL,
                   flip=PAIR_FLIP_FRAC, grad=None)
# the Mamba pair (the mixers split over the model axis): MAMBA at
# full width on the (1, 2) mesh.  Training, cut to MAMBA_TRAIN_LAYERS of
# its 48 layers (all 48 took the phase to 123 s, its dry run's trace
# included):
# MAMBA_TRAIN_STEPS steps of TRAIN_BATCH x TRAIN_SEQ tokens, the loss and
# grad norm within MAMBA_TRAIN_BOUNDS of one device's (the CPU tests'
# bounds, each above the split's measured gap there in bf16: loss 7.0e-4,
# grad norm 1.3e-3, tests/test_torch_mamba_split.py); the parameters
# after the first step within 2 lr and all but its ``flip`` share within
# lr (1.1% measured at 16 layers, 2.6% at 48, on an NVIDIA H100 80GB
# HBM3 at 700.00 W); and, since AdamW's first step moves a parameter by
# about lr whatever its gradient's size, the first batch's gradient in
# f32 compute on both sides (as the CPU tests' witness), each leaf's and
# each part of in_proj's columns (z, x, B, C, dt) within ``grad`` of one
# device's in norm.  The CPU tests measured every leaf's f32 gap at
# 6.0e-6; a B or C column's gradient not summed over the ranks, or a
# replicated leaf's summed twice, moves its block by a large fraction of
# its norm.  (In bf16 compute a leaf's gradient is no witness: dt_bias's,
# a sum of cancelling terms, moved by 0.23 of its largest element on the
# CPU.)
MAMBA = "mamba2-1.3b"
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_STEPS = 16, 2
MAMBA_TRAIN_BOUNDS = dict(loss=2e-3, gnorm=4e-3, flip=0.05, grad=1e-3)


def shard_rank(plan: dict) -> None:
    """One rank of the shard phase's group (``chip_smoke.py --shard-rank
    PLAN``, under torchrun): ``train`` under the group's mesh, then its
    parameters' CRCs, its peak memory and bytes of training state, a
    profile of ``PROFILE_STEPS`` more steps, and the kernels' launch
    counts, written as one ``[shard-rank]`` line by rank 0."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch import sharding as SH
    from repro_torch import tree as TR
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TTRAIN
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    dev = init_distributed(plan["device"])
    try:
        cfg = configs.get_config(plan["arch"])
        tc = TTRAIN.TrainConfig(steps=plan["steps"],
                                global_batch=plan["batch"], seq=plan["seq"],
                                lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                log_every=1,
                                model_parallel=plan["model_parallel"])
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = TTRAIN.train(cfg, tc, verbose=False, device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        state = [out["params"], out["opt_state"]["m"], out["opt_state"]["v"]]
        state_gib = sum(SH.local(t).numel() * SH.local(t).element_size()
                        for tree in state for t in TR.leaves(tree)) / 2 ** 30
        t0 = time.perf_counter()
        crcs = leaf_crcs(out["params"])
        crc_s = time.perf_counter() - t0
        policy = SH.ShardingPolicy(mesh=make_local_mesh(tc.model_parallel,
                                                        dev))
        t0 = time.perf_counter()
        profile = profile_steps(torch, TTRAIN, cfg, tc, out, policy,
                                tag="[shard]")
        profile_s = time.perf_counter() - t0
        times = out["step_times"]
        med = sorted(times[1:])[len(times[1:]) // 2]
        row = dict(world=dist.get_world_size(),
                   mesh=list(policy.mesh.mesh.shape),
                   backend=dist.get_backend(), losses=out["losses"],
                   first_step_ms=times[0] * 1e3, median_step_ms=med * 1e3,
                   tokens_per_s=tc.global_batch * tc.seq / med,
                   peak_gib=peak, state_gib_per_rank=state_gib, run_s=run_s,
                   crc_s=crc_s, profile_s=profile_s, profile=profile,
                   launches=ops.launch_counts(), crcs=crcs)
        if dist.get_rank() == 0:
            rank_line(plan, "[shard-rank]", row)
    finally:
        dist.destroy_process_group()


def shard_pair(plan: dict) -> None:
    """One of two ranks sharing card 0 (``chip_smoke.py --shard-rank``
    with ``"pair"``, under torchrun) over gloo: ``build_step`` on each
    mesh of ``plan["meshes"]`` (model-parallel sizes), then rank 0 runs
    the one-device step from the same init and holds each mesh's run to
    it; each rank writes a ``[shard-pair]`` line (its bytes of training
    state and seconds), rank 0 the comparison."""
    import os
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import configs, optim
    from repro_torch import sharding as SH
    from repro_torch import tree as TR
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.kernels import ops
    from repro_torch.launch import train as TTRAIN
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    dev = torch.device(plan["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    from torch.utils.flop_counter import FlopCounterMode
    dist.init_process_group("gloo", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    rank = dist.get_rank()
    try:
        # the collectives the model split adds, on CUDA tensors
        hi = torch.full((3,), float(rank + 1), device=dev)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        half = torch.full((3,), 1.5 + rank, device=dev,
                          dtype=torch.bfloat16)
        dist.all_reduce(half)
        probe = dict(max=hi.tolist(), bf16_sum=half.float().tolist())
        rank_line(plan, "[shard-pair]", dict(rank=rank, probe=probe))
        check(probe == dict(max=[2.0] * 3, bf16_sum=[4.0] * 3),
              f"shard pair: gloo on CUDA tensors gave {probe}")
        cfg = dataclasses.replace(configs.get_config(plan["arch"]),
                                  num_layers=plan["layers"])
        opt_cfg = optim.AdamWConfig(lr=TRAIN_LR, schedule=optim.make_schedule(
            cfg.schedule, TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
        data = DataIterator(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=plan["seq"],
                                       global_batch=plan["batch"]))
        batches = [next(data) for _ in range(plan["steps"])]
        ops.reset_launch_counts()

        def run(policy) -> dict:
            params = lm.init_params(cfg, 0, device=dev)
            if policy is not None:
                params = policy.place(params, dev)
            for leaf in TR.leaves(params):
                leaf.requires_grad_(True)
            state = optim.adamw_init(params, opt_cfg)
            step = TTRAIN.build_step(cfg, policy, opt_cfg, False)
            out = {"metrics": [], "names": [
                TR.path_name(p) for p, _ in TR.flatten_with_paths(params)]}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for i, batch in enumerate(batches):
                if policy is not None:
                    batch = policy.batch_rows(batch)
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch.items()}
                params, state, _, m = step(params, state, None, batch)
                out["metrics"].append((float(m["loss"]),
                                       float(m["grad_norm"]),
                                       float(m["lr"])))
                if i == 0:
                    # the first step's peak above its arguments (the
                    # dry run's temporaries), before the whole
                    # parameters below are held on the card
                    out["peak_gib"] = (torch.cuda.max_memory_allocated()
                                       - base) / 2 ** 30
                    # a collective: every rank gathers
                    out["after1"] = [SH.gather_full(t).detach().clone()
                                     for t in TR.leaves(params)]
            out["seconds"] = time.perf_counter() - t0
            out["final"] = [SH.gather_full(t).detach().clone()
                            for t in TR.leaves(params)]
            with FlopCounterMode(display=False) as fc:
                step(params, state, None, batch)
            out["flops"] = fc.get_total_flops()
            out["state_gib"] = sum(
                SH.local(t).numel() * SH.local(t).element_size()
                for tree in (params, state["m"], state["v"])
                for t in TR.leaves(tree)) / 2 ** 30
            if (plan.get("bounds") or PAIR_BOUNDS)["grad"] is not None:
                del params, state
                out["grad_f32"] = grads_f32(policy)
            return out

        def grads_f32(policy) -> list:
            """The first batch's gradient of every leaf from the same
            init in f32 compute, gathered whole (a collective)."""
            params = lm.init_params(cfg, 0, device=dev)
            if policy is not None:
                params = policy.place(params, dev)
            leaves = TR.leaves(params)
            for leaf in leaves:
                leaf.requires_grad_(True)
            batch = batches[0]
            if policy is not None:
                batch = policy.batch_rows(batch)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            old, lm.COMPUTE_DTYPE = lm.COMPUTE_DTYPE, torch.float32
            try:
                grads = torch.autograd.grad(
                    lm.train_loss(params, batch, cfg, policy), leaves)
            finally:
                lm.COMPUTE_DTYPE = old
            return [SH.gather_full(g).detach() for g in grads]

        runs = {}
        for mp in plan["meshes"]:
            policy = SH.ShardingPolicy(mesh=make_local_mesh(mp, dev))
            name = "x".join(map(str, policy.mesh.mesh.shape))
            runs[name] = run(policy)
            mine = dict(rank=rank, mesh=name, seconds=runs[name]["seconds"],
                        state_gib=runs[name]["state_gib"],
                        peak_gib=runs[name]["peak_gib"],
                        flops=runs[name]["flops"])
            rank_line(plan, "[shard-pair]", mine)
            if rank != 0:
                runs[name] = None
        if rank == 0:
            one = run(None)
            parts = ([cfg.d_inner, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_state, cfg.ssm_heads]
                     if cfg.family in ("ssm", "hybrid") else None)
            rows = {name: pair_against_one_device(
                name, got, one, plan.get("bounds") or PAIR_BOUNDS,
                one["names"], parts) for name, got in runs.items()}
            row = dict(one_device_state_gib=one["state_gib"],
                       one_device_seconds=one["seconds"], meshes=rows,
                       launches=ops.launch_counts())
            rank_line(plan, "[shard-pair]", row)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def grad_block_rels(got: list, one: list, names: list, parts) -> dict:
    """The f32 gradient of each leaf against one device's, ``|got - one|
    / |one|`` in norm, ``in_proj``'s by its column parts ``z, x, B, C,
    dt`` (``parts``: their widths), as ``{name: rel}``."""
    out = {}
    for name, a, b in zip(names, got, one):
        blocks = [(name, a, b)]
        if parts is not None and name.endswith("in_proj"):
            blocks = [(f"{name}.{k}", x, y) for k, x, y in zip(
                ("z", "x", "B", "C", "dt"), a.split(parts, -1),
                b.split(parts, -1))]
        for key, x, y in blocks:
            den = float(y.float().norm())
            out[key] = float((x.float() - y.float()).norm()) / \
                (den if den > 0 else 1.0)
    return out


def pair_against_one_device(name: str, got: dict, one: dict,
                            bounds: dict, names: list,
                            parts=None) -> dict:
    """A pair run on mesh ``name`` held to the one-device run
    (``bounds``: :data:`PAIR_BOUNDS` or :data:`MAMBA_TRAIN_BOUNDS`): its
    loss and grad norm within ``loss`` / ``gnorm`` each step, its
    parameters after the first within 2 lr and all but a ``flip`` share
    within lr (the model axis's split, ``1x2``, sums row-parallel
    partials in another order; the batch's, ``2x1``, the data halves'
    gradients), and where ``grad`` is set each block of the first batch's
    f32 gradient (:func:`grad_block_rels`) within it.  Returns the worst
    numbers."""
    lr1 = one["metrics"][0][2]
    d1 = [(a - b).abs() for a, b in zip(got["after1"], one["after1"])]
    grad = {}
    if bounds["grad"] is not None:
        rels = grad_block_rels(got["grad_f32"], one["grad_f32"], names,
                               parts)
        kinds = {}
        for key, v in rels.items():
            kind = key.split("/")[-1]
            kinds[kind] = max(kinds.get(kind, 0.0), v)
        worst = max(rels, key=rels.get)
        grad = dict(grad_f32_max_rel=rels[worst], grad_f32_worst=worst,
                    grad_f32_rel_by_kind=kinds)
    row = dict(
        loss_rel=max(abs(a[0] - b[0]) / b[0]
                     for a, b in zip(got["metrics"], one["metrics"])),
        gnorm_rel=max(abs(a[1] - b[1]) / b[1]
                      for a, b in zip(got["metrics"], one["metrics"])),
        final_max_ulp=max(float((a - b).abs().max()) /
                          (2.0 ** -23 * max(float(b.abs().max()), 1e-30))
                          for a, b in zip(got["final"], one["final"])),
        after1_max_over_lr=max(float(d.max()) for d in d1) / lr1,
        after1_past_lr_frac=sum(int((d > lr1).sum()) for d in d1) /
        sum(d.numel() for d in d1),
        after1_past_1e3_lr_frac=sum(int((d > 1e-3 * lr1).sum())
                                    for d in d1) /
        sum(d.numel() for d in d1),
        **grad,
        losses=[m[0] for m in got["metrics"]],
        one_device_losses=[m[0] for m in one["metrics"]])
    print(f"[shard] pair {json.dumps(dict(mesh=name, **row))}", flush=True)
    check(row["loss_rel"] <= bounds["loss"] and
          row["gnorm_rel"] <= bounds["gnorm"]
          and row["after1_max_over_lr"] <= 2 * (1 + 1e-3) and
          row["after1_past_lr_frac"] <= bounds["flip"] and
          (bounds["grad"] is None or
           row["grad_f32_max_rel"] <= bounds["grad"]),
          f"shard pair {name}: {row}")
    return row


def pair_dry_run(arch: str = TRAIN_ARCH, layers: int = PAIR_LAYERS) -> dict:
    """The dry run of the pair's cell (``arch`` at full width cut to
    ``layers`` layers, TRAIN_BATCH x TRAIN_SEQ tokens) on rank 0 of a
    fake (1, 2) group: dot FLOPs a rank, peak, its temporaries (the peak
    less the arguments: parameters, moments, batch), what splits."""
    from repro_torch import configs
    from repro_torch.analysis import opstats as OS
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.config import ShapeConfig
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers)
    rec = DR.lower_cell(arch, None, multi_pod=False, cfg=cfg,
                        shape=ShapeConfig("pair", TRAIN_SEQ, TRAIN_BATCH,
                                          "train"), mesh_shape=(1, 2))
    check(rec["status"] == "ok" and rec["model_split"]["split"],
          f"shard: the pair's dry run {rec.get('status')} "
          f"{rec.get('model_split')}")
    return dict(dot_flops=OS.op_stats(rec["counter"].log())[
        "dot_flops_per_device"],
        peak_gib=rec["memory"]["peak_bytes_per_device"] / 2 ** 30,
        temp_gib=rec["memory"]["temp_bytes_per_device"] / 2 ** 30,
        model_split=rec["model_split"])


def rank_line(plan: dict, tag: str, row: dict) -> None:
    """A rank's result: one ``tag`` line appended to its own file in
    ``plan["out"]``.  The ranks share one stdout pipe, where two lines
    written at once can interleave."""
    import os
    with open(Path(plan["out"]) / f"rank{os.environ['RANK']}.jsonl",
              "a") as f:
        f.write(f"{tag} {json.dumps(row)}\n")


def torchrun(nproc: int, plan: dict, tag: str) -> list:
    """``chip_smoke.py --shard-rank PLAN`` in ``nproc`` ranks through
    ``torch.distributed.run --standalone``: the JSON of the ``tag`` lines
    its ranks wrote (:func:`rank_line`), rank by rank (its ``[shard]``
    lines echoed)."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory() as out:
        p = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(nproc), str(ROOT / "chip_smoke.py"),
             "--shard-rank", json.dumps(dict(plan, out=out))],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), cwd=ROOT,
            capture_output=True, text=True, timeout=SHARD_TIMEOUT_S)
        fails = [ln for ln in p.stderr.splitlines() if "FAIL" in ln]
        check(p.returncode == 0, f"shard: the torchrun group of {nproc} "
              f"failed ({p.returncode}): {fails} {p.stdout[-1500:]} "
              f"{p.stderr[-2000:]}")
        for line in p.stdout.splitlines():
            if line.startswith("[shard] "):
                print(line)
        lines = [line for path in sorted(Path(out).glob("rank*.jsonl"))
                 for line in path.read_text().splitlines()]
    return [json.loads(line.split(" ", 1)[1]) for line in lines
            if line.startswith(tag + " ")]


def shard_phase(torch, ops, one_device: dict) -> dict:
    """The sharded trainer through ``torch.distributed.run``.  One rank
    (NCCL, a ``(1, 1)`` mesh) at full width: its losses and every
    parameter's CRC32 equal to the one-device run's (``one_device``, the
    train phase's), its step ms, tokens/s, peak memory, idle share and
    collectives a step printed beside the one-device step's.  Then two
    ranks on the card (:func:`pair_phase`).  No kernel launched (the
    ranks' counts).  Returns the counts."""
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    rows = torchrun(1, dict(mode="one", arch=TRAIN_ARCH, steps=TRAIN_STEPS,
                            batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                            model_parallel=1, device="cuda"),
                    "[shard-rank]")
    check(len(rows) == 1, "shard: no [shard-rank] line")
    got = rows[0]
    crcs = got.pop("crcs")
    same = sum(crcs.get(k) == v for k, v in one_device["crcs"].items())
    row = dict(arch=TRAIN_ARCH, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
               seq=TRAIN_SEQ, leaves=len(one_device["crcs"]),
               leaves_bit_equal=same,
               sharded={k: got[k] for k in (
                   "world", "mesh", "backend", "first_step_ms",
                   "median_step_ms", "tokens_per_s", "peak_gib",
                   "state_gib_per_rank", "run_s", "crc_s", "profile_s")},
               one_device={k: one_device[k] for k in (
                   "first_step_ms", "median_step_ms", "tokens_per_s",
                   "peak_gib", "run_s")},
               idle_share={"sharded": got["profile"]["idle_share"],
                           "one_device": one_device["profile"]["idle_share"]},
               collectives_per_step={
                   k: got["profile"][k] for k in (
                       "nccl_kernels_per_step", "collective_calls_per_step")})
    print(f"[shard] one-rank NCCL group vs one device {json.dumps(row)}")
    check(got["backend"] == "nccl" and got["mesh"] == [1, 1],
          f"shard: ran on {got['backend']} over a {got['mesh']} mesh")
    check(got["losses"] == one_device["losses"],
          f"shard: losses {got['losses']} sharded, "
          f"{one_device['losses']} on one device")
    check(set(crcs) == set(one_device["crcs"]) and
          same == len(one_device["crcs"]),
          f"shard: {len(one_device['crcs']) - same} of "
          f"{len(one_device['crcs'])} parameters differ from the one-device "
          f"run's")
    check(got["profile"]["collective_calls_per_step"] > 0,
          "shard: the profile shows no collective")
    print(f"[shard] one rank: {time.perf_counter() - t0:.1f}s")
    pair = pair_phase()
    mamba = mamba_train_pair()
    counts = {k: ops.launch_counts()[k] + got["launches"][k] + pair[k]
              + mamba[k] for k in got["launches"]}
    print(f"[shard] phase {time.perf_counter() - t0:.1f}s launches "
          f"{json.dumps(counts)}")
    return counts


def pair_phase(arch: str = TRAIN_ARCH, layers: int = PAIR_LAYERS,
               steps: int = PAIR_STEPS, meshes=(2, 1), bounds=None,
               tag: str = "two ranks on the card (gloo)") -> dict:
    """Two ranks on the card over gloo (:func:`shard_pair`): the
    collectives the model split adds on CUDA tensors, then a ``(1, 2)``
    mesh (the model axis split) and a ``(2, 1)`` mesh (the batch split)
    against the one-device step, each rank's bytes of training state, peak
    above it in the first step and ``FlopCounterMode`` count, the
    ``(1, 2)`` count held equal to the dry run's (:func:`pair_dry_run`)
    and its peak within DRYRUN_PEAK_REL of the dry run's temporaries (its
    peak less its arguments: the card's peak is taken above the training
    state).  ``arch`` / ``layers`` / ``steps`` / ``meshes`` name another
    pair, held to ``bounds`` (:func:`pair_against_one_device`).  Returns
    the ranks' launch counts."""
    t1 = time.perf_counter()
    pair = torchrun(2, dict(mode="pair", arch=arch, layers=layers,
                            steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                            meshes=list(meshes), device="cuda",
                            bounds=bounds), "[shard-pair]")
    probes = [r for r in pair if "probe" in r]
    ranks = [r for r in pair if "mesh" in r]
    one = [r for r in pair if "meshes" in r]
    check(len(probes) == 2 and len(ranks) == 2 * len(meshes) and
          len(one) == 1, f"shard: the pair printed {len(pair)} lines")
    print(f"[shard] gloo on CUDA tensors {json.dumps(probes)}")
    one = one[0]
    dry = pair_dry_run(arch, layers)
    for name, cmp in one["meshes"].items():
        mine = [r for r in ranks if r["mesh"] == name]
        row = dict(arch=arch, layers=layers, steps=steps,
                   mesh=name, **cmp,
                   state_gib_per_rank=[r["state_gib"] for r in mine],
                   peak_gib_per_rank=[r["peak_gib"] for r in mine],
                   flops_per_rank=[r["flops"] for r in mine],
                   seconds=max(r["seconds"] for r in mine),
                   one_device_state_gib=one["one_device_state_gib"])
        if name == "1x2":
            row.update(dry_run_flops=dry["dot_flops"],
                       dry_run_peak_gib=dry["peak_gib"],
                       dry_run_temp_gib=dry["temp_gib"],
                       peak_rel=[r["peak_gib"] / dry["temp_gib"] - 1
                                 for r in mine],
                       model_split=dry["model_split"])
            check(all(r["flops"] == dry["dot_flops"] for r in mine),
                  f"shard pair 1x2: FlopCounterMode counted "
                  f"{row['flops_per_rank']} a rank, the dry run "
                  f"{dry['dot_flops']}")
            check(all(abs(r) <= DRYRUN_PEAK_REL for r in row["peak_rel"]),
                  f"shard pair 1x2: the first step's peak "
                  f"{row['peak_gib_per_rank']} GiB a rank above the state, "
                  f"the dry run's temporaries {dry['temp_gib']:.3f} GiB")
        print(f"[shard] {tag} {json.dumps(row)}")
    print(f"[shard] {tag}: {time.perf_counter() - t1:.1f}s")
    return one["launches"]


def mamba_train_pair() -> dict:
    """The Mamba pair's training (:func:`pair_phase`): MAMBA at full
    width, MAMBA_TRAIN_LAYERS layers, MAMBA_TRAIN_STEPS steps of TRAIN_BATCH x
    TRAIN_SEQ tokens on the ``(1, 2)`` mesh against one device's steps on
    rank 0, held within MAMBA_TRAIN_BOUNDS, its ``FlopCounterMode`` count
    a rank the dry run's (``[shard] mamba pair train`` lines).  Returns
    the ranks' launch counts."""
    return pair_phase(MAMBA, MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_STEPS, (2,),
                      MAMBA_TRAIN_BOUNDS, "mamba pair train")


# ------------------------------------------------------- serve pair ----

# serving split over the model axis (lm.prefill / lm.decode_step under a
# policy): two gloo ranks sharing the card on a (1, 2) mesh, llama3-8b at
# full width cut to PAIR_LAYERS layers, fused STaMP with int8 weights
# prepared whole and cut to each rank's blocks, the decode matmul K3 and
# the packed-cache attention K6; a prompt of each of SERVE_PROMPTS tokens
# (320: the long-span chain) then SERVE_STEPS teacher-forced decode steps.
# Rank 0 holds the pair against one device, at the served 8/4-bit mix and
# with every row at 8 bits: the prefill logits equal (each row-parallel
# site's K2 int32 parts summed, then one epilogue: one device's bits),
# every step's within SERVE_LOGIT_REL of the largest one-device logit,
# the greedy token equal wherever the one-device top-1 / top-2 margin
# exceeds SERVE_MARGIN.  On each rank the row-parallel sites' K1 codes
# (statistics mode, gloo's all-reduce, K1 with them) equal the whole
# rows' block exactly, and so does the block's K1 -> K2 product (K2's
# parts, gloo's integer all-reduce, K2's summed mode), and its
# FlopCounterMode count of the dry run's serve cells (make_serve_config,
# packed weights placed by the rule table) equals the dry run's on a fake
# (1, 2) group
SERVE_PROMPTS, SERVE_STEPS = (128, 320), 16
# (measured, NVIDIA H100 80GB HBM3, 700.00 W: prefill 0 at every setting;
# with the decode steps 8-bit 0.0063 / 0.0098, the mix 0 / 0 at 128 / 320
# tokens, since wo and down sum K3's int32 parts before one epilogue;
# f32 parts summed gave 0.0098–0.0215.  Decode's one sum still in
# another order: K6's block states merged over the ranks move a bf16
# step now and then, which the next quantizer may turn into a code.)
SERVE_LOGIT_REL = 3e-2
SERVE_MARGIN = 0.1
SERVE_PAIR_KERNELS = {"stamp_transform_quantize", "stamp_int_gemm",
                      "stamp_decode_matmul", "cache_decode_attention",
                      "stamp_span_transform"}
# the Mamba serve pair (MAMBA at full width cut to MAMBA_SERVE_LAYERS of
# its 48 layers — all 48 took the phase to 88 s, its 64 decode steps'
# 9216 gloo collectives most of it — the fused execution over int8
# weights prepared whole and cut by part):
# prompts of 128 and 512 tokens (the SSD takes a prompt of at most one
# 256-token chunk or whole chunks, as the reference's does: 320 is
# refused; 512 runs K2's long-span chain and the link), then SERVE_STEPS
# teacher-forced decode steps, at the served mix and at 8 bits.  Rank 0
# holds every step's logits equal to one device's (the CPU tests measured
# 0 at every mesh; the gated norm's per-head sums are gathered and summed
# as one device sums them, and each row-parallel out_proj sums K2's or
# K3's int32 parts before one epilogue, so nothing is summed in another
# order), the greedy tokens, and its first layer's SSM state and conv
# tail blocks one device's slices bit for bit; each rank's first in_proj
# K1 codes one device's and its out_proj K1 codes and K1 -> K2 product
# the whole rows'.  No attention: K6 is not on this path.
MAMBA_PROMPTS, MAMBA_SERVE_LAYERS = (128, 512), 24
MAMBA_PAIR_KERNELS = {"stamp_transform_quantize", "stamp_int_gemm",
                      "stamp_decode_matmul", "stamp_span_transform"}
SERVE_FLOP_CELLS = {"prefill": (SERVE_PROMPTS[0], 1),
                    "decode": (SERVE_PROMPTS[0] + SERVE_STEPS, 1)}


def _mode_counts(ops) -> dict:
    """Every wrapper's launches, and its launches in a mode."""
    return {f"{k.__name__}.{a}": v for k in ops.KERNELS
            for a, v in vars(k).items() if a.endswith("launches")}


def serve_rank_run(torch, lm, params, cfg, serve, tokens, forced,
                   policy=None) -> tuple:
    """Prefill ``tokens`` (1, s), then the ``forced`` tokens a step: the
    (steps + 1, 1, V) logits and the first layer's cache entry after the
    prefill."""
    logits, cache = lm.prefill(params, tokens, cfg, serve, policy=policy)
    first = {k: v.clone() for k, v in cache[0].items()}
    out = [logits]
    s = tokens.shape[1]
    for i, tok in enumerate(forced):
        logits, cache = lm.decode_step(params, cache, tok, s + i, cfg, serve,
                                       policy=policy)
        out.append(logits)
    return torch.stack(out), first


def serve_flop_cell(torch, lm, LS, cfg, policy, dev, kind: str) -> int:
    """``FlopCounterMode``'s count of the dry run's serve cell ``kind``
    (:data:`SERVE_FLOP_CELLS`) on this rank: ``make_serve_config``, the
    packed bf16 parameters placed by the rule table."""
    from torch.utils.flop_counter import FlopCounterMode
    seq, b = SERVE_FLOP_CELLS[kind]
    serve = dataclasses.replace(LS.make_serve_config(cfg),
                                cache_capacity=seq)
    params = lm.init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
    params["layers"] = [lm.quantize_weights_for_serving(p, 4)
                        for p in params["layers"]]
    params = policy.place(params, dev)
    with FlopCounterMode(display=False) as fc:
        if kind == "prefill":
            lm.prefill(params, torch.zeros((b, seq), dtype=torch.int32,
                                           device=dev), cfg, serve,
                       policy=policy, global_batch=b)
        else:
            cache = lm.init_cache(cfg, b, seq, serve, dev,
                                  group=policy.seq_group(b),
                                  split=policy.model_split())
            lm.decode_step(params, cache, torch.zeros(b, dtype=torch.int32,
                                                      device=dev),
                           seq - 1, cfg, serve, policy=policy,
                           global_batch=b)
    return fc.get_total_flops()


def serve_pair(plan: dict) -> None:
    """One of two ranks sharing card 0 over gloo (``chip_smoke.py
    --shard-rank`` with ``"serve"``, under torchrun): the split serve
    path (launch counts set to 0 before it and read after), the
    row-parallel K1 codes against the whole rows', the dry run's serve
    cells under ``FlopCounterMode``; rank 0 then the one-device run and
    the comparison.  Each rank writes ``[serve-pair]`` lines."""
    import os
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch import sharding as SH
    from repro_torch.core.stamp import StampConfig, prepare_linear
    from repro_torch.kernels import ops
    from repro_torch.launch import specs as LS
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.serving.kvcache import KVCacheConfig
    dev = torch.device(plan["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    rank = dist.get_rank()
    cuda = dev.type == "cuda"
    try:
        with torch.no_grad():
            # (``reduced``: the arch's reduced config, a rehearsal on the
            # CPU)
            get = configs.get_reduced if plan.get("reduced") else \
                configs.get_config
            cfg = dataclasses.replace(get(plan["arch"]),
                                      num_layers=plan["layers"])
            policy = SH.ShardingPolicy(mesh=make_local_mesh(2, dev))
            split = policy.model_split()
            stamp = StampConfig(execution="fused", levels=None)
            whole = lm.init_params(cfg, 0, device=dev, dtype=torch.bfloat16)
            whole["layers"] = [lm.quantize_weights_for_serving(p, 4)
                               for p in whole["layers"]]
            mine = lm.prepare_fused_weights(whole, stamp, split)
            gen = torch.Generator().manual_seed(11)
            runs = []
            for s in plan["prompts"]:
                tokens = torch.randint(0, cfg.vocab_size, (1, s),
                                       generator=gen).to(dev)
                forced = torch.randint(0, cfg.vocab_size,
                                       (plan["steps"], 1),
                                       generator=gen).to(dev)
                # the served 8/4-bit mix, and every row at 8 bits (STaMP
                # and the cache), where a rounding moves no 4-bit code
                for mix, bits in (("mix", {}),
                                  ("8bit", dict(hi_bits=8, lo_bits=8))):
                    serve = lm.ServeConfig(
                        stamp=dataclasses.replace(stamp, **bits),
                        kv=KVCacheConfig(**bits),
                        cache_capacity=s + plan["steps"],
                        fused_cache_attention=True, fused_decode_matmul=True)
                    runs.append((mix, tokens, forced, serve))
            ops.reset_launch_counts()
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = [serve_rank_run(torch, lm, mine, cfg, serve, t, f, policy)
                   for _, t, f, serve in runs]
            if cuda:
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _mode_counts(ops)
            mamba = cfg.family == "ssm"
            # the row-parallel sites (wo over q_dim and down over d_ff, or
            # a Mamba mixer's out_proj over d_inner) at both prompts,
            # through gloo's all-reduces: the block's K1 codes the whole
            # rows', its product (K2's parts summed, then finished) the
            # whole rows' K1 -> K2
            codes = []
            g2 = torch.Generator(device=dev).manual_seed(12)
            sites = (("out_proj", cfg.d_inner),) if mamba else \
                (("wo", cfg.q_dim), ("down", cfg.d_ff))
            for name, k in sites:
                p = prepare_linear(torch.randn(
                    (k, cfg.d_model), generator=g2, device=dev) /
                    math.sqrt(k))
                bias = torch.randn((cfg.d_model,), generator=g2, device=dev)
                for s in plan["prompts"]:
                    x = torch.randn((1, s, k), generator=g2, device=dev,
                                    dtype=torch.bfloat16)
                    kw = dict(transform="dwt",
                              levels=stamp.resolved_levels(s),
                              skip_first=True, num_hi=64, hi_bits=8,
                              lo_bits=4)
                    qx, sx, zx = ops._quantize(x, **kw)
                    c0, c1 = split.block(k)
                    xb = x[..., c0:c1].contiguous()
                    q, sc, zp = ops._quantize(xb, **kw,
                                              row_minmax=split.minmax)
                    wq = p.qw[c0:c1].contiguous()
                    y = ops.stamp_quant_matmul(
                        xb, wq, p.sw, p.zw, wq.sum(dim=0, keepdim=True,
                                                   dtype=torch.int32),
                        bias, **kw, row_minmax=split.minmax,
                        sum_parts=split.sum)
                    one = ops.stamp_quant_matmul(x, p.qw, p.sw, p.zw,
                                                 p.qw_sum, bias, **kw)
                    codes.append(dict(site=name, rows=s, exact=bool(
                        torch.equal(q, qx[:, c0:c1]) and
                        torch.equal(sc, sx) and torch.equal(zp, zx)),
                        product_exact=bool(torch.equal(y, one))))
            if mamba:
                # the first layer's column-parallel in_proj at both
                # prompts, through the path's own functions (the
                # vocab-parallel embedding, then lm._mamba_in: ln1, K1 ->
                # K2 over this rank's parts): this rank's K1 codes one
                # device's, and its z / x B C / dt columns the matching
                # columns of one device's projection, bit for bit
                one0 = lm.prepare_fused_weights(
                    dict(whole, layers=whole["layers"][:1]),
                    stamp)["layers"][0]
                x0, x1 = split.block(cfg.d_inner)
                h0, h1 = split.block(cfg.ssm_heads)
                di = cfg.d_inner
                for _, t, _, serve in runs[::2]:
                    s = t.shape[1]
                    kw = dict(transform="dwt",
                              levels=serve.stamp.resolved_levels(s),
                              skip_first=True, num_hi=64, hi_bits=8,
                              lo_bits=4)
                    ln1 = whole["layers"][0]["ln1"].to(torch.bfloat16)
                    mine_e = lm._embed(mine, t, split)
                    one_e = lm._embed(whole, t)
                    got_q = ops._quantize(lm.L.rms_norm(mine_e, ln1,
                                                        cfg.norm_eps), **kw)
                    want_q = ops._quantize(lm.L.rms_norm(one_e, ln1,
                                                         cfg.norm_eps), **kw)
                    z, xbc, dt = lm._mamba_in(mine["layers"][0], mine_e,
                                              cfg, serve.stamp, False, split)
                    oz, oxbc, odt = lm._mamba_in(one0, one_e, cfg,
                                                 serve.stamp, False)
                    codes.append(dict(site="in_proj", rows=s, exact=all(
                        bool(torch.equal(a, b))
                        for a, b in zip(got_q, want_q)),
                        product_exact=bool(
                            torch.equal(z, oz[..., x0:x1]) and
                            torch.equal(xbc, torch.cat(
                                [oxbc[..., x0:x1], oxbc[..., di:]], -1)) and
                            torch.equal(dt, odt[..., h0:h1]))))
            flops = {kind: serve_flop_cell(torch, lm, LS, cfg, policy, dev,
                                           kind)
                     for kind in SERVE_FLOP_CELLS}
            rank_line(plan, "[serve-pair]", dict(
                rank=rank, seconds=seconds, launches=counts, codes=codes,
                flops=flops, peak_gib=torch.cuda.max_memory_allocated()
                / 2 ** 30 if cuda else None))
            if rank == 0:
                one_params = lm.prepare_fused_weights(whole, stamp)
                cmp = []
                for (mix, t, f, serve), (g, first) in zip(runs, got):
                    want, one_first = serve_rank_run(torch, lm, one_params,
                                                     cfg, serve, t, f)
                    block = None
                    if mamba:
                        # rank 0's heads and x channels: the first
                        # layer's state and conv tail blocks
                        h0, h1 = split.block(cfg.ssm_heads)
                        x0, x1 = split.block(cfg.d_inner)
                        block = bool(torch.equal(
                            first["state"], one_first["state"][:, h0:h1])
                            and torch.equal(first["conv"], torch.cat([
                                one_first["conv"][..., x0:x1],
                                one_first["conv"][..., cfg.d_inner:]], -1)))
                    top = want.topk(2, dim=-1).values
                    decisive = (top[..., 0] - top[..., 1]) > SERVE_MARGIN
                    diff = g.argmax(-1) != want.argmax(-1)
                    cmp.append(dict(
                        prompt=t.shape[1], bits=mix,
                        rel=float((g - want).abs().max() /
                                  want.abs().max()),
                        prefill_rel=float((g[0] - want[0]).abs().max() /
                                          want[0].abs().max()),
                        decisive=int(decisive.sum()),
                        misses=int((decisive & diff).sum()),
                        finite=bool(torch.isfinite(g).all()),
                        state_block_exact=block))
                rank_line(plan, "[serve-pair]", dict(one_device=cmp))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def serve_pair_dry_run(arch: str, layers: int) -> dict:
    """The dry run's serve cells of a pair (``arch`` at full width cut to
    ``layers`` layers, :data:`SERVE_FLOP_CELLS`) on rank 0 of a fake (1,
    2) group: dot FLOPs a rank, what splits and the cache's specs."""
    from repro_torch import configs
    from repro_torch.analysis import opstats as OS
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.config import ShapeConfig
    cfg = dataclasses.replace(configs.get_config(arch), num_layers=layers)
    out = {}
    for kind, (seq, b) in SERVE_FLOP_CELLS.items():
        rec = DR.lower_cell(arch, None, multi_pod=False, cfg=cfg,
                            shape=ShapeConfig(f"pair_{kind}", seq, b, kind),
                            mesh_shape=(1, 2))
        check(rec["status"] == "ok" and rec["model_split"]["split"],
              f"serve pair: the {kind} dry run {rec.get('status')} "
              f"{rec.get('model_split')}")
        out[kind] = dict(dot_flops=OS.op_stats(rec["counter"].log())[
            "dot_flops_per_device"], model_split=rec["model_split"],
            decode_kv_spec=rec.get("decode_kv_spec"),
            cache_specs=rec.get("cache_specs"))
    return out


# the modes each serve pair's path must launch: the row-parallel sites'
# K1 statistics / given and K2 parts / summed (prefill), K3's statistics
# / parts / summed (decode), and the llama pair's K6 block mode and merge
SPLIT_MODES = ("stamp_transform_quantize.stats_launches",
               "stamp_transform_quantize.given_launches",
               "stamp_int_gemm.parts_launches",
               "stamp_int_gemm.summed_launches",
               "stamp_decode_matmul.stats_launches",
               "stamp_decode_matmul.parts_launches",
               "stamp_decode_matmul.summed_launches")
SERVE_PAIRS = {
    "serve_pair": dict(arch="llama3-8b", layers=PAIR_LAYERS,
                       prompts=SERVE_PROMPTS, tag="serve pair",
                       modes=SPLIT_MODES + (
                           "cache_decode_attention.block_launches",
                           "cache_decode_attention.merge_launches")),
    "serve_pair_mamba": dict(arch=MAMBA, layers=MAMBA_SERVE_LAYERS,
                             prompts=MAMBA_PROMPTS, tag="mamba pair",
                             modes=SPLIT_MODES)}


def serve_pair_run(name: str) -> dict:
    """One serve pair of :data:`SERVE_PAIRS` (:func:`serve_pair`) on the
    card and its checks: the one-device comparison (llama's prefill
    logits bit for bit, the Mamba pair's every step's and its first
    layer's state and conv blocks bit for bit), the exact codes,
    each rank's FLOPs equal to the dry run's, a launch in each of its
    modes (``[shard] serve pair`` / ``[shard] mamba pair``).  Returns the
    pair's launch counts (both ranks')."""
    pair = SERVE_PAIRS[name]
    t0 = time.perf_counter()
    rows = torchrun(2, dict(mode="serve", arch=pair["arch"],
                            layers=pair["layers"],
                            prompts=list(pair["prompts"]),
                            steps=SERVE_STEPS, device="cuda"),
                    "[serve-pair]")
    ranks = [r for r in rows if "rank" in r]
    one = [r for r in rows if "one_device" in r]
    check(len(ranks) == 2 and len(one) == 1,
          f"{pair['tag']}: {len(rows)} lines from the ranks")
    dry = serve_pair_dry_run(pair["arch"], pair["layers"])
    launches = {}
    for r in ranks:
        for k, v in r["launches"].items():
            launches[k] = launches.get(k, 0) + v
    row = dict(arch=pair["arch"], layers=pair["layers"], mesh="1x2",
               prompts=pair["prompts"], steps=SERVE_STEPS,
               seconds=[r["seconds"] for r in ranks],
               peak_gib=[r["peak_gib"] for r in ranks],
               one_device=one[0]["one_device"], codes=ranks[0]["codes"],
               flops_per_rank={k: [r["flops"][k] for r in ranks]
                               for k in SERVE_FLOP_CELLS},
               dry_run={k: d["dot_flops"] for k, d in dry.items()},
               decode_kv_spec=dry["decode"]["decode_kv_spec"],
               model_split=dry["decode"]["model_split"],
               mode_launches={k: v for k, v in launches.items()
                              if not k.endswith(".launches")},
               phase_s=time.perf_counter() - t0)
    mamba = pair["arch"] == MAMBA
    if mamba:
        row["cache_specs"] = dry["decode"]["cache_specs"]
    print(f"[shard] {pair['tag']} {json.dumps(row)}")
    for r in ranks:
        check(all(c["exact"] and c["product_exact"] for c in r["codes"]),
              f"{pair['tag']}: rank {r['rank']}'s K1 codes or K1 -> K2 "
              f"product differ from the whole rows' {r['codes']}")
        for kind, d in dry.items():
            check(r["flops"][kind] == d["dot_flops"],
                  f"{pair['tag']}: rank {r['rank']} counted "
                  f"{r['flops'][kind]} {kind} FLOPs, the dry run "
                  f"{d['dot_flops']}")
    for c in one[0]["one_device"]:
        check(c["finite"] and c["prefill_rel"] == 0.0 and
              c["rel"] <= (0.0 if mamba else SERVE_LOGIT_REL) and
              c["misses"] == 0 and c["state_block_exact"] is not False,
              f"{pair['tag']} against one device: {c}")
        check(not mamba or c["state_block_exact"],
              f"{pair['tag']}: no state block compared {c}")
    for k in pair["modes"]:
        check(launches.get(k, 0) > 0, f"{pair['tag']}: no launch in {k}")
    return {k.split(".")[0]: v for k, v in launches.items()
            if k.endswith(".launches")}


def serve_pair_phase() -> dict:
    """Both serve pairs (:func:`serve_pair_run`), each its own path:
    ``{path: its launch counts}``."""
    return {name: serve_pair_run(name) for name in SERVE_PAIRS}


# --------------------------------------------------------- dryrun phase --

# the dry run's CLI on two production cells (subprocesses on the host,
# beside the card work below), then the dry run held against the card on
# the cells it can run whole: TRAIN_ARCH at full width on one device, no
# policy, the train phase's step (TRAIN_BATCH x TRAIN_SEQ, its numbers
# reused) and a prefill of as many tokens under make_serve_config (no
# fused kernel), timed here: FLOPs equal to FlopCounterMode's, the peak
# within DRYRUN_PEAK_REL of max_memory_allocated (less what was allocated
# before), the roofline's step time no longer than the measured step
DRYRUN_CLI = [("minicpm-2b", "train_4k", False),
              ("mamba2-1.3b", "long_500k", True)]
DRYRUN_PEAK_REL = 0.10
DRYRUN_TIMEOUT_S = 600
PREFILL_ITERS = 5


def dryrun_cli(out_dir: Path) -> list:
    """The dry run's CLI on each DRYRUN_CLI cell, one subprocess each,
    started together."""
    import os
    procs = []
    for arch, shape, multi_pod in DRYRUN_CLI:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out-dir", str(out_dir)]
        if multi_pod:
            cmd.append("--multi-pod")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   OMP_NUM_THREADS="1")
        procs.append((arch, shape, multi_pod, subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def dryrun_cli_rows(procs: list, out_dir: Path) -> list:
    """Each CLI cell's exit and record: ``ok`` on its mesh's ranks."""
    rows = []
    for arch, shape, multi_pod, proc in procs:
        try:
            log, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"dry run {arch} {shape}: over {DRYRUN_TIMEOUT_S} s")
        check(proc.returncode == 0, f"dry run {arch} {shape} exited "
              f"{proc.returncode}:\n{log[-3000:]}")
        mesh = "multipod" if multi_pod else "singlepod"
        rec = json.loads((out_dir / f"{arch}_{shape}_{mesh}.json")
                         .read_text())
        chips = 512 if multi_pod else 256
        check(rec["status"] == "ok" and rec["chips"] == chips,
              f"dry run {arch} {shape} {mesh}: {rec.get('status')} on "
              f"{rec.get('chips')} chips")
        check(rec["op_stats"]["dot_flops_per_device"] > 0 and
              rec["memory"]["peak_bytes_per_device"] >=
              rec["memory"]["argument_bytes_per_device"] > 0,
              f"dry run {arch} {shape} {mesh}: no products or memory "
              f"counted on {rec['device']}")
        r, m = rec["roofline"], rec["memory"]
        row = dict(arch=arch, shape=shape, mesh=mesh, chips=rec["chips"],
                   device=rec["device"], cell_s=rec["t_s"],
                   trace_s=rec["t_trace_s"], ops=rec["op_count"],
                   peak_gb=m["peak_bytes_per_device"] / 1e9,
                   dot_flops=rec["op_stats"]["dot_flops_per_device"],
                   collective_bytes=rec["op_stats"][
                       "collective_bytes_per_device"],
                   step_time_s=r["step_time_s"], bottleneck=r["bottleneck"],
                   useful_flops_ratio=r["useful_flops_ratio"])
        print(f"[dryrun] cli {json.dumps(row)}")
        rows.append(row)
    return rows


def prefill_on_card(torch, lm, S, cfg) -> dict:
    """``cfg``'s prefill of TRAIN_BATCH x TRAIN_SEQ tokens under
    ``make_serve_config`` on the card (bf16 parameters, int4 weights, as
    the dry run's ``serve_param_struct``): median ms of PREFILL_ITERS
    calls after a warm-up, the peak above what was allocated before the
    parameters, and ``FlopCounterMode``'s count of one call."""
    from torch.utils.flop_counter import FlopCounterMode
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = lm.init_params(cfg, 0, device="cuda", dtype=torch.bfloat16)
    params["layers"] = [lm.quantize_weights_for_serving(p, 4)
                        for p in params["layers"]]
    serve = S.make_serve_config(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                           generator=gen, device="cuda", dtype=torch.int32)
    with torch.no_grad():
        lm.prefill(params, tokens, cfg, serve)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(PREFILL_ITERS):
            t0 = time.perf_counter()
            lm.prefill(params, tokens, cfg, serve)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        with FlopCounterMode(display=False) as fc:
            lm.prefill(params, tokens, cfg, serve)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return dict(median_ms=sorted(times)[len(times) // 2] * 1e3,
                peak_gib=peak / 2 ** 30,
                flop_counter_flops=fc.get_total_flops())


def dryrun_phase(torch, ops, one_device: dict) -> dict:
    """The dry-run tools on the card's machine (no kernel: the dry run
    traces fake tensors and reaches no fused path; counts set to 0 just
    before and read just after): the CLI on DRYRUN_CLI, and the dry run
    of TRAIN_ARCH's train step and prefill at TRAIN_BATCH x TRAIN_SEQ on
    one device against the card's runs (``one_device``: the train
    phase's row), printed as ``[dryrun]`` lines.  Returns the counts and
    the rows."""
    import shutil
    import tempfile
    from repro_torch import configs
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import specs as S
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun_"))
    procs = dryrun_cli(out_dir)
    cfg = configs.get_config(TRAIN_ARCH)
    prefill = prefill_on_card(torch, lm, S, cfg)
    card = {"train": dict(median_ms=one_device["median_step_ms"],
                          peak_gib=one_device["peak_gib"]
                          - one_device["base_gib"],
                          flop_counter_flops=one_device[
                              "flop_counter_flops"]),
            "prefill": prefill}
    rows = {}
    for kind, measured in card.items():
        shape = ShapeConfig(f"card_{kind}", TRAIN_SEQ, TRAIN_BATCH, kind)
        rec = DR.analyze(DR.lower_cell(TRAIN_ARCH, None, multi_pod=False,
                                       cfg=cfg, shape=shape, sharded=False))
        stats, roof = rec["op_stats"], rec["roofline"]
        peak = rec["memory"]["peak_bytes_per_device"] / 2 ** 30
        bound_ms = roof["step_time_s"] * 1e3
        row = dict(kind=kind, arch=TRAIN_ARCH, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ, device=rec["device"],
                   dot_flops=stats["dot_flops_per_device"],
                   card_flop_counter=measured["flop_counter_flops"],
                   dot_flops_by_dtype=stats["dot_flops_by_dtype"],
                   hbm_bytes=stats["hbm_bytes_per_device"],
                   ops=rec["op_count"], peak_gib=peak,
                   card_peak_gib=measured["peak_gib"],
                   peak_rel=peak / measured["peak_gib"] - 1,
                   compute_ms=roof["compute_s"] * 1e3,
                   memory_ms=roof["memory_s"] * 1e3,
                   bound_ms=bound_ms, bottleneck=roof["bottleneck"],
                   card_ms=measured["median_ms"],
                   bound_frac=bound_ms / measured["median_ms"],
                   trace_s=rec["t_trace_s"])
        print(f"[dryrun] card {json.dumps(row)}")
        check(row["dot_flops"] == row["card_flop_counter"],
              f"dry run {kind}: {row['dot_flops']} dot FLOPs, "
              f"FlopCounterMode counted {row['card_flop_counter']} on the "
              f"card")
        check(abs(row["peak_rel"]) <= DRYRUN_PEAK_REL,
              f"dry run {kind}: peak {peak:.3f} GiB, the card's "
              f"{measured['peak_gib']:.3f} GiB")
        check(bound_ms <= measured["median_ms"],
              f"dry run {kind}: the roofline's {bound_ms:.1f} ms exceeds "
              f"the measured {measured['median_ms']:.1f} ms")
        rows[kind] = row
    # the same train cell on fake cpu tensors, as a CPU-only PyTorch
    # sweeps it: the same products, bytes less the host-to-device copies
    cpu = DR.analyze(DR.lower_cell(
        TRAIN_ARCH, None, multi_pod=False, cfg=cfg,
        shape=ShapeConfig("card_train", TRAIN_SEQ, TRAIN_BATCH, "train"),
        sharded=False, device="cpu"))["op_stats"]
    same = dict(dot_flops_equal=cpu["dot_flops_per_device"]
                == rows["train"]["dot_flops"],
                hbm_bytes_cuda_less_cpu=rows["train"]["hbm_bytes"]
                - cpu["hbm_bytes_per_device"])
    print(f"[dryrun] fake cpu vs fake cuda {json.dumps(same)}")
    check(same["dot_flops_equal"], "dry run: the fake cpu trace's FLOPs "
          "differ from the fake cuda trace's")
    cli = dryrun_cli_rows(procs, out_dir)
    shutil.rmtree(out_dir)
    counts = ops.launch_counts()
    print(f"[dryrun] phase {time.perf_counter() - t0:.1f}s launches "
          f"{json.dumps(counts)}")
    return counts, dict(rows, cli=cli)


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
    ``paged_decode_step``).  A Mamba layer carries each request's state in
    its slot row of the state pool (``pf_slots``, ``dec_active``).  Prefill
    logits and the live decode slots' logits agree within a bf16 tolerance
    of 5e-2."""
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
            pf_first=torch.ones(len(pf), dtype=torch.bool),
            pf_slots=torch.tensor(pf, dtype=torch.int32),
            dec_active=live,
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
            cfg, pcfg, device=device, num_slots=slots), []
        for inputs in plan:
            pf, dec, pools = lm.paged_unified_step(
                params, pools, **to_device(inputs, device), cfg=cfg,
                serve=serve)
            live = inputs["dec_active"]
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


# ------------------------------------------- the multimodal model API --


def multimodal_batch(torch, cfg, rows: int, prompt: int, seed: int) -> dict:
    """A CPU batch as the reference's entry points take it: ``prompt``
    seeded tokens a row and the config's stub frontend, unit-normal bf16
    embeddings at ``d_model`` — ``num_patches`` patch rows (put before the
    tokens), or ``prompt // frame_ratio`` frames for the encoder."""
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, prompt),
                                     generator=gen, dtype=torch.int32)}
    if cfg.frontend == "patch":
        batch["patches"] = torch.randn((rows, cfg.num_patches, cfg.d_model),
                                       generator=gen).to(torch.bfloat16)
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(
            (rows, max(prompt // cfg.frame_ratio, 1), cfg.d_model),
            generator=gen).to(torch.bfloat16)
    return batch


def multimodal_serving(torch, lm, ptq, pipeline, cfg, device,
                       num_hi: int) -> tuple:
    """Seeded bf16 init on ``device`` (layers drawn as they are reached),
    int4 weights and a fused ServeConfig with both kernel switches on.  An
    encoder-decoder stack is PTQ'd as the serve CLI does (2 calibration
    batches of 4 x 128 tokens) with 32 seeded frames a row beside them;
    a patch stack, whose PTQ raises on its batch as the reference's does,
    gets its config by hand, as the reference's model tests build one:
    ``num_hi`` rows at 8 bits, the rest and the lo cache at 4.  Returns
    ``(prepared params, serve config)``."""
    from repro_torch.core.stamp import StampConfig
    from repro_torch.serving.kvcache import KVCacheConfig
    params = lm.init_params(cfg, seed=0, device=device,
                            dtype=torch.bfloat16, lazy=True)
    if cfg.encoder_layers:
        calib = pipeline.calibration_batches(pipeline.DataConfig(
            vocab_size=cfg.vocab_size, seq_len=128, global_batch=4), 2)
        gen = torch.Generator().manual_seed(1)
        for b in calib:
            b["frames"] = torch.randn((4, 128 // cfg.frame_ratio,
                                       cfg.d_model), generator=gen).numpy()
        sparams, serve, _ = ptq.calibrate_and_quantize(params, calib, cfg,
                                                       device=device)
    else:
        layers = params.pop("layers")
        sparams = dict(params, layers=(lm.quantize_weights_for_serving(p)
                                       for p in layers))
        serve = lm.ServeConfig(
            stamp=StampConfig(num_hi_tokens=num_hi),
            kv=KVCacheConfig(quantized=True, num_hi=num_hi), weight_bits=4)
    del params
    serve = dataclasses.replace(
        serve, stamp=dataclasses.replace(serve.stamp, execution="fused"),
        fused_cache_attention=True, fused_decode_matmul=True)
    return lm.prepare_fused_weights(sparams, serve.stamp), serve


def model_api_run(torch, lm, params, cfg, serve, batch, steps: int,
                  feed=None, enc_out=None) -> list:
    """``lm.prefill`` of ``batch`` (on the encoder output ``enc_out`` where
    given) and ``steps`` ``lm.decode_step`` s at the positions after the
    prompt's rows (patch rows included), each fed the last logits' argmax
    or ``feed[n]``.  Returns every step's logits on the CPU."""
    logits, cache = lm.prefill(params, batch, cfg, serve, enc_out=enc_out)
    out = [logits.cpu()]
    rows = batch["tokens"].shape[1] + (cfg.num_patches
                                       if cfg.frontend == "patch" else 0)
    for n in range(steps):
        tok = out[-1].argmax(dim=-1).to(torch.int32) if feed is None \
            else feed[n]
        logits, cache = lm.decode_step(params, cache, tok.to(logits.device),
                                       rows + n, cfg, serve)
        out.append(logits.cpu())
    return out


def _rel(torch, got, want, base) -> float:
    """``|got - want| / |base|`` in the 2-norm, on the CPU in f32."""
    d = (got.cpu().float() - want.float()).norm()
    return float(d / torch.clamp_min(base.float().norm(), 1e-30))


def _prefill_blocks(lm, cfg, spec, p, stamp, kv, cap, enc) -> list:
    """A decoder layer's prefill as its sub-blocks ``[(name, fn(x) -> (y,
    cache entry or None))]``: self-attention (with the layer's quantized
    K/V), cross-attention over the encoder output ``enc`` (its bf16 ``xk``
    / ``xv``), the FFN."""
    blocks = [("attn", lambda x: lm.attn_block_prefill(p, x, cfg, stamp, kv,
                                                       cap))]
    if enc is not None and "xwq" in p:
        def cross(x):
            entry = {}
            return lm.cross_attn_block(p, x, enc, cfg, stamp, entry), entry
        blocks.append(("cross", cross))
    blocks.append(("ffn", lambda x: (lm.ffn_block(p, x, spec, cfg, stamp,
                                                  False), None)))
    return blocks


def prefill_blocks_against_cpu(torch, lm, cfg, cpu, card, serve, x, enc,
                               dev="cuda") -> list:
    """Every sub-block of every decoder layer's prefill under ``serve`` run
    on ``dev`` (kernels) and on the CPU (plain versions), both fed the
    CPU's input to it (teacher forcing: a code flipped upstream does not
    carry).  Per block: ``dev``, the distance between the two outputs over
    the block's update (``|y_card - y_cpu| / |y_cpu - x|``); ``ratio``,
    that distance over what activation quantization does to the block
    (``|y_card - y_cpu| / |y_cpu - y_plain|``, ``y_plain`` the block on
    the CPU without STaMP); ``quant``, that quantization's distance over
    the update (``|y_plain - y_cpu| / |y_cpu - x|``); ``codes``, the
    share of the K/V cache's code
    bytes that differ; ``xkv``, ``xk`` / ``xv``'s distance over their
    norm."""
    rows = []
    enc_d = None if enc is None else enc.to(dev)
    for i, (spec, p, pd) in enumerate(zip(cfg.layer_specs(), cpu["layers"],
                                          card["layers"])):
        args = (serve.kv, serve.cache_capacity)
        host = _prefill_blocks(lm, cfg, spec, p, serve.stamp, *args, enc)
        on = _prefill_blocks(lm, cfg, spec, pd, serve.stamp, *args, enc_d)
        plain = _prefill_blocks(lm, cfg, spec, p, None, None, None, enc)
        for (name, f), (_, g), (_, h) in zip(host, on, plain):
            y, e = f(x)
            yd, ed = g(x.to(dev))
            yp = h(x)[0]
            row = dict(block=f"{name}{i}", dev=_rel(torch, yd, y, y - x),
                       ratio=_rel(torch, yd, y, y - yp),
                       quant=_rel(torch, yp, y, y - x))
            if e is not None and "k_hi" in e:
                codes = [(ed[k].cpu() != e[k]).sum().item() / e[k].numel()
                         for k in ("k_hi", "v_hi", "k_lo", "v_lo")]
                row["codes"] = max(codes)
            if e is not None and "xk" in e:
                row["xkv"] = max(_rel(torch, ed[k], e[k], e[k])
                                 for k in ("xk", "xv"))
            rows.append(row)
            x = y
    return rows


def decode_blocks_against_cpu(torch, lm, cfg, cpu, card, serve, x, cache,
                              pos: int, dev="cuda") -> list:
    """One decode step's sub-blocks (attention over the cache, the FFN) of
    every layer on ``dev`` and on the CPU, both fed the CPU's input and a
    copy of the CPU's prefill cache entry (teacher forcing): per block
    ``dev``, the distance over the block's update, as in
    :func:`prefill_blocks_against_cpu`."""
    dm = serve.fused_decode_matmul
    rows = []
    for i, (spec, p, pd, e) in enumerate(zip(cfg.layer_specs(),
                                             cpu["layers"], card["layers"],
                                             cache)):
        blocks = (
            ("attn", lambda q, z, ent, at: lm.attn_block_cached_decode(
                q, z, cfg, serve, ent, torch.tensor(pos, dtype=torch.int32,
                                                     device=at), dm)),
            ("ffn", lambda q, z, ent, at: lm.ffn_block(q, z, spec, cfg,
                                                       None, dm)))
        for name, f in blocks:
            # the CPU's pad leaves some buffers strided; K6 takes dense ones
            ed = {k: v.to(dev).contiguous() for k, v in e.items()}
            y = f(p, x, {k: v.clone() for k, v in e.items()}, "cpu")
            yd = f(pd, x.to(dev), ed, dev)
            rows.append(dict(block=f"{name}{i}",
                             dev=_rel(torch, yd, y, y - x)))
            x = y
    return rows


def encoder_against_cpu(torch, lm, cfg, cpu, card, frames,
                        dev="cuda") -> tuple:
    """The encoder (plain PyTorch: no kernel) layer by layer on ``dev``
    and on the CPU, both fed the CPU's input to each layer and to the
    final norm: each output's distance over its norm.  Returns ``(the
    CPU's encoder output, the distances)``."""
    x, errs = frames.to(torch.bfloat16), []
    for p, pd in zip(cpu["encoder"]["layers"], card["encoder"]["layers"]):
        y = lm.encoder_layer(p, x, cfg)
        errs.append(_rel(torch, lm.encoder_layer(pd, x.to(dev), cfg), y, y))
        x = y
    def norm(t, w):
        return lm.L.rms_norm(t, w.to(t.dtype), cfg.norm_eps)

    y = norm(x, cpu["encoder"]["final_norm"])
    errs.append(_rel(torch, norm(x.to(dev), card["encoder"]["final_norm"]),
                     y, y))
    return y, errs


def check_model_api_against_cpu(torch, lm, cfg_mod, ptq, pipeline, arch,
                                dev="cuda") -> dict:
    """llava's or seamless's model API at its reduced size on ``dev``
    (kernels) against the CPU (plain versions), over the batches of seeds
    ``API_SEEDS`` (3 rows; llava: 16 patch rows and 16 tokens; seamless:
    32 tokens beside 8 frames).

    At the served mix (llava: 8 rows at 8 bits, the rest and the cache's
    lo rows at 4; seamless: its PTQ'd config), teacher-forced: every
    prefill sub-block within a quarter of what activation quantization
    does to it (``ratio`` ≤ 1/4), its K/V code bytes equal but for 1% at
    most, ``xk`` / ``xv`` within 2^-7 of their norm, and every decode
    sub-block within 2^-6 of its update (:func:`prefill_blocks_against_cpu`,
    :func:`decode_blocks_against_cpu`).  Whole steps are not compared at
    4 bits: a last-bit difference of the card's own cos or exp flips a
    4-bit code now and then, and flips carried through every later layer
    moved llava's reduced prefill logits by 0.68 (measured).

    At 8-bit activations and cache rows (``num_hi`` 32, every prompt row),
    whole: the prefill and two decode steps, both fed the CPU run's
    tokens, logits within 5e-2; the same sub-block readings are printed
    beside them.  Seamless's encoder is held layer by layer, teacher-
    forced, each output within 2^-7 of its norm
    (:func:`encoder_against_cpu`), and both devices' prefills take the
    CPU's encoder output (``lm.prefill``'s ``enc_out``).  Returns every
    reading."""
    cfg = cfg_mod.get_reduced(arch)
    prepared, served = multimodal_serving(torch, lm, ptq, pipeline, cfg,
                                          "cpu", num_hi=8)
    prompt = 32 - cfg.num_patches if cfg.frontend == "patch" else 32
    served = dataclasses.replace(served, cache_capacity=32 + 2)
    eight = dataclasses.replace(
        served, stamp=dataclasses.replace(served.stamp, num_hi_tokens=32,
                                          lo_bits=8),
        kv=dataclasses.replace(served.kv, num_hi=32))
    check(eight.kv.num_hi < eight.cache_capacity,
          f"{arch}: the cache's hi region fills it")
    card = to_device(prepared, dev)
    out = {}
    for seed in API_SEEDS:
        batch = multimodal_batch(torch, cfg, 3, prompt, seed=seed)
        x, enc = lm.embed_inputs(prepared, batch, cfg, encoder=False)
        read = {}
        if cfg.encoder_layers:
            enc, read["encoder"] = encoder_against_cpu(
                torch, lm, cfg, prepared, card, batch["frames"], dev)
            check(max(read["encoder"]) <= 2 ** -7,
                  f"{arch} seed {seed}: the encoder on the card is "
                  f"{read['encoder']} of its norm away from the CPU")
        for mix, serve in (("served", served), ("8bit", eight)):
            blocks = prefill_blocks_against_cpu(torch, lm, cfg, prepared,
                                                card, serve, x, enc, dev)
            logits, cache = lm.prefill(prepared, batch, cfg, serve,
                                       enc_out=enc)
            tok = logits.argmax(dim=-1).to(torch.int32)
            blocks += decode_blocks_against_cpu(
                torch, lm, cfg, prepared, card, serve, lm._embed(
                    prepared, tok[:, None]), cache, x.shape[1], dev)
            read[mix] = blocks
        for r in read["served"]:
            ok = r["ratio"] <= 0.25 if "ratio" in r else r["dev"] <= 2 ** -6
            ok &= r.get("codes", 0.0) <= 0.01 and r.get("xkv", 0.0) <= 2 ** -7
            check(ok, f"{arch} seed {seed}: served-mix block {r} on the card "
                      f"is too far from the CPU")
        ref = model_api_run(torch, lm, prepared, cfg, eight, batch, 2,
                            enc_out=enc)
        feed = [r.argmax(dim=-1).to(torch.int32) for r in ref[:2]]
        got = model_api_run(torch, lm, card, cfg, eight,
                            to_device(batch, dev), 2, feed,
                            enc_out=None if enc is None else enc.to(dev))
        read["logits"] = []
        for n, (want, have) in enumerate(zip(ref, got)):
            check(bool(torch.isfinite(have).all()),
                  f"{arch} seed {seed} step {n}: logits on the card not "
                  f"finite")
            read["logits"].append(float((have - want).abs().max()))
            check(read["logits"][-1] <= 5e-2,
                  f"{arch} seed {seed} step {n} on the card is "
                  f"{read['logits'][-1]} away from the CPU")
        out[seed] = read
    return out


def model_api_phase(torch, lm, ptq, pipeline, ops, cfg_mod, arch) -> dict:
    """``arch`` whole at full width through the model API, as the
    reference's entry points serve it: seeded init, int4 weights and the
    fused config (:func:`multimodal_serving`), then ``lm.prefill`` of
    ``MM_REQUESTS`` rows (llava: 576 patch rows and ``LLAVA_PROMPT`` tokens;
    seamless: ``SEAMLESS_PROMPT`` tokens beside 32 frames) and
    ``MM_STEPS`` ``lm.decode_step`` s over the contiguous packed cache.
    Every kernel's launch count is set to 0 just before the prefill and
    read just after the last step.  Prints tokens/s (the first token from
    the prefill and one a step, a row, over prefill and decode seconds),
    the prefill's seconds, peak memory and the launches; returns the
    counts."""
    cfg = cfg_mod.get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, serve = multimodal_serving(torch, lm, ptq, pipeline, cfg, "cuda",
                                       LLAVA_NUM_HI)
    patch = cfg.frontend == "patch"
    prompt = LLAVA_PROMPT if patch else SEAMLESS_PROMPT
    rows = prompt + (cfg.num_patches if patch else 0)
    serve = dataclasses.replace(serve, cache_capacity=rows + MM_STEPS)
    batch = to_device(multimodal_batch(torch, cfg, MM_REQUESTS, prompt,
                                       seed=0), "cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if patch:
        check(serve.stamp.resolved_levels(rows) == PATCH_STAMP["levels"],
              "llava's DWT levels are not the ones check_patch_spans holds")
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    logits, cache = lm.prefill(params, batch, cfg, serve)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t1
    finite = torch.isfinite(logits).all()
    ids = [logits.argmax(dim=-1).to(torch.int32)]
    t2 = time.perf_counter()
    for n in range(MM_STEPS):
        logits, cache = lm.decode_step(params, cache, ids[-1], rows + n, cfg,
                                       serve)
        finite &= torch.isfinite(logits).all()
        ids.append(logits.argmax(dim=-1).to(torch.int32))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t2
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check(bool(finite), f"{arch}: non-finite logits")
    check(logits.shape == (MM_REQUESTS, cfg.padded_vocab),
          f"{arch}: logits of shape {tuple(logits.shape)}")
    ids = torch.stack(ids).cpu()
    check(bool(((ids >= 0) & (ids < cfg.padded_vocab)).all()),
          f"{arch}: token ids outside the padded vocabulary")
    if cfg.encoder_layers:
        want = (MM_REQUESTS, max(prompt // cfg.frame_ratio, 1),
                cfg.num_kv_heads, cfg.resolved_head_dim)
        check(all(tuple(e["xk"].shape) == want and
                  e["xk"].dtype == torch.bfloat16 for e in cache),
              f"{arch}: the cross-attention cache is not {want} bf16")
    tokens = MM_REQUESTS * (MM_STEPS + 1)
    print(f"[model_api] {arch} layers={cfg.num_layers} "
          f"encoder_layers={cfg.encoder_layers} d_model={cfg.d_model} "
          f"rows={rows} num_hi={serve.stamp.num_hi_tokens} "
          f"setup={setup_s:.1f}s prefill_s={prefill_s:.3f} "
          f"decode_s={decode_s:.3f} tokens={tokens} "
          f"tok/s={tokens / (prefill_s + decode_s):.2f} "
          f"decode_tok/s={MM_REQUESTS * MM_STEPS / decode_s:.2f} "
          f"peak_mem={peak_gb:.2f}GiB launches={json.dumps(counts)}")
    print(f"[model_api] {arch} ids in the vocabulary's pad: "
          f"{int((ids >= cfg.vocab_size).sum())} of {ids.numel()}")
    del params, cache, batch, logits
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------- main -----


def main() -> None:
    # ``--serve-only NAME,...`` (for iterating on the card) skips phase 3,
    # the card-vs-CPU checks and the serve phases not named, and prints no
    # kernels line and no final ok line
    only = None
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("run from the root of a checkout: src/repro_torch is missing")
    split_only = sys.argv[1:] == ["--split-only"]
    if len(sys.argv) == 3 and sys.argv[1] == "--serve-only":
        only = set(sys.argv[2].split(","))
    elif len(sys.argv) == 3 and sys.argv[1] == "--shard-rank":
        plan = json.loads(sys.argv[2])
        {"pair": shard_pair, "serve": serve_pair}.get(
            plan["mode"], shard_rank)(plan)
        return
    elif len(sys.argv) > 1 and not split_only:
        fail("usage: chip_smoke.py [--serve-only PHASE,...] "
             "[--split-only]")
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
    if split_only:
        with torch.inference_mode():
            check_split_modes(torch, sm, dm, ca, ref, KV, ops, prepare_linear)
        serve_pair_phase()
        check(all(n == 0 for n in mamba_train_pair().values()),
              "the mamba pair's training launched a kernel")
        print("[chip_smoke] partial run (--split-only): no kernels line")
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
        link, chain = check_long_spans(torch, sm, ops, prepare_linear)
        torch.cuda.empty_cache()
        plink, pchain = check_patch_spans(torch, sm, ops, prepare_linear)
        link += plink
        check_segment(torch, sm, ops, prepare_linear)
        torch.cuda.empty_cache()
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
        # every linear site of the dense, MoE, hybrid and SSM archs served
        # at full width (Mamba2's in_proj N = 8512 is not a multiple of
        # K2's 128-column tile; Jamba's out_proj K = 16384), and of
        # seamless's decoder and pixart's (llava's are llama3-8b's widths;
        # seamless's cross-attention and encoder run no kernel)
        for i, arch in enumerate((*DENSE_ARCHS, *NEW_ARCHS, SEAMLESS,
                                  PIXART)):
            prefill, decode = arch_sites(configs.get_config(arch))
            d1, d2 = check_stamp(torch, sm, ops, prepare_linear, prefill,
                                 seed=20 + i)
            k1, k2 = k1 + d1, k2 + d2
            k3 += check_decode(torch, dm, prepare_linear, decode,
                               seed=30 + i)
            torch.cuda.empty_cache()
        for arch in (*MHA_ARCHS, JAMBA, PIXART):
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
        for arch in (*MHA_ARCHS, PIXART):
            cfg = configs.get_config(arch)
            k6 += check_cache_attention(
                torch, ca, ref, KV, heads=cfg.num_heads,
                hd=cfg.resolved_head_dim, kv_heads=cfg.num_kv_heads,
                prefix=cfg.name.split("-")[0] + "_")
            torch.cuda.empty_cache()
        torch.cuda.empty_cache()
        split_modes = check_split_modes(torch, sm, dm, ca, ref, KV, ops,
                                        prepare_linear)
        torch.cuda.empty_cache()
        std = check_standalone(torch, hd, wt, qp, im)
        torch.cuda.empty_cache()
    for rows in (k1, k2, k3, k4, k5, k6, link, *std.values()):
        for r in rows:
            print(f"[kernel] {json.dumps(r)}")

    from repro_torch.core import ptq
    from repro_torch.data import pipeline
    from repro_torch.launch import serve
    from repro_torch.models import lm
    for arch in ("llama3-8b", "arctic-480b", *DENSE_ARCHS, *NEW_ARCHS,
                 PIXART):
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
    for arch in (LLAVA, SEAMLESS):
        with torch.inference_mode():
            read = check_model_api_against_cpu(torch, lm, configs, ptq,
                                               pipeline, arch)
        for seed, r in read.items():
            print(f"[chip_smoke] {arch} (reduced) seed {seed} card vs CPU: "
                  f"8-bit prefill + 2 decode steps max |logit diff| "
                  f"{r['logits']} (bound 5e-2); encoder per layer "
                  f"{r.get('encoder')} (bound 2^-7 of its norm)")
            for mix in ("served", "8bit"):
                blocks = dict(arch=arch, seed=seed, mix=mix, blocks=r[mix])
                print(f"[api_blocks] {json.dumps(blocks)}")

    # which kernels each path must launch, and which it must not: the
    # library path runs only the standalone kernels, the serve paths none
    standalone = set(std)
    every = {k.__name__ for k in ops.KERNELS}
    serving = every - standalone
    with torch.inference_mode():
        paths = {"kernel_library": (library_phase(torch, ops, prepare_linear,
                                                  hd, wt, qp, im), serving)}
        paths["paper"] = (paper_phase(torch, ops, hd, wt),
                          every - PAPER_KERNELS)
    torch.cuda.empty_cache()
    paths.update(serve_phases(torch, serve, ops, configs, None, standalone))
    gc.collect()
    torch.cuda.empty_cache()
    # training runs no kernel: its paths must launch none
    counts, one_device = train_phase(torch, ops)
    paths["train"] = (counts, every)
    gc.collect()
    torch.cuda.empty_cache()
    paths["shard"] = (shard_phase(torch, ops, one_device), every)
    pairs = serve_pair_phase()
    paths["serve_pair"] = (pairs["serve_pair"], every - SERVE_PAIR_KERNELS)
    paths["serve_pair_mamba"] = (pairs["serve_pair_mamba"],
                                 every - MAMBA_PAIR_KERNELS)
    gc.collect()
    torch.cuda.empty_cache()
    dry_counts, _ = dryrun_phase(torch, ops, one_device)
    paths["dryrun"] = (dry_counts, every)
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
    # (and the segment matmul's, which runs the single kernel per span)
    stamp_rows = ("src/repro/kernels/stamp_matmul.py:222, "
                  "src/repro/kernels/stamp_matmul.py:276, "
                  "src/repro/kernels/stamp_matmul.py:345")
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
        # the long-span chain's third link: the inverse (and, under long
        # WHT spans, forward) transform of the two Pallas kernels' spans
        entry("stamp_span_transform", src + "span_link.cu", stamp_rows,
              link),
    ]
    kernels[3]["per_shape"] = k4
    # the serving split's modes, timed apart (not in the sums above)
    for kern in kernels:
        if kern["name"] in split_modes:
            kern["modes"] = split_modes[kern["name"]]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def serve_phase(torch, serve, ops, arch: str, cfg, kind: str = "paged",
                extra=(), label=None, attention: bool = True,
                before=None, after=None, prompt_len: int = 96) -> tuple:
    """Serve ``arch`` (``cfg`` overrides its config) through the serve
    entry point and the ``kind`` of engine: 4 requests x ``prompt_len``
    prompt tokens x 8 new tokens, unified steps, fused execution and
    (``attention``) the
    cache attention kernel, with the CLI flags ``extra`` appended.  Every
    kernel's launch count is set to 0 just before the run and read just
    after.  ``before(engine)`` runs before the requests are submitted,
    ``after(engine, res, sargs)`` after the run.  Returns ``(counts,
    res)``, ``res`` as ``serve.serve_requests`` returns it."""
    label = label or arch
    argv = ["--arch", arch, "--engine", kind, "--step-mode", "unified",
            "--execution", "fused", "--device", "cuda", "--requests", "4",
            "--prompt-len", str(prompt_len), "--max-new", "8",
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
    # spans of 128 rows never take the long-span link
    standalone = set(standalone) | {"stamp_span_transform"}
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
    # prefill spans past K2's 128-row tile: the long-span chain
    long_span = {"stamp_span_transform"}
    if want("llama3-8b:chunk256"):
        paths["llama3-8b:chunk256"] = (serve_phase(
            torch, serve, ops, "llama3-8b", None, label="llama3-8b:chunk256",
            extra=["--prefill-chunk", "256"], prompt_len=LONG_PROMPT)[0],
            paged - long_span)
    if want("llama3-8b:bucket512"):
        paths["llama3-8b:bucket512"] = (serve_phase(
            torch, serve, ops, "llama3-8b", None, kind="bucketed",
            label="llama3-8b:bucket512", extra=["--bucket", "512"],
            prompt_len=LONG_PROMPT)[0],
            (dense | {"paged_ragged_attention"}) - long_span)
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
    # Kimi-K2 and Jamba run K1-K5 (MoE, K4 in their attention layers),
    # Mamba2 K1-K3 only (no attention, no MoE)
    for arch, layers in NEW_ARCHS.items():
        if not want(arch):
            continue
        cfg = None if layers is None else dataclasses.replace(
            configs.get_config(arch), num_layers=layers)
        absent = standalone | {"cache_decode_attention"}
        if arch == "mamba2-1.3b":
            absent |= {"paged_ragged_attention",
                       "stamp_quant_grouped_matmul"}
        paths[arch] = (serve_phase(torch, serve, ops, arch, cfg)[0], absent)
    # pixart-sigma (head_dim 72) through both engines; llava and seamless
    # through the model API (their batches carry patches or frames): llava
    # runs the long-span chain (640-row spans), seamless spans of 128 rows
    if want(PIXART):
        paths[PIXART] = (serve_phase(torch, serve, ops, PIXART, None)[0],
                         paged)
    if want(PIXART + ":bucketed"):
        paths[PIXART + ":bucketed"] = (
            serve_phase(torch, serve, ops, PIXART, None, kind="bucketed",
                        label=PIXART + ":bucketed")[0],
            dense | {"paged_ragged_attention"})
    from repro_torch.core import ptq
    from repro_torch.data import pipeline
    from repro_torch.models import lm
    no_paging = (standalone - long_span) | {"paged_ragged_attention",
                                            "stamp_quant_grouped_matmul"}
    for arch in (LLAVA, SEAMLESS):
        if not want(arch):
            continue
        with torch.inference_mode():
            counts = model_api_phase(torch, lm, ptq, pipeline, ops, configs,
                                     arch)
        paths[arch] = (counts, no_paging | (long_span if arch == SEAMLESS
                                            else set()))
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
