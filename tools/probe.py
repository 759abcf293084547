#!/usr/bin/env python3
"""Where K1's (``stamp_transform_quantize``), K2's (``stamp_int_gemm``),
K3's (``stamp_decode_matmul``), K4's (``paged_ragged_attention``), K5's
(``stamp_quant_grouped_matmul``), K6's (``cache_decode_attention``), K7's
(``int8_matmul``), K8's (``quantize_pack``), K10's
(``walsh_hadamard``) and the long-span link's (``stamp_span_transform``)
time goes: each
timed replayed from CUDA graphs at the serve path's (or the kernel
library's) shapes, built whole and built with one part taken out, or with
its launch plan changed.

    python3 tools/probe.py k1 [--src DIR] [--cluster 4,8,16]
    python3 tools/probe.py k2 [--src DIR] [--fill 1,2,3]
    python3 tools/probe.py k3 [--src DIR] [--fill 1,2,3]
    python3 tools/probe.py k4 [--splits 1,2,3,5] [--cuts]
    python3 tools/probe.py k4 --sweep [--splits 1,2,4,8]
    python3 tools/probe.py k5 [--src DIR]
    python3 tools/probe.py k6 [--src DIR]
    python3 tools/probe.py k7 [--src DIR]
    python3 tools/probe.py k8 [--src DIR] [--warps 1,2,4]
    python3 tools/probe.py k10 [--src DIR]
    python3 tools/probe.py link [--src DIR]

A cut variant is the kernel's source (``src/repro_torch/csrc``, of this
checkout or of the checkout at ``DIR``, whose wrappers are then the ones
imported, with the headers it includes from there written into it) with
one statement deleted or replaced; its output is then wrong
and only its time is read.  Where a kernel's source was redesigned, each
design has its own set of cuts, and the set whose statements the source
holds is taken.

k2: variants without the tensor core products (``no_mma``), the transpose
of the B tile (``no_transpose``), the stage copies after the prologue's
(``no_loads``), the wait for them (``no_wait``: issued, never awaited), the
epilogue (``no_epilogue``) or every k step (``no_main_loop``: launch and
epilogue are left); and builds whose ``cp.async`` ring holds 3 or 5 stages
(``stages3``, ``stages5``; these give the right output).  Sites: llama3-8b's
paged qkv (2 spans, K split in two), gate_up dual (2 spans) and the bucketed
engine's gate_up at 8 spans.  ``--fill``: the whole build with the k-split
plan sized for that many blocks an SM (1 is the plan's own), at the paged
qkv, down and gate_up and Arctic's wo.

k1: variants without the sequence transform, the input loads (the row
window design), the reduction of the rows' min / max across the K range
(the scale launch of the three-launch design; the cluster's exchange of
the window design), the quantize's division or the code stores.  Sites:
every K1 site of the smoke (llama3-8b's and Arctic's K at 2 spans, the
bucketed 4 and 8 spans).  ``--cluster``: the whole build with clusters of
at most that many K ranges (the window design's ``MAX_CLUSTER``).

k5: variants without the gate/up products or the down products (the dp4a
design: an XOR keeps every load), the MMAs or the B transpose (the mma
design), the weight stream past the first step (every step reads the
first again), the requantize, or one of the two launches.  Sites: the
smoke's ``MOE_SHAPES`` (Arctic's experts and Kimi-K2's expert widths).

k4: llama3-8b's and Arctic's all-decode and mixed steps from
``chip_smoke.py``, with the launch plan's own split and with each count of
block slots a decode span forced (the card splits the spans over them;
each run checked against the plain version within one bf16 step); ``--cuts``: variants without the gather of
the next tile, the dequantizing pass, the prefill scores or the prefill
p.V.  ``--sweep``: all-decode steps of SLOTS spans instead, every span of
one length from 256 to 32768 positions (tables of that capacity), K6's
ragged long lengths, and the serve path's short spans in tables of 32768
positions, each with the plan's split and with each count of slots of
``--splits`` forced: where splitting a span pays.

k3: variants without the weight stream past the prologue's stages
(``no_loads``), the rows' min / max pass (``no_minmax``), the stages'
quantizing (``no_quantize``), the dp4a products (``no_products``) or the
join of the ranges and the epilogue (``no_join``); rings of 4 and 8 stages
(``stages4``, ``stages8``; right output).  Sites: llama3-8b's decode qkv,
gate and down at 8 rows and the bucketed qkv at 4.  ``--fill``: the whole
build with the plan sized for that many blocks an SM (2 is the plan's own).

k7: variants without the tensor core products (``no_mma``), the B
transpose (``no_transpose``: the tile's stores and its Σqw) or the
epilogue (``no_epilogue``); a TMA ring of 3 stages
(``stages3``) and a transposed ring of 2 (``bt2``) (right output).  Sites:
the smoke's ``GEMM_SHAPES`` (qkv, gate and down at 2048 rows, qkv at 8).

k6: variants without the K scores, the V sum, the dequantizing of the
codes, the stream of tiles past a range's first, the softmax or the merge
launch, and (the tensor-core design) with the value MMAs on one bf16
piece of the weights instead of three (the statements of each design are
listed in ``K6_VARIANTS``).
Sites: the smoke's ``CACHE_SHAPES`` (serve and long) at llama3-8b's and
Kimi-K2's attention widths, bf16 queries.

k8: (the two-pass design) variants without the second read (values made
from the index), the min / max pass (a fixed scale), the division,
``rintf``, the float-to-int conversion or the code stores; (the registers
design) without the loads, the min / max, Markstein's correction of the
quotient or the code stores (each word still computed whole), and with
every row on the per-value ``__fdiv_rn`` and ``rintf`` (``exact_ops``,
right output).  Sites: the smoke's ``PACK_SHAPES`` (bf16 at 4 and 8 bits,
the KV shape, f32 at 4 bits), each beside the ``copy_`` ceiling.
``--warps``: the whole build with each registers-route row spread over
that many warps (checked exact).

k10: variants without the butterfly stages, the loads or the stores (a
store that never happens, so nothing is optimised away), and (the
register-phase design) without the barriers between its phases.  Sites: the
smoke's ``WHT_SHAPES`` in bf16.

link: the span link's row windows (the Haar DWT) without the
butterflies, the input loads or the output stores, and its WHT tiles
(K10's register phases) without the stages, the tile loads, the tile
stores or the rows around the block (``no_copy``); and the whole build
with the WHT's tiles sized by the input's sectors instead of the
narrower of input and output (``in_sector``), the inverse's windows of
32 output rows (``out32``) or strips of 128 columns (``cols128``) (all
right output).  Sites: the smoke's timed link shapes at 2048 rows
(llama3-8b's qkv, gate/up dual and down, f32 products, bf16 out): the
inverse Haar DWT at 3 and 9 levels and the inverse WHT; and qkv and down
at 1024 rows, the inverse Haar DWT at 8 levels (the levels the serve
path resolves there).

Prints one ``[probe]`` line a site and run; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
K2_VARIANTS = {
    "full": (),
    "no_mma": ("wgmma_s8(acc,",),
    "no_transpose": ("if (kt + 1 < KT) transpose(kt + 1);",),
    "no_loads": ("if (kt + STAGES - 1 < KT) issue(kt + STAGES - 1);",),
    "no_wait": ("cp_wait<STAGES - 3>();",),
    "no_epilogue": ("finish_chunk<DUAL, EW>(Y0, Y1, Tmp, rs,",),
    "no_main_loop": ("const int KT = (ke - kb + BK - 1) / BK",),
    # not cuts: the ring of cp.async stages made one shorter or longer
    "stages3": ("constexpr int STAGES = 4;", "constexpr int STAGES = 3;"),
    "stages5": ("constexpr int STAGES = 4;", "constexpr int STAGES = 5;"),
}
K3_VARIANTS = {
    "full": (),
    "no_loads": ("issue(kt + STAGES - 1);",),
    "no_minmax": ("for (int v0 = part; v0 < nv; v0 += tpr * U) {",
                  "for (int v0 = part; v0 < 0; v0 += tpr * U) {"),
    "no_quantize": ("if (kt + 1 < KT) quantize(kt + 1);",),
    "no_products": ("acc[m][j] = __dp4a(xq[q], col[q][j], acc[m][j]);",),
    "no_join": ("for (int i = tid; i < rows * (w1 - w0); i += THREADS) {",
                "for (int i = tid; i < 0; i += THREADS) {"),
    "stages4": ("constexpr int STAGES = 6;", "constexpr int STAGES = 4;"),
    "stages8": ("constexpr int STAGES = 6;", "constexpr int STAGES = 8;"),
}
K7_VARIANTS = {
    "full": (),
    "no_mma": ("wgmma_s8(acc, desc_a(",),
    "no_transpose": ("for (int it = 0; it < 2; ++it) {",
                     "for (int it = 0; it < 0; ++it) {"),
    "no_epilogue": ("for (int hf = 0; hf < 2; ++hf) {",
                    "for (int hf = 0; hf < 0; ++hf) {"),
    "stages3": ("constexpr int STAGES = 4;", "constexpr int STAGES = 3;"),
    "bt2": ("constexpr int BT_STAGES = 3;", "constexpr int BT_STAGES = 2;"),
}
# one set of cuts for each design of K6 and K10: the earlier one on CUDA
# cores and shared-memory stages, the later one on registers and MMAs
K6_VARIANTS = {
    "cuda_cores": {
        "full": (),
        "no_kscore": ("score_row<HD>(hi, C.k_hi + hrow * HD,",),
        "no_vsum": ("for (int j = grp; j < n && grp < NG; j += NG) {",
                    "for (int j = grp; j < 0 && grp < NG; j += NG) {"),
        "no_dequant": {"replace": [
            ("((float)(byte >> 4) - zp) * sc", "(float)byte"),
            ("((float)(byte & 0xFu) - zp) * sc", "(float)w[i]"),
            ("(code_at(vcodes + j * SLOT, t0 + j < hi_len, d) -",
             "(vsc[j] -")]},
        "no_stream": {"replace": [("const int pos = t0 + tid;",
                                   "const int pos = start + tid;")]},
        "no_softmax": ("for (int r = warp; r < rep; r += THREADS / 32) {",
                       "for (int r = warp; r < 0; r += THREADS / 32) {"),
        "no_merge": ("cache_attention_merge<T><<<dim3(g, b), THREADS, 0, "
                     "st>>>(",),
    },
    "tensor_cores": {
        "full": (),
        # the scores' word reads, unpacking and MMAs (dead without these)
        "no_kscore": {"replace": [
            ("mma(d[nt], qa[pc][kk][0], 0u, qa[pc][kk][1], 0u, b0, b1);",
             "(void)0;")]},
        # the values' reads, unpacking and MMAs
        "no_vsum": {"replace": [
            ("mma(acc[mt], a0, a1, a2, a3, wb[pc][0], wb[pc][1]);",
             "(void)0;")]},
        "v_one_piece": {"replace": [
            ("mma(acc[mt], a0, a1, a2, a3, wb[pc][0], wb[pc][1]);",
             "if (pc == 0) mma(acc[mt], a0, a1, a2, a3, wb[pc][0], "
             "wb[pc][1]);")]},
        "no_dequant": {"replace": [
            ("uint32_t x = ((w >> sh) & 0x000F000Fu) | MAGIC;",
             "return w >> sh; uint32_t x = 0;")]},
        "no_stream": {"replace": [
            ("fetch(t0 + nxt, nxt % STAGES);", "(void)0;"),
            ("pf = params(t0 + nxt);", "(void)0;")]},
        "no_softmax": {"replace": [
            ("const float corr = expf(m - m_new);", "const float corr = 1.f;"),
            ("const float pe = ok ? expf(sc[gr][nt][e] - m_new) : 0.f;",
             "const float pe = ok ? sc[gr][nt][e] : 0.f;")]},
        "no_merge": {"replace": [
            ("return cudaLaunchKernelEx(&cfg, cache_attention_merge<T>,",
             "if (cfg.numAttrs) return cudaSuccess;\n  return "
             "cudaLaunchKernelEx(&cfg, cache_attention_merge<T>,")]},
    },
}
K10_VARIANTS = {
    "smem_stages": {
        "full": (),
        "no_stages": ("for (int h = 1; h < T; h <<= 1, ++lg_h) {",
                      "for (int h = 1; h < 0; h <<= 1, ++lg_h) {"),
        "no_loads": ("if (c < nvec) v = ld(x + base + j * jstep + "
                     "c * vstride);",),
        "no_stores": ("st(y + base + j * jstep + c * vstride, v);",
                      "if (v == -1.2345e-38f) st(y + base + j * jstep + "
                      "c * vstride, v);"),
    },
    "register_phases": {
        "full": (),
        "no_stages": {"replace": [("v[j] = add4(a, b);", "v[j] = a;"),
                                  ("v[j + h] = sub4(a, b);",
                                   "v[j + h] = b;")]},
        "no_loads": {"replace": [
            ("v[j] = ok ? ld4(x + off) : make_float4(0.f, 0.f, 0.f, 0.f);",
             "v[j] = make_float4((float)off, 0.f, 0.f, 0.f);"),
            ("if (c0 + h * PER < nvec)", "if (c0 + h * PER < 0)")]},
        "no_stores": {"replace": [
            ("if (ok) st4(y + off, a);",
             "if (ok && a.x == -1.2345e-38f) st4(y + off, a);")]},
        # the barriers between the register phases (a race: time only)
        "no_sync": {"replace": [("if (!first) __syncthreads();",
                                 "(void)0;")]},
    },
}
LINK_VARIANTS = {
    "windows_and_tiles": {
        "full": (),
        "no_ops": ("for (int k = 0; k < nops; ++k) {",
                   "for (int k = 0; k < 0; ++k) {"),
        "no_loads": {"replace": [
            ("cp_async16(X0 + at, x0 + g);", "X0[at] = (float)g;"),
            ("if (DUAL) cp_async16(X1 + at, x1 + g);", "(void)0;"),
            ("v[j] = ok ? ld4(x + off) : make_float4(0.f, 0.f, 0.f, 0.f);",
             "v[j] = make_float4((float)off, 0.f, 0.f, 0.f);")]},
        "no_stores": {"replace": [
            ("store4(out + out_base + (size_t)dst * N + c,",
             "if (g.x == -1.2345e-38f) store4(out + out_base + "
             "(size_t)dst * N + c,"),
            ("st4(y + off, epilogue<DUAL>(a, u, b0, nullptr, t.c0 + 4 * q, "
             "t.nvec));",
             "if (a.x == -1.2345e-38f) st4(y + off, epilogue<DUAL>(a, u, "
             "b0, nullptr, t.c0 + 4 * q, t.nvec));")]},
        "no_stages": {"replace": [("v[j] = add4(a, b);", "v[j] = a;"),
                                  ("v[j + h] = sub4(a, b);",
                                   "v[j + h] = b;")]},
        "no_copy": ("if (ty == 0 && crows > 0)",
                    "if (ty == 0 && crows < 0)"),
    },
}
# the span link's transforms at each 2048-row site
LINK_CASES = (("dwt", 3), ("dwt", 9), ("wht", 3))
# the span link's window plans beside its own (right output)
WINDOW_PLANS = {"out32": dict(SL_OUT_INVERSE=32),
                "cols128": dict(SL_COLS=128)}
# one set of cuts for each design of K1 and K5: the earlier ones (three
# launches over 32-column slabs; dp4a blocks of 4-byte loads), the later
# ones (one launch over row windows in clusters; mma.sync over a cp.async
# ring in persistent blocks)
K1_VARIANTS = {
    "three_launches": {
        "full": (),
        # the sequence transform, in both passes
        "no_transform": {"replace": [
            ("seq_transform(buf, tmp, S, TQ_W, TQ_LD, t, false);",
             "(void)0;")]},
        # the launch reducing the slabs' partial min / max
        "no_scale_pass": ("tq_scale_kernel<<<(rows + 127) / 128, 128, 0, "
                          "st>>>(",),
        "no_division": {"replace": [
            ("float q = rintf(__fdiv_rn(buf[r * TQ_LD + c], s)) + z;",
             "float q = rintf(buf[r * TQ_LD + c] * s) + z;")]},
        "no_stores": {"replace": [
            ("qx[row * K + col] = (int8_t)(int)(q - 128.0f);",
             "if (q == -1.2345f) qx[row * K + col] = (int8_t)(int)(q - "
             "128.0f);")]},
    },
    "row_windows": {
        "full": (),
        # the window's butterflies, in both passes
        "no_transform": {"replace": [
            ("for (int o = 0; o < nops; ++o) {",
             "for (int o = 0; o < 0; ++o) {")]},
        # the input loads (each slot takes its column's index instead)
        "no_loads": {"replace": [
            ("? ldg_f(xs + (size_t)in_rows[s0 + q] * K + col)",
             "? (float)(col + in_rows[s0 + q])")]},
        # the cluster's exchange: each range keeps its own min / max
        "no_exchange": {"replace": [
            ("*cluster.map_shared_rank(bmn + tid, rk)", "bmn[tid]"),
            ("*cluster.map_shared_rank(bmx + tid, rk)", "bmx[tid]"),
            ("  cluster.sync();\n  if (tid < nout) {",
             "  __syncthreads();\n  if (tid < nout) {"),
            ("  cluster.sync();    // the block's min / max stay",
             "  __syncthreads();    // the block's min / max stay")]},
        "no_division": {"replace": [
            ("float qv = rintf(__fdiv_rn(v, s)) + z;",
             "float qv = rintf(v * s) + z;")]},
        "no_stores": {"replace": [
            ("o[col] = (int8_t)(int)(qv - 128.0f);",
             "if (qv == -1.2345f) o[col] = (int8_t)(int)(qv - 128.0f);")]},
    },
}
K5_VARIANTS = {
    "dp4a_blocks": {
        "full": (),
        # the products replaced by an XOR that keeps every load alive
        "no_gate_up_products": {"replace": [
            ("g[r][c] = __dp4a(xq, wg[c], g[r][c]);",
             "g[r][c] = g[r][c] ^ xq ^ wg[c];"),
            ("u[r][c] = __dp4a(xq, wu[c], u[r][c]);",
             "u[r][c] = u[r][c] ^ xq ^ wu[c];")]},
        "no_down_products": {"replace": [
            ("p[r][k] = __dp4a(xq, wq[k], p[r][k]);",
             "p[r][k] = p[r][k] ^ xq ^ wq[k];")]},
        # every k step reads the first step's weight rows (L1 hits)
        "no_weight_stream": {"replace": [
            ("const int8_t* pg = qwg + wcol + (size_t)4 * q * F;",
             "const int8_t* pg = qwg + wcol;"),
            ("const int8_t* pu = qwu + wcol + (size_t)4 * q * F;",
             "const int8_t* pu = qwu + wcol;"),
            ("const int8_t* w = pw + (size_t)4 * q * D;",
             "const int8_t* w = qwd + (size_t)e * F * D + col;")]},
        "no_requantize": {"replace": [
            ("if (warp < nr) {                 // the slab's per-row 8-bit "
             "requantize",
             "if (warp < 0) {")]},
        "no_down_launch": ("moe_down_kernel<float><<<grid_b, DT_THREADS, "
                           "rows_bytes, st>>>(",),
    },
    "mma_persistent": {
        "full": (),
        # the MMAs replaced by an XOR that keeps every fragment alive
        "no_mma": {"replace": [
            ("mma_s8(acc[0][tt], lo[0], lo[1], hi[0], hi[1], b0, b1);",
             "acc[0][tt][0] ^= lo[0] ^ lo[1] ^ hi[0] ^ hi[1] ^ b0 ^ b1;"),
            ("mma_s8(acc[1][tt], lo[2], lo[3], hi[2], hi[3], b0, b1);",
             "acc[1][tt][0] ^= lo[2] ^ lo[3] ^ hi[2] ^ hi[3] ^ b0 ^ b1;")]},
        "no_transpose": {"replace": [
            ("transpose4(w[0], w[1], w[2], w[3], lo);",
             "lo[0] = w[0]; lo[1] = w[1]; lo[2] = w[2]; lo[3] = w[3];"),
            ("transpose4(w[4], w[5], w[6], w[7], hi);",
             "hi[0] = w[4]; hi[1] = w[5]; hi[2] = w[6]; hi[3] = w[7];")]},
        # every stage copies its item's first rows again (L2 hits)
        "no_weight_stream": {"replace": [
            ("(up ? m.qwu : m.qwg) + (ok ? base + cp_src[i] : 0), ok);",
             "(up ? m.qwu : m.qwg) + cp_src[i], ok);"),
            ("m.qwd + (ok ? base + cp_src[i] : 0), ok);",
             "m.qwd + cp_src[i], ok);")]},
        # the requantize's cross-warp reduction and its division
        "no_requantize": {"replace": [
            ("      if (tid < 8) {\n        float mn = INFINITY, mx = "
             "-INFINITY;",
             "      if (tid < 0) {\n        float mn = INFINITY, mx = "
             "-INFINITY;"),
            ("float qv = rintf(__fdiv_rn(a[h][c], s)) + z;",
             "float qv = a[h][c] * s + z;")]},
        "no_gate_up_launch": {"replace": [
            ("cudaError_t err = launch_gate_up<TT>(m, sms, st);",
             "cudaError_t err = cudaSuccess;")]},
        "no_down_launch": {"replace": [
            ("launch_down<TT, float>(m, sms, st);", "cudaSuccess;")]},
        # not cuts: the ring one stage shorter or longer
        "stages2": ("constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),
        "stages4": ("constexpr int STAGES = 3;", "constexpr int STAGES = 4;"),
    },
}
# one set of cuts for each design of K8: the earlier one reads a row twice
# (min / max, then quantize and pack), the later one keeps it in registers
K8_VARIANTS = {
    "registers": {
        "full": (),
        # the loads (each word made from its index instead: finite values)
        "no_loads": {"replace": [
            ("if (live && c < words) w[j] = __ldcs(xr + c);",
             "if (live && c < words) w[j] = make_uint4(0x3f803f80u ^ (c & "
             "0x007f007fu), 0x3f803f80u ^ ((c >> 7) & 0x007f007fu), "
             "0x3c003c00u ^ (c & 0x00ff00ffu), 0x3f003f00u ^ (c & "
             "0x00ff00ffu));")]},
        # the rows' min / max (a fixed scale and zero point)
        "no_minmax": {"replace": [("float mn = acc.lo(), mx = acc.hi();",
                                   "float mn = -4.0f, mx = 4.0f;")]},
        # Markstein's correction: the quotient left at v * RN(1/s)
        "no_division": {"replace": [
            ("const float t = __fmaf_rn(__fmaf_rn(-q0, s, v), r, q0);",
             "const float t = q0;")]},
        # not cuts: every row quantized with __fdiv_rn and rintf per value;
        # the loads through the read-only path (__ldg) instead of
        # evict-first; evict-first code stores; registers-route blocks of
        # at least 8 warps instead of 4
        "exact_ops": {"replace": [
            ("if (fabsf(z) <= FAST_ZP && s < CUDART_INF_F)", "if (false)")]},
        "ldg_loads": {"replace": [
            ("if (live && c < words) w[j] = __ldcs(xr + c);",
             "if (live && c < words) w[j] = __ldg(xr + c);")]},
        "streaming_stores": {"replace": [
            ("reinterpret_cast<uint32_t*>(qr)[c] = bytes4(p[0], p[1], p[2], "
             "p[3]);",
             "__stcs(reinterpret_cast<unsigned*>(qr) + c, bytes4(p[0], p[1], "
             "p[2], p[3]));"),
            ("reinterpret_cast<uint2*>(qr)[c] =\n            make_uint2(lo, "
             "bytes4(k[4], k[5], k[6], k[7]) ^ 0x80808080u);",
             "__stcs(reinterpret_cast<uint2*>(qr) + c, make_uint2(lo, "
             "bytes4(k[4], k[5], k[6], k[7]) ^ 0x80808080u));")]},
        "blocks_of_8_warps": ("constexpr int ROW_BLOCK = 4;",
                              "constexpr int ROW_BLOCK = 8;"),
        # the code stores (each still computed whole)
        "no_stores": {"replace": [
            ("reinterpret_cast<uint32_t*>(qr)[c] = bytes4(p[0], p[1], p[2], "
             "p[3]);",
             "{ const uint32_t o = bytes4(p[0], p[1], p[2], p[3]); if (o == "
             "0x9e3779b9u) reinterpret_cast<uint32_t*>(qr)[c] = o; }"),
            ("reinterpret_cast<uint16_t*>(qr)[c] =\n            (uint16_t)"
             "__byte_perm(p[0], p[1], 0x0040);",
             "{ const uint32_t o = __byte_perm(p[0], p[1], 0x0040); if (o == "
             "0x9e3779b9u) reinterpret_cast<uint16_t*>(qr)[c] = o; }"),
            ("reinterpret_cast<uint2*>(qr)[c] =\n            make_uint2(lo, "
             "bytes4(k[4], k[5], k[6], k[7]) ^ 0x80808080u);",
             "{ const uint32_t o = bytes4(k[4], k[5], k[6], k[7]); if ((lo ^ "
             "o) == 0x9e3779b9u) reinterpret_cast<uint2*>(qr)[c] = "
             "make_uint2(lo, o); }"),
            ("reinterpret_cast<uint32_t*>(qr)[c] = lo;",
             "if (lo == 0x9e3779b9u) reinterpret_cast<uint32_t*>(qr)[c] = "
             "lo;")]},
    },
    "two_pass": {
        "full": (),
        # the second pass's loads (its values made from the index instead)
        "no_second_read": {"replace": [
            ("ld8(xr + k + 8 * part, v);",
             "for (int i = 0; i < 8; ++i) v[i] = 1e-3f * (float)(k + 8 * "
             "part + i);")]},
        # the first pass (a fixed scale: the row's min / max never read)
        "no_minmax": ("for (int k = 8 * lane; k < d; k += 8 * 32) {",
                      "for (int k = 8 * lane; k < 0; k += 8 * 32) {"),
        "no_division": {"replace": [
            ("float q = rintf(__fdiv_rn(v, s)) + z;",
             "float q = rintf(v * s) + z;")]},
        "no_rint": {"replace": [
            ("float q = rintf(__fdiv_rn(v, s)) + z;",
             "float q = __fdiv_rn(v, s) + z;")]},
        "no_f2i": {"replace": [("return (uint32_t)(int)q;",
                                "return __float_as_uint(q);")]},
        "no_stores": {"replace": [
            ("*reinterpret_cast<uint4*>(qr + k / 2) =",
             "if (word[0] == 0x9e3779b9u) *reinterpret_cast<uint4*>(qr + "
             "k / 2) ="),
            ("*reinterpret_cast<uint4*>(qr + k) =",
             "if (word[0] == 0x9e3779b9u) *reinterpret_cast<uint4*>(qr + "
             "k) =")]},
    },
}
K4_CUTS = {
    "no_gather": ("issue_tile<HD>(a, span, kvh, t0 + TILE, kv1,",),
    "no_dequant": ("dequant_tile<HD>(smem + (t & 1) * L::RAW,",),
    "no_pf_scores": ("for (int d4 = 0; d4 < NV; ++d4) {",
                     "for (int d4 = 0; d4 < 0; ++d4) {"),
    "no_pf_pv": ("for (int j = 0; j < n_valid; ++j) {",
                 "for (int j = 0; j < 0; ++j) {"),
}


def variant_source(src: str, cuts) -> str:
    """The source with the first statement that starts with one of
    ``cuts`` removed (up to its semicolon); a pair ``(old, new)`` whose
    ``new`` ends with a semicolon or a brace replaces ``old`` instead, and
    ``{"replace": [(old, new), ...]}`` replaces every ``old`` in turn."""
    if isinstance(cuts, dict):
        for old, new in cuts["replace"]:
            if old not in src:
                raise ValueError(f"{old!r} is not in the source")
            src = src.replace(old, new)
        return src
    if len(cuts) == 2 and cuts[1][-1] in ";{":
        if cuts[0] not in src:
            raise ValueError(f"{cuts[0]!r} is not in the source")
        return src.replace(cuts[0], cuts[1], 1)
    for cut in cuts:
        if cut in src:
            i = src.index(cut)
            j = src.index(";", i)
            if cut.startswith("const int KT"):   # no k steps at all
                return src[:i] + "const int KT = 0" + src[j:]
            return src[:i] + "(void)0" + src[j:]
    if cuts:
        raise ValueError(f"none of {cuts} is in the source")
    return src


def source_of(src_root: Path, name: str) -> str:
    """``csrc/<name>.cu`` under ``src_root`` with the headers it includes
    from ``csrc`` written in place of their ``#include`` lines."""
    csrc = src_root / "src" / "repro_torch" / "csrc"
    out = []
    for line in (csrc / f"{name}.cu").read_text().splitlines(True):
        inc = line.strip()
        if inc.startswith('#include "') and inc.endswith('.cuh"'):
            line = (csrc / inc[len('#include "'):-1]).read_text()
        out.append(line)
    return "".join(out)


def variants_of(designs: dict, src_root: Path, name: str) -> dict:
    """The set of cuts in ``designs`` whose every statement is in the
    source ``csrc/<name>.cu`` under ``src_root``."""
    src = source_of(src_root, name)
    for design, variants in designs.items():
        try:
            for cuts in variants.values():
                variant_source(src, cuts)
        except ValueError:
            continue
        print(f"[probe] {name}.cu: the {design} design's cuts")
        return variants
    raise SystemExit(f"no set of cuts matches {name}.cu")


def build_variants(cs, kcuda, name: str, src_root: Path, variants: dict,
                   signatures: dict) -> dict:
    """Compile every variant of ``csrc/<name>.cu`` (one ``nvcc`` each, all
    started together) and load it with the wrapper's signatures."""
    out_dir = ROOT / "build" / "probe" / name / src_root.resolve().name
    out_dir.mkdir(parents=True, exist_ok=True)
    src = source_of(src_root, name)
    procs = {}
    for label, cuts in variants.items():
        cu = out_dir / f"{label}.cu"
        cu.write_text(variant_source(src, cuts))
        so = out_dir / f"lib{label}.so"
        procs[label] = (so, subprocess.Popen(
            [kcuda.nvcc(), *kcuda._ARCH, *kcuda._COMMON, *kcuda._FLAGS[name],
             "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            cs.fail(f"variant {label} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def k2_case(torch, cs, sm, prepare_linear, gen, spans, k, n, dual):
    """K2's inputs at one site, and a call of it."""
    x = torch.randn((spans, cs.C, k), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    w = [prepare_linear(torch.randn((k, n), generator=gen, device="cuda")
                        / math.sqrt(k)) for _ in range(2 if dual else 1)]
    qx, sx, zx = sm.stamp_transform_quantize(x, **cs.STAMP)
    wargs = [w[0].qw, w[0].sw, w[0].zw, w[0].qw_sum, None]
    if dual:
        wargs += [w[1].qw, w[1].sw, w[1].zw, w[1].qw_sum, None]
    kw = dict(transform="dwt", levels=3, skip_first=True,
              out_dtype=torch.bfloat16)
    return (lambda: sm.stamp_int_gemm(qx, sx, zx, cs.C, *wargs, **kw),
            lambda: sm.int_gemm_plain(qx, sx, zx, cs.C, *wargs, **kw))


def probe_k2(torch, cs, args) -> None:
    from repro_torch.core.stamp import prepare_linear
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import stamp_matmul as sm
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.fill:
        fills = [int(f) for f in args.fill.split(",")]
        own = sm.gemm_plan
        sites = [("qkv", cs.SPANS, cs.D, cs.D + 2 * cs.KV_HEADS * cs.HD,
                  False),
                 ("down", cs.SPANS, cs.D_FF, cs.D, False),
                 ("arctic_wo", cs.SPANS, cs.A_D, cs.A_D, False),
                 ("gate_up", cs.SPANS, cs.D, cs.D_FF, True)]
        for site, spans, k, n, dual in sites:
            call, plain = k2_case(torch, cs, sm, prepare_linear, gen, spans,
                                  k, n, dual)
            want = plain()
            for fill in fills:
                sm.gemm_plan = (lambda f: lambda b, k_, n_, d, sms:
                                own(b, k_, n_, d, f * sms))(fill)
                plan = sm.gemm_plan(spans, k, n, dual, 132)
                cs.close_bf16(torch, call(), want)
                ms = cs.timed_graph(torch, call, 50, per_graph=10)
                print(f"[probe] {site} fill={fill} n_split={plan['n_split']}"
                      f": graph_ms={ms:.4f}")
            sm.gemm_plan = own
        return
    libs = build_variants(cs, kcuda, "stamp_matmul", args.src, K2_VARIANTS,
                          sm._SIGNATURES)
    sites = [("qkv", cs.SPANS, cs.D, cs.D + 2 * cs.KV_HEADS * cs.HD, False),
             ("gate_up", cs.SPANS, cs.D, cs.D_FF, True),
             ("bucketed8_gate_up", 8, cs.D, cs.D_FF, True)]
    for site, spans, k, n, dual in sites:
        call, _ = k2_case(torch, cs, sm, prepare_linear, gen, spans, k, n,
                          dual)
        for label, lib in libs.items():
            kcuda._LIBS["stamp_matmul"] = lib
            ms = cs.timed_graph(torch, call, 50, per_graph=10)
            print(f"[probe] {site} {label}: graph_ms={ms:.4f}")
        torch.cuda.empty_cache()


def probe_k3(torch, cs, args) -> None:
    from repro_torch.core.stamp import prepare_linear
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import decode_matmul as dm
    gen = torch.Generator(device="cuda").manual_seed(1)
    sites = [(name, cs.SLOTS, k, n) for name, k, n in cs.LLAMA_DECODE_SITES]
    sites.append(("bucketed_qkv", cs.BUCKETED_ROWS, cs.D,
                  cs.D + 2 * cs.KV_HEADS * cs.HD))
    fills = [int(f) for f in args.fill.split(",")] if args.fill else []
    libs = {} if fills else build_variants(cs, kcuda, "decode_matmul",
                                           args.src, K3_VARIANTS,
                                           dm._SIGNATURES)
    own = dm.FILL
    for site, rows, k, n in sites:
        x = torch.randn((rows, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        p = prepare_linear(torch.randn((k, n), generator=gen, device="cuda")
                           / math.sqrt(k))

        def call():
            return dm.stamp_decode_matmul(x, p.qw, p.sw, p.zw, p.qw_sum,
                                          out_dtype=torch.bfloat16)

        want = dm.decode_matmul_plain(x, p.qw, p.sw, p.zw, p.qw_sum,
                                      out_dtype=torch.bfloat16)
        for fill in fills:
            dm.FILL = fill
            plan = dm.decode_plan(rows, k, n, 132)
            cs.close_bf16(torch, call(), want)
            ms = cs.timed_graph(torch, call, 200)
            print(f"[probe] k3 {site} fill={fill} n_split={plan['n_split']}"
                  f": graph_ms={ms:.4f}")
        dm.FILL = own
        for label, lib in libs.items():
            kcuda._LIBS["decode_matmul"] = lib
            ms = cs.timed_graph(torch, call, 200)
            print(f"[probe] k3 {site} {label}: graph_ms={ms:.4f}")


def probe_k7(torch, cs, args) -> None:
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import int8_gemm as im
    gen = torch.Generator(device="cuda").manual_seed(9)
    libs = build_variants(cs, kcuda, "int8_matmul", args.src, K7_VARIANTS,
                          im._SIGNATURES)
    for site, m, k, n in cs.GEMM_SHAPES:
        qx = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int8)
        qw = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        sx, zx = torch.rand((m, 1), device="cuda"), torch.zeros(
            (m, 1), device="cuda")
        sw, zw = torch.rand((1, n), device="cuda"), torch.zeros(
            (1, n), device="cuda")

        def call():
            return im.int8_matmul(qx, qw, sx, zx, sw, zw)

        for label, lib in libs.items():
            kcuda._LIBS["int8_matmul"] = lib
            ms = cs.timed_graph(torch, call, 20, per_graph=10)
            print(f"[probe] k7 {site} {label}: graph_ms={ms:.4f}")
        del qx, qw
        torch.cuda.empty_cache()


def probe_k6(torch, cs, args) -> None:
    from repro_torch.kernels import cache_attention as ca
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.serving import kvcache as KV
    libs = build_variants(cs, kcuda, "cache_attention", args.src,
                          variants_of(K6_VARIANTS, args.src,
                                      "cache_attention"), ca._SIGNATURES)
    for heads, hd, arch in ((cs.HEADS, cs.HD, "llama"),
                            (cs.KIMI_HEADS, cs.KIMI_HD, "kimi")):
        if hd not in ca._HEAD_DIMS:
            continue
        for name, b, cap, hi, lengths in cs.CACHE_SHAPES:
            gen = torch.Generator(device="cuda").manual_seed(7)
            k = torch.randn((b, cap, cs.KV_HEADS, hd), generator=gen,
                            device="cuda")
            v = torch.randn((b, cap, cs.KV_HEADS, hd), generator=gen,
                            device="cuda")
            entry = KV.quantize_full(k.bfloat16(), v.bfloat16(),
                                     KV.KVCacheConfig(num_hi=hi))
            del k, v
            q = torch.randn((b, 1, heads, hd), generator=gen,
                            device="cuda").bfloat16()
            length = torch.tensor(lengths, dtype=torch.int32, device="cuda")

            def call():
                return ca.cache_decode_attention(entry, q, length)

            for label, lib in libs.items():
                kcuda._LIBS["cache_attention"] = lib
                ms = cs.timed_graph(torch, call, 200)
                print(f"[probe] k6 {arch} {name} {label}: graph_ms={ms:.4f}")
            del entry
            torch.cuda.empty_cache()


def probe_k10(torch, cs, args) -> None:
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import wht as wt
    libs = build_variants(cs, kcuda, "wht", args.src,
                          variants_of(K10_VARIANTS, args.src, "wht"),
                          wt._SIGNATURES)
    gen = torch.Generator(device="cuda").manual_seed(9)
    for name, shape, axis in cs.WHT_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()

        def call():
            return wt.walsh_hadamard(x, axis)

        for label, lib in libs.items():
            kcuda._LIBS["wht"] = lib
            ms = cs.timed_graph(torch, call, 20, per_graph=10)
            print(f"[probe] k10 {name} {label}: graph_ms={ms:.4f}")
        del x
        torch.cuda.empty_cache()


def probe_link(torch, cs, args) -> None:
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import stamp_matmul as sm
    libs = build_variants(cs, kcuda, "span_link", args.src,
                          variants_of(LINK_VARIANTS, args.src, "span_link"),
                          sm._SPAN_SIGNATURES)
    own_plan = sm.span_wht_plan
    own_consts = {k: getattr(sm, k) for p in WINDOW_PLANS.values()
                  for k in p}
    gen = torch.Generator(device="cuda").manual_seed(11)
    qkv = cs.D + 2 * cs.KV_HEADS * cs.HD
    for name, n, dual, s, cases in (
            ("qkv", qkv, False, 2048, LINK_CASES),
            ("gate_up", cs.D_FF, True, 2048, LINK_CASES),
            ("down", cs.D, False, 2048, LINK_CASES),
            ("qkv", qkv, False, 1024, (("dwt", 8),)),
            ("down", cs.D, False, 1024, (("dwt", 8),))):
        g = torch.randn((1, s, n), generator=gen, device="cuda")
        u = torch.randn((1, s, n), generator=gen, device="cuda") \
            if dual else None
        b = torch.randn(n, generator=gen, device="cuda")
        for tf, levels in cases:
            kw = dict(transform=tf, levels=levels, skip_first=True,
                      inverse=True, out_dtype=torch.bfloat16)

            def call():
                return sm.stamp_span_transform(g, u, b, None, **kw)

            runs = list(libs.items())
            runs += [(k, libs["full"]) for k in
                     (["in_sector"] if tf == "wht" else list(WINDOW_PLANS))]
            for label, lib in runs:
                kcuda._LIBS["span_link"] = lib
                if label == "in_sector":
                    sm.span_wht_plan = (lambda *a: own_plan(*a[:5], 4))
                for name_, value in WINDOW_PLANS.get(label, {}).items():
                    setattr(sm, name_, value)
                sm.span_passes.cache_clear()
                sm._PROGRAMS.clear()
                if label == "full" or label not in dict(libs):
                    cs.check(torch.equal(call(), sm.span_transform_plain(
                        g, u, b, None, **kw)), f"link {label} differs")
                ms = cs.timed_graph(torch, call, 20, per_graph=10)
                sm.span_wht_plan = own_plan
                for name_, value in own_consts.items():
                    setattr(sm, name_, value)
                print(f"[probe] link {name} s{s} {tf}{levels} {label}: "
                      f"graph_ms={ms:.4f}")
        del g, u
        torch.cuda.empty_cache()


K1_SITES = [("qkv", 2, 4096), ("down", 2, 14336),
            ("arctic_qkv", 2, 7168), ("arctic_down", 2, 4864),
            ("bucketed4_qkv", 4, 4096), ("bucketed8_qkv", 8, 4096),
            ("bucketed8_down", 8, 14336)]


def probe_k1(torch, cs, args) -> None:
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import stamp_matmul as sm
    configs = [(f"cluster={c}", "MAX_CLUSTER", int(c))
               for c in args.cluster.split(",") if c]
    libs = {} if configs else build_variants(
        cs, kcuda, "stamp_matmul", args.src,
        variants_of(K1_VARIANTS, args.src, "stamp_matmul"), sm._SIGNATURES)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for site, spans, k in K1_SITES:
        x = torch.randn((spans, cs.C, k), generator=gen, device="cuda",
                        dtype=torch.bfloat16)

        def call():
            return sm.stamp_transform_quantize(x, **cs.STAMP)

        want = sm.transform_quantize_plain(x, **cs.STAMP)
        for label, name, value in configs:
            own = getattr(sm, name)
            setattr(sm, name, value)
            got = call()
            cs.check(all(torch.equal(g, w) for g, w in zip(got, want)),
                     f"K1 codes differ at {site} with {label}")
            ms = cs.timed_graph(torch, call, 200)
            print(f"[probe] k1 {site} {label}: graph_ms={ms:.4f}")
            setattr(sm, name, own)
        for label, lib in libs.items():
            kcuda._LIBS["stamp_matmul"] = lib
            ms = cs.timed_graph(torch, call, 200)
            print(f"[probe] k1 {site} {label}: graph_ms={ms:.4f}")


def probe_k5(torch, cs, args) -> None:
    from repro_torch.core.stamp import token_quantize
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import stamp_matmul as sm
    from repro_torch.models import layers as L
    libs = build_variants(cs, kcuda, "grouped_matmul", args.src,
                          variants_of(K5_VARIANTS, args.src,
                                      "grouped_matmul"),
                          sm._GROUPED_SIGNATURE)
    for site, d, f, experts, topk, cf, seed in cs.MOE_SHAPES:
        a = cs.grouped_case(torch, sm, L, token_quantize, d, f, experts,
                            topk, cf, seed)

        def call():
            return sm.stamp_quant_grouped_matmul(*a)

        for label, lib in libs.items():
            kcuda._LIBS["grouped_matmul"] = lib
            ms = cs.timed_graph(torch, call, 10, per_graph=2)
            print(f"[probe] k5 {site} {label}: graph_ms={ms:.4f}")
        del a
        torch.cuda.empty_cache()


def probe_k8(torch, cs, args) -> None:
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import quant_pack as qp
    warps = [int(w) for w in args.warps.split(",") if w]
    libs = {} if warps else build_variants(
        cs, kcuda, "quant_pack", args.src,
        variants_of(K8_VARIANTS, args.src, "quant_pack"), qp._SIGNATURES)
    own = qp.pack_plan
    gen = torch.Generator(device="cuda").manual_seed(9)
    for name, shape, bits, dtype in cs.PACK_SHAPES:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(
            getattr(torch, dtype))

        def call():
            return qp.quantize_pack(x, bits)

        want = qp.quant_pack_plain(x, bits)
        for g in warps:              # the registers route at g warps a row
            def plan(d, elem, *a, g=g):
                p = own(d, elem, *a)
                need = -(-(d * elem // 16) // (32 * g))
                nv = next((v for v in qp.LANE_WORDS if v >= need), 0)
                block = max(g, getattr(qp, "ROW_BLOCK", qp.WARPS))
                return dict(p, g=g, nv=nv, rows_per_block=block // g) \
                    if p["nv"] and nv else p

            qp.pack_plan = plan
            cs.check(all(torch.equal(a, b) for a, b in zip(call(), want)),
                     f"K8 differs at {name} with {g} warps a row")
            ms = cs.timed_graph(torch, call, 20, per_graph=10)
            print(f"[probe] k8 {name} warps={g}: graph_ms={ms:.4f}")
            qp.pack_plan = own
        for label, lib in libs.items():
            kcuda._LIBS["quant_pack"] = lib
            ms = cs.timed_graph(torch, call, 20, per_graph=10)
            print(f"[probe] k8 {name} {label}: graph_ms={ms:.4f}")
        ms = cs.timed_graph(torch, cs.copy_ceiling(torch, x, bits), 20,
                            per_graph=10)
        print(f"[probe] k8 {name} copy_ceiling: graph_ms={ms:.4f}")
        del x
        torch.cuda.empty_cache()


def probe_k4(torch, cs, args) -> None:
    from repro_torch.kernels import cuda as kcuda
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import kvcache as KV
    from repro_torch.serving import paged_kvcache as PKV
    own_plan = pa.launch_plan
    forced = {}

    def plan(*a):
        p = own_plan(*a)
        if "n_split" in forced:      # block slots a decode span
            p.update(n_split=forced["n_split"])
        return p

    pa.launch_plan = plan
    if args.sweep:
        sweep_k4(torch, cs, pa, PKV, KV, forced, args.splits, own_plan)
        return
    libs = build_variants(cs, kcuda, "paged_attention", ROOT, K4_CUTS,
                          pa._SIGNATURES) if args.cuts else {}
    whole = kcuda.library("paged_attention", pa._SIGNATURES)
    for heads, arch in ((cs.HEADS, "llama"), (cs.A_HEADS, "arctic")):
        for name, n_pf in (("all_decode", 0), ("mixed", cs.SPANS)):
            entry, q_pf, q_dec, starts, lens, ht, lt, _ = \
                cs._attention_case(torch, PKV, KV, n_pf, torch.bfloat16,
                                   heads)
            step = (entry, q_pf, q_dec, starts, lens, ht, lt)

            def call():
                return pa.paged_ragged_attention(*step, cs.BLOCK)

            want = torch.cat([t.flatten() for t in
                              pa.paged_attention_plain(*step, cs.BLOCK)])
            own = own_plan(0, len(lengths), cs.C, heads // cs.KV_HEADS,
                           cs.KV_HEADS, tiles * pa.KV_TILE, sms)["n_split"]
            runs = [("plan", None)] + [(f"n_split={n}", int(n))
                                       for n in args.splits.split(",")]
            for label, n in runs:
                forced.clear()
                if n is not None:
                    forced["n_split"] = n
                cs.close_bf16(torch, torch.cat([t.flatten()
                                                for t in call()]), want)
                ms = cs.timed_graph(torch, call, 200)
                print(f"[probe] {arch} {name} {label}: graph_ms={ms:.4f}")
            forced.clear()
            for label, lib in libs.items():
                kcuda._LIBS["paged_attention"] = lib
                ms = cs.timed_graph(torch, call, 200)
                print(f"[probe] {arch} {name} {label}: graph_ms={ms:.4f}")
            kcuda._LIBS["paged_attention"] = whole


SWEEP_LENGTHS = [(f"uniform{n}", [n] * 8, 0)
                 for n in (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)]
SWEEP_LENGTHS += [("ragged_long", [32768, 30001, 24576, 16385, 8192, 4097,
                                   1024, 65], 0),
                  ("short_in_32768", [97 + j for j in range(8)], 32768)]


def sweep_k4(torch, cs, pa, PKV, KV, forced, splits, own_plan) -> None:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for heads, arch in ((cs.HEADS, "llama"), (cs.A_HEADS, "arctic")):
        for name, lengths, capacity in SWEEP_LENGTHS:
            entry, q_pf, q_dec, starts, lens, ht, lt, _ = \
                cs._attention_case(torch, PKV, KV, 0, torch.bfloat16, heads,
                                   lengths, capacity)
            step = (entry, q_pf, q_dec, starts, lens, ht, lt)

            def call():
                return pa.paged_ragged_attention(*step, cs.BLOCK)

            want = pa.paged_attention_plain(*step, cs.BLOCK)[1]
            tiles = -(-(ht.shape[1] + lt.shape[1]) * cs.BLOCK // pa.KV_TILE)
            own = own_plan(0, len(lengths), cs.C, heads // cs.KV_HEADS,
                           cs.KV_HEADS, tiles * pa.KV_TILE, sms)["n_split"]
            runs = [("plan", None)] + [(f"n_split={n}", int(n))
                                       for n in splits.split(",")
                                       if int(n) <= tiles]
            for label, n in runs:
                forced.clear()
                if n is not None:
                    forced["n_split"] = n
                cs.close_bf16(torch, call()[1], want)
                ms = cs.timed_graph(torch, call, 200)
                print(f"[probe] {arch} {name} {label} (plan n_split={own})"
                      f": graph_ms={ms:.4f}")
            forced.clear()
            del entry, step, want
            torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=("k1", "k2", "k3", "k4", "k5", "k6",
                                       "k7", "k8", "k10", "link"))
    ap.add_argument("--src", type=Path, default=ROOT)
    ap.add_argument("--fill", default="")
    ap.add_argument("--cluster", default="")
    ap.add_argument("--warps", default="")
    ap.add_argument("--splits", default="1,2,3,5")
    ap.add_argument("--cuts", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve() / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("the probe needs a CUDA card")
    print(cs.nvidia_smi())
    with torch.inference_mode():
        {"k1": probe_k1, "k2": probe_k2, "k3": probe_k3, "k4": probe_k4,
         "k5": probe_k5, "k6": probe_k6, "k7": probe_k7, "k8": probe_k8,
         "k10": probe_k10, "link": probe_link}[args.kernel](torch, cs,
                                                           args)


if __name__ == "__main__":
    main()
