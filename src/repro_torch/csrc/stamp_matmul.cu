// Fused STaMP prefill linears for Hopper (sm_90a): K1 transform + quantize,
// K2 integer GEMM with the zero-point epilogue, inverse transform and bias.
//
// Replaces the Pallas kernels stamp_quant_matmul_pallas and
// stamp_quant_dual_matmul_pallas (src/repro/kernels/stamp_matmul.py).  The
// TPU kernel keeps a whole (s, K) activation tile in VMEM; at s = 128 and
// K = 14336 the int8 codes alone are 1.8 MB against 227 KB of shared memory,
// so the chain is split in two launches:
//
// K1 stamp_transform_quantize: the sequence transform runs along rows and is
//   independent per column, but the quantizer's min/max is per row across
//   all of K.  One launch: blocks own a row window of a span (the output
//   rows a few input rows determine, see the K1 section) over one K range,
//   the K ranges of a window form a thread block cluster that exchanges
//   the rows' partial min/max in distributed shared memory, and each block
//   then quantizes its range, recomputing the window's transform from the
//   input (an L2 read) rather than holding f32 values.
// K2 stamp_int_gemm: one block holds ALL rows of one span (<= 128) for a
//   tile of output columns, so the epilogue, the inverse transform along the
//   span and the bias (and the dual silu(g)*u) stay on chip: the (C, N) f32
//   product never reaches device memory.  The integer product runs on the
//   tensor cores: two warpgroups, each wgmma m64n128k32 s8 -> s32 on its 64
//   rows, over a 128-column B tile (128 weight columns, or 64 gate + 64 up
//   columns in the dual mode).  A and the B tile's raw (K, N) rows arrive
//   through a 4-stage cp.async ring of 16-byte copies (4-byte ones where K
//   or N is not a multiple of 16), their addresses set up once a block.
//   wgmma reads K-major operands, and the (K, N) weight is N-major, so each
//   step half the block transposes the next B tile with __byte_perm into
//   wgmma's core-matrix layout (16-byte stores; the 8-column groups padded
//   to 528 bytes so the stores spread over the banks) while the tensor cores
//   work on this one, and the other half sums the A rows (Σqx); one barrier
//   a step.  The weight's column sums Σqw are fixed with the weight, so
//   they come in precomputed (PreparedLinear.qw_sum).  After the main loop
//   the epilogue's f32 tiles and the transform's scratch reuse the stage
//   buffers (two chunks of columns), so a block takes 81 KB and two blocks
//   share an SM.  Where the column tiles and spans give fewer blocks than
//   the card has SMs (the paged path's 2 spans at qkv and down), K is split
//   into ranges of whole steps (kernels/stamp_matmul.py: gemm_plan) whose
//   blocks form one thread block cluster: the ranges exchange their int32
//   products through distributed shared memory, and ranges 0 and 1 each
//   finish one chunk (integer sums, exact in any order).
//
// Bound on the H100: K2 at the main path's shapes (2 spans x 128 rows) does
// 2*256*K*N int8 operations on K*N weight bytes — about 500 operations per
// weight byte, just under the card's ~590 int8 ops/byte ridge.  Measured
// (tools/probe.py k2), the tensor cores and the transpose hide behind the
// issue of the stage copies, which with the epilogue bound the kernel.  K1
// is bound by bytes, and at the main path's sizes (a few MB) by the
// latency of its one launch and its passes.
//
// Numerics mirror the reference as it runs compiled: true division
// (__fdiv_rn) by the per-token scale, round half to even (rintf), the 1e-8
// scale floor, clip to [0, n] then -128.  The Haar butterflies and the
// WHT's final 1/sqrt(p) multiply by f32 reciprocals: XLA turns the
// reference's division by those constants into that product.  Built with
// -fmad=false so the f32 epilogue evaluates in the plain version's order.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

struct SeqT {
  int kind;      // 0 none, 1 Haar DWT, 2 WHT
  int levels;
  int skip;      // first (sink) row stays out of the transform
  float inv_sqrt2;  // f32 reciprocal of f32(sqrt(2))
  float inv_wht;    // f32 reciprocal of f32(sqrt(p)), p = largest 2^k <= rows
};

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------- K1 ----
//
// A row window is a set of at most TQ_OUT output rows of a span whose
// transform needs only a few input rows: under the Haar DWT of `levels`
// levels an output row depends on at most 2^levels consecutive input rows
// (and, where a band has odd length, on the pair at the band's start: the
// reference carries the first detail of an odd band into the next level),
// under the WHT on the p rows of its block, under none on itself alone.
// The host works the windows out (kernels/stamp_matmul.py: tq_windows) as
// a small program each: the input rows it loads into slots, the
// butterflies on slots in the reference's order (in place: every value is
// consumed once), and which slot holds which output row.  A block runs one
// window over one K range of one span; the K ranges of a (window, span)
// form a thread block cluster of up to 16.  The window's program sits in
// shared memory; each thread carries TQ_U columns at once (all its input
// rows' loads in flight together), its slots in shared memory (its own
// column: no barrier), and keeps the window's per-row min / max in
// registers; the block reduces them, the cluster exchanges the ranges'
// partial min / max through distributed shared memory (every rank's read
// in flight at once), and every block derives the rows' scales and zero
// points and quantizes its range.  Where a range is one chunk of columns
// (K up to 16 x 512: every main-path site but the down projection's) the
// window's outputs wait in registers for the quantize; else 8 ranges make
// a second pass that recomputes them from the input, read back from L2
// (measured faster there than 4 columns a thread kept in registers, whose
// 216 registers left one block an SM).  One launch; no scratch in device
// memory.

constexpr int TQ_OUT = 16;       // output rows of a window (registers)
constexpr int TQ_BATCH = 16;     // input rows loaded before they are stored
constexpr int TQ_HDR = 8;        // ints of a window's program header
constexpr int TQ_MAX_CL = 16;    // K ranges of a cluster
constexpr int TQ_U = 2;          // columns a thread carries at once
constexpr int TQ_SMEM = 200 * 1024;   // dynamic shared memory a block may ask

enum TqOp { TQ_HAAR = 1, TQ_BFLY = 2, TQ_SCALE = 3 };

__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// KEEP: the block's K range is one chunk of TQ_U x blockDim columns, so the
// window's outputs stay in registers from the min / max to the quantize
// (else the second pass recomputes them from the input, read back from L2).
// Two blocks an SM (at most 128 registers a thread), so a span's windows
// and ranges at the main path's sizes start in one wave.
template <typename T, bool KEEP>
__global__ void __launch_bounds__(256, 2)
tq_kernel(const T* __restrict__ x, int S, int K, const int* __restrict__ prog,
          float inv_sqrt2, float inv_wht, int num_hi, float n_hi, float n_lo,
          int kc, int room, int8_t* qx, float* sx, float* zx,
          const float* __restrict__ given, float* stats) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int U = TQ_U;
  // the window's program (room ints), then the slots [slot][U * blockDim.x]
  extern __shared__ int pg[];
  float* rf = reinterpret_cast<float*>(pg + room);
  __shared__ float wmn[8][TQ_OUT], wmx[8][TQ_OUT];
  __shared__ float bmn[TQ_OUT], bmx[TQ_OUT], sc[TQ_OUT], zp[TQ_OUT];
  const int nt = blockDim.x, tid = threadIdx.x, ld = U * nt;
  const int* hdr = prog + TQ_HDR * blockIdx.y;
  const int ni = hdr[0], nops = hdr[1], nout = hdr[2];
  const int len = hdr[5] + 2 * nout - hdr[3];     // inputs, ops, outputs
  for (int i = tid; i < len; i += nt) pg[i] = prog[hdr[3] + i];
  __syncthreads();
  const int* in_rows = pg;
  const int* ops = pg + (hdr[4] - hdr[3]);
  const int* outs = pg + (hdr[5] - hdr[3]);
  const int b = blockIdx.z, rank = (int)cluster.block_rank();
  const int c0 = rank * kc, c1 = min(K, c0 + kc);
  const T* xs = x + (size_t)b * S * K;

  // the window's transform of columns cb + u * nt + tid into the slots
  auto transform = [&](int cb) {
    for (int s0 = 0; s0 < ni; s0 += TQ_BATCH) {
      float v[TQ_BATCH][U];
#pragma unroll
      for (int q = 0; q < TQ_BATCH; ++q)
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int col = cb + u * nt + tid;
          v[q][u] = s0 + q < ni && col < c1
                        ? ldg_f(xs + (size_t)in_rows[s0 + q] * K + col)
                        : 0.0f;
        }
#pragma unroll
      for (int q = 0; q < TQ_BATCH; ++q)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (s0 + q < ni) rf[(s0 + q) * ld + u * nt + tid] = v[q][u];
    }
    // the ops in order, each in place on its slots
    for (int o = 0; o < nops; ++o) {
      const int code = ops[o];
      const int kind = (unsigned)code >> 28;
      const int i = (code >> 14) & 0x3fff, j = code & 0x3fff;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float* a = rf + i * ld + u * nt + tid;
        if (kind == TQ_SCALE) {
          *a = *a * inv_wht;
        } else {
          float* c = rf + j * ld + u * nt + tid;
          const float va = *a, vc = *c;
          if (kind == TQ_HAAR) {
            *a = (va + vc) * inv_sqrt2;
            *c = (va - vc) * inv_sqrt2;
          } else {
            *a = va + vc;
            *c = va - vc;
          }
        }
      }
    }
  };

  float mn[TQ_OUT], mx[TQ_OUT];
  float keep[KEEP ? TQ_OUT : 1][U];
#pragma unroll
  for (int q = 0; q < TQ_OUT; ++q) {
    mn[q] = INFINITY;
    mx[q] = -INFINITY;
  }
  // (given statistics: the pass only keeps the outputs for the quantize)
  for (int cb = c0; cb < c1 && (KEEP || !given); cb += ld) {
    transform(cb);
#pragma unroll
    for (int q = 0; q < TQ_OUT; ++q) {
      if (q < nout) {
        const float* r = rf + outs[2 * q] * ld + tid;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float v = r[u * nt];
          if (KEEP) keep[KEEP ? q : 0][u] = v;
          if (cb + u * nt + tid < c1) {
            mn[q] = fminf(mn[q], v);
            mx[q] = fmaxf(mx[q], v);
          }
        }
      }
    }
  }
  // the block's min / max of each row, then the cluster's
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
#pragma unroll
  for (int q = 0; q < TQ_OUT; ++q) {
    float a = mn[q], c = mx[q];
    for (int o = 16; o > 0; o >>= 1) {
      a = fminf(a, __shfl_xor_sync(0xffffffffu, a, o));
      c = fmaxf(c, __shfl_xor_sync(0xffffffffu, c, o));
    }
    if (lane == 0) {
      wmn[warp][q] = a;
      wmx[warp][q] = c;
    }
  }
  __syncthreads();
  if (tid < nout) {
    float a = INFINITY, c = -INFINITY;
    for (int w = 0; w < nw; ++w) {
      a = fminf(a, wmn[w][tid]);
      c = fmaxf(c, wmx[w][tid]);
    }
    bmn[tid] = a;
    bmx[tid] = c;
  }
  cluster.sync();
  if (tid < nout) {
    const int ranks = (int)cluster.num_blocks();
    float pa[TQ_MAX_CL], pc[TQ_MAX_CL];
#pragma unroll
    for (int rk = 0; rk < TQ_MAX_CL; ++rk) {   // all ranks' loads in flight
      pa[rk] = rk < ranks ? *cluster.map_shared_rank(bmn + tid, rk)
                          : INFINITY;
      pc[rk] = rk < ranks ? *cluster.map_shared_rank(bmx + tid, rk)
                          : -INFINITY;
    }
    float a = pa[0], c = pc[0];
#pragma unroll
    for (int rk = 1; rk < TQ_MAX_CL; ++rk) {
      a = fminf(a, pa[rk]);
      c = fmaxf(c, pc[rk]);
    }
    const int row = outs[2 * tid + 1];
    if (given) {            // the whole row's, all-reduced over its blocks
      a = given[2 * ((size_t)b * S + row)];
      c = given[2 * ((size_t)b * S + row) + 1];
    }
    if (stats && rank == 0) {
      stats[2 * ((size_t)b * S + row)] = a;
      stats[2 * ((size_t)b * S + row) + 1] = c;
    }
    const float n = row < num_hi ? n_hi : n_lo;
    const float s = fmaxf(__fdiv_rn(c - a, n), 1e-8f);
    const float z = rintf(__fdiv_rn(-a, s));
    sc[tid] = s;
    zp[tid] = z;
    if (rank == 0 && !stats) {
      sx[(size_t)b * S + row] = s;
      zx[(size_t)b * S + row] = z - 128.0f;   // shifted with the codes
    }
  }
  __syncthreads();
  for (int cb = c0; cb < c1 && !stats; cb += ld) {
    if (!KEEP) transform(cb);
#pragma unroll
    for (int q = 0; q < TQ_OUT; ++q) {
      if (q < nout) {
        const int row = outs[2 * q + 1];
        const float s = sc[q], z = zp[q];
        const float n = row < num_hi ? n_hi : n_lo;
        const float* r = rf + outs[2 * q] * ld + tid;
        int8_t* o = qx + ((size_t)b * S + row) * K;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int col = cb + u * nt + tid;
          if (col < c1) {
            const float v = KEEP ? keep[KEEP ? q : 0][u] : r[u * nt];
            float qv = rintf(__fdiv_rn(v, s)) + z;
            qv = fminf(fmaxf(qv, 0.0f), n);
            o[col] = (int8_t)(int)(qv - 128.0f);
          }
        }
      }
    }
  }
  cluster.sync();    // the block's min / max stay until every rank read them
}

// ---------------------------------------------------------------- K2 ----

constexpr int RM = 128;          // rows per block: one whole span
constexpr int BNV = 128;         // B columns a block multiplies (dual: 64 + 64)
constexpr int BK = 64;           // k per stage
constexpr int STAGES = 4;
// A and the transposed B tile are stored as wgmma's K-major core matrices
// without swizzle: 8 rows x 16 k-bytes (128 contiguous bytes) each, the 4
// k-chunks of an 8-row group next to each other (LBO 128 bytes), 8-row
// groups 512 bytes apart in A and 528 in B (SBO): the padding puts the
// 16-byte stores of the transposing pass on distinct banks.
constexpr int CM_LBO = 128, A_SBO = 512, BT_SBO = 528;
constexpr int A_BYTES = RM * BK;             // 8192
constexpr int B_BYTES = BK * BNV;            // 8192 (raw k rows of 128 bytes)
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int BT_BYTES = BNV / 8 * BT_SBO;   // 8448, two of them
constexpr int BT_OFF = STAGES * STAGE_BYTES;
constexpr int RS_OFF = BT_OFF + 2 * BT_BYTES;
constexpr int GEMM_SMEM = RS_OFF + RM * 4;   // 82944
// the epilogue's per-row (sx, zx) and per-column (zw, Σqw, sw, bias of each
// weight) values, staged in shared memory where the transposed B buffers
// were
constexpr int EPI_FLOATS = 2 * RM + 8 * 64;
static_assert(EPI_FLOATS * 4 <= 2 * BT_BYTES, "epilogue values fit");
constexpr int MAX_SPLITS = 8;      // k ranges a cluster can hold
constexpr int GEMM_THREADS = 256;

// output columns a block writes, and the width of an epilogue chunk (two
// chunks a block; its Y tiles and the transform's scratch alias the stages)
template <bool DUAL> struct Cols {
  static constexpr int BLOCK = DUAL ? BNV / 2 : BNV;
  static constexpr int EW = BLOCK / 2;
};

// The epilogue's inputs; pout / pin: a row-parallel block's parts (see
// stamp_int_gemm), written in place of the epilogue, or read in place of
// the product.
struct Epi {
  const float* sx; const float* zx;
  const float* sw0; const float* zw0; const int* ws0; const float* b0;
  const float* sw1; const float* zw1; const int* ws1; const float* b1;
  int* pout; const int* pin;
};

__device__ __forceinline__ void cp_async_z(void* dst, const void* src,
                                           int bytes, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? bytes : 0;   // zero-fill what lies outside
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void transpose4(int w0, int w1, int w2, int w3,
                                           int* col) {
  const int t0 = __byte_perm(w0, w1, 0x5140);
  const int t1 = __byte_perm(w2, w3, 0x5140);
  const int t2 = __byte_perm(w0, w1, 0x7362);
  const int t3 = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// Byte offset of (row, 16-byte k-chunk c) in a core-matrix tile.
template <int SBO>
__device__ __forceinline__ int cm_off(int row, int c) {
  return (row >> 3) * SBO + c * CM_LBO + (row & 7) * 16;
}

template <int SBO>
__device__ __forceinline__ uint64_t cm_desc(const void* p) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(p);
  return ((a >> 4) & 0x3FFF) | ((uint64_t)(CM_LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);   // layout 0: no swizzle
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
__device__ __forceinline__ void reg_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 128, int32) += A (64 x 32, s8, K-major) * B (32 x 128, s8,
// K-major), both from shared memory; D in the m64nNk32 fragment layout.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Inverse sequence transform of the S x W tile `buf` (row stride W) along
// rows, in place, with `tmp` as scratch: seq_transform's inverse with the
// width known at compile time (the same operations in the same order).
template <int W>
__device__ void inverse_rows(float* buf, float* tmp, int S, const SeqT& t) {
  const int off = t.skip ? 1 : 0;
  const int n = S - off;
  if (n <= 0 || t.kind == 0) return;
  float* x = buf + off * W;
  float* y = tmp + off * W;
  if (t.kind == 1) {
    int sizes[34];
    int ns = 0, lo = n;
    sizes[ns++] = lo;
    for (int l = 0; l < t.levels && lo >= 2; ++l) {
      lo = (lo + 1) / 2;
      sizes[ns++] = lo;
    }
    for (int i = 0; i < ns - 1; ++i) {
      const int pairs = sizes[ns - 2 - i] / 2;
      for (int idx = threadIdx.x; idx < 2 * pairs * W; idx += blockDim.x) {
        const int r = idx / W, c = idx % W, q = r / 2;
        const float a = x[q * W + c], d = x[(pairs + q) * W + c];
        y[idx] = (r % 2 == 0) ? (a + d) * t.inv_sqrt2 : (a - d) * t.inv_sqrt2;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < 2 * pairs * W; idx += blockDim.x)
        x[idx] = y[idx];
      __syncthreads();
    }
  } else {
    int p = 1;
    while (2 * p <= n) p *= 2;
    for (int h = 1; h < p; h *= 2) {
      for (int idx = threadIdx.x; idx < (p / 2) * W; idx += blockDim.x) {
        const int pr = idx / W, c = idx % W;
        const int i0 = (pr / h) * 2 * h + pr % h, i1 = i0 + h;
        const float a = x[i0 * W + c], b = x[i1 * W + c];
        x[i0 * W + c] = a + b;
        x[i1 * W + c] = a - b;
      }
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < p * W; idx += blockDim.x)
      x[idx] = x[idx] * t.inv_wht;
    __syncthreads();
  }
}

// Zero-point epilogue, inverse sequence transform, bias (and silu(g)*u) of
// one chunk of EW output columns from nbase, for the S rows of the span at
// row0.  Y0 (Y1) hold the int32 products as bits; rs the rows' Σqx; `ep`
// (EPI_FLOATS) holds the rows' sx and zx, and gets the chunk's column
// values.  Same evaluation order as the plain version:
//   ((acc - zx*Σqw) - zw*Σqx + (K*zx)*zw) * sx * sw
template <bool DUAL, int EW, typename TO>
__device__ void finish_chunk(float* Y0, float* Y1, float* Tmp, const float* rs,
                             float* ep, int S, int K, int N, int nbase,
                             size_t row0, const Epi& e, const SeqT& t,
                             TO* out) {
  const float* sxs = ep;
  const float* zxs = ep + RM;
  float* cp = ep + 2 * RM;   // zw, Σqw, sw, bias; the up weight's at +4 EW
  for (int i = threadIdx.x; i < (DUAL ? 2 : 1) * EW; i += blockDim.x) {
    const int c = i % EW, n = nbase + c;
    const bool up = i >= EW;
    const bool ok = n < N;
    const float* zw = up ? e.zw1 : e.zw0;
    const float* sw = up ? e.sw1 : e.sw0;
    const int* ws = up ? e.ws1 : e.ws0;
    const float* b = up ? e.b1 : e.b0;
    float* o = cp + (up ? 4 * EW : 0);
    o[c] = ok ? zw[n] : 0.0f;
    o[EW + c] = ok ? (float)ws[n] : 0.0f;
    o[2 * EW + c] = ok ? sw[n] : 0.0f;
    o[3 * EW + c] = ok && b ? b[n] : 0.0f;
  }
  __syncthreads();
  const float kf = (float)K;
  for (int idx = threadIdx.x; idx < S * EW; idx += blockDim.x) {
    const int r = idx / EW, c = idx % EW;
    const float s = sxs[r], z = zxs[r], q = rs[r];
    const float w0 = cp[c];
    Y0[idx] = ((((float)__float_as_int(Y0[idx]) - z * cp[EW + c]) - w0 * q) +
               (kf * z) * w0) * s * cp[2 * EW + c];
    if (DUAL) {
      const float w1 = cp[4 * EW + c];
      Y1[idx] = ((((float)__float_as_int(Y1[idx]) - z * cp[5 * EW + c]) -
                  w1 * q) + (kf * z) * w1) * s * cp[6 * EW + c];
    }
  }
  __syncthreads();
  inverse_rows<EW>(Y0, Tmp, S, t);
  if (DUAL) inverse_rows<EW>(Y1, Tmp, S, t);
  for (int idx = threadIdx.x; idx < S * EW; idx += blockDim.x) {
    const int r = idx / EW, c = idx % EW, n = nbase + c;
    if (n >= N) continue;
    float v = Y0[idx] + cp[3 * EW + c];
    if (DUAL) {
      const float u = Y1[idx] + cp[7 * EW + c];
      v = (v * (1.0f / (1.0f + expf(-v)))) * u;  // jax.nn.silu's steps
    }
    store_f(out + (row0 + r) * N + n, v);
  }
}

// The rows' sx and zx into `ep`.
__device__ __forceinline__ void stage_rows(float* ep, const Epi& e, int S,
                                           size_t row0) {
  for (int r = threadIdx.x; r < S; r += blockDim.x) {
    ep[r] = e.sx[row0 + r];
    ep[RM + r] = e.zx[row0 + r];
  }
}

// Main loop: block (span, column tile, k range).  A (the span's codes) and
// the B tile's raw k rows arrive through a 4-stage cp.async ring.  One
// barrier a step: after it, each of the two warpgroups starts its
// wgmma m64n128k32 s8 -> s32 on its 64 rows (A and the transposed B of step
// kt, from shared memory), and while the tensor cores run, half the block
// transposes step kt+1's raw B tile (__byte_perm) into the other transposed
// buffer and the other half sums its A rows (Σqx, dp4a).  With several k
// ranges, the ranges' blocks form a cluster and the first sums the others'
// products before the epilogue.
template <bool DUAL, typename TO, bool VEC>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
stamp_gemm_kernel(const int8_t* qx, int S, int K, int N, const int8_t* qw0,
                  const int8_t* qw1, Epi e, SeqT t, int split_k, int rows,
                  TO* out) {
  extern __shared__ __align__(128) unsigned char gsm[];
  using CL = Cols<DUAL>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;                 // warpgroup: rows 64 wg ..
  // spans vary fastest, so the spans of a column tile run together and
  // the weight tile comes from device memory once, then from L2
  const int n0 = blockIdx.y * CL::BLOCK;
  const size_t row0 = (size_t)blockIdx.x * S;
  // a long span without a transform runs as tiles of S rows, the last one
  // ragged: its block takes the rows that are left
  S = min(S, (int)((size_t)rows - row0));
  // summed parts: no product of its own; the whole K from the parts' corner
  if (e.pin) K = e.pin[(size_t)rows * (N + 1) + N];
  const int split = blockIdx.z, n_split = gridDim.z;
  const int kb = split * split_k, ke = min(K, kb + split_k);
  const int KT = e.pin ? 0 : (ke - kb + BK - 1) / BK;
  // VEC: 16-byte copies (K and N multiples of 16), each thread's two A and
  // two B copies a stage set up once, a stage then moves the pointers by
  // BK; otherwise 4-byte copies, their addresses worked out per stage
  constexpr int CH = VEC ? 16 : 4;                 // bytes a copy
  constexpr int A_SH = VEC ? 2 : 4, B_SH = VEC ? 3 : 5;   // log2 copies a row
  constexpr int NC = VEC ? (RM << A_SH) / GEMM_THREADS : 1;
  const int8_t* ga[NC];
  const int8_t* gb[NC];
  int sa[NC], sb[NC], ka[NC], kr[NC];
  bool va[NC], vb[NC];
  if (VEC) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int i = tid + j * GEMM_THREADS;
      const int r = i >> A_SH, c = i & ((1 << A_SH) - 1);
      ka[j] = kb + c * CH;
      va[j] = r < S;
      ga[j] = va[j] ? qx + (row0 + r) * K + ka[j] : qx;
      sa[j] = cm_off<A_SBO>(r, c);
      const int rb = i >> B_SH, cb = i & ((1 << B_SH) - 1);
      int col = cb * CH;
      const int8_t* w = qw0;
      if (DUAL && col >= BNV / 2) { w = qw1; col -= BNV / 2; }
      kr[j] = kb + rb;
      vb[j] = n0 + col < N;
      gb[j] = vb[j] ? w + (size_t)kr[j] * N + n0 + col : qw0;
      sb[j] = A_BYTES + rb * BNV + cb * CH;
    }
  }

  auto issue = [&](int kt) {
    unsigned char* st = gsm + (kt % STAGES) * STAGE_BYTES;
    const int k0 = kt * BK;
    if (VEC) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const bool oa = va[j] && ka[j] + k0 < ke;
        cp_async_z(st + sa[j], oa ? ga[j] + k0 : qx, 16, oa);
        const bool ob = vb[j] && kr[j] + k0 < ke;
        cp_async_z(st + sb[j], ob ? gb[j] + (size_t)k0 * N : qw0, 16, ob);
      }
    } else {
      for (int i = tid; i < (RM << A_SH); i += GEMM_THREADS) {
        const int r = i >> A_SH, c = i & ((1 << A_SH) - 1);
        const int k = kb + k0 + c * CH;
        const bool ok = r < S && k < ke;
        const int byte = c * CH;
        cp_async_z(st + cm_off<A_SBO>(r, byte >> 4) + (byte & 15),
                   ok ? qx + (row0 + r) * K + k : qx, CH, ok);
      }
      for (int i = tid; i < (BK << B_SH); i += GEMM_THREADS) {
        const int rb = i >> B_SH, c = i & ((1 << B_SH) - 1);
        const int k = kb + k0 + rb;
        int col = c * CH;
        const int8_t* w = qw0;
        if (DUAL && col >= BNV / 2) { w = qw1; col -= BNV / 2; }
        const int n = n0 + col;
        const bool ok = k < ke && n < N;
        cp_async_z(st + A_BYTES + rb * BNV + c * CH,
                   ok ? w + (size_t)k * N + n : qw0, CH, ok);
      }
    }
  };

  // Threads 0-127: raw B of stage kt -> the k-major core matrices of
  // transposed buffer kt % 2, a thread a (16-byte k-chunk, 4 columns) item:
  // 16 word loads (a warp reads 32 consecutive words of a k row), 4
  // __byte_perm transposes, 4 16-byte stores (distinct banks by the SBO
  // padding).  Threads 128-255: Σqx of row tid - 128 of stage kt's A tile.
  int my_rsum = 0;
  auto transpose = [&](int kt) {
    const unsigned char* st = gsm + (kt % STAGES) * STAGE_BYTES;
    if (tid < 128) {
      const int* Bw = reinterpret_cast<const int*>(st + A_BYTES);
      unsigned char* Bt = gsm + BT_OFF + (kt & 1) * BT_BYTES;
      const int c = tid >> 5, cw = tid & 31;
      int col[4][4];   // [k-quad][column]
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int* w = Bw + (16 * c + 4 * q) * 32 + cw;
        transpose4(w[0], w[32], w[64], w[96], col[q]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<int4*>(Bt + cm_off<BT_SBO>(4 * cw + j, c)) =
            make_int4(col[0][j], col[1][j], col[2][j], col[3][j]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int4 v = *reinterpret_cast<const int4*>(
            st + cm_off<A_SBO>(tid - 128, c));
        my_rsum = __dp4a(v.x, 0x01010101, my_rsum);
        my_rsum = __dp4a(v.y, 0x01010101, my_rsum);
        my_rsum = __dp4a(v.z, 0x01010101, my_rsum);
        my_rsum = __dp4a(v.w, 0x01010101, my_rsum);
      }
    }
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  const bool busy = wg * 64 < S;   // a warpgroup whose rows lie past the span idles

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) issue(s);
    cp_commit();
  }
  cp_wait<STAGES - 2>();
  __syncthreads();
  if (KT > 0) transpose(0);
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 3>();
    fence_async_smem();   // this thread's copies and stores, to the tensor cores
    __syncthreads();      // Bt kt % 2 written, stage kt + 1 landed
    if (busy) {
      const unsigned char* As =
          gsm + (kt % STAGES) * STAGE_BYTES + wg * 8 * A_SBO;
      const unsigned char* Bt = gsm + BT_OFF + (kt & 1) * BT_BYTES;
      reg_fence(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        wgmma_s8(acc, cm_desc<A_SBO>(As + 2 * ks * CM_LBO),
                 cm_desc<BT_SBO>(Bt + 2 * ks * CM_LBO));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      reg_fence(acc);
    }
    if (kt + STAGES - 1 < KT) issue(kt + STAGES - 1);
    cp_commit();
    if (kt + 1 < KT) transpose(kt + 1);
    if (busy) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      reg_fence(acc);
    }
  }
  cp_wait<0>();
  __syncthreads();     // the stages are free for the epilogue's tiles

  // fragment of acc: rows 64 wg + 16 (warp % 4) + lane / 4 (+8 for regs
  // 4j + 2, 4j + 3), columns 8 j + 2 (lane % 4) (+1) of the 128-wide tile;
  // single: epilogue chunk c holds columns [64c, 64c + 64); dual: gate
  // columns [32c, 32c + 32) and the up columns 64 further
  auto chunk_of = [](int j) {
    return DUAL ? ((8 * j) % (BNV / 2)) / (BNV / 4) : (8 * j) / (BNV / 2);
  };
  int c_first = 0, c_last = 1;
  if (n_split > 1) {
    // The k ranges of one (span, column tile) form a thread block cluster:
    // every range leaves its int32 products and row sums in its shared
    // memory; range c (c < 2) adds the others' products of epilogue chunk
    // c and all row sums to its own through distributed shared memory, and
    // runs that chunk's epilogue.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    int* mine = reinterpret_cast<int*>(gsm);
#pragma unroll
    for (int q = 0; q < 16; ++q)
      reinterpret_cast<int4*>(mine)[q * GEMM_THREADS + tid] =
          make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                    acc[4 * q + 3]);
    mine[16 * 4 * GEMM_THREADS + tid] = my_rsum;
    cluster.sync();
    if (split < 2)
      for (int rk = 0; rk < n_split; ++rk) {
        if (rk == split) continue;
        const int* rem = cluster.map_shared_rank(mine, rk);
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          if (chunk_of(q) != split) continue;
          const int4 v =
              reinterpret_cast<const int4*>(rem)[q * GEMM_THREADS + tid];
          acc[4 * q] += v.x;
          acc[4 * q + 1] += v.y;
          acc[4 * q + 2] += v.z;
          acc[4 * q + 3] += v.w;
        }
        my_rsum += rem[16 * 4 * GEMM_THREADS + tid];
      }
    cluster.sync();    // the ranges' memory stays until it is read
    if (split >= 2) return;
    c_first = c_last = split;
  }

  const int rbase = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cl = 2 * (lane & 3);
  if constexpr (!DUAL) {
    // parts: the products and row sums out (row stride N + 1), no
    // epilogue; summed parts: the same entries in, for the epilogue
    if (e.pout || e.pin) {
      const size_t ld = (size_t)N + 1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (chunk_of(j) < c_first || chunk_of(j) > c_last) continue;
        const int n = n0 + 8 * j + cl;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = rbase + 8 * hf;
          if (r >= S) continue;
          const size_t at = (row0 + r) * ld + n;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (n + u >= N) continue;
            if (e.pin)
              acc[4 * j + 2 * hf + u] = e.pin[at + u];
            else
              e.pout[at + u] = acc[4 * j + 2 * hf + u];
          }
        }
      }
      const int r = tid - 128;
      if (tid >= 128 && r < S) {
        if (e.pin)
          my_rsum = e.pin[(row0 + r) * ld + N];
        else if (blockIdx.y == 0 && c_first == 0)
          e.pout[(row0 + r) * ld + N] = my_rsum;
      }
      if (e.pout) return;
    }
  }
  float* rs = reinterpret_cast<float*>(gsm + RS_OFF);
  if (tid >= 128) rs[tid - 128] = (float)my_rsum;
  float* ep = reinterpret_cast<float*>(gsm + BT_OFF);
  stage_rows(ep, e, S, row0);
  constexpr int EW = CL::EW;
  float* Y0 = reinterpret_cast<float*>(gsm);
  float* Y1 = Y0 + RM * EW;
  float* Tmp = Y1 + (DUAL ? RM * EW : 0);
  for (int c = c_first; c <= c_last; ++c) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (chunk_of(j) != c) continue;
      const int vc = 8 * j + cl;
      const int which = DUAL ? vc / (BNV / 2) : 0;
      const int oc = (DUAL ? vc % (BNV / 2) : vc) % EW;
      float* Y = which ? Y1 : Y0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = rbase + 8 * hf;
        if (r >= S) continue;
        Y[r * EW + oc] = __int_as_float(acc[4 * j + 2 * hf]);
        Y[r * EW + oc + 1] = __int_as_float(acc[4 * j + 2 * hf + 1]);
      }
    }
    __syncthreads();
    finish_chunk<DUAL, EW>(Y0, Y1, Tmp, rs, ep, S, K, N, n0 + c * EW, row0,
                           e, t, out);
    __syncthreads();
  }
}

template <bool DUAL, typename TO, bool VEC>
cudaError_t launch_variant(const dim3& grid, cudaStream_t st,
                           const int8_t* qx, int S, int K, int N,
                           const int8_t* qw0, const int8_t* qw1, const Epi& e,
                           const SeqT& t, int split_k, int rows, TO* o) {
  // the attribute is set once per instantiation and card (it belongs to
  // the card's context): bit d of `sized` for card d
  static unsigned sized = 0u;
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev); e != cudaSuccess) return e;
  if (dev >= 32 || !((sized >> dev) & 1u)) {
    const cudaError_t err = cudaFuncSetAttribute(
        stamp_gemm_kernel<DUAL, TO, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
    if (err != cudaSuccess) return err;
    if (dev < 32) sized |= 1u << dev;
  }
  if (grid.z == 1) {
    stamp_gemm_kernel<DUAL, TO, VEC><<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(
        qx, S, K, N, qw0, qw1, e, t, split_k, rows, o);
    return cudaGetLastError();
  }
  // the k ranges of a (span, column tile) run as one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(GEMM_THREADS);
  cfg.dynamicSmemBytes = GEMM_SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, stamp_gemm_kernel<DUAL, TO, VEC>, qx, S, K,
                            N, qw0, qw1, e, t, split_k, rows, o);
}

template <bool DUAL, typename TO>
cudaError_t launch_gemm(int rows, const int8_t* qx, int S, int K, int N,
                        const int8_t* qw0, const int8_t* qw1, const Epi& e,
                        SeqT t, int n_split, int split_k, int vec, void* out,
                        cudaStream_t st) {
  TO* o = static_cast<TO*>(out);
  const dim3 grid((rows + S - 1) / S,
                  (N + Cols<DUAL>::BLOCK - 1) / Cols<DUAL>::BLOCK, n_split);
  return vec ? launch_variant<DUAL, TO, true>(grid, st, qx, S, K, N, qw0, qw1,
                                              e, t, split_k, rows, o)
             : launch_variant<DUAL, TO, false>(grid, st, qx, S, K, N, qw0,
                                               qw1, e, t, split_k, rows, o);
}

template <typename T, bool KEEP>
cudaError_t launch_tq(const void* x, int B, int S, int K, const int* prog,
                      int n_win, int cl, int kc, int room, int threads,
                      size_t smem, float inv_sqrt2, float inv_wht, int num_hi,
                      float n_hi, float n_lo, int8_t* qx, float* sx,
                      float* zx, const float* given, float* stats,
                      cudaStream_t st) {
  // the attributes are set once per instantiation and card: bit d of
  // `sized` for card d
  static unsigned sized = 0u;
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev); e != cudaSuccess) return e;
  if (dev >= 32 || !((sized >> dev) & 1u)) {
    cudaError_t e = cudaFuncSetAttribute(
        tq_kernel<T, KEEP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TQ_SMEM);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(tq_kernel<T, KEEP>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
    if (dev < 32) sized |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl, n_win, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, tq_kernel<T, KEEP>,
                            static_cast<const T*>(x), S, K, prog, inv_sqrt2,
                            inv_wht, num_hi, n_hi, n_lo, kc, room, qx, sx,
                            zx, given, stats);
}

template <typename T>
cudaError_t launch_tq_keep(int keep, const void* x, int B, int S, int K,
                           const int* prog, int n_win, int cl, int kc,
                           int room, int threads, size_t smem,
                           float inv_sqrt2, float inv_wht, int num_hi,
                           float n_hi, float n_lo, int8_t* qx, float* sx,
                           float* zx, const float* given, float* stats,
                           cudaStream_t st) {
  return keep ? launch_tq<T, true>(x, B, S, K, prog, n_win, cl, kc, room,
                                   threads, smem, inv_sqrt2, inv_wht, num_hi,
                                   n_hi, n_lo, qx, sx, zx, given, stats, st)
              : launch_tq<T, false>(x, B, S, K, prog, n_win, cl, kc, room,
                                    threads, smem, inv_sqrt2, inv_wht,
                                    num_hi, n_hi, n_lo, qx, sx, zx, given,
                                    stats, st);
}

// ------------------------------------------------------------ long spans --
//
// A span longer than RM rows does not fit K2's on-chip tile, and under the
// WHT a span whose power-of-two block exceeds K1's 256 window rows does not
// fit K1's windows either.  There the chain takes a third link,
// stamp_span_transform (csrc/span_link.cu): forward, the f32 sequence
// transform that K1 then quantizes with transform none (whose windows need
// one row each); inverse, the transform of K2's f32 products (K2 with
// transform none over tiles of RM rows, after the zero-point epilogue) with
// the bias, the dual silu(g)*u and the cast to the output type.

}  // namespace

// prog: the span's row windows (tq_windows), n_win of them; cl: the K
// ranges of kc columns a window's cluster splits K into; keep: a range is
// one chunk of TQ_U x threads columns (the outputs stay in registers);
// room: ints of the longest window program; threads a block and its shared
// memory (program and slots), smem bytes.  Two modes for a row-parallel
// block of a model split, whose rows' min / max must be the whole rows':
// stats (non-null) takes (B * S, 2) f32 and receives each transformed
// row's (min, max) over this block's K instead of the codes (qx, sx, zx
// untouched); given (non-null, (B * S, 2) f32) quantizes with those
// (min, max) in place of the block's own.  The transform is per column,
// so a block's transformed values, and with the all-reduced (min, max)
// its codes, scales and zero points, are the whole row's bit for bit.
extern "C" int stamp_transform_quantize(
    const void* x, int x_bf16, int B, int S, int K, const int* prog,
    int n_win, int cl, int kc, int keep, int room, int threads, int smem,
    float inv_sqrt2, float inv_wht, int num_hi, float n_hi, float n_lo,
    void* qx, float* sx, float* zx, const float* given, float* stats,
    void* stream) {
  if (cl < 1 || cl > TQ_MAX_CL || n_win < 1 || kc < 1 || threads < 32 ||
      threads > 256 || threads % 32 || smem > TQ_SMEM || room % 4 ||
      (keep && kc > TQ_U * threads) || (given && stats))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(qx);
  return (int)(x_bf16
                   ? launch_tq_keep<__nv_bfloat16>(
                         keep, x, B, S, K, prog, n_win, cl, kc, room,
                         threads, smem, inv_sqrt2, inv_wht, num_hi, n_hi,
                         n_lo, q, sx, zx, given, stats, st)
                   : launch_tq_keep<float>(keep, x, B, S, K, prog, n_win, cl,
                                           kc, room, threads, smem,
                                           inv_sqrt2, inv_wht, num_hi, n_hi,
                                           n_lo, q, sx, zx, given, stats,
                                           st));
}

// rows: all rows of qx, in spans of S (a long span without a transform:
// tiles of S rows, the last one ragged).  Two modes for a row-parallel
// block of a model split, single GEMM only, whose product is a sum over
// the blocks' K ranges: parts_out (non-null, (rows + 1, N + 1) int32)
// receives the block's int32 products [r, n] and row sums Σqx [r, N] in
// place of the epilogue (out untouched; the caller puts the block's Σqw
// and K in the last row); parts_in (the ranks' parts summed: the whole
// rows' products, row sums, Σqw and K) is read in place of the product
// (qx, qw0 and ws0 unread) and finished by the epilogue, which is then
// one device's bit for bit.  Integer sums are exact in any order.
extern "C" int stamp_int_gemm(
    const void* qx, const float* sx, const float* zx, int rows, int S, int K,
    int N, const void* qw0, const float* sw0, const float* zw0,
    const int* ws0, const float* b0, const void* qw1, const float* sw1,
    const float* zw1, const int* ws1, const float* b1, int kind, int levels,
    int skip, float inv_sqrt2, float inv_wht, void* out, int out_bf16,
    int n_split, int split_k, int vec, int* parts_out, const int* parts_in,
    void* stream) {
  if (S > RM || S < 1 || n_split < 1 || n_split > MAX_SPLITS ||
      split_k < 1 || split_k % BK ||
      ((parts_out || parts_in) && qw1) || (parts_out && parts_in) ||
      (parts_in && n_split != 1))
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || N == 0) return 0;
  if (kind != 0 && rows % S) return (int)cudaErrorInvalidValue;
  const SeqT t{kind, levels, skip, inv_sqrt2, inv_wht};
  if (parts_in) ws0 = parts_in + (size_t)rows * (N + 1);
  const Epi e{sx, zx, sw0, zw0, ws0, b0, sw1, zw1, ws1, b1, parts_out,
              parts_in};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(qx);
  const int8_t* w0 = static_cast<const int8_t*>(qw0);
  const int8_t* w1 = static_cast<const int8_t*>(qw1);
  cudaError_t err;
  if (qw1 != nullptr)
    err = out_bf16
              ? launch_gemm<true, __nv_bfloat16>(rows, a, S, K, N, w0, w1, e,
                                                 t, n_split, split_k, vec,
                                                 out, st)
              : launch_gemm<true, float>(rows, a, S, K, N, w0, w1, e, t,
                                         n_split, split_k, vec, out, st);
  else
    err = out_bf16
              ? launch_gemm<false, __nv_bfloat16>(rows, a, S, K, N, w0, w1,
                                                  e, t, n_split, split_k,
                                                  vec, out, st)
              : launch_gemm<false, float>(rows, a, S, K, N, w0, w1, e, t,
                                          n_split, split_k, vec, out, st);
  return (int)err;
}
