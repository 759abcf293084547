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
//   all of K.  So K walks in 32-column slabs: pass 1 transforms each slab in
//   shared memory and writes per-row partial min/max, a small pass reduces
//   them to the per-token scale / zero point, and pass 3 RECOMPUTES the
//   slab's transform and quantizes it.  Recomputing (rather than keeping the
//   transformed f32 in a scratch buffer) reads the activation twice (2 x
//   2 bytes per value in bf16) instead of writing and reading 4-byte f32
//   scratch (8 bytes per value): the transform is a few adds per value.
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
// is bound by bytes.
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

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Sequence transform of the S x W tile `buf` (row stride ld) along rows, in
// place, with `tmp` as scratch of the same layout.  Every thread of the
// block calls it.
__device__ void seq_transform(float* buf, float* tmp, int S, int W, int ld,
                              const SeqT& t, bool inverse) {
  const int off = t.skip ? 1 : 0;
  const int n = S - off;
  if (n <= 0 || t.kind == 0) return;
  float* x = buf + off * ld;
  float* y = tmp + off * ld;
  if (t.kind == 1) {
    int sizes[34];
    int ns = 0, lo = n;
    sizes[ns++] = lo;
    for (int l = 0; l < t.levels && lo >= 2; ++l) {
      lo = (lo + 1) / 2;
      sizes[ns++] = lo;
    }
    for (int i = 0; i < ns - 1; ++i) {
      const int m = inverse ? sizes[ns - 2 - i] : sizes[i];
      const int pairs = m / 2;
      for (int idx = threadIdx.x; idx < 2 * pairs * W; idx += blockDim.x) {
        const int r = idx / W, c = idx % W;
        float v;
        if (!inverse) {
          const int q = r < pairs ? r : r - pairs;
          const float a = x[(2 * q) * ld + c], b = x[(2 * q + 1) * ld + c];
          v = r < pairs ? (a + b) * t.inv_sqrt2 : (a - b) * t.inv_sqrt2;
        } else {
          const int q = r / 2;
          const float a = x[q * ld + c], d = x[(pairs + q) * ld + c];
          v = (r % 2 == 0) ? (a + d) * t.inv_sqrt2 : (a - d) * t.inv_sqrt2;
        }
        y[r * ld + c] = v;
      }
      __syncthreads();
      for (int idx = threadIdx.x; idx < 2 * pairs * W; idx += blockDim.x) {
        const int r = idx / W, c = idx % W;
        x[r * ld + c] = y[r * ld + c];
      }
      __syncthreads();
    }
  } else {
    int p = 1;
    while (2 * p <= n) p *= 2;
    for (int h = 1; h < p; h *= 2) {
      for (int idx = threadIdx.x; idx < (p / 2) * W; idx += blockDim.x) {
        const int pr = idx / W, c = idx % W;
        const int i0 = (pr / h) * 2 * h + pr % h, i1 = i0 + h;
        const float a = x[i0 * ld + c], b = x[i1 * ld + c];
        x[i0 * ld + c] = a + b;
        x[i1 * ld + c] = a - b;
      }
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < p * W; idx += blockDim.x) {
      const int r = idx / W, c = idx % W;
      x[r * ld + c] = x[r * ld + c] * t.inv_wht;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- K1 ----

constexpr int TQ_W = 32;         // columns per slab
constexpr int TQ_LD = TQ_W + 1;  // padded row stride (no bank conflicts)
constexpr int TQ_THREADS = 256;

template <typename T>
__device__ void load_slab(const T* x, float* buf, int S, int K, int col0) {
  const int b = blockIdx.y;
  for (int idx = threadIdx.x; idx < S * TQ_W; idx += blockDim.x) {
    const int r = idx / TQ_W, c = idx % TQ_W, col = col0 + c;
    buf[r * TQ_LD + c] =
        col < K ? load_f(x + ((size_t)b * S + r) * K + col) : 0.0f;
  }
  __syncthreads();
}

template <typename T>
__global__ void tq_minmax_kernel(const T* x, int S, int K, SeqT t,
                                 float* pmin, float* pmax, int nslab) {
  extern __shared__ float smem[];
  float* buf = smem;
  float* tmp = smem + S * TQ_LD;
  const int slab = blockIdx.x, col0 = slab * TQ_W;
  load_slab(x, buf, S, K, col0);
  seq_transform(buf, tmp, S, TQ_W, TQ_LD, t, false);
  const int wcols = min(TQ_W, K - col0);
  for (int r = threadIdx.x; r < S; r += blockDim.x) {
    float mn = buf[r * TQ_LD], mx = mn;
    for (int c = 1; c < wcols; ++c) {
      const float v = buf[r * TQ_LD + c];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    const size_t row = (size_t)blockIdx.y * S + r;
    pmin[row * nslab + slab] = mn;
    pmax[row * nslab + slab] = mx;
  }
}

__global__ void tq_scale_kernel(const float* pmin, const float* pmax,
                                int nslab, int rows, int S, int num_hi,
                                float n_hi, float n_lo, float* sx,
                                float* zx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float mn = pmin[(size_t)row * nslab], mx = pmax[(size_t)row * nslab];
  for (int i = 1; i < nslab; ++i) {
    mn = fminf(mn, pmin[(size_t)row * nslab + i]);
    mx = fmaxf(mx, pmax[(size_t)row * nslab + i]);
  }
  const float n = (row % S) < num_hi ? n_hi : n_lo;
  const float s = fmaxf(__fdiv_rn(mx - mn, n), 1e-8f);
  const float z = rintf(__fdiv_rn(-mn, s));
  sx[row] = s;
  zx[row] = z - 128.0f;  // shifted with the codes: (q - z) is unchanged
}

template <typename T>
__global__ void tq_quant_kernel(const T* x, int S, int K, SeqT t,
                                const float* sx, const float* zx, int num_hi,
                                float n_hi, float n_lo, int8_t* qx) {
  extern __shared__ float smem[];
  float* buf = smem;
  float* tmp = smem + S * TQ_LD;
  const int col0 = blockIdx.x * TQ_W;
  load_slab(x, buf, S, K, col0);
  seq_transform(buf, tmp, S, TQ_W, TQ_LD, t, false);
  for (int idx = threadIdx.x; idx < S * TQ_W; idx += blockDim.x) {
    const int r = idx / TQ_W, c = idx % TQ_W, col = col0 + c;
    if (col >= K) continue;
    const size_t row = (size_t)blockIdx.y * S + r;
    const float s = sx[row], z = zx[row] + 128.0f;
    const float n = r < num_hi ? n_hi : n_lo;
    float q = rintf(__fdiv_rn(buf[r * TQ_LD + c], s)) + z;
    q = fminf(fmaxf(q, 0.0f), n);
    qx[row * K + col] = (int8_t)(int)(q - 128.0f);
  }
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

struct Epi {
  const float* sx; const float* zx;
  const float* sw0; const float* zw0; const int* ws0; const float* b0;
  const float* sw1; const float* zw1; const int* ws1; const float* b1;
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
                  const int8_t* qw1, Epi e, SeqT t, int split_k, TO* out) {
  extern __shared__ __align__(128) unsigned char gsm[];
  using CL = Cols<DUAL>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2;                 // warpgroup: rows 64 wg ..
  // spans vary fastest, so the spans of a column tile run together and
  // the weight tile comes from device memory once, then from L2
  const int n0 = blockIdx.y * CL::BLOCK;
  const size_t row0 = (size_t)blockIdx.x * S;
  const int split = blockIdx.z, n_split = gridDim.z;
  const int kb = split * split_k, ke = min(K, kb + split_k);
  const int KT = (ke - kb + BK - 1) / BK;
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
                           const SeqT& t, int split_k, TO* o) {
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
        qx, S, K, N, qw0, qw1, e, t, split_k, o);
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
                            N, qw0, qw1, e, t, split_k, o);
}

template <bool DUAL, typename TO>
cudaError_t launch_gemm(int B, const int8_t* qx, int S, int K, int N,
                        const int8_t* qw0, const int8_t* qw1, const Epi& e,
                        SeqT t, int n_split, int split_k, int vec, void* out,
                        cudaStream_t st) {
  TO* o = static_cast<TO*>(out);
  const dim3 grid(B, (N + Cols<DUAL>::BLOCK - 1) / Cols<DUAL>::BLOCK, n_split);
  return vec ? launch_variant<DUAL, TO, true>(grid, st, qx, S, K, N, qw0, qw1,
                                              e, t, split_k, o)
             : launch_variant<DUAL, TO, false>(grid, st, qx, S, K, N, qw0,
                                               qw1, e, t, split_k, o);
}

template <typename T>
cudaError_t launch_tq(const void* x, int B, int S, int K, SeqT t, int num_hi,
                      float n_hi, float n_lo, float* pmin, float* pmax,
                      int8_t* qx, float* sx, float* zx, cudaStream_t st) {
  const int nslab = (K + TQ_W - 1) / TQ_W;
  const size_t smem = 2 * (size_t)S * TQ_LD * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      tq_minmax_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(tq_quant_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(nslab, B);
  tq_minmax_kernel<T><<<grid, TQ_THREADS, smem, st>>>(
      static_cast<const T*>(x), S, K, t, pmin, pmax, nslab);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int rows = B * S;
  tq_scale_kernel<<<(rows + 127) / 128, 128, 0, st>>>(
      pmin, pmax, nslab, rows, S, num_hi, n_hi, n_lo, sx, zx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  tq_quant_kernel<T><<<grid, TQ_THREADS, smem, st>>>(
      static_cast<const T*>(x), S, K, t, sx, zx, num_hi, n_hi, n_lo, qx);
  return cudaGetLastError();
}

}  // namespace

extern "C" int stamp_transform_quantize(
    const void* x, int x_bf16, int B, int S, int K, int kind, int levels,
    int skip, float inv_sqrt2, float inv_wht, int num_hi, float n_hi,
    float n_lo,
    float* pmin, float* pmax, void* qx, float* sx, float* zx,
    void* stream) {
  const SeqT t{kind, levels, skip, inv_sqrt2, inv_wht};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(qx);
  return (int)(x_bf16 ? launch_tq<__nv_bfloat16>(x, B, S, K, t, num_hi,
                                                 n_hi, n_lo, pmin, pmax, q,
                                                 sx, zx, st)
                      : launch_tq<float>(x, B, S, K, t, num_hi, n_hi, n_lo,
                                         pmin, pmax, q, sx, zx, st));
}

extern "C" int stamp_int_gemm(
    const void* qx, const float* sx, const float* zx, int B, int S, int K,
    int N, const void* qw0, const float* sw0, const float* zw0,
    const int* ws0, const float* b0, const void* qw1, const float* sw1,
    const float* zw1, const int* ws1, const float* b1, int kind, int levels,
    int skip, float inv_sqrt2, float inv_wht, void* out, int out_bf16,
    int n_split, int split_k, int vec, void* stream) {
  if (S > RM || S < 1 || n_split < 1 || n_split > MAX_SPLITS ||
      split_k < 1 || split_k % BK)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  const SeqT t{kind, levels, skip, inv_sqrt2, inv_wht};
  const Epi e{sx, zx, sw0, zw0, ws0, b0, sw1, zw1, ws1, b1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(qx);
  const int8_t* w0 = static_cast<const int8_t*>(qw0);
  const int8_t* w1 = static_cast<const int8_t*>(qw1);
  cudaError_t err;
  if (qw1 != nullptr)
    err = out_bf16 ? launch_gemm<true, __nv_bfloat16>(B, a, S, K, N, w0, w1, e,
                                                      t, n_split, split_k, vec,
                                                      out, st)
                   : launch_gemm<true, float>(B, a, S, K, N, w0, w1, e, t,
                                              n_split, split_k, vec, out, st);
  else
    err = out_bf16 ? launch_gemm<false, __nv_bfloat16>(B, a, S, K, N, w0, w1,
                                                       e, t, n_split, split_k,
                                                       vec, out, st)
                   : launch_gemm<false, float>(B, a, S, K, N, w0, w1, e, t,
                                               n_split, split_k, vec, out, st);
  return (int)err;
}
