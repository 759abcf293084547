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
//   64-column tile, so the int32 accumulators, the epilogue, the inverse
//   transform along the span and the bias (and the dual silu(g)*u) stay on
//   chip: the (C, N) f32 product never reaches device memory.  The integer
//   product is dp4a over 4-byte packs; the B tile is repacked to k-major
//   quads in shared memory.  The weight's column sums Σqw are fixed with the
//   weight, so they come in precomputed (PreparedLinear.qw_sum); only the
//   activation's row sums Σqx are summed here, from the A tiles on chip.
//
// Bound on the H100: K2 at the main path's shapes (2 spans x 128 rows) does
// 2*256*K*N int8 operations on K*N weight bytes — about 500 operations per
// weight byte, above the card's ~590 int8 ops/byte ridge only with tensor
// cores; dp4a on CUDA cores makes this simple kernel operation-bound.  K1 is
// bound by bytes.  wgmma/TMA and a persistent schedule are later work.
//
// Numerics mirror the reference as it runs compiled: true division
// (__fdiv_rn) by the per-token scale, round half to even (rintf), the 1e-8
// scale floor, clip to [0, n] then -128.  The Haar butterflies and the
// WHT's final 1/sqrt(p) multiply by f32 reciprocals: XLA turns the
// reference's division by those constants into that product.  Built with
// -fmad=false so the f32 epilogue evaluates in the plain version's order.

#include <cuda_runtime.h>
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

constexpr int RM = 128;        // rows per block: one whole span
constexpr int BN = 64;         // output columns per block
constexpr int BK = 64;         // k per smem stage
constexpr int KQ = BK / 4;     // 4-byte k quads per stage
constexpr int A_LD = KQ + 1;
constexpr int GEMM_THREADS = 256;

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

// B stage: Bs[kq][c] packs qw[k0+4kq .. +3][n0+c] (k-major quads).
__device__ void load_b_stage(const int8_t* qw, int K, int N, int k0, int n0,
                             int* Bs) {
  const int kq = threadIdx.x / (BN / 4), cg = threadIdx.x % (BN / 4);
  const int col = n0 + 4 * cg;
  int w[4] = {0, 0, 0, 0};
  if (col < N) {
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 4 * kq + i;
      if (k < K) w[i] = *reinterpret_cast<const int*>(qw + (size_t)k * N + col);
    }
  }
  int c4[4];
  transpose4(w[0], w[1], w[2], w[3], c4);
  for (int j = 0; j < 4; ++j) Bs[kq * BN + 4 * cg + j] = c4[j];
}

template <bool DUAL, typename TO>
__global__ void __launch_bounds__(GEMM_THREADS)
stamp_gemm_kernel(const int8_t* qx, const float* sx, const float* zx, int S,
                  int K, int N, const int8_t* qw0, const float* sw0,
                  const float* zw0, const int* ws0, const float* b0,
                  const int8_t* qw1, const float* sw1, const float* zw1,
                  const int* ws1, const float* b1, SeqT t, TO* out) {
  extern __shared__ int gsm[];
  int* As = gsm;                          // RM x A_LD
  int* Bs0 = As + RM * A_LD;              // KQ x BN
  int* Bs1 = Bs0 + KQ * BN;
  float* rsum = reinterpret_cast<float*>(Bs1 + KQ * BN);   // RM
  float* Y0 = rsum + RM;                                  // RM x BN
  float* Y1 = Y0 + RM * BN;
  float* Tmp = Y1 + (DUAL ? RM * BN : 0);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const size_t row0 = (size_t)blockIdx.y * S;
  const int ones = 0x01010101;

  int acc0[8][4], acc1[8][4];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 4; ++j) acc0[i][j] = acc1[i][j] = 0;
  int my_rsum = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < RM * KQ; idx += GEMM_THREADS) {
      const int r = idx / KQ, q = idx % KQ, k = k0 + 4 * q;
      int v = 0;
      if (r < S && k < K)
        v = *reinterpret_cast<const int*>(qx + (row0 + r) * K + k);
      As[r * A_LD + q] = v;
    }
    load_b_stage(qw0, K, N, k0, n0, Bs0);
    if (DUAL) load_b_stage(qw1, K, N, k0, n0, Bs1);
    __syncthreads();
    if (tid < RM)
      for (int q = 0; q < KQ; ++q) my_rsum = __dp4a(As[tid * A_LD + q], ones, my_rsum);
#pragma unroll 4
    for (int q = 0; q < KQ; ++q) {
      int a[8], b[4], bb[4];
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * A_LD + q];
      for (int j = 0; j < 4; ++j) b[j] = Bs0[q * BN + tx + 16 * j];
      if (DUAL)
        for (int j = 0; j < 4; ++j) bb[j] = Bs1[q * BN + tx + 16 * j];
      for (int i = 0; i < 8; ++i)
        for (int j = 0; j < 4; ++j) {
          acc0[i][j] = __dp4a(a[i], b[j], acc0[i][j]);
          if (DUAL) acc1[i][j] = __dp4a(a[i], bb[j], acc1[i][j]);
        }
    }
    __syncthreads();
  }
  if (tid < RM) rsum[tid] = (float)my_rsum;
  __syncthreads();

  // zero-point epilogue, same evaluation order as the plain version:
  // ((acc - zx*Σqw) - zw*Σqx + (K*zx)*zw) * sx * sw
  const float kf = (float)K;
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    const float s = r < S ? sx[row0 + r] : 0.0f;
    const float z = r < S ? zx[row0 + r] : 0.0f;
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j, n = n0 + c;
      float y0 = 0.0f, y1 = 0.0f;
      if (r < S && n < N) {
        const float w0 = zw0[n];
        y0 = ((((float)acc0[i][j] - z * (float)ws0[n]) - w0 * rsum[r]) +
              (kf * z) * w0) * s * sw0[n];
        if (DUAL) {
          const float w1 = zw1[n];
          y1 = ((((float)acc1[i][j] - z * (float)ws1[n]) - w1 * rsum[r]) +
                (kf * z) * w1) * s * sw1[n];
        }
      }
      Y0[r * BN + c] = y0;
      if (DUAL) Y1[r * BN + c] = y1;
    }
  }
  __syncthreads();
  seq_transform(Y0, Tmp, S, BN, BN, t, true);
  if (DUAL) seq_transform(Y1, Tmp, S, BN, BN, t, true);
  for (int idx = tid; idx < S * BN; idx += GEMM_THREADS) {
    const int r = idx / BN, c = idx % BN, n = n0 + c;
    if (n >= N) continue;
    float v = Y0[idx] + (b0 ? b0[n] : 0.0f);
    if (DUAL) {
      const float u = Y1[idx] + (b1 ? b1[n] : 0.0f);
      v = (v * (1.0f / (1.0f + expf(-v)))) * u;  // jax.nn.silu's steps
    }
    store_f(out + (row0 + r) * N + n, v);
  }
}

template <bool DUAL, typename TO>
cudaError_t launch_gemm(dim3 grid, size_t smem, cudaStream_t st,
                        const int8_t* qx, const float* sx, const float* zx,
                        int S, int K, int N, const int8_t* qw0,
                        const float* sw0, const float* zw0, const int* ws0,
                        const float* b0, const int8_t* qw1, const float* sw1,
                        const float* zw1, const int* ws1, const float* b1,
                        SeqT t, void* out) {
  cudaError_t e = cudaFuncSetAttribute(
      stamp_gemm_kernel<DUAL, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  stamp_gemm_kernel<DUAL, TO><<<grid, GEMM_THREADS, smem, st>>>(
      qx, sx, zx, S, K, N, qw0, sw0, zw0, ws0, b0, qw1, sw1, zw1, ws1, b1, t,
      static_cast<TO*>(out));
  return cudaGetLastError();
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
    int skip, float inv_sqrt2,
    float inv_wht, void* out, int out_bf16, void* stream) {
  if (S > RM) return (int)cudaErrorInvalidValue;
  const SeqT t{kind, levels, skip, inv_sqrt2, inv_wht};
  const bool dual = qw1 != nullptr;
  const dim3 grid((N + BN - 1) / BN, B);
  const size_t smem = sizeof(int) * (RM * A_LD + 2 * KQ * BN) +
                      sizeof(float) * RM +
                      sizeof(float) * RM * BN * (dual ? 3 : 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* a = static_cast<const int8_t*>(qx);
  const int8_t* w0 = static_cast<const int8_t*>(qw0);
  const int8_t* w1 = static_cast<const int8_t*>(qw1);
  cudaError_t e;
  if (dual)
    e = out_bf16 ? launch_gemm<true, __nv_bfloat16>(
                       grid, smem, st, a, sx, zx, S, K, N, w0, sw0, zw0, ws0,
                       b0, w1, sw1, zw1, ws1, b1, t, out)
                 : launch_gemm<true, float>(grid, smem, st, a, sx, zx, S, K,
                                            N, w0, sw0, zw0, ws0, b0, w1, sw1,
                                            zw1, ws1, b1, t, out);
  else
    e = out_bf16 ? launch_gemm<false, __nv_bfloat16>(
                       grid, smem, st, a, sx, zx, S, K, N, w0, sw0, zw0, ws0,
                       b0, w1, sw1, zw1, ws1, b1, t, out)
                 : launch_gemm<false, float>(grid, smem, st, a, sx, zx, S, K,
                                             N, w0, sw0, zw0, ws0, b0, w1,
                                             sw1, zw1, ws1, b1, t, out);
  return (int)e;
}
