// Single-token STaMP decode matmul for Hopper (sm_90a): K3.
//
// Replaces the Pallas kernel stamp_decode_matmul_pallas
// (src/repro/kernels/decode_matmul.py): per-row 8-bit min-max quantize of
// the (M, K) decode tokens, int8 x int8 -> int32 GEMM against the prepared
// (K, N) int8 weight, zero-point epilogue and bias.
//
// Bound on the H100: with M = 8 decode slots the work is 2*M*K*N int8
// operations on K*N weight bytes — 16 operations per byte, far below the
// card's ridge, so the kernel is bound by reading the int8 weight once.
// Design: a quantize launch (one block per row; it also zeroes the int32
// accumulators), then a split-K GEMM whose grid covers N in 512-column
// strips times K in chunks, so some 500 blocks stream disjoint slices of
// the weight with 4-byte loads (each thread owns 4 adjacent columns and
// repacks 4 rows of them into k-major quads for dp4a).  Partial sums meet
// in global int32 accumulators by atomicAdd — integer addition, so the
// result does not depend on the order.  A last small launch applies the
// epilogue ((acc - zx*Σqw) - zw*Σqx + (K*zx)*zw) * sx * sw + bias in the
// plain version's order (built with -fmad=false).  The weight's column sums
// Σqw come in precomputed with the weight (PreparedLinear.qw_sum).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int MAXM = 16;        // decode rows per launch
constexpr int Q_THREADS = 256;
constexpr int G_THREADS = 128;  // 4 columns each: 512 columns per block

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ float block_reduce(float v, bool is_max, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : fminf(v, w);
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = red[0];
    for (int i = 1; i < (int)blockDim.x / 32; ++i)
      r = is_max ? fmaxf(r, red[i]) : fminf(r, red[i]);
    red[32] = r;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

template <typename T>
__global__ void dq_quant_kernel(const T* x, int K, int N, int8_t* qx,
                                float* sx, float* zx, int* qxsum, int* acc) {
  __shared__ float red[33];
  __shared__ int ired[32];
  const int m = blockIdx.x;
  const T* xr = x + (size_t)m * K;
  float mn = load_f(xr), mx = mn;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = load_f(xr + k);
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  mn = block_reduce(mn, false, red);
  mx = block_reduce(mx, true, red);
  // (mx - mn) / 255 as the compiled reference evaluates it
  const float s = fmaxf((mx - mn) * (1.0f / 255.0f), 1e-8f);
  const float z = rintf(__fdiv_rn(-mn, s));
  int part = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float q = rintf(__fdiv_rn(load_f(xr + k), s)) + z;
    q = fminf(fmaxf(q, 0.0f), 255.0f);
    const int c = (int)(q - 128.0f);
    qx[(size_t)m * K + k] = (int8_t)c;
    part += c;
  }
  for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
  if (threadIdx.x % 32 == 0) ired[threadIdx.x / 32] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    int tot = 0;
    for (int i = 0; i < (int)blockDim.x / 32; ++i) tot += ired[i];
    qxsum[m] = tot;
    sx[m] = s;
    zx[m] = z - 128.0f;
  }
  for (int n = threadIdx.x; n < N; n += blockDim.x) acc[(size_t)m * N + n] = 0;
}

__global__ void __launch_bounds__(G_THREADS)
dq_gemm_kernel(const int8_t* qx, int M, int K, int N, const int8_t* qw,
               int kchunk, int* acc) {
  extern __shared__ int xs[];  // M x (kchunk / 4) k-quads of the token codes
  const int k0 = blockIdx.y * kchunk;
  const int kq_n = (min(kchunk, K - k0)) / 4;
  const int ldq = kchunk / 4;
  for (int idx = threadIdx.x; idx < M * kq_n; idx += blockDim.x) {
    const int m = idx / kq_n, q = idx % kq_n;
    xs[m * ldq + q] =
        *reinterpret_cast<const int*>(qx + (size_t)m * K + k0 + 4 * q);
  }
  __syncthreads();
  const int col = (blockIdx.x * G_THREADS + threadIdx.x) * 4;
  if (col >= N) return;
  int a[MAXM][4];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[m][j] = 0;
  const int8_t* wp = qw + (size_t)k0 * N + col;
  for (int q = 0; q < kq_n; ++q) {
    const int w0 = *reinterpret_cast<const int*>(wp + (size_t)(4 * q) * N);
    const int w1 = *reinterpret_cast<const int*>(wp + (size_t)(4 * q + 1) * N);
    const int w2 = *reinterpret_cast<const int*>(wp + (size_t)(4 * q + 2) * N);
    const int w3 = *reinterpret_cast<const int*>(wp + (size_t)(4 * q + 3) * N);
    const int t0 = __byte_perm(w0, w1, 0x5140);
    const int t1 = __byte_perm(w2, w3, 0x5140);
    const int t2 = __byte_perm(w0, w1, 0x7362);
    const int t3 = __byte_perm(w2, w3, 0x7362);
    const int c[4] = {(int)__byte_perm(t0, t1, 0x5410),
                      (int)__byte_perm(t0, t1, 0x7632),
                      (int)__byte_perm(t2, t3, 0x5410),
                      (int)__byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int m = 0; m < MAXM; ++m) {
      if (m < M) {
        const int xq = xs[m * ldq + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[m][j] = __dp4a(xq, c[j], a[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < M) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        atomicAdd(acc + (size_t)m * N + col + j, a[m][j]);
    }
  }
}

template <typename TO>
__global__ void dq_epilogue_kernel(const int* acc, const int* wsum,
                                   const int* qxsum, const float* sx,
                                   const float* zx, const float* sw,
                                   const float* zw, const float* bias, int M,
                                   int N, int K, TO* out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * N) return;
  const int m = idx / N, n = idx % N;
  const float z = zx[m], w = zw[n];
  float y = ((((float)acc[idx] - z * (float)wsum[n]) - w * (float)qxsum[m]) +
             ((float)K * z) * w) * sx[m] * sw[n];
  if (bias) y = y + bias[n];
  store_f(out + idx, y);
}

}  // namespace

extern "C" int stamp_decode_matmul(
    const void* x, int x_bf16, int M, int K, int N, const void* qw,
    const float* sw, const float* zw, const int* wsum, const float* bias,
    int kchunk, void* qx, float* sx, float* zx, int* qxsum, int* acc,
    void* out, int out_bf16, void* stream) {
  if (M > MAXM || kchunk % 4 || K % 4 || N % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q = static_cast<int8_t*>(qx);
  if (x_bf16)
    dq_quant_kernel<__nv_bfloat16><<<M, Q_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), K, N, q, sx, zx, qxsum, acc);
  else
    dq_quant_kernel<float><<<M, Q_THREADS, 0, st>>>(
        static_cast<const float*>(x), K, N, q, sx, zx, qxsum, acc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + 4 * G_THREADS - 1) / (4 * G_THREADS),
                  (K + kchunk - 1) / kchunk);
  dq_gemm_kernel<<<grid, G_THREADS, sizeof(int) * M * (kchunk / 4), st>>>(
      q, M, K, N, static_cast<const int8_t*>(qw), kchunk, acc);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int total = M * N;
  if (out_bf16)
    dq_epilogue_kernel<__nv_bfloat16><<<(total + 255) / 256, 256, 0, st>>>(
        acc, wsum, qxsum, sx, zx, sw, zw, bias, M, N, K,
        static_cast<__nv_bfloat16*>(out));
  else
    dq_epilogue_kernel<float><<<(total + 255) / 256, 256, 0, st>>>(
        acc, wsum, qxsum, sx, zx, sw, zw, bias, M, N, K,
        static_cast<float*>(out));
  return (int)cudaGetLastError();
}
