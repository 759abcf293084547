// Multi-level Haar DWT along the sequence axis for Hopper (sm_90a): K9.
//
// Replaces the Pallas kernel haar_dwt_pallas (src/repro/kernels/
// haar_dwt.py): the forward multi-level orthonormal Haar transform of
// (b, s, d) activations along s, or its inverse, every level in one launch,
// computed in f32 as (a +- b) * f32(1/sqrt 2) with one cast at the end.
//
// Bound on the H100: bytes.  The transform does 3 flops per value and
// level, so one read and one write of the activation is all it needs.
// Design: a group of 2^L consecutive rows is self-contained in an L-level
// DWT.  The group's approximation lands in row g; its level-l details land
// in rows s/2^l + g*2^(L-l) + j, j < 2^(L-l).  One thread per (group,
// column) reads its 2^L values at stride d (coalesced across a warp along
// d), runs every level in registers in the plain version's order and
// scatters the outputs: one read, one write, no shared memory, any d.  The
// inverse is the mirror image.  L <= 5 keeps 32 f32 values a thread; the
// wrapper chains launches for deeper transforms.  Built with -fmad=false:
// from level 2 on, a level sums products of the previous one, and the plain
// version rounds each product before the sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 5;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float ld(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void st(__half* p, float v) {
  *p = __float2half_rn(v);
}

template <int L, bool INV, typename T>
__global__ void __launch_bounds__(THREADS)
haar_kernel(const T* x, T* y, long long total, int groups, int d, float r) {
  constexpr int N = 1 << L;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % d);
  const long long t = idx / d;
  const int g = (int)(t % groups);
  const long long b = t / groups;
  const long long s = (long long)groups * N;
  const T* xb = x + b * s * d + c;
  T* yb = y + b * s * d + c;
  float v[N];
  if (!INV) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = ld(xb + ((long long)g * N + i) * d);
    // level l turns the band v[0, m) into m/2 approximations followed by
    // m/2 details; earlier levels' details stay where they are
#pragma unroll
    for (int l = 1; l <= L; ++l) {
      const int m = N >> (l - 1);
      float tmp[N];
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        if (j < m / 2) {
          tmp[j] = (v[2 * j] + v[2 * j + 1]) * r;
          tmp[m / 2 + j] = (v[2 * j] - v[2 * j + 1]) * r;
        }
      }
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < m) v[j] = tmp[j];
    }
    st(yb + (long long)g * d, v[0]);
#pragma unroll
    for (int l = 1; l <= L; ++l) {
      const int cnt = N >> l;
      const long long row = (s >> l) + (long long)g * cnt;
#pragma unroll
      for (int j = 0; j < N / 2; ++j)
        if (j < cnt) st(yb + (row + j) * d, v[cnt + j]);
    }
  } else {
    v[0] = ld(xb + (long long)g * d);
#pragma unroll
    for (int l = 1; l <= L; ++l) {
      const int cnt = N >> l;
      const long long row = (s >> l) + (long long)g * cnt;
#pragma unroll
      for (int j = 0; j < N / 2; ++j)
        if (j < cnt) v[cnt + j] = ld(xb + (row + j) * d);
    }
    // deepest level first: the band v[0, m) holds m/2 approximations and
    // m/2 details, and becomes m interleaved (even, odd) values
#pragma unroll
    for (int l = L; l >= 1; --l) {
      const int m = N >> (l - 1);
      float tmp[N];
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        if (j < m / 2) {
          tmp[2 * j] = (v[j] + v[m / 2 + j]) * r;
          tmp[2 * j + 1] = (v[j] - v[m / 2 + j]) * r;
        }
      }
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j < m) v[j] = tmp[j];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) st(yb + ((long long)g * N + i) * d, v[i]);
  }
}

template <int L, typename T>
cudaError_t launch_levels(const void* x, void* y, int b, int s, int d,
                          int inverse, float r, cudaStream_t st) {
  const int groups = s >> L;
  const long long total = (long long)b * groups * d;
  if (total == 0) return cudaSuccess;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (inverse)
    haar_kernel<L, true, T><<<blocks, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y), total, groups, d, r);
  else
    haar_kernel<L, false, T><<<blocks, THREADS, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y), total, groups, d, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, void* y, int b, int s, int d, int levels,
                   int inverse, float r, cudaStream_t st) {
  switch (levels) {
    case 0: return launch_levels<0, T>(x, y, b, s, d, inverse, r, st);
    case 1: return launch_levels<1, T>(x, y, b, s, d, inverse, r, st);
    case 2: return launch_levels<2, T>(x, y, b, s, d, inverse, r, st);
    case 3: return launch_levels<3, T>(x, y, b, s, d, inverse, r, st);
    case 4: return launch_levels<4, T>(x, y, b, s, d, inverse, r, st);
    case 5: return launch_levels<5, T>(x, y, b, s, d, inverse, r, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (b, s, d) contiguous, the same dtype (0 f32, 1 bf16, 2 f16);
// s a multiple of 2^levels, levels <= 5; r = f32(1/sqrt 2).
extern "C" int haar_dwt_seq(const void* x, void* y, int dtype, int b, int s,
                            int d, int levels, int inverse, float r,
                            void* stream) {
  if (levels < 0 || levels > MAX_LEVELS || s % (1 << levels) || b < 0 ||
      d < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(x, y, b, s, d, levels, inverse, r, st);
    case 1:
      return (int)launch<__nv_bfloat16>(x, y, b, s, d, levels, inverse, r,
                                        st);
    case 2: return (int)launch<__half>(x, y, b, s, d, levels, inverse, r, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
