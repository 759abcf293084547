// Standalone int8 x int8 GEMM with zero-point correction for Hopper
// (sm_90a): K7.
//
// Replaces the Pallas kernel int8_matmul_pallas (src/repro/kernels/
// int8_matmul.py):  Y[m, n] = ((acc - zx*Sw) - zw*Sx + (K*zx)*zw) * sx * sw
// with acc = sum_k qx[m, k] * qw[k, n] in int32, Sw = sum_k qw[k, n] and
// Sx = sum_k qx[m, k], both summed on the fly (the standalone API gets no
// precomputed column sums), the epilogue in f32 in the reference's order.
//
// Bound on the H100: integer operations at the main path's 2048 rows (2MNK
// int8 operations over a few tens of MB); bytes at 8 decode rows, where the
// (K, N) weight is read once.  Design: 128 x 128 output tiles, 8 warps of
// 64 x 32, on the tensor cores through mma.sync m16n8k32 s8.s8 -> s32.
// Each 64-deep K step stages qx's tile as 16-byte rows and qw's tile
// transposed to k-major quads (a __byte_perm transpose of 4 x 4 bytes, as
// K3 does) in shared memory, padded to 20 words a row so the fragment
// loads avoid bank conflicts; the next step's global loads are in flight in
// registers while the tensor cores work.  The same tiles feed the sums:
// threads 0-127 add their column's quads, 128-255 their row's, with
// dp4a against 0x01010101.  Rows and columns past M and N, and K past its
// end, load as zeros, so any M (down to the 8 rows of a decode batch), N
// and K work.  The epilogue is built with -fmad=false, so it rounds as the
// plain version does.  torch._int_mm is only the library yardstick.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64, THREADS = 256;
constexpr int LDW = BK / 4 + 4;  // words a staged row, padded

__device__ __forceinline__ void st2(float* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    p[0] = a;
  }
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b,
                                    bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
  }
}
__device__ __forceinline__ void st2(__half* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  } else {
    p[0] = __float2half_rn(a);
  }
}
template <typename T>
__device__ __forceinline__ void st1(T* p, float a) {
  st2(p, a, 0.0f, false);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
int8_mm_kernel(const int8_t* __restrict__ qx, const int8_t* __restrict__ qw,
               const float* __restrict__ sx, const float* __restrict__ zx,
               const float* __restrict__ sw, const float* __restrict__ zw,
               int M, int N, int K, int vec, TO* __restrict__ out) {
  __shared__ __align__(16) int As[BM * LDW];
  __shared__ __align__(16) int Bs[BN * LDW];
  __shared__ int rsum[BM], csum[BN];
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane / 4, tg = lane % 4;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  int my_sum = 0;  // tid < 128: column n0 + tid; else row m0 + tid - 128

  int4 a_reg[2];
  int b_reg[2][4];

  auto load_tile = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * THREADS;
      const int row = e / 4, ch = e % 4;
      const int gm = m0 + row, gk = k0 + ch * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (gm < M) {
        const int8_t* p = qx + (long long)gm * K + gk;
        if (vec && gk + 16 <= K) {
          v = *reinterpret_cast<const int4*>(p);
        } else {
          int w[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            uint32_t u = 0;
            for (int b = 0; b < 4; ++b)
              if (gk + 4 * q + b < K)
                u |= (uint32_t)(uint8_t)p[4 * q + b] << (8 * b);
            w[q] = (int)u;
          }
          v = make_int4(w[0], w[1], w[2], w[3]);
        }
      }
      a_reg[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * THREADS;
      const int kq = e % 16, ng = e / 16;
      const int gk = k0 + kq * 4, gn = n0 + ng * 4;
      int w[4];
      if (vec && gn + 4 <= N) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = gk + r < K ? *reinterpret_cast<const int*>(
                                  qw + (long long)(gk + r) * N + gn)
                            : 0;
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t u = 0;
          if (gk + r < K)
            for (int b = 0; b < 4; ++b)
              if (gn + b < N)
                u |= (uint32_t)(uint8_t)qw[(long long)(gk + r) * N + gn + b]
                     << (8 * b);
          w[r] = (int)u;
        }
      }
      // rows k..k+3 of 4 columns -> 4 columns of k-major quads
      const int t0 = __byte_perm(w[0], w[1], 0x5140);
      const int t1 = __byte_perm(w[2], w[3], 0x5140);
      const int t2 = __byte_perm(w[0], w[1], 0x7362);
      const int t3 = __byte_perm(w[2], w[3], 0x7362);
      b_reg[i][0] = __byte_perm(t0, t1, 0x5410);
      b_reg[i][1] = __byte_perm(t0, t1, 0x7632);
      b_reg[i][2] = __byte_perm(t2, t3, 0x5410);
      b_reg[i][3] = __byte_perm(t2, t3, 0x7632);
    }
  };

  const int KT = (K + BK - 1) / BK;
  load_tile(0);
  for (int kt = 0; kt < KT; ++kt) {
    __syncthreads();  // the previous step's fragments are read
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = tid + i * THREADS;
      *reinterpret_cast<int4*>(&As[(e / 4) * LDW + (e % 4) * 4]) = a_reg[i];
      const int kq = e % 16, ng = e / 16;
#pragma unroll
      for (int j = 0; j < 4; ++j) Bs[(ng * 4 + j) * LDW + kq] = b_reg[i][j];
    }
    __syncthreads();
    if (kt + 1 < KT) load_tile(kt + 1);
    {
      const int* src = tid < BN ? &Bs[tid * LDW] : &As[(tid - BN) * LDW];
#pragma unroll
      for (int q = 0; q < BK / 4; ++q)
        my_sum = __dp4a(src[q], 0x01010101, my_sum);
    }
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kw = ks * 8;
      int af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int rb = wm * 64 + mi * 16;
        af[mi][0] = As[(rb + g) * LDW + kw + tg];
        af[mi][1] = As[(rb + g + 8) * LDW + kw + tg];
        af[mi][2] = As[(rb + g) * LDW + kw + 4 + tg];
        af[mi][3] = As[(rb + g + 8) * LDW + kw + 4 + tg];
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int cb = wn * 32 + ni * 8;
        bfr[ni][0] = Bs[(cb + g) * LDW + kw + tg];
        bfr[ni][1] = Bs[(cb + g) * LDW + kw + 4 + tg];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  if (tid < BN)
    csum[tid] = my_sum;
  else
    rsum[tid - BN] = my_sum;
  __syncthreads();

  const float kf = (float)K;
  const bool pairs = (N % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wm * 64 + mi * 16 + g + 8 * half;
      const int row = m0 + lr;
      if (row >= M) continue;
      const float z = zx[row], s = sx[row], qs = (float)rsum[lr];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int lc = wn * 32 + ni * 8 + 2 * tg;
        const int col = n0 + lc;
        if (col >= N) continue;
        float y[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int cc = min(col + c, N - 1);
          const float w = zw[cc];
          y[c] = ((((float)acc[mi][ni][2 * half + c] -
                    z * (float)csum[lc + c]) -
                   w * qs) +
                  (kf * z) * w) *
                 s * sw[cc];
        }
        TO* o = out + (long long)row * N + col;
        if (pairs)
          st2(o, y[0], y[1], true);
        else {
          st1(o, y[0]);
          if (col + 1 < N) st1(o + 1, y[1]);
        }
      }
    }
  }
}

template <typename TO>
cudaError_t launch(const void* qx, const void* qw, const float* sx,
                   const float* zx, const float* sw, const float* zw, int M,
                   int N, int K, int vec, void* out, cudaStream_t st) {
  if (M == 0 || N == 0) return cudaSuccess;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_mm_kernel<TO><<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(qx), static_cast<const int8_t*>(qw), sx, zx,
      sw, zw, M, N, K, vec, static_cast<TO*>(out));
  return cudaGetLastError();
}

}  // namespace

// qx: (M, K) int8, qw: (K, N) int8, sx/zx: (M,) f32, sw/zw: (N,) f32, all
// contiguous; out: (M, N) of out_dtype (0 f32, 1 bf16, 2 f16).  vec asks
// for 16-byte loads of qx and 4-byte loads of qw: the caller checks that K
// is a multiple of 16, N of 4, and the pointers' alignment.
extern "C" int int8_matmul(const void* qx, const void* qw, const float* sx,
                           const float* zx, const float* sw, const float* zw,
                           int M, int N, int K, int vec, void* out,
                           int out_dtype, void* stream) {
  if (M < 0 || N < 0 || K < 0 || M > 65535 * BM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return (int)launch<float>(qx, qw, sx, zx, sw, zw, M, N, K, vec, out,
                                st);
    case 1:
      return (int)launch<__nv_bfloat16>(qx, qw, sx, zx, sw, zw, M, N, K, vec,
                                        out, st);
    case 2:
      return (int)launch<__half>(qx, qw, sx, zx, sw, zw, M, N, K, vec, out,
                                 st);
    default: return (int)cudaErrorInvalidValue;
  }
}
