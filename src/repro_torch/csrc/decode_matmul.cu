// Single-token STaMP decode matmul for Hopper (sm_90a): K3.
//
// Replaces the Pallas kernel stamp_decode_matmul_pallas
// (src/repro/kernels/decode_matmul.py): per-row 8-bit min-max quantize of
// the (M, K) decode tokens, int8 x int8 -> int32 GEMM against the prepared
// (K, N) int8 weight, zero-point epilogue and bias.
//
// Bound on the H100: with M = 4 or 8 decode slots the work is 2*M*K*N int8
// operations on K*N weight bytes — 8 to 16 operations per byte, far below
// the card's ridge, so the kernel is bound by reading the int8 weight once.
// What that takes is bytes in flight: a stream of 16-byte copies deep
// enough to cover the latency of device memory on every SM.
//
// Design: one launch.  A block owns a strip of 256 columns (128 where the
// strips are few), a tile of up to 8 rows and one range of K; the K ranges
// of a strip (1, 2, 4 or 8) form a thread block cluster
// (kernels/decode_matmul.py: decode_plan sizes it so the blocks fill the
// card once, three to an SM).  Each block streams its (range, strip) slab
// of the weight through a ring of 6 stages of 32 k-rows (16-byte
// cp.async, 4-byte where N is not a multiple of 16; the raw activation
// values of the stage ride along), five stages in flight while one is
// multiplied.  The quantizer needs each row's min and max over all of K:
// every block takes them over its own range (while the first stages load),
// the cluster exchanges them through distributed shared memory, and every
// block derives the same scale and zero point — min and max do not depend
// on order, so the codes are those of one pass over the row.  A block then
// quantizes each stage's activations as it arrives (true division
// __fdiv_rn, rintf, the reference's (max - min) * f32(1/255)) and
// multiplies them with dp4a against the weight's k-major quads (4 rows of 4
// columns transposed with __byte_perm): a thread owns 4 columns and 8 (or
// 4) k-rows of a stage for all the tile's rows (8 warps a block and up to
// three blocks an SM, so the stream and the products' latency overlap;
// measured with tools/probe.py k3, the products bound K3 in fewer warps).
// At the end the ranges' int32 products and row sums Σqx meet in
// distributed shared memory; each block of the cluster finishes its share
// of the strip's columns: the epilogue
// ((acc - zx*Σqw) - zw*Σqx + (K*zx)*zw) * sx * sw + bias in the plain
// version's order (built with -fmad=false).  Integer sums are exact in
// any order, so there are no atomics, no zeroed buffer and no second
// launch.  The weight's column sums Σqw come in precomputed with the
// weight (PreparedLinear.qw_sum).
//
// A row-parallel block of a model split quantizes with the whole rows'
// (min, max) (`given`, all-reduced over the ranks).  Its parts mode writes
// the block's int32 products and row sums Σqx in place of the epilogue;
// the ranks' parts summed (an integer all-reduce, exact), the summed mode
// (decode_summed_kernel) finishes them with the same scale, zero point
// and epilogue code as one launch over the whole rows: one device's
// output, bit for bit.

#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int ROWS = 8;          // decode rows a block (a row tile)
constexpr int KS = 32;           // k rows a stage
constexpr int STAGES = 6;
constexpr int THREADS = 256;
constexpr int MAX_SPLIT = 8;     // k ranges a cluster holds
constexpr int X_BYTES = ROWS * KS * 4;           // raw f32 (bf16 uses half)

// A block's layout for a strip of BN columns (256, or 128 where 256-wide
// strips leave SMs idle): CW column words, each a thread's for one of KP
// parts of a stage's k rows (QPT k quads of 4 rows each).
template <int BN>
struct Lay {
  static constexpr int CW = BN / 4, KP = THREADS / CW, QPT = KS / 4 / KP;
  static constexpr int W_BYTES = KS * BN;
  static constexpr int STAGE_BYTES = W_BYTES + X_BYTES;
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int XC_OFF = RING;              // codes: 2 x ROWS x KS
  static constexpr int MM_OFF = XC_OFF + 2 * ROWS * KS;  // (min, max), (s, z)
  static constexpr int QS_OFF = MM_OFF + 4 * ROWS * 4;   // rows' Σqx
  static constexpr int SMEM = QS_OFF + ROWS * 4;
  static_assert(ROWS * BN * 4 <= RING, "the int32 products fit the ring");
  static_assert(QPT == 1 || QPT == 2, "one or two k quads a thread");
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
// 4 consecutive activations (16 bytes of f32, 8 of bf16; aligned: K is a
// multiple of 4 and so is every offset the kernel reads at)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xFFFF0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xFFFF0000u));
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

struct Args {
  const void* x; const int8_t* qw;
  const float* sw; const float* zw; const int* wsum; const float* bias;
  int M, K, N, split_k;
  void* out;
  const float* given;   // (M, 2) rows' (min, max), or null: the rows' own
  int* parts;           // (M + 1, N + 1) int32 parts mode, or null
};

// a row's scale and zero point from its (min, max): (mx - mn) / 255 as the
// compiled reference evaluates it, a true division for the zero point
__device__ __forceinline__ float2 row_scale(float mn, float mx) {
  const float s = fmaxf((mx - mn) * (1.0f / 255.0f), 1e-8f);
  return make_float2(s, rintf(__fdiv_rn(-mn, s)));
}

// the zero-point epilogue in the plain version's order (-fmad=false):
// z is the zero point shifted by 128 (the codes are signed)
__device__ __forceinline__ float finish(int acc, float z, int wsum, float zw,
                                        float qf, float kf, float s,
                                        float sw) {
  return ((((float)acc - z * (float)wsum) - zw * qf) + (kf * z) * zw) * s *
         sw;
}

// With one range the block is its own cluster: plain barriers and its own
// shared memory.
__device__ __forceinline__ void sync_cluster(int n_split) {
  if (n_split > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}
template <typename P>
__device__ __forceinline__ P* at_rank(P* p, int rank, int n_split) {
  return n_split > 1 ? cg::this_cluster().map_shared_rank(p, rank) : p;
}

// Block (range, strip, row tile).  TX: activation type; TO: output type;
// VEC: 16-byte weight copies (N a multiple of 16); BN: the strip's columns.
template <typename TX, typename TO, bool VEC, int BN>
__global__ void __launch_bounds__(THREADS, 3)
decode_matmul_kernel(Args a) {
  using L = Lay<BN>;
  constexpr int CW = L::CW, W_BYTES = L::W_BYTES;
  constexpr int STAGE_BYTES = L::STAGE_BYTES;
  extern __shared__ __align__(16) unsigned char sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int row0 = blockIdx.z * ROWS;
  const int rows = min(ROWS, a.M - row0);
  const int K = a.K, N = a.N;
  const int kb = split * a.split_k, ke = min(K, kb + a.split_k);
  const int KT = (ke - kb + KS - 1) / KS;
  const TX* x = static_cast<const TX*>(a.x);
  constexpr int XE = 4 / sizeof(TX);          // activations a 4-byte copy

  // a stage: the weight's k rows [k0, k0 + KS) of the strip, and the tile
  // rows' activations at the same k
  auto issue = [&](int kt) {
    if (kt >= KT) return;
    unsigned char* st = sm + (kt % STAGES) * STAGE_BYTES;
    const int k0 = kb + kt * KS;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < W_BYTES / 16 / THREADS; ++j) {
        const int i = tid + j * THREADS, r = i / (BN / 16);
        const int c = (i % (BN / 16)) * 16;
        const bool ok = k0 + r < ke && n0 + c < N;
        cp_async_z(st + r * BN + c,
                   ok ? a.qw + (size_t)(k0 + r) * N + n0 + c : a.qw, 16, ok);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < W_BYTES / 4 / THREADS; ++j) {
        const int i = tid + j * THREADS, r = i / CW, c = (i % CW) * 4;
        const bool ok = k0 + r < ke && n0 + c < N;
        cp_async_z(st + r * BN + c,
                   ok ? a.qw + (size_t)(k0 + r) * N + n0 + c : a.qw, 4, ok);
      }
    }
    constexpr int WPR = KS / XE;                // 4-byte words a row
    for (int i = tid; i < ROWS * WPR; i += THREADS) {
      const int m = i / WPR, k = (i % WPR) * XE;
      const bool ok = m < rows && k0 + k < ke;
      cp_async_z(st + W_BYTES + (m * KS + k) * sizeof(TX),
                 ok ? x + (size_t)(row0 + m) * K + k0 + k : a.x, 4, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    issue(s);
    cp_commit();
  }

  // each row's min and max over this range, exchanged across the cluster:
  // every block derives the same scale and zero point from the whole row.
  // A row takes tpr threads (all 256 spread over the tile's rows), each
  // with U vectors of 4 values in flight, so the pass is a few round trips
  // to memory however long the range.
  float* mm = reinterpret_cast<float*>(sm + L::MM_OFF);  // (min, max) a row
  float* sz = mm + 2 * ROWS;                           // (s, z) a row
  if (a.given) {
    // a row-parallel block: the whole rows' (min, max), all-reduced over
    // the blocks (every range takes the same, so the exchange keeps them)
    if (tid < 2 * rows) mm[tid] = a.given[2 * row0 + tid];
  } else {
    constexpr int U = 8;
    const int tpr = THREADS / (rows > 4 ? 8 : rows > 2 ? 4 : rows > 1 ? 2
                               : 1);
    const int m = tid / tpr, part = tid % tpr;
    float mn = __int_as_float(0x7f800000), mx = -mn;   // +inf, -inf
    if (m < rows) {
      const TX* xr = x + (size_t)(row0 + m) * K + kb;
      const int nv = (ke - kb) / 4;
      for (int v0 = part; v0 < nv; v0 += tpr * U) {
        float4 buf[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (v0 + u * tpr < nv) buf[u] = load4(xr + 4 * (v0 + u * tpr));
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (v0 + u * tpr < nv) {
            mn = fminf(fminf(mn, buf[u].x), fminf(buf[u].y,
                       fminf(buf[u].z, buf[u].w)));
            mx = fmaxf(fmaxf(mx, buf[u].x), fmaxf(buf[u].y,
                       fmaxf(buf[u].z, buf[u].w)));
          }
      }
    }
    // the row's threads: lanes of a warp by shuffles, then warps (a row
    // spans up to 8 of them) in shared memory
    for (int o = min(tpr, 32) / 2; o; o >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    float* red = sz;                    // free until the scales are set
    if (lane == 0) {
      red[2 * warp] = mn;
      red[2 * warp + 1] = mx;
    }
    __syncthreads();
    if (part == 0 && m < rows) {
      for (int w = warp + 1; w < warp + tpr / 32; ++w) {
        mn = fminf(mn, red[2 * w]);
        mx = fmaxf(mx, red[2 * w + 1]);
      }
      mm[2 * m] = mn;
      mm[2 * m + 1] = mx;
    }
  }
  sync_cluster(n_split);
  if (tid < rows) {
    float mn = mm[2 * tid], mx = mm[2 * tid + 1];
    for (int r = 0; r < n_split; ++r) {
      const float* rm = at_rank(mm, r, n_split);
      mn = fminf(mn, rm[2 * tid]);
      mx = fmaxf(mx, rm[2 * tid + 1]);
    }
    const float2 r = row_scale(mn, mx);
    sz[2 * tid] = r.x;
    sz[2 * tid + 1] = r.y;
  }

  // quantize a stage's activations into codes buffer kt % 2: warp m takes
  // row m, a lane a value (its Σqx part)
  static_assert(ROWS * KS == THREADS, "a value a thread");
  const int qm = warp, qk = lane;
  int qsum = 0;
  auto quantize = [&](int kt) {
    const TX* xs = reinterpret_cast<const TX*>(
        sm + (kt % STAGES) * STAGE_BYTES + W_BYTES);
    int c = 0;
    if (qm < rows && kb + kt * KS + qk < ke) {
      const float s = sz[2 * qm], z = sz[2 * qm + 1];
      float q = rintf(__fdiv_rn(load_f(xs + qm * KS + qk), s)) + z;
      q = fminf(fmaxf(q, 0.0f), 255.0f);
      c = (int)(q - 128.0f);
      qsum += c;
    }
    (sm + L::XC_OFF + (kt & 1) * ROWS * KS)[qm * KS + qk] = (uint8_t)c;
  };

  // products: thread (cw, kp) owns columns 4cw .. 4cw + 3 and the stage's
  // k rows [4 QPT kp, 4 QPT (kp + 1))
  constexpr int QPT = L::QPT;
  const int cw = tid % CW, kp = tid / CW;
  int acc[ROWS][4];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  cp_wait<STAGES - 2>();
  __syncthreads();              // stage 0 landed; the rows' (s, z) written
  if (KT > 0) quantize(0);
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 3>();
    __syncthreads();            // stage kt + 1 landed, codes kt written,
                                // stage kt - 1 read by every thread
    issue(kt + STAGES - 1);
    cp_commit();
    if (kt + 1 < KT) quantize(kt + 1);
    const int* W = reinterpret_cast<const int*>(sm + (kt % STAGES) *
                                                STAGE_BYTES);
    const int* xc = reinterpret_cast<const int*>(sm + L::XC_OFF +
                                                 (kt & 1) * ROWS * KS);
    int col[QPT][4];
#pragma unroll
    for (int q = 0; q < QPT; ++q) {
      const int r = 4 * (QPT * kp + q);
      transpose4(W[r * CW + cw], W[(r + 1) * CW + cw], W[(r + 2) * CW + cw],
                 W[(r + 3) * CW + cw], col[q]);
    }
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      if (m >= rows) break;
      // the row's codes for the thread's k quads, one 4- or 8-byte load
      int xq[QPT];
      if constexpr (QPT == 2) {
        const int2 v = reinterpret_cast<const int2*>(xc + m * (KS / 4))[kp];
        xq[0] = v.x;
        xq[1] = v.y;
      } else {
        xq[0] = xc[m * (KS / 4) + kp];
      }
#pragma unroll
      for (int q = 0; q < QPT; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[m][j] = __dp4a(xq[q], col[q][j], acc[m][j]);
    }
  }
  cp_wait<0>();
  __syncthreads();              // the ring is free for the products

  // the parts of the block's k rows summed in turn, then the row sums
  int4* P = reinterpret_cast<int4*>(sm);        // ROWS x CW column words
  if (kp == 0)
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      P[m * CW + cw] = make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  for (int o = 1; o < 32; o <<= 1)
    qsum += __shfl_xor_sync(0xffffffffu, qsum, o);
  int* qs = reinterpret_cast<int*>(sm + L::QS_OFF);
  if (lane == 0) qs[qm] = qsum;
  for (int part = 1; part < L::KP; ++part) {
    __syncthreads();
    if (kp == part)
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const int4 v = P[m * CW + cw];
        P[m * CW + cw] = make_int4(v.x + acc[m][0], v.y + acc[m][1],
                                   v.z + acc[m][2], v.w + acc[m][3]);
      }
  }
  sync_cluster(n_split);        // every range's products and row sums

  // range `split` finishes column words [CW split / n, CW (split + 1) / n)
  // of the strip for the tile's rows
  const int w0 = CW * split / n_split, w1 = CW * (split + 1) / n_split;
  const float kf = (float)K;
  TO* out = static_cast<TO*>(a.out);
  for (int i = tid; i < rows * (w1 - w0); i += THREADS) {
    const int m = i / (w1 - w0), w = w0 + i % (w1 - w0);
    int4 v = make_int4(0, 0, 0, 0);
    int q = 0;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      if (r < n_split) {      // the ranks' loads all issued before use
        const int4 u = at_rank(P, r, n_split)[m * CW + w];
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
        q += at_rank(qs, r, n_split)[m];
      }
    }
    const float s = sz[2 * m], z = sz[2 * m + 1] - 128.0f, qf = (float)q;
    const int col = n0 + 4 * w;
    const int vals[4] = {v.x, v.y, v.z, v.w};
    if (a.parts) {
      // parts mode: the products and the row's Σqx, no epilogue
      int* pr = a.parts + (size_t)(row0 + m) * (N + 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < N) pr[col + j] = vals[j];
      if (col == 0) pr[N] = q;
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col + j;
      if (n >= N) break;
      float y = finish(vals[j], z, a.wsum[n], a.zw[n], qf, kf, s, a.sw[n]);
      if (a.bias) y = y + a.bias[n];
      store_f(out + (size_t)(row0 + m) * N + n, y);
    }
  }
  sync_cluster(n_split);        // the ranges' memory stays until it is read
}

template <typename TX, typename TO, bool VEC, int BN>
cudaError_t launch_variant(const Args& a, int n_split, cudaStream_t st) {
  constexpr int SMEM = Lay<BN>::SMEM;
  // the attribute is set once per instantiation and card (it belongs to
  // the card's context): bit d of `sized` for card d
  static unsigned sized = 0u;
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev); e != cudaSuccess) return e;
  if (dev >= 32 || !((sized >> dev) & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_matmul_kernel<TX, TO, VEC, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 32) sized |= 1u << dev;
  }
  const dim3 grid(n_split, (a.N + BN - 1) / BN, (a.M + ROWS - 1) / ROWS);
  if (n_split == 1) {
    decode_matmul_kernel<TX, TO, VEC, BN><<<grid, THREADS, SMEM, st>>>(a);
    return cudaGetLastError();
  }
  // the k ranges of a (strip, row tile) run as one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_matmul_kernel<TX, TO, VEC, BN>, a);
}

template <typename TX, typename TO>
cudaError_t launch(const Args& a, int n_split, int vec, int strip,
                   cudaStream_t st) {
  if (strip == 128)
    return vec ? launch_variant<TX, TO, true, 128>(a, n_split, st)
               : launch_variant<TX, TO, false, 128>(a, n_split, st);
  return vec ? launch_variant<TX, TO, true, 256>(a, n_split, st)
             : launch_variant<TX, TO, false, 256>(a, n_split, st);
}

// K3's statistics mode for a row-parallel block: each row's (min, max)
// over its K values, one block a row (the rows are a few decode tokens).
template <typename TX>
__global__ void __launch_bounds__(THREADS)
row_minmax_kernel(const TX* x, int K, float* out) {
  __shared__ float red[2][THREADS / 32];
  const TX* xr = x + (size_t)blockIdx.x * K;
  float mn = __int_as_float(0x7f800000), mx = -mn;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const float v = load_f(xr + k);
    mn = fminf(mn, v);
    mx = fmaxf(mx, v);
  }
  for (int o = 16; o; o >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[0][warp] = mn;
    red[1][warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < THREADS / 32; ++w) {
      mn = fminf(mn, red[0][w]);
      mx = fmaxf(mx, red[1][w]);
    }
    out[2 * blockIdx.x] = mn;
    out[2 * blockIdx.x + 1] = mx;
  }
}

// K3's summed mode: the ranks' summed parts (M + 1, N + 1) — products
// and Σqx a row, the whole weight's Σqw and K in the last row — finished
// with the whole rows' (min, max) `given`: a thread a column of a row.
template <typename TO>
__global__ void __launch_bounds__(THREADS)
decode_summed_kernel(const int* parts, const float* given, const float* sw,
                     const float* zw, const float* bias, int M, int N,
                     TO* out) {
  const int m = blockIdx.y, n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int* pr = parts + (size_t)m * (N + 1);
  const int* last = parts + (size_t)M * (N + 1);
  const float2 r = row_scale(given[2 * m], given[2 * m + 1]);
  float y = finish(pr[n], r.y - 128.0f, last[n], zw[n], (float)pr[N],
                   (float)last[N], r.x, sw[n]);
  if (bias) y = y + bias[n];
  store_f(out + (size_t)m * N + n, y);
}

}  // namespace

// x: (M, K) bf16 (x_bf16) or f32, contiguous; out: (M, 2) f32, each row's
// (min, max).
extern "C" int decode_row_minmax(const void* x, int x_bf16, int M, int K,
                                 float* out, void* stream) {
  if (M < 0 || K < 1) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    row_minmax_kernel<__nv_bfloat16><<<M, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), K, out);
  else
    row_minmax_kernel<float><<<M, THREADS, 0, st>>>(
        static_cast<const float*>(x), K, out);
  return (int)cudaGetLastError();
}

// x: (M, K) bf16 (x_bf16) or f32; qw: (K, N) int8; sw, zw: (N,) f32; wsum:
// (N,) int32; bias: (N,) f32 or null; out: (M, N) bf16 (out_bf16) or f32;
// all contiguous.  n_split k ranges of split_k rows (a multiple of 32)
// cover K; strip: columns a block, 128 or 256; vec: N is a multiple of 16
// and qw 16-byte aligned.  parts and given, both or neither: the parts
// mode of a row-parallel block of a model split quantizes with given, (M,
// 2) f32 the whole rows' (min, max) all-reduced, in place of the rows' own,
// and writes the first M rows of parts, (M + 1, N + 1) int32 (products,
// Σqx last); it neither reads sw / zw / wsum / bias nor writes out.
extern "C" int stamp_decode_matmul(
    const void* x, int x_bf16, int M, int K, int N, const void* qw,
    const float* sw, const float* zw, const int* wsum, const float* bias,
    int n_split, int split_k, int strip, int vec, void* out, int out_bf16,
    const float* given, int* parts, void* stream) {
  if (M < 0 || K < 1 || N < 0 || K % 4 || N % 4 || n_split < 1 ||
      n_split > MAX_SPLIT || split_k < KS || split_k % KS ||
      (long long)(n_split - 1) * split_k >= K ||
      (long long)n_split * split_k < K || (M + ROWS - 1) / ROWS > 65535 ||
      (strip != 128 && strip != 256) || !parts != !given)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  const Args a{x, static_cast<const int8_t*>(qw), sw, zw, wsum, bias,
               M, K, N, split_k, out, given, parts};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_bf16)
    e = out_bf16
            ? launch<__nv_bfloat16, __nv_bfloat16>(a, n_split, vec, strip, st)
            : launch<__nv_bfloat16, float>(a, n_split, vec, strip, st);
  else
    e = out_bf16 ? launch<float, __nv_bfloat16>(a, n_split, vec, strip, st)
                 : launch<float, float>(a, n_split, vec, strip, st);
  return (int)e;
}

// parts: (M + 1, N + 1) int32, the ranks' summed parts of the parts mode,
// the whole weight's Σqw in [M, :N] and K in [M, N]; given: (M, 2) f32 the
// whole rows' (min, max); sw, zw: (N,) f32; bias: (N,) f32 or null; out:
// (M, N) bf16 (out_bf16) or f32; all contiguous.
extern "C" int stamp_decode_matmul_summed(
    const int* parts, const float* given, int M, int N, const float* sw,
    const float* zw, const float* bias, void* out, int out_bf16,
    void* stream) {
  if (M < 0 || N < 0 || M > 65535) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + THREADS - 1) / THREADS, M);
  if (out_bf16)
    decode_summed_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        parts, given, sw, zw, bias, M, N, static_cast<__nv_bfloat16*>(out));
  else
    decode_summed_kernel<float><<<grid, THREADS, 0, st>>>(
        parts, given, sw, zw, bias, M, N, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
