// Grouped MoE expert FFN for Hopper (sm_90a): K5.
//
// Replaces the Pallas kernel stamp_quant_grouped_matmul_pallas
// (src/repro/kernels/stamp_matmul.py).  Per expert bucket of the gathered
// int8 dispatch buffer (b, E, C, d): gate and up int8 GEMMs against the
// stacked (E, d, f) expert codes, the zero-point epilogue, silu(g)*u, an
// 8-bit per-row requantize of each bf-column slab of the activation, and
// the down-projection (E, f, d) whose per-slab partial products sum in f32
// over the slabs in order.  Rows at or past the bucket's kept-token count
// are written as exact zeros.
//
// Bound on the H100: bytes.  A prefill step has few rows per expert (at
// Arctic's widths C = 3 capacity slots per 128-token span, so at most 6
// rows for two spans), so the work is ~12 int8 operations per weight byte,
// far below the card's ridge: the kernel is as fast as it streams each
// occupied expert's 3*d*f int8 weight bytes once.  The Pallas grid
// (b, E, C-tile, f-tile) walks experts per batch row and would re-read an
// expert's weights once per span; here a block takes the buckets of ALL
// spans of its expert (a compact list of kept rows), so every weight byte
// is read once per call, and a bucket with no kept token streams nothing.
//
// The TPU kernel carries the f32 down-proj accumulator in VMEM scratch
// across its sequential f-tile grid axis.  Blocks on Hopper run in no
// order, and f32 atomics across slabs would reorder the sum, so the chain
// is two launches, both deterministic:
//
// (a) moe_gate_up_kernel, a block per (f slab, expert): 256 threads split
//     d into k groups, each thread owning 4 adjacent columns (4-byte loads,
//     repacked into k-major quads for dp4a) for up to RB rows at a time;
//     the k groups meet in shared int32 sums (integer atomics: exact,
//     order-free).  Then the epilogue, silu(g)*u, and the slab's per-row
//     requantize (one warp per row) on chip; the int8 codes and the f32
//     scale / shifted zero point / int32 code sum of each (row, slab) go to
//     device memory (a few MB).
// (b) moe_down_kernel, a block per (256 output columns, expert): each
//     thread owns 4 columns and walks the slabs j = 0 .. nf-1 in order, an
//     int32 dp4a sum per slab over bf rows of the down codes, then the
//     slab's epilogue added to f32 registers: the reference's order.
//
// The down codes' per-slab column sums are fixed with the weight and come
// in precomputed (E, nf, d), as the gate/up column sums do (E, 1, f).
// Numerics mirror the Pallas kernel as it runs compiled: true division
// (__fdiv_rn) by the per-row scale, round half to even (rintf), the 1e-8
// floor, (mx - mn) * f32(1/255) (XLA's form of the division by 255), silu
// as x * (1 / (1 + exp(-x))), and -fmad=false so the f32 epilogues evaluate
// in the plain version's order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int RB = THREADS / 32;   // rows per chunk: one warp each
constexpr int MAX_BF = 512;
constexpr int DT_THREADS = 64;     // down-proj block: 4 columns a thread
constexpr int DT = 4 * DT_THREADS;

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int ld4(const int8_t* p) {
  return __ldg(reinterpret_cast<const int*>(p));
}

// Four 4-byte words of consecutive k rows -> four k-major column quads.
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

// Kept rows of expert e over every batch row, as flat indices into the
// (B, E, C) dispatch layout; thread 0 builds the list.  Returns its length.
__device__ int kept_rows(const int* counts, int B, int E, int C, int e,
                         int* rows, int* n_shared) {
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < B; ++i) {
      const int cnt = min(max(counts[i * E + e], 0), C);
      for (int c = 0; c < cnt; ++c) rows[n++] = (i * E + e) * C + c;
    }
    *n_shared = n;
  }
  __syncthreads();
  return *n_shared;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ((acc - zx*Σqw) - zw*Σqx + (K*zx)*zw) * sx * sw: the plain version's order
__device__ __forceinline__ float epilogue(int acc, float sx, float zx,
                                          float sw, float zw, int wsum,
                                          int xsum, float k) {
  return ((((float)acc - zx * (float)wsum) - zw * (float)xsum) +
          (k * zx) * zw) * sx * sw;
}

// ---------------------------------------------------------------- (a) ----

__global__ void __launch_bounds__(THREADS)
moe_gate_up_kernel(const int8_t* qx, const float* sx, const float* zx,
                   const int* counts, int B, int E, int C, int D, int F,
                   int BF, const int8_t* qwg, const float* swg,
                   const float* zwg, const int* wsg, const int8_t* qwu,
                   const float* swu, const float* zwu, const int* wsu,
                   int8_t* qa, float* sa, float* za, int* qas) {
  extern __shared__ int sm[];
  int* accg = sm;                    // RB x BF int32 sums
  int* accu = accg + RB * BF;
  float* av = reinterpret_cast<float*>(accu + RB * BF);   // RB x BF
  int* rows = reinterpret_cast<int*>(av + RB * BF);       // B * C
  __shared__ int n_rows;
  __shared__ int xsum[RB];

  const int j = blockIdx.x, e = blockIdx.y;
  const int nf = F / BF;
  const int nrows = kept_rows(counts, B, E, C, e, rows, &n_rows);
  if (nrows == 0) return;            // empty bucket: stream nothing

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ct = BF / 4, kgn = THREADS / ct;
  const int cg = tid % ct, kg = tid / ct;
  const int dq = D / 4;
  const size_t wcol = (size_t)e * D * F + (size_t)j * BF + 4 * cg;
  const float kf = (float)D;

  for (int r0 = 0; r0 < nrows; r0 += RB) {
    const int nr = min(RB, nrows - r0);
    for (int idx = tid; idx < RB * BF; idx += THREADS) accg[idx] = accu[idx] = 0;
    if (warp < nr) {                 // Σqx of each row, one warp per row
      const int8_t* xr = qx + (size_t)rows[r0 + warp] * D;
      int s = 0;
      for (int q = lane; q < dq; q += 32) s = __dp4a(ld4(xr + 4 * q), 0x01010101, s);
      s = warp_sum(s);
      if (lane == 0) xsum[warp] = s;
    }
    __syncthreads();
    if (kg < kgn) {
      const int8_t* xr[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) xr[r] = qx + (size_t)rows[r0 + min(r, nr - 1)] * D;
      int g[RB][4], u[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) g[r][c] = u[r][c] = 0;
      for (int q = kg; q < dq; q += kgn) {
        const int8_t* pg = qwg + wcol + (size_t)4 * q * F;
        const int8_t* pu = qwu + wcol + (size_t)4 * q * F;
        int wg[4], wu[4];
        transpose4(ld4(pg), ld4(pg + F), ld4(pg + 2 * (size_t)F),
                   ld4(pg + 3 * (size_t)F), wg);
        transpose4(ld4(pu), ld4(pu + F), ld4(pu + 2 * (size_t)F),
                   ld4(pu + 3 * (size_t)F), wu);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
            const int xq = ld4(xr[r] + 4 * q);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              g[r][c] = __dp4a(xq, wg[c], g[r][c]);
              u[r][c] = __dp4a(xq, wu[c], u[r][c]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            atomicAdd(accg + r * BF + 4 * cg + c, g[r][c]);
            atomicAdd(accu + r * BF + 4 * cg + c, u[r][c]);
          }
        }
      }
    }
    __syncthreads();
    for (int idx = tid; idx < nr * BF; idx += THREADS) {
      const int r = idx / BF, n = j * BF + idx % BF;
      const int row = rows[r0 + r];
      const size_t w = (size_t)e * F + n;
      const float gv = epilogue(accg[idx], sx[row], zx[row], swg[w], zwg[w],
                                wsg[w], xsum[r], kf);
      const float uv = epilogue(accu[idx], sx[row], zx[row], swu[w], zwu[w],
                                wsu[w], xsum[r], kf);
      av[idx] = (gv * (1.0f / (1.0f + expf(-gv)))) * uv;
    }
    __syncthreads();
    if (warp < nr) {                 // the slab's per-row 8-bit requantize
      const float* ar = av + warp * BF;
      float mn = ar[0], mx = ar[0];
      for (int c = lane; c < BF; c += 32) {
        mn = fminf(mn, ar[c]);
        mx = fmaxf(mx, ar[c]);
      }
      mn = warp_min(mn);
      mx = warp_max(mx);
      const float s = fmaxf((mx - mn) * (1.0f / 255.0f), 1e-8f);
      const float z = rintf(__fdiv_rn(-mn, s));
      const size_t row = rows[r0 + warp];
      int part = 0;
      for (int c = lane; c < BF; c += 32) {
        float q = rintf(__fdiv_rn(ar[c], s)) + z;
        q = fminf(fmaxf(q, 0.0f), 255.0f);
        const int code = (int)(q - 128.0f);
        qa[row * F + (size_t)j * BF + c] = (int8_t)code;
        part += code;
      }
      part = warp_sum(part);
      if (lane == 0) {
        sa[row * nf + j] = s;
        za[row * nf + j] = z - 128.0f;
        qas[row * nf + j] = part;
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- (b) ----

template <typename TO>
__global__ void __launch_bounds__(DT_THREADS)
moe_down_kernel(const int* counts, int B, int E, int C, int D, int F, int BF,
                const int8_t* qa, const float* sa, const float* za,
                const int* qas, const int8_t* qwd, const float* swd,
                const float* zwd, const int* wsd, TO* out) {
  extern __shared__ int rows[];      // B * C
  __shared__ int n_rows;
  const int e = blockIdx.y;
  const int col = blockIdx.x * DT + 4 * threadIdx.x;
  const int nf = F / BF;
  // rows at or past each bucket's count: exact zeros
  for (int i = 0; i < B; ++i) {
    const int cnt = min(max(counts[i * E + e], 0), C);
    for (int c = cnt; c < C && col < D; ++c)
      for (int k = 0; k < 4; ++k)
        store_f(out + ((size_t)(i * E + e) * C + c) * D + col + k, 0.0f);
  }
  const int nrows = kept_rows(counts, B, E, C, e, rows, &n_rows);
  if (nrows == 0 || col >= D) return;

  const float kf = (float)BF;
  const int bq = BF / 4;
  float zw[4], sw[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    zw[k] = zwd[(size_t)e * D + col + k];
    sw[k] = swd[(size_t)e * D + col + k];
  }
  for (int r0 = 0; r0 < nrows; r0 += RB) {
    const int nr = min(RB, nrows - r0);
    int row[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) row[r] = rows[r0 + min(r, nr - 1)];
    float acc[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] = 0.0f;
    for (int j = 0; j < nf; ++j) {
      int p[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) p[r][k] = 0;
      const int8_t* pw = qwd + ((size_t)e * F + (size_t)j * BF) * D + col;
      for (int q = 0; q < bq; ++q) {
        const int8_t* w = pw + (size_t)4 * q * D;
        int wq[4];
        transpose4(ld4(w), ld4(w + D), ld4(w + 2 * (size_t)D),
                   ld4(w + 3 * (size_t)D), wq);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < nr) {
            const int xq = ld4(qa + (size_t)row[r] * F + (size_t)j * BF + 4 * q);
#pragma unroll
            for (int k = 0; k < 4; ++k) p[r][k] = __dp4a(xq, wq[k], p[r][k]);
          }
        }
      }
      const int* ws = wsd + ((size_t)e * nf + j) * D + col;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          const size_t rj = (size_t)row[r] * nf + j;
          const float s = sa[rj], z = za[rj];
          const int xs = qas[rj];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            acc[r][k] = acc[r][k] + epilogue(p[r][k], s, z, sw[k], zw[k],
                                             ws[k], xs, kf);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < nr) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          store_f(out + (size_t)row[r] * D + col + k, acc[r][k]);
      }
    }
  }
}

}  // namespace

extern "C" int stamp_grouped_moe(
    const void* qx, const float* sx, const float* zx, const int* counts,
    int B, int E, int C, int D, int F, int BF, const void* qwg,
    const float* swg, const float* zwg, const int* wsg, const void* qwu,
    const float* swu, const float* zwu, const int* wsu, const void* qwd,
    const float* swd, const float* zwd, const int* wsd, void* qa, float* sa,
    float* za, int* qas, void* out, int out_bf16, void* stream) {
  if (D % 4 || BF % 4 || BF > MAX_BF || F % BF)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t rows_bytes = sizeof(int) * (size_t)B * C;
  const size_t smem_a = sizeof(int) * 3 * RB * BF + rows_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      moe_gate_up_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  moe_gate_up_kernel<<<dim3(F / BF, E), THREADS, smem_a, st>>>(
      static_cast<const int8_t*>(qx), sx, zx, counts, B, E, C, D, F, BF,
      static_cast<const int8_t*>(qwg), swg, zwg, wsg,
      static_cast<const int8_t*>(qwu), swu, zwu, wsu,
      static_cast<int8_t*>(qa), sa, za, qas);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 grid_b((D + DT - 1) / DT, E);
  const int8_t* a = static_cast<const int8_t*>(qa);
  const int8_t* w = static_cast<const int8_t*>(qwd);
  if (out_bf16) {
    err = cudaFuncSetAttribute(moe_down_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rows_bytes);
    if (err != cudaSuccess) return (int)err;
    moe_down_kernel<__nv_bfloat16><<<grid_b, DT_THREADS, rows_bytes, st>>>(
        counts, B, E, C, D, F, BF, a, sa, za, qas, w, swd, zwd, wsd,
        static_cast<__nv_bfloat16*>(out));
  } else {
    err = cudaFuncSetAttribute(moe_down_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)rows_bytes);
    if (err != cudaSuccess) return (int)err;
    moe_down_kernel<float><<<grid_b, DT_THREADS, rows_bytes, st>>>(
        counts, B, E, C, D, F, BF, a, sa, za, qas, w, swd, zwd, wsd,
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
