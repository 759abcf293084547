// Paged mixed-precision attention for Hopper (sm_90a): K4.
//
// Replaces the Pallas kernels paged_ragged_attention and
// paged_decode_attention (src/repro/kernels/paged_attention.py): prefill
// chunk spans and decode spans of one unified serving step attend through
// their block tables into the int8 "hi" page pool (the first num_hi tokens
// of every sequence) and the int4-nibble "lo" pool, with f16 per-token
// scale / zero point, under the mask  kv_pos <= q_pos AND kv_pos < length.
// An all-decode step is the same kernel with no prefill spans.
//
// Grid (span, kv_head, query-row tile): the TPU walks the logical blocks as
// a sequential grid axis and carries (m, l, acc) in a revisited output
// block; here that axis is a loop inside the block, and each query row keeps
// its running max, sum and accumulator in registers (4 threads per row, each
// owning head_dim/4 interleaved features).  The block reads its own table
// entries (the TPU scalar-prefetched them), dequantizes one page of K and V
// into shared memory (hi nibble = even feature), and stops at the first page
// past the tile's last visible position, so the pages read are the ones the
// span's length needs.
//
// Bound on the H100: bytes — every span streams its pages (about 0.5 byte
// per cached value plus f16 scale/zp per token and head) against a few
// hundred flops per page row.  Pages are small (4 or 16 tokens), so the loop
// is latency-bound in this first version; a split-K over pages and a
// cp.async ring are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;       // query rows per block
constexpr int TPR = 4;         // threads per query row
constexpr int THREADS = ROWS * TPR;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Pools {
  const int8_t* k_hi; const int8_t* v_hi;
  const __half* k_hi_s; const __half* k_hi_z;
  const __half* v_hi_s; const __half* v_hi_z;
  const uint8_t* k_lo; const uint8_t* v_lo;
  const __half* k_lo_s; const __half* k_lo_z;
  const __half* v_lo_s; const __half* v_lo_z;
};

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* q_pf, const T* q_dec, Pools P,
                       const int* hi_table, const int* lo_table,
                       const int* lengths, const int* q_starts, int n_pf,
                       int C, int h, int g, int bs, int nh, int nl,
                       float scale, T* out_pf, T* out_dec) {
  extern __shared__ float kv[];  // K page then V page, bs x HD each
  float* Kp = kv;
  float* Vp = kv + bs * HD;
  constexpr int DPT = HD / TPR;

  const int span = blockIdx.x, kvh = blockIdx.y;
  const int rep = h / g;
  const bool is_pf = span < n_pf;
  const int nrows = is_pf ? C * rep : rep;
  const int row0 = blockIdx.z * ROWS;
  if (row0 >= nrows) return;
  const int length = lengths[span];
  const int qstart = is_pf ? q_starts[span] : length - 1;
  const int row = row0 + threadIdx.x / TPR, part = threadIdx.x % TPR;
  const bool active = row < nrows;
  const int c = active ? row / rep : 0, r = row % rep;
  const int head = kvh * rep + r;
  const int qpos = qstart + c;
  const int last_row = min(row0 + ROWS, nrows) - 1;
  const int kv_limit = min(length, qstart + last_row / rep + 1);

  const T* qp = is_pf ? q_pf + (((size_t)span * C + c) * h + head) * HD
                      : q_dec + ((size_t)(span - n_pf) * h + head) * HD;
  float q[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    q[i] = active ? load_f(qp + part + TPR * i) * scale : 0.0f;
    acc[i] = 0.0f;
  }
  float m = -1e30f, l = 0.0f;
  const int num_hi = nh * bs;

  for (int blk = 0; blk < nh + nl; ++blk) {
    const bool hi = blk < nh;
    const int start = hi ? blk * bs : num_hi + (blk - nh) * bs;
    if (start >= kv_limit) break;
    const int page = hi ? hi_table[span * nh + blk]
                        : lo_table[span * nl + (blk - nh)];
    for (int idx = threadIdx.x; idx < bs * HD; idx += THREADS) {
      const int t = idx / HD, d = idx % HD;
      const size_t tok = ((size_t)page * bs + t) * g + kvh;
      float kc, vc, ks, kz, vs, vz;
      if (hi) {
        kc = (float)P.k_hi[tok * HD + d];
        vc = (float)P.v_hi[tok * HD + d];
        ks = __half2float(P.k_hi_s[tok]); kz = __half2float(P.k_hi_z[tok]);
        vs = __half2float(P.v_hi_s[tok]); vz = __half2float(P.v_hi_z[tok]);
      } else {
        const uint8_t kb = P.k_lo[tok * (HD / 2) + d / 2];
        const uint8_t vb = P.v_lo[tok * (HD / 2) + d / 2];
        kc = (float)((d % 2 == 0) ? (kb >> 4) : (kb & 0xF));
        vc = (float)((d % 2 == 0) ? (vb >> 4) : (vb & 0xF));
        ks = __half2float(P.k_lo_s[tok]); kz = __half2float(P.k_lo_z[tok]);
        vs = __half2float(P.v_lo_s[tok]); vz = __half2float(P.v_lo_z[tok]);
      }
      Kp[idx] = (kc - kz) * ks;
      Vp[idx] = (vc - vz) * vs;
    }
    __syncthreads();
    for (int j = 0; j < bs; ++j) {
      const int pos = start + j;
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) s += q[i] * Kp[j * HD + part + TPR * i];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (!active || pos > qpos || pos >= length) continue;
      const float m_new = fmaxf(m, s);
      const float corr = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * corr + p;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        acc[i] = acc[i] * corr + p * Vp[j * HD + part + TPR * i];
      m = m_new;
    }
    __syncthreads();
  }
  if (!active) return;
  T* op = is_pf ? out_pf + (((size_t)span * C + c) * h + head) * HD
                : out_dec + ((size_t)(span - n_pf) * h + head) * HD;
  const float inv = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPT; ++i) store_f(op + part + TPR * i, acc[i] / inv);
}

template <int HD, typename T>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t st, const void* q_pf,
                   const void* q_dec, const Pools& P, const int* ht,
                   const int* lt, const int* len, const int* qs, int n_pf,
                   int C, int h, int g, int bs, int nh, int nl, float scale,
                   void* out_pf, void* out_dec) {
  paged_attention_kernel<HD, T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q_pf), static_cast<const T*>(q_dec), P, ht, lt,
      len, qs, n_pf, C, h, g, bs, nh, nl, scale, static_cast<T*>(out_pf),
      static_cast<T*>(out_dec));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, dim3 grid, size_t smem, cudaStream_t st,
                        const void* q_pf, const void* q_dec, const Pools& P,
                        const int* ht, const int* lt, const int* len,
                        const int* qs, int n_pf, int C, int h, int g, int bs,
                        int nh, int nl, float scale, void* out_pf,
                        void* out_dec) {
  switch (hd) {
    case 16: return launch<16, T>(grid, smem, st, q_pf, q_dec, P, ht, lt, len, qs, n_pf, C, h, g, bs, nh, nl, scale, out_pf, out_dec);
    case 32: return launch<32, T>(grid, smem, st, q_pf, q_dec, P, ht, lt, len, qs, n_pf, C, h, g, bs, nh, nl, scale, out_pf, out_dec);
    case 64: return launch<64, T>(grid, smem, st, q_pf, q_dec, P, ht, lt, len, qs, n_pf, C, h, g, bs, nh, nl, scale, out_pf, out_dec);
    case 128: return launch<128, T>(grid, smem, st, q_pf, q_dec, P, ht, lt, len, qs, n_pf, C, h, g, bs, nh, nl, scale, out_pf, out_dec);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int paged_attention(
    const void* q_pf, const void* q_dec, int q_bf16, int n_pf, int S, int C,
    int h, int g, int hd, int bs, int nh, int nl, const void* k_hi,
    const void* v_hi, const void* k_hi_s, const void* k_hi_z,
    const void* v_hi_s, const void* v_hi_z, const void* k_lo,
    const void* v_lo, const void* k_lo_s, const void* k_lo_z,
    const void* v_lo_s, const void* v_lo_z, const int* hi_table,
    const int* lo_table, const int* lengths, const int* q_starts,
    float scale, void* out_pf, void* out_dec, void* stream) {
  const Pools P{static_cast<const int8_t*>(k_hi),
                static_cast<const int8_t*>(v_hi),
                static_cast<const __half*>(k_hi_s),
                static_cast<const __half*>(k_hi_z),
                static_cast<const __half*>(v_hi_s),
                static_cast<const __half*>(v_hi_z),
                static_cast<const uint8_t*>(k_lo),
                static_cast<const uint8_t*>(v_lo),
                static_cast<const __half*>(k_lo_s),
                static_cast<const __half*>(k_lo_z),
                static_cast<const __half*>(v_lo_s),
                static_cast<const __half*>(v_lo_z)};
  const int rep = h / g;
  const int max_rows = n_pf > 0 ? C * rep : rep;
  const dim3 grid(n_pf + S, g, (max_rows + ROWS - 1) / ROWS);
  const size_t smem = 2 * (size_t)bs * hd * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      q_bf16 ? dispatch_hd<__nv_bfloat16>(hd, grid, smem, st, q_pf, q_dec, P,
                                          hi_table, lo_table, lengths,
                                          q_starts, n_pf, C, h, g, bs, nh, nl,
                                          scale, out_pf, out_dec)
             : dispatch_hd<float>(hd, grid, smem, st, q_pf, q_dec, P,
                                  hi_table, lo_table, lengths, q_starts, n_pf,
                                  C, h, g, bs, nh, nl, scale, out_pf,
                                  out_dec);
  return (int)e;
}
