// Decode attention over the contiguous packed KV cache for Hopper (sm_90a):
// K6.
//
// Replaces the Pallas kernel cache_decode_attention
// (src/repro/kernels/cache_attention.py): one query token per batch row
// attends over that row's cache, whose first hi_len positions hold int8 codes
// and the rest int4 nibbles packed two per byte (even feature in the high
// nibble), each (token, kv head) with an f16 scale and zero point, under the
// mask pos < length[b].  The output is o / max(l, 1e-30) in q's dtype.
//
// Bound on the H100: bytes.  The packed cache is about 0.52 byte per cached
// value and every value is used for two multiply-adds per query head of its
// group, so a long cache is read at a few operations per byte.
//
// Design.  The TPU walks a grid (b, g, lo block) in order and carries the
// online-softmax state of a (b, g) row across its blocks.  At a decode batch
// of 8 with 8 kv heads that is 64 rows on a card with 132 SMs, so here the
// sequence is split as well (flash-decoding): launch 1 gives each block one
// contiguous range of positions of one (b, g) row and all `rep` query heads of
// that kv head.  The block walks its range in tiles of 128 positions: one
// thread per position loads that token's K and V codes with vector loads,
// dequantizes K a word at a time in registers and scores it against the
// pre-scaled queries (shared memory, broadcast reads), and stages the V codes
// in shared memory; a warp per query head takes the tile's max, exp and sum
// and rescales the running (m, l); then each thread dequantizes the V value of
// its feature at each position and accumulates p * v.  Shared memory is ~25 KB
// a block and registers are capped at 128 a thread, so several blocks share an
// SM and hide each other's load latency.  Positions at or past length[b] are
// never read: a range that starts past it writes an empty partial (m = -1e30,
// l = 0) and reads nothing, and the walk stops at the tile holding the last
// valid position. Launch 2 merges the ranges' partials of each (b, g, head) in
// range order, so no float atomics are used and the output is the same on
// every run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;   // one thread per position of a tile
constexpr int TILE = 128;
constexpr int MAX_REP = 8;     // query heads per kv head
// staged V rows lie HD + SLOT_PAD bytes apart: one word past HD, so the
// threads of a warp, each storing its own row, hit different banks
constexpr int SLOT_PAD = 4;
constexpr float NEG = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// NW 32-bit words of a row whose start is aligned to 16 bytes (NW a multiple
// of 4) or to 8 (NW even: a lo row at head_dim 16 or 112)
template <int NW>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
    const uint4* v = static_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 u = v[i];
      w[4 * i] = u.x; w[4 * i + 1] = u.y; w[4 * i + 2] = u.z;
      w[4 * i + 3] = u.w;
    }
  } else {
    static_assert(NW % 2 == 0, "rows hold an even number of words");
    const uint2* v = static_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const uint2 u = v[i];
      w[2 * i] = u.x; w[2 * i + 1] = u.y;
    }
  }
}

// Code of feature d in a row of codes: int8 (hi) or packed nibbles (lo:
// byte j holds feature 2j in its high nibble and 2j + 1 in its low one).
__device__ __forceinline__ float code_at(const uint8_t* row, bool hi, int d) {
  if (hi) return (float)(int8_t)row[d];
  const uint8_t byte = row[d >> 1];
  return (float)((d & 1) ? (byte & 0xFu) : (byte >> 4));
}

struct Cache {
  const int8_t* k_hi; const int8_t* v_hi;
  const uint8_t* k_lo; const uint8_t* v_lo;
  const __half* k_sc; const __half* k_zp;
  const __half* v_sc; const __half* v_zp;
};

// Scores of one K row against the rep pre-scaled queries (shared memory):
// the row's codes are read as words, each word dequantized to 4 (hi) or 8
// (lo) values that meet every query head before the next word is read.
template <int HD>
__device__ __forceinline__ void score_row(bool hi, const int8_t* hi_row,
                                          const uint8_t* lo_row, float sc,
                                          float zp, const float* qs, int rep,
                                          float (&s)[MAX_REP]) {
  if (hi) {
    uint32_t w[HD / 4];
    load_words<HD / 4>(hi_row, w);
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) {
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = ((float)(int8_t)((w[i] >> (8 * j)) & 0xFFu) - zp) * sc;
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        const float4 qv = reinterpret_cast<const float4*>(qs + r * HD)[i];
        s[r] += qv.x * x[0] + qv.y * x[1] + qv.z * x[2] + qv.w * x[3];
      }
    }
  } else {
    uint32_t w[HD / 8];
    load_words<HD / 8>(lo_row, w);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (w[i] >> (8 * j)) & 0xFFu;
        x[2 * j] = ((float)(byte >> 4) - zp) * sc;
        x[2 * j + 1] = ((float)(byte & 0xFu) - zp) * sc;
      }
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        const float4* q4 = reinterpret_cast<const float4*>(qs + r * HD);
        const float4 a = q4[2 * i], b = q4[2 * i + 1];
        s[r] += a.x * x[0] + a.y * x[1] + a.z * x[2] + a.w * x[3] +
                b.x * x[4] + b.y * x[5] + b.z * x[6] + b.w * x[7];
      }
    }
  }
}

// A row of codes (HD bytes hi, HD / 2 lo) copied into a shared-memory slot.
template <int HD>
__device__ __forceinline__ void stage_row(bool hi, const int8_t* hi_row,
                                          const uint8_t* lo_row,
                                          uint8_t* slot) {
  if (hi) {
    uint32_t w[HD / 4];
    load_words<HD / 4>(hi_row, w);
#pragma unroll
    for (int i = 0; i < HD / 4; ++i)
      reinterpret_cast<uint32_t*>(slot)[i] = w[i];
  } else {
    uint32_t w[HD / 8];
    load_words<HD / 8>(lo_row, w);
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      reinterpret_cast<uint32_t*>(slot)[i] = w[i];
  }
}

// part: (b, g, n_split, rep, HD + 2) f32 — m, l, then the unnormalised sum
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS, 4)
cache_attention_split(const T* q, Cache C, const int* lengths, int h, int g,
                      int hi_len, int S, int split_len, float scale,
                      float* part) {
  extern __shared__ __align__(16) float smem[];
  // position groups in the V sum (threads past NG * HD, as at head_dim 112,
  // take none)
  constexpr int NG = THREADS / HD;
  const int rep = h / g;
  float* qs = smem;                       // rep x HD pre-scaled queries
  float* ps = qs + MAX_REP * HD;          // rep x TILE scores, then p
  float* vsc = ps + MAX_REP * TILE;       // V scale and zero point per
  float* vzp = vsc + TILE;                // position of the tile
  float* stat = vzp + TILE;               // m, l, corr per head
  float* m_run = stat;
  float* l_run = stat + MAX_REP;
  float* corr = stat + 2 * MAX_REP;
  uint8_t* vcodes = reinterpret_cast<uint8_t*>(stat + 4 * MAX_REP);
  // the tile's V codes, one slot a position (a lo row fills half of it)
  constexpr int SLOT = HD + SLOT_PAD;

  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x;
  const int s_lo = S - hi_len;
  const int start = split * split_len;
  const int end = min(min(start + split_len, S), lengths[bi]);
  float* out = part + (((size_t)bi * g + kvh) * n_split + split) * rep *
                          (HD + 2);

  if (start >= end) {                     // nothing of this range is valid
    for (int i = tid; i < rep * (HD + 2); i += THREADS)
      out[i] = (i % (HD + 2) == 0) ? NEG : 0.0f;
    return;
  }
  for (int i = tid; i < rep * HD; i += THREADS)
    qs[i] = load_f(q + ((size_t)bi * h + kvh * rep) * HD + i) * scale;
  if (tid < rep) { m_run[tid] = NEG; l_run[tid] = 0.0f; }

  const int d = tid % HD, grp = tid / HD;
  float acc[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.0f;
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += TILE) {
    const int n = min(TILE, end - t0);
    // 1. one position per thread: score its K row, stage its V row
    if (tid < n) {
      const int pos = t0 + tid;
      const bool hi = pos < hi_len;
      const size_t sp = ((size_t)bi * S + pos) * g + kvh;
      const size_t hrow = hi ? (((size_t)bi * hi_len + pos) * g + kvh) : 0;
      const size_t lrow = hi ? 0
          : (((size_t)bi * s_lo + (pos - hi_len)) * g + kvh);
      float s[MAX_REP];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) s[r] = 0.0f;
      score_row<HD>(hi, C.k_hi + hrow * HD, C.k_lo + lrow * (HD / 2),
                    __half2float(C.k_sc[sp]), __half2float(C.k_zp[sp]), qs,
                    rep, s);
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) ps[r * TILE + tid] = s[r];
      stage_row<HD>(hi, C.v_hi + hrow * HD, C.v_lo + lrow * (HD / 2),
                    vcodes + tid * SLOT);
      vsc[tid] = __half2float(C.v_sc[sp]);
      vzp[tid] = __half2float(C.v_zp[sp]);
    }
    __syncthreads();
    // 2. a warp per query head: tile max, p = exp(s - m), running (m, l)
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < rep; r += THREADS / 32) {
      float mx = NEG;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, ps[r * TILE + j]);
#pragma unroll
      for (int o = 16; o; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[r], mx);
      float sum = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(ps[r * TILE + j] - m_new);
        ps[r * TILE + j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_run[r] - m_new);
        corr[r] = c;
        l_run[r] = l_run[r] * c + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();
    // 3. acc = acc * corr + sum over the tile's positions of p * v, each v
    //    dequantized from the staged codes as in the K row
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < rep) acc[r] *= corr[r];
    for (int j = grp; j < n && grp < NG; j += NG) {
      const float v = (code_at(vcodes + j * SLOT, t0 + j < hi_len, d) -
                       vzp[j]) * vsc[j];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) acc[r] += ps[r * TILE + j] * v;
    }
    __syncthreads();
  }
  // position groups' sums joined in group order (HD < THREADS); the V code
  // slots are free again
  if constexpr (NG > 1) {
    float* red = reinterpret_cast<float*>(vcodes);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < rep) red[(grp * MAX_REP + r) * HD + d] = acc[r];
    __syncthreads();
    if (grp == 0)
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        float a = 0.0f;
        for (int k = 0; k < NG; ++k) a += red[(k * MAX_REP + r) * HD + d];
        acc[r] = a;
      }
  }
  if (grp == 0)
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      out[r * (HD + 2) + 2 + d] = acc[r];
      if (d == 0) {
        out[r * (HD + 2)] = m_run[r];
        out[r * (HD + 2) + 1] = l_run[r];
      }
    }
}

// one block per (kv head, b): merge the ranges in order
template <typename T>
__global__ void __launch_bounds__(THREADS)
cache_attention_merge(const float* part, int h, int g, int hd, int n_split,
                      T* out) {
  const int kvh = blockIdx.x, bi = blockIdx.y;
  const int rep = h / g;
  const float* base = part + ((size_t)bi * g + kvh) * n_split * rep *
                                 (hd + 2);
  for (int idx = threadIdx.x; idx < rep * hd; idx += THREADS) {
    const int r = idx / hd, d = idx % hd;
    float m = NEG;
    for (int i = 0; i < n_split; ++i)
      m = fmaxf(m, base[(i * rep + r) * (hd + 2)]);
    float l = 0.0f, o = 0.0f;
    for (int i = 0; i < n_split; ++i) {
      const float* pi = base + (i * rep + r) * (hd + 2);
      const float c = expf(pi[0] - m);
      l += pi[1] * c;
      o += pi[2 + d] * c;
    }
    store_f(out + ((size_t)bi * h + kvh * rep + r) * hd + d,
            o / fmaxf(l, 1e-30f));
  }
}

size_t smem_bytes(int hd) {
  // queries, scores, V scale / zero point, (m, l, corr) padded to 16 bytes,
  // then the V codes (or, at the end, the position groups' sums)
  const size_t codes = (size_t)TILE * (hd + SLOT_PAD);
  const size_t sums = sizeof(float) * (THREADS / hd) * MAX_REP * hd;
  return sizeof(float) * (MAX_REP * hd + MAX_REP * TILE + 2 * TILE +
                          4 * MAX_REP) + (codes > sums ? codes : sums);
}

template <int HD, typename T>
cudaError_t launch(const void* q, const Cache& C, const int* lengths, int b,
                   int h, int g, int hi_len, int S, int split_len,
                   int n_split, float scale, float* part, void* out,
                   cudaStream_t st) {
  const size_t smem = smem_bytes(HD);
  cudaError_t e = cudaFuncSetAttribute(
      cache_attention_split<HD, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cache_attention_split<HD, T><<<dim3(n_split, g, b), THREADS, smem, st>>>(
      static_cast<const T*>(q), C, lengths, h, g, hi_len, S, split_len,
      scale, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cache_attention_merge<T><<<dim3(g, b), THREADS, 0, st>>>(
      part, h, g, HD, n_split, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const Cache& C,
                        const int* lengths, int b, int h, int g, int hi_len,
                        int S, int split_len, int n_split, float scale,
                        float* part, void* out, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16, T>(q, C, lengths, b, h, g, hi_len, S, split_len, n_split, scale, part, out, st);
    case 32: return launch<32, T>(q, C, lengths, b, h, g, hi_len, S, split_len, n_split, scale, part, out, st);
    case 64: return launch<64, T>(q, C, lengths, b, h, g, hi_len, S, split_len, n_split, scale, part, out, st);
    case 112: return launch<112, T>(q, C, lengths, b, h, g, hi_len, S, split_len, n_split, scale, part, out, st);
    case 128: return launch<128, T>(q, C, lengths, b, h, g, hi_len, S, split_len, n_split, scale, part, out, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Positions per range: enough ranges for about eight blocks on each of the
// card's `sms` multiprocessors (when every row is full), whole tiles each.
// The wrapper passes the card's SM count and sizes the partials buffer from
// the result.
extern "C" int cache_attention_split_len(int b, int g, int S, int sms) {
  const int target = 8 * (sms > 0 ? sms : 1);
  const int rows = b * g;
  const int tiles = (S + TILE - 1) / TILE;
  int splits = (target + rows - 1) / rows;
  if (splits > tiles) splits = tiles;
  if (splits < 1) splits = 1;
  const int per = (tiles + splits - 1) / splits;
  return per * TILE;
}

extern "C" int cache_attention(
    const void* q, int q_bf16, int b, int h, int g, int hd, int hi_len,
    int S, const void* k_hi, const void* v_hi, const void* k_lo,
    const void* v_lo, const void* k_sc, const void* k_zp, const void* v_sc,
    const void* v_zp, const int* lengths, int split_len, int n_split,
    float scale, void* part, void* out, void* stream) {
  if (h % g || h / g > MAX_REP) return (int)cudaErrorInvalidValue;
  const Cache C{static_cast<const int8_t*>(k_hi),
                static_cast<const int8_t*>(v_hi),
                static_cast<const uint8_t*>(k_lo),
                static_cast<const uint8_t*>(v_lo),
                static_cast<const __half*>(k_sc),
                static_cast<const __half*>(k_zp),
                static_cast<const __half*>(v_sc),
                static_cast<const __half*>(v_zp)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  cudaError_t e =
      q_bf16 ? dispatch_hd<__nv_bfloat16>(hd, q, C, lengths, b, h, g, hi_len,
                                          S, split_len, n_split, scale, p,
                                          out, st)
             : dispatch_hd<float>(hd, q, C, lengths, b, h, g, hi_len, S,
                                  split_len, n_split, scale, p, out, st);
  return (int)e;
}
