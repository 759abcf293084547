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
// Bound on the H100: bytes in principle (about 0.5 byte per cached value and
// a few hundred flops per cached token), but at the serve path's sizes the
// work is a few microseconds of f32 arithmetic, so the kernel is bound by
// latency: how many dependent global-load round trips and barriers a block
// takes to walk its span.  The design cuts both.
//
// Work items.  The TPU walks the logical blocks as a sequential grid axis and
// carries (m, l, acc) in a revisited output block; here one launch runs a
// flat list of blocks, prefill blocks first: a prefill block owns 64 query
// rows (row = token * rep + head of the kv head's group) of one span and one
// kv head and walks positions [0, min(length, last q_pos + 1)); a decode
// block owns all rep query heads of one kv head of a decode span and one
// range of it.  The wrapper sizes the list by span type
// (kernels/paged_attention.py: launch_plan): a mixed step walks its decode
// spans whole; an all-decode step gives each kv head n_split block slots a
// span, one wave of the card.  The host does not know the spans' lengths
// (they live on the card), so every decode block works out from them which
// span and range its slot takes (decode_slot: a span is split only from 8
// tiles, into balanced ranges of at least 2, the spare slots shared in
// proportion to the spans' tiles; measured, tools/probe.py k4 --sweep);
// unused slots return at once.  A span of one range writes its output; the others
// write (m, l, acc) partials, which a second launch merges in range order,
// so the result does not depend on timing.
//
// KV tiles.  A block walks its positions in tiles of 32 (8 pages at page
// size 4): the tile's K and V code rows are gathered through the block table
// with cp.async (16-byte chunks, or 8 and 4 where a row is not whole
// 16-byte chunks: 72 bytes hi and 36 lo at head_dim 72; each token's four
// f16 scale / zero-point values as the 4-byte pair that holds them), two
// stages deep, so the next tile's gather is in flight while this one is
// computed.  One pass then
// dequantizes the tile to f32 in shared memory, each thread a quarter of one
// K or V row with its scale and zero point read once, codes read as words
// (hi) or half-words (lo: both nibbles of a byte from one load), the chunk
// a thread takes rotating with the row so a warp's reads and writes hit
// distinct banks.  Four barriers a tile, against two a page before.  The
// queries come in 16-byte loads, all issued before the first is used.
//
// Prefill math: every thread holds a 2 x 4 (rows x keys) score tile, so each
// K value read from shared memory serves two query rows and each query value
// four keys; p . V gives every thread a 4 x 8 (rows x features) accumulator
// tile.  Decode math: a decode span has only rep rows, so its keys are spread
// over the block: 8 threads a key, each a slice of the features for every
// query head, joined by shuffles; a warp a head for the softmax; then a
// thread a feature and a group of keys accumulates p . v, the groups joined
// in group order.  All arithmetic is f32 FMAs, as the reference computes it;
// the tensor cores would buy nothing at this size and would change numerics.
// Measured (tools/probe.py k4), the prefill scores are the largest part of
// a mixed step's time.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 32;       // KV positions per tile
constexpr int PF_ROWS = 64;    // query rows of a prefill block
constexpr int MAX_REP = 8;     // query heads per kv head
constexpr int SPLIT_FROM = 8;  // tiles from which a decode span is split
constexpr int MIN_RANGE = 2;   // tiles a range of a split span holds at least
constexpr int SPAN_CHUNK = 8;  // decode spans a lane of a planning warp holds
constexpr int MAX_SPLIT_SPANS = 32 * SPAN_CHUNK;
constexpr float NEG = -1e30f;

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of queries (4 f32 or 8 bf16, the last argument says which) times
// `scale` into f32 at `dst`.
__device__ __forceinline__ void unpack_scaled(uint4 u, float scale,
                                              float* dst, const float*) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(__uint_as_float(u.x) * scale, __uint_as_float(u.y) * scale,
                     __uint_as_float(u.z) * scale, __uint_as_float(u.w) * scale);
}
__device__ __forceinline__ void unpack_scaled(uint4 u, float scale,
                                              float* dst,
                                              const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    d[i] = make_float4(
        __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[2 * i] & 0xFFFFu))) * scale,
        __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[2 * i] >> 16))) * scale,
        __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[2 * i + 1] & 0xFFFFu))) * scale,
        __bfloat162float(__ushort_as_bfloat16((unsigned short)(w[2 * i + 1] >> 16))) * scale);
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Pools {
  const int8_t* k_hi; const int8_t* v_hi;
  const __half* k_hi_s; const __half* k_hi_z;
  const __half* v_hi_s; const __half* v_hi_z;
  const uint8_t* k_lo; const uint8_t* v_lo;
  const __half* k_lo_s; const __half* k_lo_z;
  const __half* v_lo_s; const __half* v_lo_z;
};

struct Args {
  const void* q_pf; const void* q_dec;
  Pools P;
  const int* hi_table; const int* lo_table;
  const int* lengths; const int* q_starts;
  int n_pf, C, h, g, bs, nh, nl;
  int S, row_tiles, n_split;   // decode spans; block slots a decode span
  float scale;
  void* out_pf; void* out_dec;
  float* part;   // (g, S * n_split, rep, HD + 2): m, l, unnormalised sum
};

// Shared memory (bytes from the start): two raw stages, then the f32 K, V
// and query tiles (row stride HD + 4 words), the score tile and the per-row
// softmax state.  A raw stage holds TILE K rows and TILE V rows of HD bytes
// (a lo row fills half of its slot), 4 words of f16 pairs a token and
// which half of each pair is the token's.
template <int HD>
struct Layout {
  static constexpr int LD = HD + 4;
  static constexpr int RAW = 2 * TILE * HD + 20 * TILE;
  static constexpr int KS = 2 * RAW;
  static constexpr int VS = KS + 4 * TILE * LD;
  static constexpr int QS = VS + 4 * TILE * LD;
  static constexpr int PS = QS + 4 * PF_ROWS * LD;
  static constexpr int STAT = PS + 4 * PF_ROWS * (TILE + 1);
  static constexpr int BYTES = STAT + 4 * 4 * PF_ROWS;
};

// Gather the tile of positions [t0, min(t0 + TILE, t1)) of (span, kvh) into a
// raw stage: thread tid copies for token tid / 8.
template <int HD>
__device__ __forceinline__ void issue_tile(const Args& a, int span, int kvh,
                                           int t0, int t1, uint8_t* raw) {
  const int j = threadIdx.x >> 3, sub = threadIdx.x & 7;
  const int pos = t0 + j;
  if (pos >= t1) return;
  const int num_hi = a.nh * a.bs;
  const bool hi = pos < num_hi;
  const int lp = hi ? pos : pos - num_hi;
  const int page = hi ? a.hi_table[span * a.nh + lp / a.bs]
                      : a.lo_table[span * a.nl + lp / a.bs];
  const size_t tok = ((size_t)page * a.bs + lp % a.bs) * a.g + kvh;
  uint8_t* kdst = raw + j * HD;
  uint8_t* vdst = raw + TILE * HD + j * HD;
  if (hi) {
    // a hi row of HD bytes in 16-byte chunks, or 8 at head_dim 72
    constexpr int CH = HD % 16 == 0 ? 16 : 8;
    constexpr int N = HD / CH;
    const int8_t* ks = a.P.k_hi + tok * HD;
    const int8_t* vs = a.P.v_hi + tok * HD;
    for (int c = sub; c < 2 * N; c += 8) {
      if (c < N) cp_async(kdst + CH * c, ks + CH * c, CH);
      else cp_async(vdst + CH * (c - N), vs + CH * (c - N), CH);
    }
  } else {
    // a lo row of HD / 2 bytes in the largest chunks that divide it (and so
    // keep every row's chunks aligned): 16 bytes, 8 at head_dim 16 and 112,
    // 4 at 72
    constexpr int RB = HD / 2;
    constexpr int CH = RB % 16 == 0 ? 16 : RB % 8 == 0 ? 8 : 4;
    constexpr int N = RB / CH;
    static_assert(RB % 4 == 0, "head_dim is a multiple of 8");
    const uint8_t* ks = a.P.k_lo + tok * RB;
    const uint8_t* vs = a.P.v_lo + tok * RB;
    for (int c = sub; c < 2 * N; c += 8) {
      if (c < N) cp_async(kdst + CH * c, ks + CH * c, CH);
      else cp_async(vdst + CH * (c - N), vs + CH * (c - N), CH);
    }
  }
  if (sub < 4) {
    const __half* src =
        sub == 0 ? (hi ? a.P.k_hi_s : a.P.k_lo_s)
        : sub == 1 ? (hi ? a.P.k_hi_z : a.P.k_lo_z)
        : sub == 2 ? (hi ? a.P.v_hi_s : a.P.v_lo_s)
                   : (hi ? a.P.v_hi_z : a.P.v_lo_z);
    uint32_t* pdst = reinterpret_cast<uint32_t*>(raw + 2 * TILE * HD) + 4 * j;
    // the 4-byte pair holding this token's value (a page holds an even
    // number of (token, head) values, so the pair never leaves the pool)
    cp_async(pdst + sub, src + (tok & ~(size_t)1), 4);
    if (sub == 0)
      reinterpret_cast<int*>(raw + 2 * TILE * HD + 16 * TILE)[j] =
          (int)(tok & 1);
  }
}

// Dequantize a raw stage into the f32 tiles: thread tid takes a quarter of
// K (even tid / 4) or V (odd) row tid / 8, a 16-byte chunk of every four;
// which chunk of the four a step takes rotates with the row, so a warp's
// eight rows read and write distinct banks.  A row of HD / 4 chunks that is
// not whole groups of four (head_dim 72: 18) ends with its first R parts
// taking one chunk more.  Rows past n_valid are zeros.
template <int HD>
__device__ __forceinline__ void dequant_tile(const uint8_t* raw, int t0,
                                             int n_valid, int num_hi,
                                             float* Ks, float* Vs) {
  constexpr int LD = HD + 4;
  constexpr int G = HD / 16, R = HD / 4 % 4;   // groups of 4 chunks; rest
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int j = row >> 1;
  const bool isv = row & 1;
  float4* dst = reinterpret_cast<float4*>((isv ? Vs : Ks) + j * LD);
  if (j >= n_valid) {
#pragma unroll
    for (int i = 0; i < G; ++i)
      dst[4 * ((i + row) % G) + part] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (R && part < R) dst[4 * G + part] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const uint32_t* pw = reinterpret_cast<const uint32_t*>(raw + 2 * TILE * HD)
                       + 4 * j + (isv ? 2 : 0);
  const int sh = 16 * reinterpret_cast<const int*>(raw + 2 * TILE * HD +
                                                   16 * TILE)[j];
  const float sc = __half2float(__ushort_as_half((unsigned short)(pw[0] >> sh)));
  const float zp = __half2float(__ushort_as_half((unsigned short)(pw[1] >> sh)));
  const uint8_t* codes = raw + (isv ? TILE * HD : 0) + j * HD;
  const bool hi = t0 + j < num_hi;
  // features 4c .. 4c + 3
  auto chunk = [&](int c) {
    if (hi) {
      const uint32_t u = reinterpret_cast<const uint32_t*>(codes)[c];
      dst[c] = make_float4(((float)(int8_t)(u & 0xFFu) - zp) * sc,
                           ((float)(int8_t)((u >> 8) & 0xFFu) - zp) * sc,
                           ((float)(int8_t)((u >> 16) & 0xFFu) - zp) * sc,
                           ((float)(int8_t)(u >> 24) - zp) * sc);
    } else {
      // bytes 2c, 2c + 1; byte b holds feature 2b (high nibble) and 2b + 1
      const unsigned u = reinterpret_cast<const uint16_t*>(codes)[c];
      const unsigned b0 = u & 0xFFu, b1 = u >> 8;
      dst[c] = make_float4(((float)(b0 >> 4) - zp) * sc,
                           ((float)(b0 & 0xFu) - zp) * sc,
                           ((float)(b1 >> 4) - zp) * sc,
                           ((float)(b1 & 0xFu) - zp) * sc);
    }
  };
#pragma unroll
  for (int i = 0; i < G; ++i) chunk(4 * ((i + row) % G) + part);
  if (R && part < R) chunk(4 * G + part);
}

// Walk positions [kv0, kv1) tile by tile: gather (two stages), dequantize,
// then `compute(t0, n_valid)` on the f32 tiles.
template <int HD, typename F>
__device__ __forceinline__ void walk(const Args& a, int span, int kvh,
                                     int kv0, int kv1, unsigned char* smem,
                                     F&& compute) {
  using L = Layout<HD>;
  float* Ks = reinterpret_cast<float*>(smem + L::KS);
  float* Vs = reinterpret_cast<float*>(smem + L::VS);
  const int num_hi = a.nh * a.bs;
  const int ntiles = kv1 > kv0 ? (kv1 - kv0 + TILE - 1) / TILE : 0;
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = kv0 + t * TILE;
    if (t + 1 < ntiles) {
      issue_tile<HD>(a, span, kvh, t0 + TILE, kv1,
                     smem + ((t + 1) & 1) * L::RAW);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();   // this stage landed; the previous tile's math is done
    const int n_valid = min(TILE, kv1 - t0);
    dequant_tile<HD>(smem + (t & 1) * L::RAW, t0, n_valid, num_hi, Ks, Vs);
    __syncthreads();
    compute(t0, n_valid);
  }
}

// ------------------------------------------------------------ prefill ----

template <int HD, typename T>
__device__ void prefill_block(const Args& a, int span, int kvh, int rt,
                              unsigned char* smem) {
  using L = Layout<HD>;
  constexpr int LD = HD + 4, NV = HD / 4, DV = (NV + 15) / 16;
  float* Ks = reinterpret_cast<float*>(smem + L::KS);
  float* Vs = reinterpret_cast<float*>(smem + L::VS);
  float* Qs = reinterpret_cast<float*>(smem + L::QS);
  float* Ps = reinterpret_cast<float*>(smem + L::PS);
  float* m_s = reinterpret_cast<float*>(smem + L::STAT);
  float* l_s = m_s + PF_ROWS;
  float* c_s = l_s + PF_ROWS;
  int* qpos_s = reinterpret_cast<int*>(c_s + PF_ROWS);
  const int tid = threadIdx.x;
  const int rep = a.h / a.g, nrows = a.C * rep, row0 = rt * PF_ROWS;
  const int length = a.lengths[span], qstart = a.q_starts[span];
  const int last = min(row0 + PF_ROWS, nrows) - 1;
  const int kv1 = min(length, qstart + last / rep + 1);
  if (kv1 > 0) {
    issue_tile<HD>(a, span, kvh, 0, kv1, smem);
    cp_commit();
  }
  {  // the rows' queries, pre-scaled: 16-byte loads, all issued at once
    constexpr int E = 16 / sizeof(T), CPR = HD / E;   // elements, chunks a row
    constexpr int STEPS = (PF_ROWS * CPR + THREADS - 1) / THREADS;
    const T* q = static_cast<const T*>(a.q_pf);
    uint4 raw_q[STEPS];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int i = tid + k * THREADS, r = i / CPR, R = row0 + r;
      raw_q[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < PF_ROWS * CPR && R < nrows)
        raw_q[k] = *reinterpret_cast<const uint4*>(
            q + (((size_t)span * a.C + R / rep) * a.h + kvh * rep + R % rep) *
                    HD + (i % CPR) * E);
    }
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int i = tid + k * THREADS;
      if (i < PF_ROWS * CPR)
        unpack_scaled(raw_q[k], a.scale, Qs + (i / CPR) * LD + (i % CPR) * E,
                      q);
    }
  }
  if (tid < PF_ROWS) {
    const int R = row0 + tid;
    qpos_s[tid] = R < nrows ? qstart + R / rep : -1;
    m_s[tid] = NEG;
    l_s[tid] = 0.0f;
  }
  // (the walk's first barrier publishes Qs and the row state)

  const int rg = tid >> 3, kg = tid & 7;    // scores: rows 2rg.., keys kg + 8i
  const int pr = tid >> 4, dg = tid & 15;   // p . V: rows 4pr.., float4 dg + 16e
  float4 acc[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < DV; ++e) acc[i][e] = make_float4(0.f, 0.f, 0.f, 0.f);

  walk<HD>(a, span, kvh, 0, kv1, smem, [&](int t0, int n_valid) {
    const float4* Q4 = reinterpret_cast<const float4*>(Qs);
    const float4* K4 = reinterpret_cast<const float4*>(Ks);
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) s[i][k] = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < NV; ++d4) {
      const float4 qa = Q4[(2 * rg) * (LD / 4) + d4];
      const float4 qb = Q4[(2 * rg + 1) * (LD / 4) + d4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 kv = K4[(kg + 8 * k) * (LD / 4) + d4];
        s[0][k] = fmaf(qa.w, kv.w, fmaf(qa.z, kv.z,
                  fmaf(qa.y, kv.y, fmaf(qa.x, kv.x, s[0][k]))));
        s[1][k] = fmaf(qb.w, kv.w, fmaf(qb.z, kv.z,
                  fmaf(qb.y, kv.y, fmaf(qb.x, kv.x, s[1][k]))));
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * rg + i, qp = qpos_s[r];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int key = kg + 8 * k;
        const bool ok = key < n_valid && t0 + key <= qp;
        Ps[r * (TILE + 1) + key] = ok ? s[i][k] : NEG;
      }
    }
    __syncthreads();
    {  // online softmax: 4 threads a row, 8 keys each
      const int r = tid >> 2, part = tid & 3;
      float* pr_row = Ps + r * (TILE + 1) + 8 * part;
      float mx = NEG;
#pragma unroll
      for (int i = 0; i < 8; ++i) mx = fmaxf(mx, pr_row[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = pr_row[i];
        const float p = v == NEG ? 0.0f : expf(v - m_new);
        pr_row[i] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float c = expf(m_old - m_new);
        c_s[r] = c;
        l_s[r] = l_s[r] * c + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    const float4* V4 = reinterpret_cast<const float4*>(Vs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = c_s[4 * pr + i];
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        acc[i][e].x *= c; acc[i][e].y *= c; acc[i][e].z *= c; acc[i][e].w *= c;
      }
    }
    for (int j = 0; j < n_valid; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * pr + i) * (TILE + 1) + j];
#pragma unroll
      for (int e = 0; e < DV; ++e) {
        if (dg + 16 * e >= NV) break;
        const float4 v = V4[j * (LD / 4) + dg + 16 * e];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][e].x += p[i] * v.x; acc[i][e].y += p[i] * v.y;
          acc[i][e].z += p[i] * v.z; acc[i][e].w += p[i] * v.w;
        }
      }
    }
  });
  if (kv1 <= 0) __syncthreads();   // the row state was never published
  T* out = static_cast<T*>(a.out_pf);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * pr + i, R = row0 + r;
    if (R >= nrows) continue;
    const float inv = fmaxf(l_s[r], 1e-30f);
    T* o = out + (((size_t)span * a.C + R / rep) * a.h + kvh * rep + R % rep)
                     * HD;
#pragma unroll
    for (int e = 0; e < DV; ++e) {
      const int f = 4 * (dg + 16 * e);
      if (f >= HD) break;
      store_f(o + f, acc[i][e].x / inv);
      store_f(o + f + 1, acc[i][e].y / inv);
      store_f(o + f + 2, acc[i][e].z / inv);
      store_f(o + f + 3, acc[i][e].w / inv);
    }
  }
}

// ------------------------------------------------------------- decode ----

// Ranges of a span of `tiles` tiles in a step of `total` tiles over
// `spare` = S * (n_split - 1) slots beyond one a span.
__device__ __forceinline__ int range_count(int tiles, int total, int spare) {
  if (tiles < SPLIT_FROM) return 1;
  return min(1 + tiles * spare / total, tiles / MIN_RANGE);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The split of a step's decode spans over the block slots of a kv head
// (decode_ranges in kernels/paged_attention.py is the same plan in Python),
// worked out by the calling warp from the S decode lengths: every span has
// one slot, and the other S * (n_split - 1) go to the spans of at least
// SPLIT_FROM tiles in proportion to their tiles (a range at least MIN_RANGE
// tiles), a span's ranges in the slots after the spans before it.  Lane l
// holds spans [8 l, 8 l + 8).  Returns {span, its first slot, its ranges k,
// its tiles} for the span that owns `slot` (slot >= 0) or for span `span`
// (slot < 0); span -1 for an unused slot.  One warp of a block calls it (out
// of line: the callers' register budget stays the walk's) and shares the
// result; 32-bit products, as the launch has at most 4096 slots.
__device__ __noinline__ int4 decode_slot(const int* lengths, int S,
                                         int n_split, int slot, int span) {
  const int lane = threadIdx.x & 31;
  const int c0 = lane * SPAN_CHUNK;
  int t[SPAN_CHUNK];
  int total = 0;
#pragma unroll
  for (int j = 0; j < SPAN_CHUNK; ++j) {
    t[j] = c0 + j < S ? (lengths[c0 + j] + TILE - 1) / TILE : 0;
    total += t[j];
  }
  total = max(warp_sum(total), 1);
  const int spare = S * (n_split - 1);
  int mine = 0;
#pragma unroll
  for (int j = 0; j < SPAN_CHUNK; ++j) {
    t[j] = c0 + j < S ? range_count(t[j], total, spare) : 0;  // now ranges
    mine += t[j];
  }
  int first = mine;            // inclusive scan over the lanes, then less mine
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, first, o);
    if (lane >= o) first += v;
  }
  first -= mine;
  int4 res = make_int4(-1, 0, 0, 0);
#pragma unroll
  for (int j = 0; j < SPAN_CHUNK; ++j) {
    if (c0 + j >= S) break;
    if (slot >= 0 ? (slot >= first && slot < first + t[j]) : c0 + j == span)
      res = make_int4(c0 + j, first, t[j],
                      (lengths[c0 + j] + TILE - 1) / TILE);
    first += t[j];
  }
  const unsigned owner = __ballot_sync(0xffffffffu, res.x >= 0);
  if (!owner) return make_int4(-1, 0, 0, 0);
  const int src = __ffs(owner) - 1;
  return make_int4(__shfl_sync(0xffffffffu, res.x, src),
                   __shfl_sync(0xffffffffu, res.y, src),
                   __shfl_sync(0xffffffffu, res.z, src),
                   __shfl_sync(0xffffffffu, res.w, src));
}

template <int HD, typename T>
__device__ void decode_block(const Args& a, int slot, int kvh,
                             unsigned char* smem) {
  using L = Layout<HD>;
  // p . v: a thread a feature of one of NG key groups (at most 8, so the
  // groups' sums fit the buffer they are joined in)
  constexpr int LD = HD + 4, NV = HD / 4;
  constexpr int NG = THREADS / HD < 8 ? THREADS / HD : 8;
  float* Ks = reinterpret_cast<float*>(smem + L::KS);
  float* Vs = reinterpret_cast<float*>(smem + L::VS);
  float* Qs = reinterpret_cast<float*>(smem + L::QS);
  float* Ps = reinterpret_cast<float*>(smem + L::PS);
  float* m_s = reinterpret_cast<float*>(smem + L::STAT);
  float* l_s = m_s + PF_ROWS;
  float* c_s = l_s + PF_ROWS;
  const int tid = threadIdx.x;
  const int rep = a.h / a.g;
  // which span and range this slot takes: unsplit, span `slot` whole; split,
  // worked out from the lengths
  int dspan = slot, n_rng = 1, rng = 0, tiles = 0;
  if (a.n_split > 1) {
    // warp 0 plans; the score tile is free until the walk's first barriers
    int4* plan_s = reinterpret_cast<int4*>(smem + L::PS);
    if (tid < 32) {
      const int4 sl = decode_slot(a.lengths + a.n_pf, a.S, a.n_split, slot,
                                  0);
      if (tid == 0) *plan_s = sl;
    }
    __syncthreads();
    const int4 sl = *plan_s;
    if (sl.x < 0) return;        // an unused slot: the whole block leaves
    dspan = sl.x;
    rng = slot - sl.y;
    n_rng = sl.z;
    tiles = sl.w;
  }
  const int span = a.n_pf + dspan;
  const int length = a.lengths[span];
  const int kv0 = n_rng == 1 ? 0 : tiles * rng / n_rng * TILE;
  const int kv1 = n_rng == 1 ? length
                             : min(tiles * (rng + 1) / n_rng * TILE, length);
  if (kv1 > kv0) {
    issue_tile<HD>(a, span, kvh, kv0, kv1, smem);
    cp_commit();
  }
  {  // the rep query heads, pre-scaled, in 16-byte loads
    constexpr int E = 16 / sizeof(T), CPR = HD / E;
    const T* q = static_cast<const T*>(a.q_dec) +
                 ((size_t)dspan * a.h + kvh * rep) * HD;
    for (int i = tid; i < rep * CPR; i += THREADS)
      unpack_scaled(*reinterpret_cast<const uint4*>(q + i * E), a.scale,
                    Qs + (i / CPR) * LD + (i % CPR) * E, q);
  }
  if (tid < MAX_REP) {
    m_s[tid] = NEG;
    l_s[tid] = 0.0f;
  }

  const int key = tid >> 3, part = tid & 7;  // scores: 8 threads a key
  const int d = tid % HD, grp = tid / HD;    // p . v: a feature, a key group
  float acc[MAX_REP];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) acc[r] = 0.0f;

  walk<HD>(a, span, kvh, kv0, kv1, smem, [&](int t0, int n_valid) {
    const float4* Q4 = reinterpret_cast<const float4*>(Qs);
    const float4* K4 = reinterpret_cast<const float4*>(Ks);
    float s[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) s[r] = 0.0f;
#pragma unroll
    for (int i = part; i < NV; i += 8) {
      const float4 kv = K4[key * (LD / 4) + i];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        const float4 qv = Q4[r * (LD / 4) + i];
        s[r] = fmaf(qv.w, kv.w, fmaf(qv.z, kv.z,
               fmaf(qv.y, kv.y, fmaf(qv.x, kv.x, s[r]))));
      }
    }
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 1);
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 2);
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], 4);
    }
    if (part == 0)
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) Ps[r * (TILE + 1) + key] = key < n_valid ? s[r] : NEG;
    __syncthreads();
    {  // online softmax: a warp a query head, a lane a key
      const int r = tid >> 5, lane = tid & 31;
      if (r < rep) {
        const float v = Ps[r * (TILE + 1) + lane];
        float mx = v;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[r], m_new = fmaxf(m_old, mx);
        const float p = v == NEG ? 0.0f : expf(v - m_new);
        Ps[r * (TILE + 1) + lane] = p;
        float sum = p;
#pragma unroll
        for (int o = 16; o; o >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) {
          const float c = expf(m_old - m_new);
          c_s[r] = c;
          l_s[r] = l_s[r] * c + sum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < rep) acc[r] *= c_s[r];
    for (int j = grp; j < n_valid && grp < NG; j += NG) {
      const float v = Vs[j * LD + d];
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) acc[r] += Ps[r * (TILE + 1) + j] * v;
    }
  });
  // join the key groups in group order; their buffer overlays the K, V and
  // query tiles, free once every thread is past the last tile
  __syncthreads();
  float* red = Ks;
  if constexpr (NG > 1) {
    if (grp < NG)
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r)
        if (r < rep) red[(grp * MAX_REP + r) * HD + d] = acc[r];
    __syncthreads();
    if (grp == 0)
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r >= rep) break;
        float s = 0.0f;
        for (int k = 0; k < NG; ++k) s += red[(k * MAX_REP + r) * HD + d];
        acc[r] = s;
      }
  }
  if (grp != 0) return;
  if (n_rng == 1) {
    T* o = static_cast<T*>(a.out_dec) + ((size_t)dspan * a.h + kvh * rep) * HD;
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
      if (r < rep) store_f(o + r * HD + d, acc[r] / fmaxf(l_s[r], 1e-30f));
  } else {
    float* o = a.part + ((size_t)kvh * a.S * a.n_split + slot) * rep *
                            (HD + 2);
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r >= rep) break;
      o[r * (HD + 2) + 2 + d] = acc[r];
      if (d == 0) {
        o[r * (HD + 2)] = m_s[r];
        o[r * (HD + 2) + 1] = l_s[r];
      }
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS, 2)
paged_attention_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pf_blocks = a.n_pf * a.g * a.row_tiles;
  const int b = blockIdx.x;
  if (b < pf_blocks) {
    prefill_block<HD, T>(a, b / (a.row_tiles * a.g),
                         (b / a.row_tiles) % a.g, b % a.row_tiles, smem);
  } else {
    const int d = b - pf_blocks;   // slot-major, a kv head a block
    decode_block<HD, T>(a, d / a.g, d % a.g, smem);
  }
}

// one block per (kv head, decode span): the ranges' partials in range order
// (a span of one range wrote its output itself)
template <typename T>
__global__ void __launch_bounds__(128)
paged_attention_merge(const float* part, const int* dec_lengths, int S,
                      int h, int g, int hd, int n_split, T* out) {
  const int kvh = blockIdx.x, ds = blockIdx.y;
  __shared__ int4 plan_s;
  if (threadIdx.x < 32) {
    const int4 sl = decode_slot(dec_lengths, S, n_split, -1, ds);
    if (threadIdx.x == 0) plan_s = sl;
  }
  __syncthreads();
  const int4 sl = plan_s;
  const int k = sl.z;
  if (k < 2) return;
  const int rep = h / g;
  const float* base = part + ((size_t)kvh * S * n_split + sl.y) * rep *
                                 (hd + 2);
  for (int idx = threadIdx.x; idx < rep * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    float m = NEG;
    for (int i = 0; i < k; ++i)
      m = fmaxf(m, base[(i * rep + r) * (hd + 2)]);
    float l = 0.0f, o = 0.0f;
    for (int i = 0; i < k; ++i) {
      const float* pi = base + (i * rep + r) * (hd + 2);
      const float c = expf(pi[0] - m);
      l += pi[1] * c;
      o += pi[2 + d] * c;
    }
    store_f(out + ((size_t)ds * h + kvh * rep + r) * hd + d,
            o / fmaxf(l, 1e-30f));
  }
}

template <int HD, typename T>
cudaError_t launch(const Args& a, int S, cudaStream_t st) {
  constexpr int smem = Layout<HD>::BYTES;
  // the attribute is set once per instantiation and card (it belongs to
  // the card's context): bit d of `sized` for card d
  static unsigned sized = 0u;
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev); e != cudaSuccess) return e;
  if (dev >= 32 || !((sized >> dev) & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<HD, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    if (dev < 32) sized |= 1u << dev;
  }
  const int blocks = a.n_pf * a.g * a.row_tiles + S * a.g * a.n_split;
  paged_attention_kernel<HD, T><<<blocks, THREADS, smem, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1) return e;
  paged_attention_merge<T><<<dim3(a.g, S), 128, 0, st>>>(
      a.part, a.lengths + a.n_pf, S, a.h, a.g, HD, a.n_split,
      static_cast<T*>(a.out_dec));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, int S, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16, T>(a, S, st);
    case 32: return launch<32, T>(a, S, st);
    case 64: return launch<64, T>(a, S, st);
    case 72: return launch<72, T>(a, S, st);
    case 112: return launch<112, T>(a, S, st);
    case 128: return launch<128, T>(a, S, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory a block of head dim hd takes (the wrapper checks it against
// the card's limit before the first launch).
extern "C" int paged_attention_smem_bytes(int hd) {
  switch (hd) {
    case 16: return Layout<16>::BYTES;
    case 32: return Layout<32>::BYTES;
    case 64: return Layout<64>::BYTES;
    case 72: return Layout<72>::BYTES;
    case 112: return Layout<112>::BYTES;
    case 128: return Layout<128>::BYTES;
    default: return -1;
  }
}

extern "C" int paged_attention(
    const void* q_pf, const void* q_dec, int q_bf16, int n_pf, int S, int C,
    int h, int g, int hd, int bs, int nh, int nl, const void* k_hi,
    const void* v_hi, const void* k_hi_s, const void* k_hi_z,
    const void* v_hi_s, const void* v_hi_z, const void* k_lo,
    const void* v_lo, const void* k_lo_s, const void* k_lo_z,
    const void* v_lo_s, const void* v_lo_z, const int* hi_table,
    const int* lo_table, const int* lengths, const int* q_starts,
    float scale, int row_tiles, int n_split, void* part, void* out_pf,
    void* out_dec, void* stream) {
  if (h % g || h / g > MAX_REP || n_split < 1 ||
      (n_split > 1 && (S > MAX_SPLIT_SPANS || S * n_split > 4096 ||
                       part == nullptr)) ||
      (n_pf > 0 && row_tiles < 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q_pf = q_pf;
  a.q_dec = q_dec;
  a.P = Pools{static_cast<const int8_t*>(k_hi),
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
  a.hi_table = hi_table;
  a.lo_table = lo_table;
  a.lengths = lengths;
  a.q_starts = q_starts;
  a.n_pf = n_pf; a.C = C; a.h = h; a.g = g; a.bs = bs; a.nh = nh; a.nl = nl;
  a.S = S;
  a.row_tiles = n_pf > 0 ? row_tiles : 0;
  a.n_split = n_split;
  a.scale = scale;
  a.out_pf = out_pf;
  a.out_dec = out_dec;
  a.part = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(q_bf16 ? dispatch_hd<__nv_bfloat16>(hd, a, S, st)
                      : dispatch_hd<float>(hd, a, S, st));
}
