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
// online-softmax state of a (b, g) row across its blocks.  Here the sequence
// is split as well (flash-decoding): launch 1 gives each block of 4 warps one
// contiguous range of tiles of one (b, g) row and all `rep` query heads of
// that kv head; launch 2 merges the ranges' partials of each (b, g, head) in
// range order, so no float atomics are used and the output is the same on
// every run.  Launch 2 is a programmatic dependent launch: its blocks are
// scheduled while launch 1 runs and wait on it in the kernel, so its
// launch latency is hidden.  Tiles are 128 lo positions or 64 hi ones (8 KB of codes each
// way); a ring of 3 stages of cp.async copies keeps two tiles in flight
// while the block works on a third, with the tile's scales and zero points
// prefetched in registers.  A warp takes 32 positions of a tile, and the
// arithmetic runs on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// out) on the raw codes, which are exact in bf16:
//   scores  s_j = sk_j sum_d (c_jd - zk_j) q_d / sqrt(hd), as
//           (heads x features) x (features x positions), the query heads
//           padding the 16 rows;
//   values  o_d = sum_j (p_j sv_j) (c_jd - zv_j), as
//           (features x positions) x (positions x heads), the score
//           accumulators becoming the second operand in registers.
// A code minus its zero point is a small integer, exact in bf16 (the zero
// points are whole numbers; one outside [-128, 127] is clamped into it and
// the rest, times sum_d q_d or sum_j p_j sv_j, added in f32), so no sum
// cancels.  Nibbles become bf16 by a mask into the mantissa of 128.0 and one
// exact bf16 subtraction of 128 + z, two values an instruction.  What is not
// exact in bf16 is split into bf16 pieces whose products the tensor cores
// keep exact: the weights p sv into three, f32 queries into three (bf16
// queries are one piece), so every product is the f32 one.  Features are permuted within a
// lane's words (the same way for codes and queries) so that a lane reads
// whole words: 16 bytes of a lo row for the scores, 8 bytes of each of 4
// rows for the values, from rows laid out in shared memory so that neither
// read has a bank conflict.  head_dim 112 and 72 run as 128 with the
// queries' extra features zero (the codes there are whatever the stage
// held: finite, times a zero query, and their value sums are never
// written); a head_dim-72 row is not whole 16-byte chunks (72 bytes hi, 36
// lo), so its copies take 8-byte (hi) and 4-byte (lo) chunks.  Positions at or past length[b] are never read: a
// range that starts past it writes an empty partial (m = -1e30, l = 0) and
// reads nothing, the walk stops at the tile holding the last valid
// position, and a masked position's weight is zero whatever its scale.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE_LO = 128;   // lo positions of a tile: 32 a warp
constexpr int TILE_HI = 64;    // hi positions of a tile: 16 a warp
constexpr int STAGES = 3;
constexpr int MAX_REP = 8;     // query heads per kv head: the MMAs' n = 8
constexpr float NEG = -1e30f;
constexpr uint32_t MAGIC = 0x43004300u;   // bf16x2 (128.0, 128.0)

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct Cache {
  const int8_t* k_hi; const int8_t* v_hi;
  const uint8_t* k_lo; const uint8_t* v_lo;
  const __half* k_sc; const __half* k_zp;
  const __half* v_sc; const __half* v_zp;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 x) {
  return static_cast<uint32_t>(*reinterpret_cast<uint16_t*>(&x));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return bits(__float2bfloat16_rn(lo)) | (bits(__float2bfloat16_rn(hi)) << 16);
}
// the zero point a code's bf16 operand takes off (whole, in [-128, 127])
__device__ __forceinline__ float zcut(float z) {
  return fminf(fmaxf(rintf(z), -128.f), 127.f);
}
// bf16x2 (128 + za, 128 + zb): exact for cut zero points
__device__ __forceinline__ uint32_t zpair(float za, float zb) {
  return pack(128.f + za, 128.f + zb);
}
// the nibbles at bits [sh, sh + 4) and [sh + 16, sh + 20) of w, as bf16x2
// (128 + c) - (128 + z): exact
__device__ __forceinline__ uint32_t nibbles(uint32_t w, int sh, uint32_t zp) {
  uint32_t x = ((w >> sh) & 0x000F000Fu) | MAGIC;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&x),
                                   *reinterpret_cast<__nv_bfloat162*>(&zp));
  return *reinterpret_cast<const uint32_t*>(&r);
}
// an int8 code as a bf16 value (exact)
__device__ __forceinline__ float i8(uint32_t byte) {
  return (float)(int8_t)(uint8_t)byte;
}

// x = hi + mid + lo in bf16 pieces (f32 exactly, but for underflow)
__device__ __forceinline__ void split3(float x, float (&p)[3]) {
  p[0] = __bfloat162float(__float2bfloat16_rn(x));
  const float r1 = x - p[0];
  p[1] = __bfloat162float(__float2bfloat16_rn(r1));
  p[2] = r1 - p[1];
}

// Layout of a head dim.  HDP: features the MMAs run over (112 and 72
// padded to 128); KS: k-steps of the scores and m-tiles of the values (both
// HDP/16).
template <int HD>
struct Dims {
  static constexpr int HDP = (HD == 112 || HD == 72) ? 128 : HD;
  static constexpr int KS = HDP / 16;
  static constexpr int LO_ROW = HDP / 2;    // shared-memory row, lo tile
  static constexpr int HI_ROW = HDP;        // hi tile
  static constexpr int CODE_BYTES = TILE_LO * LO_ROW;   // = TILE_HI * HI_ROW
  static constexpr int STAGE = 2 * CODE_BYTES + TILE_LO * 16;
};

// Byte offset in a lo tile of the 8-byte chunk c of row r.  At head_dim 128
// (rows of 64 bytes) rows are permuted and chunks XORed so that the scores'
// 16-byte reads (rows r and r + 4 by a quarter warp) and the values' 8-byte
// reads (rows r..r+3 by a half warp) fall in distinct banks.
template <int HDP>
__device__ __forceinline__ int lo_off(int r, int c) {
  if constexpr (HDP == 128)
    return 64 * (r ^ ((r >> 2) & 1)) + 8 * (c ^ (((r >> 1) & 1) << 2));
  else
    return r * (HDP / 2) + 8 * c;
}

// Feature of the k-th query of lane group tig in k-step kk, slot j (0, 1:
// b0's low and high half; 2, 3: b1's): the lane's codes come as words of 4
// bytes (at head_dim 16, its 2 bytes spread to bytes 0 and 2), and k-step
// kk takes word kk / 2: its bytes kk % 2 and kk % 2 + 2, high nibbles (even
// features) into b0, low nibbles into b1.
template <int HDP>
__device__ __forceinline__ int k_feature(int tig, int kk, int j) {
  const int beta = HDP == 16 ? (j & 1)
                             : 4 * (kk >> 1) + (kk & 1) + 2 * (j & 1);
  return tig * (HDP / 4) + 2 * beta + (j >> 1);
}

// The scores of one group of 16 positions (tile rows p0 + ...): n-tile nt's
// column c is position p0 + 8 nt + c / 2 + 4 (c % 2), so that lane (gid,
// tig)'s accumulators d[nt][0..1] hold positions p0 + 8 nt + tig (+ 4): the
// rows of the value MMAs' second operand.
template <int HD, int NQ, bool HI>
__device__ __forceinline__ void score_group(const uint8_t* kc,
                                            const float4* prm, int p0,
                                            const uint32_t (&qa)[NQ][Dims<HD>::KS][2],
                                            int gid, int tig,
                                            float (&d)[2][4]) {
  using D = Dims<HD>;
  constexpr int HDP = D::HDP;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    d[nt][0] = d[nt][1] = d[nt][2] = d[nt][3] = 0.f;
    const int r = p0 + 8 * nt + (gid >> 1) + 4 * (gid & 1);
    const float z = zcut(prm[r].y);
    if constexpr (HI) {
      const uint8_t* row = kc + r * D::HI_ROW;
#pragma unroll
      for (int kk = 0; kk < D::KS; ++kk) {
        // slots 0, 2 and 1, 3 are neighbouring bytes
        const int f0 = k_feature<HDP>(tig, kk, 0);
        const int f1 = k_feature<HDP>(tig, kk, 1);
        const uint32_t u0 = *reinterpret_cast<const uint16_t*>(row + f0);
        const uint32_t u1 = *reinterpret_cast<const uint16_t*>(row + f1);
        const uint32_t b0 = pack(i8(u0 & 0xFF) - z, i8(u1 & 0xFF) - z);
        const uint32_t b1 = pack(i8(u0 >> 8) - z, i8(u1 >> 8) - z);
#pragma unroll
        for (int pc = 0; pc < NQ; ++pc)
          mma(d[nt], qa[pc][kk][0], 0u, qa[pc][kk][1], 0u, b0, b1);
      }
    } else {
      constexpr int NW = HDP >= 32 ? HDP / 32 : 1;
      uint32_t w[NW];
      const uint8_t* base = kc + lo_off<HDP>(r, 0);   // unswizzled below 128
      if constexpr (HDP == 128) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            kc + lo_off<HDP>(r, 2 * tig));
        w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
      } else if constexpr (HDP == 64) {
        const uint2 u = *reinterpret_cast<const uint2*>(base + 8 * tig);
        w[0] = u.x; w[1] = u.y;
      } else if constexpr (HDP == 32) {
        w[0] = *reinterpret_cast<const uint32_t*>(base + 4 * tig);
      } else {
        const uint32_t u = *reinterpret_cast<const uint16_t*>(base + 2 * tig);
        w[0] = (u & 0xFFu) | ((u & 0xFF00u) << 8);
      }
      const uint32_t zp = zpair(z, z);
#pragma unroll
      for (int kk = 0; kk < D::KS; ++kk) {
        const uint32_t x = w[kk >> 1];
        const uint32_t b0 = nibbles(x, (kk & 1) ? 12 : 4, zp);
        const uint32_t b1 = nibbles(x, (kk & 1) ? 8 : 0, zp);
#pragma unroll
        for (int pc = 0; pc < NQ; ++pc)
          mma(d[nt], qa[pc][kk][0], 0u, qa[pc][kk][1], 0u, b0, b1);
      }
    }
  }
}

// The values of one group of 16 positions: m-tile mt's row gid is feature
// 2 (KS gid + mt) (a high nibble), row gid + 8 the feature after it, so a
// lane reads KS bytes of each of its 4 positions p0 + tig + 4 i.
template <int HD, bool HI>
__device__ __forceinline__ void value_group(const uint8_t* vc, int p0,
                                            const uint32_t (&wb)[3][2],
                                            const float (&z)[2][2],
                                            int gid, int tig,
                                            float (&acc)[Dims<HD>::KS][4]) {
  using D = Dims<HD>;
  constexpr int HDP = D::HDP, KS = D::KS;
  if constexpr (HI) {
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      const int f = 2 * (KS * gid + mt);
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = *reinterpret_cast<const uint16_t*>(
            vc + (p0 + tig + 4 * i) * D::HI_ROW + f);
      const uint32_t a0 = pack(i8(u[0] & 0xFF) - z[0][0],
                               i8(u[1] & 0xFF) - z[0][1]);
      const uint32_t a1 = pack(i8(u[0] >> 8) - z[0][0],
                               i8(u[1] >> 8) - z[0][1]);
      const uint32_t a2 = pack(i8(u[2] & 0xFF) - z[1][0],
                               i8(u[3] & 0xFF) - z[1][1]);
      const uint32_t a3 = pack(i8(u[2] >> 8) - z[1][0],
                               i8(u[3] >> 8) - z[1][1]);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
        mma(acc[mt], a0, a1, a2, a3, wb[pc][0], wb[pc][1]);
    }
  } else {
    constexpr int NW = KS >= 4 ? KS / 4 : 1;
    uint32_t w[4][NW];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = p0 + tig + 4 * i;
      if constexpr (KS == 8) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            vc + lo_off<HDP>(r, gid));
        w[i][0] = u.x; w[i][1] = u.y;
      } else if constexpr (KS == 4) {
        w[i][0] = *reinterpret_cast<const uint32_t*>(
            vc + lo_off<HDP>(r, 0) + 4 * gid);
      } else if constexpr (KS == 2) {
        w[i][0] = *reinterpret_cast<const uint16_t*>(
            vc + lo_off<HDP>(r, 0) + 2 * gid);
      } else {
        w[i][0] = vc[lo_off<HDP>(r, 0) + gid];
      }
    }
    const uint32_t z01 = zpair(z[0][0], z[0][1]);
    const uint32_t z23 = zpair(z[1][0], z[1][1]);
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      // byte mt of positions (tig, tig + 4) and (tig + 8, tig + 12) into
      // bytes 0 and 2 of a word
      const uint32_t sel = (mt & 3) | ((4 + (mt & 3)) << 8);
      const uint32_t v01 = __byte_perm(w[0][mt >> 2], w[1][mt >> 2], sel);
      const uint32_t v23 = __byte_perm(w[2][mt >> 2], w[3][mt >> 2], sel);
      const uint32_t a0 = nibbles(v01, 4, z01), a1 = nibbles(v01, 0, z01);
      const uint32_t a2 = nibbles(v23, 4, z23), a3 = nibbles(v23, 0, z23);
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
        mma(acc[mt], a0, a1, a2, a3, wb[pc][0], wb[pc][1]);
    }
  }
}

template <typename T>
struct Occupancy { static constexpr int BLOCKS = 4; };
template <>
struct Occupancy<float> { static constexpr int BLOCKS = 3; };  // 3 q pieces

// part: (b, g, n_split, rep, HD + 2) f32 — m, l, then the unnormalised sum
template <int HD, typename T>
__global__ void __launch_bounds__(THREADS, Occupancy<T>::BLOCKS)
cache_attention_split(const T* q, Cache C, const int* lengths, int h, int g,
                      int hi_len, int S, int tiles_per_range, float scale,
                      float* part, int hi0, int lo0) {
  using D = Dims<HD>;
  constexpr int HDP = D::HDP, KS = D::KS;
  constexpr int NQ = std::is_same<T, float>::value ? 3 : 1;
  extern __shared__ __align__(16) uint8_t smem[];

  // the merge may launch now; it waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int kvh = blockIdx.x, split = blockIdx.y, bi = blockIdx.z;
  const int n_split = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int rep = h / g;
  const int s_lo = S - hi_len;
  const int n_hi = (hi_len + TILE_HI - 1) / TILE_HI;
  const int n_tiles = n_hi + (s_lo + TILE_LO - 1) / TILE_LO;
  const int len = lengths[bi];
  float* out = part + (((size_t)bi * g + kvh) * n_split + split) * rep *
                          (HD + 2);

  // positions are local to the buffers; hi position i is global hi0 + i,
  // lo position hi_len + i global lo0 + i (0 and hi_len for a whole cache,
  // a rank's blocks' first positions for a block of a sequence-split one,
  // past every length for a region this rank does not read), and the
  // mask is global: each region's valid local positions end at
  const int end_hi = max(0, min(hi_len, len - hi0));
  const int end_lo = hi_len + max(0, min(s_lo, len - lo0));
  auto tile_start = [&](int t) {
    return t < n_hi ? t * TILE_HI : hi_len + (t - n_hi) * TILE_LO;
  };
  auto valid_end = [&](int t) { return t < n_hi ? end_hi : end_lo; };
  // the range's tiles holding valid positions: a run (a region's valid
  // positions are a prefix of it, and the lo region's start past the hi
  // region's), after any hi tiles of a region this rank does not read
  int t0 = split * tiles_per_range;
  const int t1 = min(t0 + tiles_per_range, n_tiles);
  while (t0 < t1 && tile_start(t0) >= valid_end(t0)) ++t0;
  int n_act = 0;
  while (t0 + n_act < t1 && tile_start(t0 + n_act) < valid_end(t0 + n_act))
    ++n_act;
  if (n_act == 0) {
    for (int i = tid; i < rep * (HD + 2); i += THREADS)
      out[i] = (i % (HD + 2) == 0) ? NEG : 0.0f;
    return;
  }

  // queries: lane (gid, tig) holds head gid's features of its k-steps in
  // NQ bf16 pieces (zero past rep heads or HD features), and sum_d q_d
  uint32_t qa[NQ][KS][2];
  float qsum = 0.f;
  {
    const T* qh = q + ((size_t)bi * h + kvh * rep + gid) * HD;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float pcs[4][3];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = k_feature<HDP>(tig, kk, j);
        const float x = (gid < rep && f < HD) ? load_f(qh + f) : 0.f;
        qsum += x;
        split3(x, pcs[j]);
      }
#pragma unroll
      for (int pc = 0; pc < NQ; ++pc) {
        qa[pc][kk][0] = pack(pcs[0][pc], pcs[1][pc]);
        qa[pc][kk][1] = pack(pcs[2][pc], pcs[3][pc]);
      }
    }
    qsum += __shfl_xor_sync(0xffffffffu, qsum, 1);
    qsum += __shfl_xor_sync(0xffffffffu, qsum, 2);
  }

  // copies of tile t into stage st: codes by cp.async, scales and zero
  // points read into registers (stored after the current tile's work)
  auto fetch = [&](int t, int st) {
    uint8_t* base = smem + st * D::STAGE;
    const bool hi = t < n_hi;
    const int start = tile_start(t);
    const int n = min(hi ? min(TILE_HI, hi_len - start)
                         : min(TILE_LO, S - start), valid_end(t) - start);
    if (hi) {
      // a hi row in the largest chunks that divide it (and so keep every
      // row's chunks aligned): 16 bytes, or 8 at head_dim 72
      constexpr int CB = HD % 16 == 0 ? 16 : 8;
      constexpr int CH = HD / CB;            // chunks a hi row
      for (int i = tid; i < 2 * n * CH; i += THREADS) {
        const int kv = i / (n * CH), rc = i % (n * CH);
        const int r = rc / CH, c = rc % CH;
        const int8_t* src = (kv ? C.v_hi : C.k_hi) +
            (((size_t)bi * hi_len + start + r) * g + kvh) * HD + CB * c;
        cp_async<CB>(base + kv * D::CODE_BYTES + r * D::HI_ROW + CB * c, src);
      }
    } else {
      // a lo row: 16-byte chunks, 8 at head_dim 16 and 112, 4 at 72
      constexpr int RB = HD / 2;
      constexpr int CB = RB % 16 == 0 ? 16 : RB % 8 == 0 ? 8 : 4;
      constexpr int CH = RB / CB;            // chunks a lo row
      static_assert(RB % 4 == 0, "head_dim is a multiple of 8");
      for (int i = tid; i < 2 * n * CH; i += THREADS) {
        const int kv = i / (n * CH), rc = i % (n * CH);
        const int r = rc / CH, c = rc % CH;
        const uint8_t* src = (kv ? C.v_lo : C.k_lo) +
            (((size_t)bi * s_lo + start - hi_len + r) * g + kvh) * RB +
            CB * c;
        // the chunk's byte offset in the row, through the 8-byte swizzle
        cp_async<CB>(base + kv * D::CODE_BYTES +
                         lo_off<HDP>(r, CB * c / 8) + CB * c % 8, src);
      }
    }
  };
  auto params = [&](int t) {
    const int start = tile_start(t);
    const int pos = start + tid;
    const int end = valid_end(t);
    float4 pr = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < (t < n_hi ? TILE_HI : TILE_LO) && pos < end) {
      const size_t sp = ((size_t)bi * S + pos) * g + kvh;
      pr = make_float4(__half2float(C.k_sc[sp]), __half2float(C.k_zp[sp]),
                       __half2float(C.v_sc[sp]), __half2float(C.v_zp[sp]));
    }
    return pr;
  };
  auto prm_slot = [&](int st) {
    return reinterpret_cast<float4*>(smem + st * D::STAGE +
                                     2 * D::CODE_BYTES);
  };

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_act) {
      fetch(t0 + i, i);
      prm_slot(i)[tid] = params(t0 + i);
    }
    cp_commit();
  }

  // head gid: running max, and this lane's shares of l and of
  // sum_j w_j (zv_j - cut zv_j)
  float m = NEG, l = 0.f, zs = 0.f;
  float acc[KS][4];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt)
    acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  for (int it = 0; it < n_act; ++it) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    float4 pf = make_float4(0.f, 0.f, 0.f, 0.f);
    if (nxt < n_act) {
      fetch(t0 + nxt, nxt % STAGES);
      pf = params(t0 + nxt);
    }
    cp_commit();

    const int t = t0 + it, st = it % STAGES;
    const bool hi = t < n_hi;
    const int start = tile_start(t);
    // rows of this tile holding valid positions
    const int n = valid_end(t) - start;
    const uint8_t* kc = smem + st * D::STAGE;
    const uint8_t* vc = kc + D::CODE_BYTES;
    const float4* prm = prm_slot(st);
    const int ngrp = hi ? 1 : 2;
    const int wbase = warp * 16 * ngrp;

    float sc[2][2][2];                 // group, n-tile, position pair
#pragma unroll
    for (int gr = 0; gr < 2; ++gr) {
      if (gr >= ngrp) break;
      float d[2][4];
      if (hi)
        score_group<HD, NQ, true>(kc, prm, wbase + 16 * gr, qa, gid, tig, d);
      else
        score_group<HD, NQ, false>(kc, prm, wbase + 16 * gr, qa, gid, tig, d);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = wbase + 16 * gr + 8 * nt + tig + 4 * e;
          const float4 p = prm[r];
          const float s = (d[nt][e] - (p.y - zcut(p.y)) * qsum) * p.x * scale;
          sc[gr][nt][e] = r < n ? s : NEG;
        }
    }
    float mx = NEG;
#pragma unroll
    for (int gr = 0; gr < 2; ++gr)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (gr < ngrp) mx = fmaxf(mx, sc[gr][nt][e]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    l *= corr;
    zs *= corr;
    // the heads of this lane's value accumulators: 2 tig, 2 tig + 1
    const float c0 = __shfl_sync(0xffffffffu, corr, (2 * tig) << 2);
    const float c1 = __shfl_sync(0xffffffffu, corr, (2 * tig + 1) << 2);
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      acc[mt][0] *= c0; acc[mt][1] *= c1;
      acc[mt][2] *= c0; acc[mt][3] *= c1;
    }
#pragma unroll
    for (int gr = 0; gr < 2; ++gr) {
      if (gr >= ngrp) break;
      float wp[2][2][3], zv[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = wbase + 16 * gr + 8 * nt + tig + 4 * e;
          const float4 p = prm[r];
          const bool ok = r < n;
          const float pe = ok ? expf(sc[gr][nt][e] - m_new) : 0.f;
          const float w = ok ? pe * p.z : 0.f;
          zv[nt][e] = zcut(p.w);
          l += pe;
          zs += ok ? w * (p.w - zv[nt][e]) : 0.f;
          split3(w, wp[nt][e]);
        }
      uint32_t wb[3][2];
#pragma unroll
      for (int pc = 0; pc < 3; ++pc) {
        wb[pc][0] = pack(wp[0][0][pc], wp[0][1][pc]);
        wb[pc][1] = pack(wp[1][0][pc], wp[1][1][pc]);
      }
      if (hi) value_group<HD, true>(vc, wbase + 16 * gr, wb, zv, gid, tig, acc);
      else value_group<HD, false>(vc, wbase + 16 * gr, wb, zv, gid, tig, acc);
    }
    if (nxt < n_act) prm_slot(nxt % STAGES)[tid] = pf;
  }

  // join the warps in order: (m, l, zs) per head and the sums per (head,
  // feature) through shared memory, then write the range's partial
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  zs += __shfl_xor_sync(0xffffffffu, zs, 1);
  zs += __shfl_xor_sync(0xffffffffu, zs, 2);
  cp_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  float* red_o = red + 3 * WARPS * MAX_REP;
  if (tig == 0) {
    red[(0 * WARPS + warp) * MAX_REP + gid] = m;
    red[(1 * WARPS + warp) * MAX_REP + gid] = l;
    red[(2 * WARPS + warp) * MAX_REP + gid] = zs;
  }
#pragma unroll
  for (int mt = 0; mt < KS; ++mt) {
    const int f = 2 * (KS * gid + mt);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = 2 * tig + j;
      if (r < rep) {
        float* o = red_o + (warp * MAX_REP + r) * HDP;
        o[f] = acc[mt][j];
        o[f + 1] = acc[mt][2 + j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rep * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float mm = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      mm = fmaxf(mm, red[w * MAX_REP + r]);
    float ll = 0.f, oo = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float c = expf(red[w * MAX_REP + r] - mm);
      ll += red[(WARPS + w) * MAX_REP + r] * c;
      oo += (red_o[(w * MAX_REP + r) * HDP + d] -
             red[(2 * WARPS + w) * MAX_REP + r]) * c;
    }
    out[r * (HD + 2) + 2 + d] = oo;
    if (d == 0) {
      out[r * (HD + 2)] = mm;
      out[r * (HD + 2) + 1] = ll;
    }
  }
}

// one block per (kv head, b, query head), a thread a feature: merge the
// ranges in order.  A partial whose m is -inf (a sequence block that holds
// no valid position) weighs 0.  With `state` (block mode) the merged
// partial (m, l, unnormalised sum) is written there, (b, g, rep, hd + 2),
// m = -inf where no position was valid, and `out` is not.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cache_attention_merge(const float* part, int h, int g, int hd, int n_split,
                      T* out, float* state) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int kvh = blockIdx.x, bi = blockIdx.y, r = blockIdx.z;
  const int rep = h / g;
  const float* base = part + ((size_t)bi * g + kvh) * n_split * rep *
                                 (hd + 2);
  float* st = state ? state + (((size_t)bi * g + kvh) * rep + r) * (hd + 2)
                    : nullptr;
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float m = NEG;
    for (int i = 0; i < n_split; ++i)
      m = fmaxf(m, base[(i * rep + r) * (hd + 2)]);
    float l = 0.0f, o = 0.0f;
    for (int i = 0; i < n_split; ++i) {
      const float* pi = base + (i * rep + r) * (hd + 2);
      const float c = pi[0] == -INFINITY ? 0.0f : expf(pi[0] - m);
      l += pi[1] * c;
      o += pi[2 + d] * c;
    }
    if (st) {
      st[2 + d] = o;
      if (d == 0) {
        st[0] = l > 0.0f ? m : -INFINITY;
        st[1] = l;
      }
    } else {
      store_f(out + ((size_t)bi * h + kvh * rep + r) * hd + d,
              o / fmaxf(l, 1e-30f));
    }
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const Cache& C, const int* lengths, int b,
                   int h, int g, int hi_len, int S, int tiles_per_range,
                   int n_split, float scale, float* part, void* out,
                   int hi0, int lo0, float* state, cudaStream_t st) {
  using D = Dims<HD>;
  const size_t merge = sizeof(float) * WARPS * MAX_REP * (3 + D::HDP);
  const size_t smem = STAGES * D::STAGE > merge ? STAGES * D::STAGE : merge;
  cudaError_t e = cudaFuncSetAttribute(
      cache_attention_split<HD, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cache_attention_split<HD, T><<<dim3(g, n_split, b), THREADS, smem, st>>>(
      static_cast<const T*>(q), C, lengths, h, g, hi_len, S,
      tiles_per_range, scale, part, hi0, lo0);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g, b, h / g);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, cache_attention_merge<T>,
                            static_cast<const float*>(part), h, g, HD,
                            n_split, static_cast<T*>(out), state);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const Cache& C,
                        const int* lengths, int b, int h, int g, int hi_len,
                        int S, int tpr, int n_split, float scale,
                        float* part, void* out, int hi0, int lo0,
                        float* state, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<16, T>(q, C, lengths, b, h, g, hi_len, S, tpr, n_split, scale, part, out, hi0, lo0, state, st);
    case 32: return launch<32, T>(q, C, lengths, b, h, g, hi_len, S, tpr, n_split, scale, part, out, hi0, lo0, state, st);
    case 64: return launch<64, T>(q, C, lengths, b, h, g, hi_len, S, tpr, n_split, scale, part, out, hi0, lo0, state, st);
    case 72: return launch<72, T>(q, C, lengths, b, h, g, hi_len, S, tpr, n_split, scale, part, out, hi0, lo0, state, st);
    case 112: return launch<112, T>(q, C, lengths, b, h, g, hi_len, S, tpr, n_split, scale, part, out, hi0, lo0, state, st);
    case 128: return launch<128, T>(q, C, lengths, b, h, g, hi_len, S, tpr, n_split, scale, part, out, hi0, lo0, state, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// tiles_per_range and n_split come from the wrapper's launch plan
// (kernels/cache_attention.py: tiles of TILE_HI hi and TILE_LO lo
// positions); they must cover the row's tiles.  Block mode, for a rank's
// block of a sequence-split cache: hi0 / lo0 are the global positions of
// the buffers' first hi and lo positions (0 and hi_len for a whole cache;
// past every length for a region the rank does not read), and with
// `state` non-null the ranges' merged partial (m, l, o), (b, g, h / g,
// hd + 2) f32, is written there instead of the output.
extern "C" int cache_attention(
    const void* q, int q_bf16, int b, int h, int g, int hd, int hi_len,
    int S, const void* k_hi, const void* v_hi, const void* k_lo,
    const void* v_lo, const void* k_sc, const void* k_zp, const void* v_sc,
    const void* v_zp, const int* lengths, int tiles_per_range, int n_split,
    float scale, void* part, void* out, int hi0, int lo0, void* state,
    void* stream) {
  const int n_tiles = (hi_len + TILE_HI - 1) / TILE_HI +
                      (S - hi_len + TILE_LO - 1) / TILE_LO;
  if (h % g || h / g > MAX_REP || tiles_per_range < 1 || n_split < 1 ||
      n_split > 65535 || (long long)tiles_per_range * n_split < n_tiles)
    return (int)cudaErrorInvalidValue;
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
  float* sp = static_cast<float*>(state);
  cudaError_t e =
      q_bf16 ? dispatch_hd<__nv_bfloat16>(hd, q, C, lengths, b, h, g, hi_len,
                                          S, tiles_per_range, n_split, scale,
                                          p, out, hi0, lo0, sp, st)
             : dispatch_hd<float>(hd, q, C, lengths, b, h, g, hi_len, S,
                                  tiles_per_range, n_split, scale, p, out,
                                  hi0, lo0, sp, st);
  return (int)e;
}

// The merge alone over the ranks' block states of a sequence-split cache:
// part (b, g, n, h / g, hd + 2) f32 (each the merged (m, l, o) of one
// rank's block, in rank order; m = -inf for a block with no valid
// position), out (b, h, hd) in the queries' type.
extern "C" int cache_attention_merge_states(const void* part, int out_bf16,
                                            int b, int h, int g, int hd,
                                            int n, void* out, void* stream) {
  if (b < 0 || g < 1 || h % g || h / g > MAX_REP || n < 1 || hd < 1)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(g, b, h / g);
  const float* p = static_cast<const float*>(part);
  if (out_bf16)
    cache_attention_merge<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        p, h, g, hd, n, static_cast<__nv_bfloat16*>(out), nullptr);
  else
    cache_attention_merge<float><<<grid, THREADS, 0, st>>>(
        p, h, g, hd, n, static_cast<float*>(out), nullptr);
  return (int)cudaGetLastError();
}
