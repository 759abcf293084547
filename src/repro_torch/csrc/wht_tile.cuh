// K10's tile of the Walsh-Hadamard transform, shared by csrc/wht.cu (K10
// walsh_hadamard) and csrc/span_link.cu (the long-span link under the WHT):
// the loads and stores of four-element chunks, the XOR-swizzled slots of
// the f32 tile in shared memory, and the register phases of a tile (see
// wht.cu's note for the design).  The last phase hands each chunk to an
// output policy (Store here: scale and write), so a caller can fuse its own
// epilogue into it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace wht_tile {

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

// four contiguous elements (16-byte aligned in f32, 8-byte in 16 bits)
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void st4(__half* p, float4 v) {
  __half2 a = __floats2half2_rn(v.x, v.y);
  __half2 b = __floats2half2_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

// row p of a staged tile of rb-byte rows: rows eight apart trade places
// within 128 bytes, so that the first phase (rows p, p + 8, ... across a
// quarter or half warp) reads distinct banks
__device__ __forceinline__ int staged_row(int p, int rb) {
  return rb >= 128 ? p : p ^ ((p >> 3) & (128 / rb - 1));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// one tile of one launch; element (c, i) of the block's tile lies at
// base + c * vstride + i * pstride, vectors c in [c0, c0 + w)
struct Tile {
  long long base;       // the tile's first element (batch, tile, c0)
  long long vstride;    // between vectors
  long long pstride;    // between positions of the tile
  int c0, nvec;         // the block's first vector, vectors in all
  int lp, lq;           // log2 of chunk positions P and chunk columns Q
  bool chunk_pos;       // chunks along the positions (feature mode)
};

// shared-memory slot of chunk u = p * Q + q: the low three bits are XORed
// with higher bits so that the first phase's writes (chunk positions eight
// apart across the threads) and every later phase's accesses (eight
// neighbouring chunks a quarter warp) hit distinct banks
__device__ __forceinline__ int slot(int u, int lq) {
  const int mask = lq >= 3 ? 0 : 7 & ~((1 << lq) - 1);
  return u ^ ((u >> 3) & mask);
}

// global offset of chunk (p, q) and whether it holds data
__device__ __forceinline__ long long chunk_off(const Tile& t, int p, int q,
                                               bool& ok) {
  if (t.chunk_pos) {
    const int c = t.c0 + q;
    ok = c < t.nvec;
    return t.base + (long long)c * t.vstride + (long long)(4 * p) * t.pstride;
  }
  const int c = t.c0 + 4 * q;
  ok = c < t.nvec;
  return t.base + (long long)c * t.vstride + (long long)p * t.pstride;
}

// one register phase: every thread's items hold R = 2^gb chunks whose
// positions differ in bits [s, s + gb); `first` reads them from device
// memory (STAGED: from the staged rows `stage`), `last` hands each chunk
// (t, position, chunk column, value) to `out`, which scales and writes it,
// the others go through shared memory
template <int R, bool STAGED, typename TI, typename Out>
__device__ __forceinline__ void phase(const Tile& t, const TI* x,
                                      const Out& out, float4* sm,
                                      const uint8_t* stage, int rb, int s,
                                      bool first, bool last) {
  constexpr int GB = R == 1 ? 0 : R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  const int Q = 1 << t.lq;
  const int items = 1 << (t.lp + t.lq - GB);
  const int low = (1 << s) - 1;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int q = it & (Q - 1), o = it >> t.lq;
    const int pb = (o & low) | ((o >> s) << (s + GB));
    float4 v[R];
    if (first) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if constexpr (STAGED) {
          v[j] = ld4(reinterpret_cast<const TI*>(
              stage + staged_row(pb + j, rb) * rb) + 4 * q);
        } else {
          bool ok;
          const long long off = chunk_off(t, pb + (j << s), q, ok);
          v[j] = ok ? ld4(x + off) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
      if (t.chunk_pos) {     // the stages h = 1, 2 inside each chunk
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float4 a = v[j];
          const float4 b = make_float4(a.x + a.y, a.x - a.y, a.z + a.w,
                                       a.z - a.w);
          v[j] = make_float4(b.x + b.z, b.y + b.w, b.x - b.z, b.y - b.w);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j)
        v[j] = sm[slot(((pb + (j << s)) << t.lq) | q, t.lq)];
    }
#pragma unroll
    for (int h = 1; h < R; h <<= 1)
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (!(j & h)) {
          const float4 a = v[j], b = v[j + h];
          v[j] = add4(a, b);
          v[j + h] = sub4(a, b);
        }
    if (last) {
#pragma unroll
      for (int j = 0; j < R; ++j) out(t, pb + (j << s), q, v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j)
        sm[slot(((pb + (j << s)) << t.lq) | q, t.lq)] = v[j];
    }
  }
}

// a tile's register phases, three position bits the first and at most
// GMAX each later one; after_first() runs once the first phase is done with
// its source
template <bool STAGED, int GMAX, typename TI, typename Out, typename F>
__device__ __forceinline__ void run_tile(const Tile& t, const TI* x,
                                         const Out& out, float4* sm,
                                         const uint8_t* stage, int rb,
                                         F after_first) {
  int s = 0;
  bool first = true;
  while (true) {
    const int gb = min(t.lp - s, first ? 3 : GMAX);
    const bool last = s + gb >= t.lp;
    if (!first) __syncthreads();
#define WHT_PHASE(R) phase<R, STAGED>(t, x, out, sm, stage, rb, s, first, \
                                      last)
    switch (gb) {
      case 0: WHT_PHASE(1); break;
      case 1: WHT_PHASE(2); break;
      case 2: WHT_PHASE(4); break;
      case 3: WHT_PHASE(8); break;
      default:
        if constexpr (GMAX > 3) WHT_PHASE(16);
        break;
    }
#undef WHT_PHASE
    if (first) after_first();
    if (last) break;
    s += gb;
    first = false;
  }
}

// the plain last-phase store: the chunk scaled by r (if `scale`) into y
template <typename TO>
struct Store {
  TO* y;
  int scale;
  float r;
  __device__ __forceinline__ void operator()(const Tile& t, int p, int q,
                                             float4 a) const {
    bool ok;
    const long long off = chunk_off(t, p, q, ok);
    if (scale) a = make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
    if (ok) st4(y + off, a);
  }
};

}  // namespace wht_tile
