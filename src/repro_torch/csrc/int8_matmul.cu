// Standalone int8 x int8 GEMM with zero-point correction for Hopper
// (sm_90a): K7.
//
// Replaces the Pallas kernel int8_matmul_pallas (src/repro/kernels/
// int8_matmul.py):  Y[m, n] = ((acc - zx*Sw) - zw*Sx + (K*zx)*zw) * sx * sw
// with acc = sum_k qx[m, k] * qw[k, n] in int32, Sw = sum_k qw[k, n] and
// Sx = sum_k qx[m, k], both summed on the fly (the standalone API gets no
// precomputed column sums), the epilogue in f32 in the reference's order.
//
// Bound on the H100: integer operations at 2048 rows (2MNK int8 operations
// over a few tens of MB); bytes at 8 decode rows, where the (K, N) weight
// is read once.
//
// Design: a persistent, warp-specialised kernel; one block an SM walks
// 128 x 128 output tiles.  Warp 12 (the producer) keeps a ring of 4 stages
// full with TMA: a stage is the A tile (128 rows x 128 k, 128-byte swizzle,
// the layout wgmma reads) and the B tile's raw (K, N) rows (128 k x 128
// columns).  wgmma reads 8-bit operands K-major only, and the weight is
// N-major, so warps 8-11 (the transposer) turn each raw B tile into
// K-major core matrices (__byte_perm of 4 x 4 bytes, 16-byte stores, the
// 8-column groups padded to 1040 bytes so the stores of a warp hit
// distinct banks) in a second ring of 3 buffers, take the weight's column
// sums Σqw from the transposed columns with dp4a, and stage each tile's
// epilogue values (Σqw, scales and zero points).  Each transposed buffer
// ends in 16 columns of ones, so the tensor cores form the rows' sums Σqx
// with the product.  Warps 0-7 (two consumer warpgroups, 64 rows each)
// only issue wgmma.m64n144k32.s32.s8.s8, one k step in flight while the
// next is issued, and run the epilogue of their tile from the registers
// (staged in shared memory, written out in 16-byte rows) while the
// producer and the transposer already fill the next tile's stages.
// Measured (tools/probe.py k7), the epilogue, the transpose and the MMAs
// each cost about a quarter: the consumers' epilogue leaves the tensor
// cores idle.  mbarriers order the three roles: full (TMA bytes
// landed), empty (the stage read by all), B-transposed full / empty, and
// the tile's epilogue values full / empty.  The epilogue is built with
// -fmad=false, so it rounds as the plain version does.  TMA needs K and N
// multiples of 16 and 16-byte aligned operands; the wrapper pads other
// shapes (all below 128) into zeroed copies, which change no product or
// sum.  torch._int_mm is only the library yardstick.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 128;    // tile rows, columns, k bytes
constexpr int STAGES = 4;                      // TMA ring
constexpr int BT_STAGES = 3;                   // transposed B ring
constexpr int TRANSPOSER0 = 256;               // warps 8-11 (0-7 consume)
constexpr int PRODUCER_WARP = 12;
constexpr int THREADS = 13 * 32;
constexpr int A_BYTES = BM * BK;               // 16384, 1024-aligned
constexpr int B_BYTES = BK * BN;               // 16384 raw (K, N) rows
constexpr int STAGE_TX = A_BYTES + B_BYTES;
// transposed B: K-major core matrices (8 columns x 16 k-bytes), the 8
// k-chunks of a column group 128 bytes apart (LBO), groups 1040 apart (SBO)
constexpr int BT_LBO = 128, BT_SBO = 8 * 128 + 16;
// the product's columns: the tile's 128 and 16 of ones, whose products
// are the rows' Σqx (int32 on the tensor cores, no pass over A)
constexpr int BNX = BN + 16, NACC = BNX / 2;   // accumulators a thread
constexpr int BT_BYTES = BNX / 8 * BT_SBO;     // 18720
// a tile's epilogue values, staged by the transposer: its 128 rows' (sx,
// zx) and its 128 columns' (Σqw, zw, sw), as floats; the transposer
// warps' partial Σqw are summed in a scratch of 4 x 128 ints first
constexpr int SUM_FLOATS = 2 * BM + 3 * BN;
constexpr int PART_OFF_INTS = 2 * SUM_FLOATS;

constexpr int A_OFF = 0;
constexpr int B_OFF = A_OFF + STAGES * A_BYTES;
constexpr int BT_OFF = B_OFF + STAGES * B_BYTES;
constexpr int SUM_OFF = BT_OFF + BT_STAGES * BT_BYTES;
// each consumer warpgroup stages its 64 x 128 outputs here (in passes of
// 256 bytes a row, rows padded so a warp's fragment stores spread over
// the banks) and writes them out in 16-byte coalesced stores
constexpr int OUT_OFF = SUM_OFF + (2 * SUM_FLOATS + 4 * BN) * 4;
constexpr int OUT_PITCH_MAX = 256 + 8 * 4;
constexpr int BAR_OFF = OUT_OFF + 2 * 64 * OUT_PITCH_MAX;
constexpr int NBARS = 2 * STAGES + 2 * BT_STAGES + 4;
constexpr int SMEM = BAR_OFF + NBARS * 8 + 1024;   // + alignment slack
static_assert(B_OFF % 1024 == 0 && BT_OFF % 16 == 0 && OUT_OFF % 16 == 0 &&
              BAR_OFF % 8 == 0, "aligned regions");
static_assert(SMEM <= 232448, "fits the shared memory a block may use");

// ------------------------------------------------------------ helpers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// Spin until the phase of parity `parity` has completed (a fresh barrier
// counts the phase before its first, of parity 1, as completed).
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(bar) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a ring position: slot and the parity of its current use
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  template <int N>
  __device__ __forceinline__ void next() {
    if (++slot == N) { slot = 0; phase ^= 1u; }
  }
};

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

// wgmma descriptors: A K-major with the 128-byte swizzle (8-row atoms of
// 1024 bytes, the TMA box's layout), B K-major core matrices, no swizzle
__device__ __forceinline__ uint64_t desc_a(uint32_t addr) {
  return ((uint64_t)((addr >> 4) & 0x3FFF)) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return ((uint64_t)((addr >> 4) & 0x3FFF)) |
         ((uint64_t)(BT_LBO >> 4) << 16) | ((uint64_t)(BT_SBO >> 4) << 32);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous MMAs.
__device__ __forceinline__ void reg_fence(int (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D (64 x 144, int32) += A (64 x 32, s8) * B (32 x 144, s8), both K-major
// in shared memory; D in the m64nNk32 fragment layout.  s8 products take
// N in multiples of 16 past 128: B's columns 128-143 are ones, so D's
// columns 128-143 hold the rows' Σqx.
__device__ __forceinline__ void wgmma_s8(int (&d)[NACC], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71}, %72, %73, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void st2(float* p, float a, float b, bool pair) {
  if (pair)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    p[0] = a;
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b,
                                    bool pair) {
  if (pair)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else
    p[0] = __float2bfloat16_rn(a);
}
__device__ __forceinline__ void st2(__half* p, float a, float b, bool pair) {
  if (pair)
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
  else
    p[0] = __float2half_rn(a);
}

struct Args {
  const float* sx; const float* zx; const float* sw; const float* zw;
  int M, N, K, KT;   // K the product's depth, KT its k steps (of the
                     // operands the maps address, zero-padded past K)
  int tiles_m, tiles;
  void* out;
};

// ------------------------------------------------------------- kernel ----

template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
int8_mm_kernel(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_b, Args a) {
  extern __shared__ unsigned char raw_smem[];
  // the A tiles' 128-byte swizzle repeats every 1024 bytes
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw_smem) + 1023) & ~(uintptr_t)1023);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t bars = smem_u32(sm + BAR_OFF);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  auto bt_full = [&](int b) { return bars + 8 * (2 * STAGES + b); };
  auto bt_empty = [&](int b) {
    return bars + 8 * (2 * STAGES + BT_STAGES + b);
  };
  auto sum_full = [&](int t) {
    return bars + 8 * (2 * STAGES + 2 * BT_STAGES + t);
  };
  auto sum_empty = [&](int t) {
    return bars + 8 * (2 * STAGES + 2 * BT_STAGES + 2 + t);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), 12);     // 4 transposer warps + 8 consumer warps
    }
    for (int b = 0; b < BT_STAGES; ++b) {
      bar_init(bt_full(b), 4);
      bar_init(bt_empty(b), 8);
    }
    for (int t = 0; t < 2; ++t) {
      bar_init(sum_full(t), 4);
      bar_init(sum_empty(t), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the ones columns of every transposed buffer, written once
  for (int i = tid; i < BT_STAGES * 2 * BT_SBO / 4; i += THREADS) {
    const int buf = i / (2 * BT_SBO / 4), w = i % (2 * BT_SBO / 4);
    reinterpret_cast<uint32_t*>(sm + BT_OFF + buf * BT_BYTES +
                                BN / 8 * BT_SBO)[w] = 0x01010101u;
  }
  fence_async_smem();
  __syncthreads();
  const int KT = a.KT;

  if (warp == PRODUCER_WARP) {
    // ---- producer: one thread keeps the TMA ring full
    if (lane != 0) return;
    Ring r;
    r.phase = 1;                  // the ring starts empty
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      const int m0 = (t % a.tiles_m) * BM, n0 = (t / a.tiles_m) * BN;
      for (int kt = 0; kt < KT; ++kt) {
        bar_wait(empty(r.slot), r.phase);
        bar_expect_tx(full(r.slot), STAGE_TX);
        tma_load_2d(smem_u32(sm + A_OFF + r.slot * A_BYTES), &map_a, kt * BK,
                    m0, full(r.slot));
        tma_load_2d(smem_u32(sm + B_OFF + r.slot * B_BYTES), &map_b, n0,
                    kt * BK, full(r.slot));
        r.next<STAGES>();
      }
    }
    return;
  }

  if (tid >= TRANSPOSER0) {
    // ---- transposer: raw B -> K-major core matrices; Σqw
    const int t = tid - TRANSPOSER0, tw = t >> 5, cw = t & 31;
    Ring r, b, s;
    b.phase = 1;                  // the buffers start free
    s.phase = 1;
    for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
      int csum[4] = {0, 0, 0, 0};
      for (int kt = 0; kt < KT; ++kt) {
        bar_wait(full(r.slot), r.phase);
        bar_wait(bt_empty(b.slot), b.phase);
        const int* Bw = reinterpret_cast<const int*>(sm + B_OFF +
                                                     r.slot * B_BYTES);
        unsigned char* Bt = sm + BT_OFF + b.slot * BT_BYTES;
        // items (k-chunk c, columns 4cw .. 4cw + 3): 16 word loads (a warp
        // reads 32 consecutive words of a k row), 4 transposes, 4 16-byte
        // stores on distinct banks
#pragma unroll
        for (int it = 0; it < 2; ++it) {
          const int c = tw + 4 * it;
          int col[4][4];      // [k-quad][column]
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int* w = Bw + (16 * c + 4 * q) * (BN / 4) + cw;
            transpose4(w[0], w[BN / 4], w[BN / 2], w[3 * BN / 4], col[q]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = 4 * cw + j;
            *reinterpret_cast<int4*>(Bt + (n >> 3) * BT_SBO + c * BT_LBO +
                                     (n & 7) * 16) =
                make_int4(col[0][j], col[1][j], col[2][j], col[3][j]);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              csum[j] = __dp4a(col[q][j], 0x01010101, csum[j]);
          }
        }
        fence_async_smem();   // the transposed tile, to the tensor cores
        __syncwarp();
        if (lane == 0) {
          bar_arrive(bt_full(b.slot));
          bar_arrive(empty(r.slot));
        }
        r.next<STAGES>();
        b.next<BT_STAGES>();
      }
      // the tile's epilogue values: column t's Σqw from the 4 warps'
      // partials (a barrier of the transposer's 128 threads between)
      const int m0 = (tile % a.tiles_m) * BM, n0 = (tile / a.tiles_m) * BN;
      int* part = reinterpret_cast<int*>(sm + SUM_OFF) + PART_OFF_INTS;
#pragma unroll
      for (int j = 0; j < 4; ++j) part[tw * BN + 4 * cw + j] = csum[j];
      bar_wait(sum_empty(s.slot), s.phase);
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
      float* ev = reinterpret_cast<float*>(sm + SUM_OFF) + s.slot * SUM_FLOATS;
      const int row = m0 + t, col = n0 + t;
      ev[t] = row < a.M ? a.sx[row] : 0.0f;
      ev[BM + t] = row < a.M ? a.zx[row] : 0.0f;
      ev[2 * BM + t] = (float)(part[t] + part[BN + t] + part[2 * BN + t] +
                               part[3 * BN + t]);
      ev[2 * BM + BN + t] = col < a.N ? a.zw[col] : 0.0f;
      ev[2 * BM + 2 * BN + t] = col < a.N ? a.sw[col] : 0.0f;
      asm volatile("bar.sync 1, 128;\n" ::: "memory");  // part is free
      __syncwarp();
      if (lane == 0) bar_arrive(sum_full(s.slot));
      s.next<2>();
    }
    return;
  }

  // ---- consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  Ring r, b, s;
  int acc[NACC];
  const float kf = (float)a.K;
  TO* out = static_cast<TO*>(a.out);
  // 16-byte stores where every output row starts on a 16-byte boundary
  const bool vec_out = (a.N * sizeof(TO)) % 16 == 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int m0 = (tile % a.tiles_m) * BM, n0 = (tile / a.tiles_m) * BN;
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0;
    int prev_r = -1, prev_b = -1;
    for (int kt = 0; kt < KT; ++kt) {
      bar_wait(full(r.slot), r.phase);
      bar_wait(bt_full(b.slot), b.phase);
      const uint32_t As = smem_u32(sm + A_OFF + r.slot * A_BYTES) +
                          wg * 64 * BK;
      const uint32_t Bt = smem_u32(sm + BT_OFF + b.slot * BT_BYTES);
      reg_fence(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        wgmma_s8(acc, desc_a(As + 32 * ks), desc_b(Bt + 2 * ks * BT_LBO));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      reg_fence(acc);
      // the previous step's products are done: release its buffers
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      reg_fence(acc);
      if (prev_r >= 0) {
        __syncwarp();
        if (lane == 0) {
          bar_arrive(empty(prev_r));
          bar_arrive(bt_empty(prev_b));
        }
      }
      prev_r = r.slot;
      prev_b = b.slot;
      r.next<STAGES>();
      b.next<BT_STAGES>();
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    reg_fence(acc);
    if (prev_r >= 0) {
      __syncwarp();
      if (lane == 0) {
        bar_arrive(empty(prev_r));
        bar_arrive(bt_empty(prev_b));
      }
    }
    // epilogue from the registers: fragment rows 64 wg + 16 (warp % 4) +
    // lane / 4 (+8 for regs 4j + 2, 4j + 3), columns 8 j + 2 (lane % 4)
    // (+1); staged a pass of W columns at a time (256 bytes a row), then
    // written out a row's 256 bytes by 16 threads
    bar_wait(sum_full(s.slot), s.phase);
    const float* ev = reinterpret_cast<const float*>(sm + SUM_OFF) +
                      s.slot * SUM_FLOATS;
    constexpr int W = 256 / sizeof(TO), PITCH = 256 + 8 * sizeof(TO);
    unsigned char* stage = sm + OUT_OFF + wg * 64 * OUT_PITCH_MAX;
    const int wt = tid & 127, lr0 = (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int p = 0; p < BN / W; ++p) {
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int lr = wg * 64 + lr0 + 8 * hf;
        if (m0 + lr >= a.M) continue;
        // Σqx: the row's product with a ones column (128 + 2 (lane % 4))
        const float qs = (float)acc[64 + 2 * hf];
        const float sc = ev[lr], z = ev[BM + lr];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (8 * j < p * W || 8 * j >= (p + 1) * W) continue;
          const int lc = 8 * j + 2 * (lane & 3);
          float y[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float ws = ev[2 * BM + lc + c], w = ev[2 * BM + BN + lc + c];
            y[c] = ((((float)acc[4 * j + 2 * hf + c] - z * ws) - w * qs) +
                    (kf * z) * w) * sc * ev[2 * BM + 2 * BN + lc + c];
          }
          st2(reinterpret_cast<TO*>(stage + (lr0 + 8 * hf) * PITCH) +
                  (lc - p * W), y[0], y[1], true);
        }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
      constexpr int E = 16 / sizeof(TO);          // outputs a 16-byte chunk
#pragma unroll
      for (int i = wt; i < 64 * 16; i += 128) {
        const int rr = i >> 4, ch = i & 15;
        const int row = m0 + wg * 64 + rr, col = n0 + p * W + ch * E;
        if (row >= a.M || col >= a.N) continue;
        const unsigned char* src = stage + rr * PITCH + ch * 16;
        TO* dst = out + (size_t)row * a.N + col;
        if (vec_out) {
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        } else {
          for (int e = 0; e < E && col + e < a.N; ++e)
            dst[e] = reinterpret_cast<const TO*>(src)[e];
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(sum_empty(s.slot));
    s.next<2>();
  }
}

// ---------------------------------------------------------------- host ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major (rows, cols) int8 matrix with row stride ld, read in boxes of
// (box_rows, box_cols)
bool make_map(CUtensorMap* map, const void* base, int rows, int cols, int ld,
              int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n[32] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 32 && n[dev]) return n[dev];
  int c = 0;
  cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 32) n[dev] = c;
  return c;
}

template <typename TO>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb,
                   const Args& a, cudaStream_t st) {
  // the attribute is set once per instantiation and card: bit d for card d
  static unsigned sized = 0u;
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev); e != cudaSuccess) return e;
  if (dev >= 32 || !((sized >> dev) & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        int8_mm_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM);
    if (e != cudaSuccess) return e;
    if (dev < 32) sized |= 1u << dev;
  }
  const int grid = a.tiles < sm_count() ? a.tiles : sm_count();
  int8_mm_kernel<TO><<<grid, THREADS, SMEM, st>>>(ma, mb, a);
  return cudaGetLastError();
}

}  // namespace

// qx: (M, ldx) int8, qw: (ldx, ldw) int8, K <= ldx and N <= ldw, ldx and
// ldw multiples of 16, both 16-byte aligned (columns past K of qx and rows
// past K of qw, if any, are zeros: the wrapper's padded copies); sx/zx:
// (M,) f32, sw/zw: (N,) f32; out: (M, N) of out_dtype (0 f32, 1 bf16, 2 f16).
extern "C" int int8_matmul(const void* qx, const void* qw, const float* sx,
                           const float* zx, const float* sw, const float* zw,
                           int M, int N, int K, int ldx, int ldw, void* out,
                           int out_dtype, void* stream) {
  if (M < 0 || N < 0 || K < 0 || ldx < K || ldw < N || ldx % 16 ||
      ldw % 16 || (uintptr_t)qx % 16 || (uintptr_t)qw % 16)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  Args a{sx, zx, sw, zw, M, N, K, (ldx + BK - 1) / BK,
         (M + BM - 1) / BM, 0, out};
  a.tiles = a.tiles_m * ((N + BN - 1) / BN);
  const int kp = ldx;            // qx's columns = qw's rows the maps see
  CUtensorMap ma, mb;
  if (!make_map(&ma, qx, M, kp, ldx, BM, BK, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&mb, qw, kp, ldw, ldw, BK, BN, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return (int)launch<float>(ma, mb, a, st);
    case 1: return (int)launch<__nv_bfloat16>(ma, mb, a, st);
    case 2: return (int)launch<__half>(ma, mb, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
