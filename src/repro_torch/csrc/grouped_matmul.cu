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
// rows for two spans; Kimi-K2's top-8 of 384 experts gives C = 4), so the
// work is ~12 int8 operations per weight byte, far below the card's ridge:
// the kernel is as fast as it streams each occupied expert's 3*d*f int8
// weight bytes once.
//
// Design.  Two launches, both persistent (one wave of blocks that walk a
// work list), both deterministic:
//
// (a) moe_gate_up_kernel: a work item is (expert, row group, f slab of bf
//     columns).  Its block streams the slab's gate and up weight columns
//     (bf bytes of each of d rows, both matrices) through a ring of
//     STAGES shared-memory stages (3: measured faster than 4 or 6, as it
//     leaves room for more blocks an SM) filled by 16-byte cp.async
//     copies, the next item's stages already in flight while an item's
//     epilogue runs.
//     One warp owns 32 columns.  The products run on the tensor cores,
//     mma.sync m16n8k32 s8 -> s32 with the expert's columns as the
//     16-row A operand and up to 8 kept tokens as the 8-wide B operand:
//     the stacked weight is (k, n) row-major, so a thread reads 4-byte
//     words of 4 columns at 4 consecutive k rows and transposes them with
//     __byte_perm into k-major quads (its 4 columns become rows g and
//     g + 8 of two m16 tiles).  Stage rows are 16-byte-chunk swizzled so
//     these word reads meet no bank conflict.  Up to TT token tiles (8 TT
//     kept rows, the row group) are multiplied against each weight tile
//     while it sits in shared memory, so every weight byte is read once
//     per row group: once at all for up to 32 kept rows an expert.  The
//     epilogue (zero points, silu(g)*u) and the slab's per-row 8-bit
//     requantize run on the accumulators; the int8 codes and the f32
//     scale / shifted zero point / int32 code sum of each (row, slab) go to
//     device memory (a few MB).
// (b) moe_down_kernel: a work item is (expert, row group, 256 output
//     columns).  It streams the down codes' 256 columns over all f rows the
//     same way, an int32 product per slab on the tensor cores, and at each
//     slab's end adds the slab's epilogue to f32 accumulators in slab order
//     j = 0 .. nf-1: the reference's order.  It also writes the zero rows.
//     It is a programmatic dependent launch: its blocks start as (a)'s
//     leave, write the zero rows and build their work list, and wait for
//     (a)'s codes only before their first copy.
//
// Each block builds the work list itself from the bucket counts (the
// occupied experts and their row groups, a block-wide scan), so an expert
// with no kept token costs nothing and nothing waits on the host.  The
// down codes' per-slab column sums are fixed with the weight and come in
// precomputed (E, nf, d), as the gate/up column sums do (E, 1, f).
// Numerics mirror the Pallas kernel as it runs compiled: true division
// (__fdiv_rn) by the per-row scale, round half to even (rintf), the 1e-8
// floor, (mx - mn) * f32(1/255) (XLA's form of the division by 255), silu
// as x * (1 / (1 + exp(-x))), and -fmad=false so the f32 epilogues evaluate
// in the plain version's order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int STAGES = 3;
constexpr int TT_MAX = 4;              // token tiles of 8 kept rows
constexpr int ROWS = 8 * TT_MAX;       // kept rows of a row group
constexpr int MAX_BF = 512;
constexpr int DOWN_COLS = 256;         // output columns of a (b) item
constexpr int DOWN_THREADS = 256;      // 8 warps of 32 columns

struct Moe {
  const int8_t* qx; const float* sx; const float* zx; const int* counts;
  int B, E, C, D, F, BF, nf, n_groups_max;
  const int8_t* qwg; const float* swg; const float* zwg; const int* wsg;
  const int8_t* qwu; const float* swu; const float* zwu; const int* wsu;
  const int8_t* qwd; const float* swd; const float* zwd; const int* wsd;
  int8_t* qa; float* sa; float* za; int* qas;
  void* out;
  unsigned long long* wbytes;     // optional: weight bytes streamed
};

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;        // zero-fill what lies outside
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// d = a (16 x 32, row-major) * b (32 x 8, column-major) + d, int8 -> int32
__device__ __forceinline__ void mma_s8(int* d, int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte offset of (k row, 16-byte chunk c) in a weight stage whose rows are
// rsb bytes: chunks are XOR-swizzled by bits 2-3 of the row, so the words
// a warp reads at rows 4t + i (t = 0..3) of its 32 columns fall on 32
// distinct banks (rsb is a multiple of 128).
__device__ __forceinline__ int w_off(int k, int c, int rsb) {
  return k * rsb + ((c ^ (((k >> 2) & 3) << 1)) << 4);
}

// ((acc - zx*Σqw) - zw*Σqx + (K*zx)*zw) * sx * sw: the plain version's order
__device__ __forceinline__ float epilogue(int acc, float sx, float zx,
                                          float sw, float zw, int wsum,
                                          int xsum, float k) {
  return ((((float)acc - zx * (float)wsum) - zw * (float)xsum) +
          (k * zx) * zw) * sx * sw;
}

// ------------------------------------------------------- the work list ----

// Per block, in shared memory: the clamped counts cnt[e * B + i] and the
// list of (expert, row group) entries, (e << 8) | g, in expert order.
struct Plan {
  unsigned char* cnt;
  int* groups;
  int n_groups;
};

__device__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? scratch[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    scratch[32 + lane] = s;          // inclusive sums of the warps
  }
  __syncthreads();
  const int before = warp ? scratch[32 + warp - 1] : 0;
  *total = scratch[32 + nw - 1];
  __syncthreads();
  return before + x - v;
}

__device__ void build_plan(const Moe& m, Plan& p, int* scratch) {
  for (int idx = threadIdx.x; idx < m.B * m.E; idx += blockDim.x) {
    const int i = idx / m.E, e = idx % m.E;
    p.cnt[e * m.B + i] =
        (unsigned char)min(max(m.counts[idx], 0), m.C);
  }
  __syncthreads();
  int base = 0;
  for (int e0 = 0; e0 < m.E; e0 += blockDim.x) {
    const int e = e0 + threadIdx.x;
    int ng = 0;
    if (e < m.E) {
      int n = 0;
      for (int i = 0; i < m.B; ++i) n += p.cnt[e * m.B + i];
      ng = (n + ROWS - 1) / ROWS;
    }
    int total;
    const int at = base + block_exclusive_scan(ng, scratch, &total);
    for (int g = 0; g < ng && at + g < m.n_groups_max; ++g)
      p.groups[at + g] = (e << 8) | g;
    base += total;
  }
  __syncthreads();
  p.n_groups = min(base, m.n_groups_max);
}

// Kept rows of expert e: n, and the flat dispatch row of its r-th one.
__device__ __forceinline__ int kept_count(const Plan& p, int B, int e) {
  int n = 0;
  for (int i = 0; i < B; ++i) n += p.cnt[e * B + i];
  return n;
}
__device__ __forceinline__ int kept_row(const Plan& p, int B, int E, int C,
                                        int e, int r) {
  for (int i = 0; i < B; ++i) {
    const int c = p.cnt[e * B + i];
    if (r < c) return (i * E + e) * C + r;
    r -= c;
  }
  return -1;
}

// ------------------------------------------------ the shared pipeline ----

// Stage layout: [weights of each matrix: kb rows x rsb bytes][x: ROWS rows
// x (kb + 16) bytes] (the x rows padded so a warp's fragment reads meet no
// bank conflict).
struct Stage {
  int kb, rsb, xrs, mats, bytes;
  __device__ __forceinline__ int x_off() const { return mats * kb * rsb; }
};

// The x rows of row group `grp` of expert e at k rows [k0, k0 + kb): one
// 16-byte copy a (row, chunk), rows past the group's kept ones zero-filled.
__device__ __forceinline__ void issue_x(unsigned char* st, const Stage& S,
                                        const Plan& p, const int8_t* x,
                                        size_t ld, int n_rows, int B, int E,
                                        int C, int e, int grp, int k0,
                                        int kmax) {
  const int per = S.kb >> 4;
  for (int idx = threadIdx.x; idx < n_rows * per; idx += blockDim.x) {
    const int r = idx / per, c = idx % per;
    const int rr = grp * ROWS + r;
    const int row = rr < kept_count(p, B, e) ? kept_row(p, B, E, C, e, rr)
                                             : -1;
    const int k = k0 + 16 * c;
    const bool ok = row >= 0 && k < kmax;
    cp_async16(st + S.x_off() + r * S.xrs + 16 * c,
               ok ? x + (size_t)row * ld + k : x, ok);
  }
}

// Σqx of the stage's x rows, added to xsum[r] (shared-memory atomics:
// integer, exact in any order).
__device__ __forceinline__ void add_xsum(const unsigned char* xt,
                                         const Stage& S, int n_rows,
                                         int* xsum) {
  const int per = S.kb >> 4;
  for (int idx = threadIdx.x; idx < n_rows * per; idx += blockDim.x) {
    const int r = idx / per, c = idx % per;
    const int4 v = *reinterpret_cast<const int4*>(xt + r * S.xrs + 16 * c);
    int s = __dp4a(v.x, 0x01010101, 0);
    s = __dp4a(v.y, 0x01010101, s);
    s = __dp4a(v.z, 0x01010101, s);
    s = __dp4a(v.w, 0x01010101, s);
    atomicAdd(xsum + r, s);
  }
}

// One 32-deep k step of a warp's 32 columns x TT token tiles: the A
// fragments of both m16 tiles from the swizzled stage, the B fragments
// from the x rows, TT x 2 MMAs.
template <int TT>
__device__ __forceinline__ void mma_step(const unsigned char* wt, int rsb,
                                         const unsigned char* xt, int xrs,
                                         int kk, int cw, int (*acc)[TT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int chunk = ((cw + 4 * g) >> 4) ^ (t << 1);
  const int cb = (chunk << 4) + 4 * (g & 3);
  int w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = *reinterpret_cast<const int*>(wt + (kk + 4 * t + i) * rsb + cb);
    w[4 + i] = *reinterpret_cast<const int*>(wt + (kk + 16 + 4 * t + i) * rsb
                                             + cb);
  }
  int lo[4], hi[4];
  transpose4(w[0], w[1], w[2], w[3], lo);
  transpose4(w[4], w[5], w[6], w[7], hi);
#pragma unroll
  for (int tt = 0; tt < TT; ++tt) {
    const unsigned char* xr = xt + (8 * tt + g) * xrs + kk + 4 * t;
    const int b0 = *reinterpret_cast<const int*>(xr);
    const int b1 = *reinterpret_cast<const int*>(xr + 16);
    mma_s8(acc[0][tt], lo[0], lo[1], hi[0], hi[1], b0, b1);
    mma_s8(acc[1][tt], lo[2], lo[3], hi[2], hi[3], b0, b1);
  }
}

// Which column (0..3 of the thread's 4) and token (of 8 tt + 2 t + 0/1) an
// accumulator register holds: m16 tile mt row g is column 2 mt, row g + 8
// column 2 mt + 1; registers 0, 1 are row g, 2, 3 row g + 8.
__device__ __forceinline__ int acc_col(int mt, int reg) {
  return 2 * mt + (reg >> 1);
}

// ---------------------------------------------------------------- (a) ----

template <int TT>
__global__ void __launch_bounds__(512, 1)
moe_gate_up_kernel(Moe m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rsb = (m.BF + 127) & ~127;
  Stage S;
  S.kb = rsb <= 256 ? 64 : 32;
  S.rsb = rsb;
  S.xrs = S.kb + 16;
  S.mats = 2;
  S.bytes = 2 * S.kb * rsb + ROWS * S.xrs;
  unsigned char* ring = smem;
  // the down launch may start now: its blocks write the zero rows and
  // build their work list, then wait for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  Plan p;
  p.cnt = ring + STAGES * S.bytes;
  p.groups = reinterpret_cast<int*>(p.cnt + ((m.E * m.B + 15) & ~15));
  int* scratch = p.groups + m.n_groups_max;               // 64
  int* rows_s = scratch + 64;                             // ROWS
  int* xsum_s = rows_s + ROWS;                            // ROWS
  float* red_mn = reinterpret_cast<float*>(xsum_s + ROWS);  // 16 x ROWS
  float* red_mx = red_mn + 16 * ROWS;
  int* red_sum = reinterpret_cast<int*>(red_mx + 16 * ROWS);
  float* sc_s = reinterpret_cast<float*>(red_sum + 16 * ROWS);
  float* zp_s = sc_s + ROWS;
  build_plan(m, p, scratch);

  const int nf = m.nf;
  const int n_items = p.n_groups * nf;
  const int my_items = n_items > (int)blockIdx.x
                           ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int spi = (m.D + S.kb - 1) / S.kb;           // stages an item
  const int total = my_items * spi;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int cw = 32 * warp;                  // the warp's first column
  const int g = lane >> 2, t = lane & 3;
  const int bchunks = m.BF >> 4;
  for (int r = tid; r < ROWS; r += blockDim.x) xsum_s[r] = 0;

  auto item_of = [&](int q, int& e, int& grp, int& j) {
    const int it = blockIdx.x + q * gridDim.x;
    const int ge = p.groups[it / nf];
    e = ge >> 8;
    grp = ge & 255;
    j = it % nf;
  };
  // the thread's weight copies of a stage, the same every stage: kb / 8
  // of them (2 kb rows x bf / 16 chunks over bf threads), their offsets in
  // the stage and from the stage's first weight row
  const int n_cp = S.kb / 8;
  int cp_dst[8], cp_src[8], cp_k[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = tid + i * blockDim.x;
    const int mat = idx / (S.kb * bchunks), rem = idx % (S.kb * bchunks);
    const int k = rem / bchunks, c = rem % bchunks;
    cp_dst[i] = mat * S.kb * rsb + w_off(k, c, rsb);
    cp_src[i] = k * m.F + 16 * c;
    cp_k[i] = mat ? -1 - k : k;            // the up matrix's rows < 0
  }
  auto issue = [&](int s) {
    const int q = s / spi, ks = s % spi;
    int e, grp, j;
    item_of(q, e, grp, j);
    unsigned char* st = ring + (s % STAGES) * S.bytes;
    const int k0 = ks * S.kb;
    const size_t base = ((size_t)e * m.D + k0) * m.F + (size_t)j * m.BF;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < n_cp) {
        const bool up = cp_k[i] < 0;
        const int k = up ? -1 - cp_k[i] : cp_k[i];
        const bool ok = k0 + k < m.D;
        cp_async16(st + cp_dst[i],
                   (up ? m.qwu : m.qwg) + (ok ? base + cp_src[i] : 0), ok);
      }
    }
    issue_x(st, S, p, m.qx, m.D, 8 * TT, m.B, m.E, m.C, e, grp, k0, m.D);
  };

  int acc_g[2][TT][4], acc_u[2][TT][4];
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < total) issue(s + STAGES - 1);
    cp_commit();
    const int q = s / spi, ks = s % spi;
    int e, grp, j;
    item_of(q, e, grp, j);
    if (ks == 0) {                   // an item starts
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int tt = 0; tt < TT; ++tt)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc_g[mt][tt][r] = acc_u[mt][tt][r] = 0;
      if (tid < ROWS) {
        const int r = grp * ROWS + tid;
        rows_s[tid] = r < kept_count(p, m.B, e)
                          ? kept_row(p, m.B, m.E, m.C, e, r) : -1;
      }
      if (tid == 0 && m.wbytes)
        atomicAdd(m.wbytes, 2ull * m.D * m.BF);
    }
    const unsigned char* st = ring + (s % STAGES) * S.bytes;
    const unsigned char* xt = st + S.x_off();
    if (cw < m.BF) {
      for (int kk = 0; kk < S.kb; kk += 32) {
        mma_step<TT>(st, rsb, xt, S.xrs, kk, cw, acc_g);
        mma_step<TT>(st + S.kb * rsb, rsb, xt, S.xrs, kk, cw, acc_u);
      }
    }
    add_xsum(xt, S, 8 * TT, xsum_s);   // Σqx of the group's rows
    if (ks != spi - 1) continue;

    // ---- the item's epilogue: silu(g)*u and the slab's requantize ----
    __syncthreads();
    const size_t wcol = (size_t)e * m.F + (size_t)j * m.BF + cw + 4 * g;
    float4 sg = make_float4(0.f, 0.f, 0.f, 0.f), zg = sg, su = sg, zu = sg;
    int4 qg = make_int4(0, 0, 0, 0), qu = qg;
    const bool colok = cw < m.BF;
    if (colok) {
      sg = *reinterpret_cast<const float4*>(m.swg + wcol);
      zg = *reinterpret_cast<const float4*>(m.zwg + wcol);
      qg = *reinterpret_cast<const int4*>(m.wsg + wcol);
      su = *reinterpret_cast<const float4*>(m.swu + wcol);
      zu = *reinterpret_cast<const float4*>(m.zwu + wcol);
      qu = *reinterpret_cast<const int4*>(m.wsu + wcol);
    }
    const float swg4[4] = {sg.x, sg.y, sg.z, sg.w};
    const float zwg4[4] = {zg.x, zg.y, zg.z, zg.w};
    const int wsg4[4] = {qg.x, qg.y, qg.z, qg.w};
    const float swu4[4] = {su.x, su.y, su.z, su.w};
    const float zwu4[4] = {zu.x, zu.y, zu.z, zu.w};
    const int wsu4[4] = {qu.x, qu.y, qu.z, qu.w};
    const float kf = (float)m.D;
#pragma unroll
    for (int tt = 0; tt < TT; ++tt) {
      float a[2][4];                 // [token 2t + h][column]
      int rowh[2];
      float sxh[2], zxh[2];
      int xsh[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tok = 8 * tt + 2 * t + h;
        rowh[h] = rows_s[tok];
        sxh[h] = rowh[h] >= 0 ? m.sx[rowh[h]] : 0.f;
        zxh[h] = rowh[h] >= 0 ? m.zx[rowh[h]] : 0.f;
        xsh[h] = xsum_s[tok];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int c = acc_col(mt, r), h = r & 1;
          const float gv = epilogue(acc_g[mt][tt][r], sxh[h], zxh[h],
                                    swg4[c], zwg4[c], wsg4[c], xsh[h], kf);
          const float uv = epilogue(acc_u[mt][tt][r], sxh[h], zxh[h],
                                    swu4[c], zwu4[c], wsu4[c], xsh[h], kf);
          a[h][c] = (gv * (1.0f / (1.0f + expf(-gv)))) * uv;
        }
      // per-token min / max over the slab's columns
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mn = fminf(fminf(a[h][0], a[h][1]), fminf(a[h][2], a[h][3]));
        float mx = fmaxf(fmaxf(a[h][0], a[h][1]), fmaxf(a[h][2], a[h][3]));
        for (int o = 4; o < 32; o <<= 1) {
          mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        }
        if (g == 0) {
          red_mn[warp * ROWS + 2 * t + h] = colok ? mn : INFINITY;
          red_mx[warp * ROWS + 2 * t + h] = colok ? mx : -INFINITY;
        }
      }
      __syncthreads();
      if (tid < 8) {
        float mn = INFINITY, mx = -INFINITY;
        for (int w = 0; w < nwarps; ++w) {
          mn = fminf(mn, red_mn[w * ROWS + tid]);
          mx = fmaxf(mx, red_mx[w * ROWS + tid]);
        }
        const float s = fmaxf((mx - mn) * (1.0f / 255.0f), 1e-8f);
        sc_s[tid] = s;
        zp_s[tid] = rintf(__fdiv_rn(-mn, s));
      }
      __syncthreads();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tok = 2 * t + h;
        const float s = sc_s[tok], z = zp_s[tok];
        int part = 0;
        unsigned packed = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float qv = rintf(__fdiv_rn(a[h][c], s)) + z;
          qv = fminf(fmaxf(qv, 0.0f), 255.0f);
          const int code = (int)(qv - 128.0f);
          part += code;
          packed |= (unsigned)(code & 0xff) << (8 * c);
        }
        if (colok && rowh[h] >= 0)
          *reinterpret_cast<unsigned*>(m.qa + (size_t)rowh[h] * m.F +
                                       (size_t)j * m.BF + cw + 4 * g) = packed;
        for (int o = 4; o < 32; o <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (g == 0) red_sum[warp * ROWS + tok] = colok ? part : 0;
      }
      __syncthreads();
      if (tid < 8) {
        const int row = rows_s[8 * tt + tid];
        int sum = 0;
        for (int w = 0; w < nwarps; ++w) sum += red_sum[w * ROWS + tid];
        if (row >= 0) {
          m.sa[(size_t)row * nf + j] = sc_s[tid];
          m.za[(size_t)row * nf + j] = zp_s[tid] - 128.0f;
          m.qas[(size_t)row * nf + j] = sum;
        }
      }
      __syncthreads();
    }
    for (int r = tid; r < ROWS; r += blockDim.x) xsum_s[r] = 0;
  }
  cp_wait<0>();
}

// ---------------------------------------------------------------- (b) ----

template <int TT, typename TO>
__global__ void __launch_bounds__(DOWN_THREADS)
moe_down_kernel(Moe m) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage S;
  S.kb = m.BF % 64 == 0 ? 64 : 32;
  S.rsb = DOWN_COLS;
  S.xrs = S.kb + 16;
  S.mats = 1;
  S.bytes = S.kb * DOWN_COLS + ROWS * S.xrs;
  unsigned char* ring = smem;
  Plan p;
  p.cnt = ring + STAGES * S.bytes;
  p.groups = reinterpret_cast<int*>(p.cnt + ((m.E * m.B + 15) & ~15));
  int* scratch = p.groups + m.n_groups_max;
  int* rows_s = scratch + 64;
  TO* out = static_cast<TO*>(m.out);

  // rows at or past each bucket's count: exact zeros
  const int nrow = m.B * m.E * m.C;
  for (int rr = blockIdx.x; rr < nrow; rr += gridDim.x) {
    const int i = rr / (m.E * m.C), e = (rr / m.C) % m.E, c = rr % m.C;
    if (c < min(max(m.counts[i * m.E + e], 0), m.C)) continue;
    for (int col = threadIdx.x; col < m.D; col += blockDim.x)
      store_f(out + (size_t)rr * m.D + col, 0.0f);
  }
  build_plan(m, p, scratch);

  const int nf = m.nf;
  const int tiles = (m.D + DOWN_COLS - 1) / DOWN_COLS;
  const int n_items = p.n_groups * tiles;
  const int my_items = n_items > (int)blockIdx.x
                           ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int spi = m.F / S.kb;
  const int per_slab = m.BF / S.kb;
  const int total = my_items * spi;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto item_of = [&](int q, int& e, int& grp, int& n0) {
    const int it = blockIdx.x + q * gridDim.x;
    const int ge = p.groups[it / tiles];
    e = ge >> 8;
    grp = ge & 255;
    n0 = (it % tiles) * DOWN_COLS;
  };
  // the thread's weight copies of a stage: kb / 16 of them (kb rows x 16
  // chunks over 256 threads), one chunk column each
  const int n_cp = S.kb / 16;
  const int cp_c = tid % (DOWN_COLS / 16);
  int cp_dst[4], cp_src[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = (tid + i * DOWN_THREADS) / (DOWN_COLS / 16);
    cp_dst[i] = w_off(k, cp_c, DOWN_COLS);
    cp_src[i] = k * m.D + 16 * cp_c;
  }
  auto issue = [&](int s) {
    const int q = s / spi, ks = s % spi;
    int e, grp, n0;
    item_of(q, e, grp, n0);
    unsigned char* st = ring + (s % STAGES) * S.bytes;
    const int k0 = ks * S.kb;
    const bool ok = n0 + 16 * cp_c < m.D;
    const size_t base = ((size_t)e * m.F + k0) * m.D + n0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n_cp)
        cp_async16(st + cp_dst[i], m.qwd + (ok ? base + cp_src[i] : 0), ok);
    issue_x(st, S, p, m.qa, m.F, 8 * TT, m.B, m.E, m.C, e, grp, k0, m.F);
  };

  int acc[2][TT][4];
  float facc[2][TT][4];
  float sw4[4], zw4[4];
  const float kf = (float)m.BF;
  // the gate/up launch's codes and scales are complete past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) issue(s);
    cp_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (s + STAGES - 1 < total) issue(s + STAGES - 1);
    cp_commit();
    const int q = s / spi, ks = s % spi;
    int e, grp, n0;
    item_of(q, e, grp, n0);
    const int col = n0 + 32 * warp + 4 * g;   // the thread's 4 columns
    const bool colok = col < m.D;
    if (ks == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int tt = 0; tt < TT; ++tt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[mt][tt][r] = 0;
            facc[mt][tt][r] = 0.0f;
          }
      if (tid < ROWS) {
        const int r = grp * ROWS + tid;
        rows_s[tid] = r < kept_count(p, m.B, e)
                          ? kept_row(p, m.B, m.E, m.C, e, r) : -1;
      }
      if (tid == 0 && m.wbytes)
        atomicAdd(m.wbytes,
                  (unsigned long long)m.F * min(DOWN_COLS, m.D - n0));
      const size_t wc = (size_t)e * m.D + (colok ? col : 0);
      const float4 sv = *reinterpret_cast<const float4*>(m.swd + wc);
      const float4 zv = *reinterpret_cast<const float4*>(m.zwd + wc);
      sw4[0] = sv.x; sw4[1] = sv.y; sw4[2] = sv.z; sw4[3] = sv.w;
      zw4[0] = zv.x; zw4[1] = zv.y; zw4[2] = zv.z; zw4[3] = zv.w;
      __syncthreads();               // rows_s
    }
    const unsigned char* st = ring + (s % STAGES) * S.bytes;
    if (32 * warp < m.D - n0) {
      for (int kk = 0; kk < S.kb; kk += 32)
        mma_step<TT>(st, DOWN_COLS, st + S.x_off(), S.xrs, kk,
                     32 * warp, acc);
    }
    if ((ks + 1) % per_slab == 0) {  // a slab ends: its epilogue, in order
      const int j = ks / per_slab;
      const int4 wv = colok ? *reinterpret_cast<const int4*>(
                                  m.wsd + ((size_t)e * nf + j) * m.D + col)
                            : make_int4(0, 0, 0, 0);
      const int ws4[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int tt = 0; tt < TT; ++tt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rows_s[8 * tt + 2 * t + h];
          if (row < 0) continue;
          const size_t rj = (size_t)row * nf + j;
          const float sa = m.sa[rj], za = m.za[rj];
          const int xs = m.qas[rj];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = 2 * hh + h, c = acc_col(mt, r);
              facc[mt][tt][r] = facc[mt][tt][r] +
                  epilogue(acc[mt][tt][r], sa, za, sw4[c], zw4[c], ws4[c],
                           xs, kf);
              acc[mt][tt][r] = 0;
            }
        }
    }
    if (ks == spi - 1 && colok) {    // the item's output rows
#pragma unroll
      for (int tt = 0; tt < TT; ++tt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rows_s[8 * tt + 2 * t + h];
          if (row < 0) continue;
          TO* o = out + (size_t)row * m.D + col;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int mt = c >> 1, r = 2 * (c & 1) + h;
            store_f(o + c, facc[mt][tt][r]);
          }
        }
    }
  }
  cp_wait<0>();
}

// The shared-memory layout's size: the ring, the counts, the work list and
// the epilogue's scratch.
size_t smem_bytes(const Moe& m, int stage_bytes, bool gate_up) {
  size_t b = (size_t)STAGES * stage_bytes + ((m.E * m.B + 15) & ~15) +
             4 * ((size_t)m.n_groups_max + 64 + ROWS);
  if (gate_up) b += 4 * (ROWS + 3 * 16 * ROWS + 2 * ROWS);
  return b;
}

// Blocks an SM holds of `Kernel` with `smem` bytes, and its shared-memory
// attribute: set once per card (the attribute belongs to the card's
// context), bit d of `sized` for card d; the occupancy is kept per card for
// the last size asked.
template <auto Kernel>
cudaError_t prepare(int threads, size_t smem, int* per_sm) {
  static unsigned sized = 0u;
  static size_t cached_smem[32];
  static int cached_fit[32];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !((sized >> dev) & 1u)) {
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err != cudaSuccess) return err;
    if (dev < 32) sized |= 1u << dev;
  }
  if (dev < 32 && cached_smem[dev] == smem && cached_fit[dev] > 0) {
    *per_sm = cached_fit[dev];
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, Kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  if (dev < 32) {
    cached_smem[dev] = smem;
    cached_fit[dev] = *per_sm;
  }
  return cudaSuccess;
}

template <int TT>
cudaError_t launch_gate_up(const Moe& m, int sms, cudaStream_t st) {
  const int rsb = (m.BF + 127) & ~127;
  const int kb = rsb <= 256 ? 64 : 32;
  const int threads = 32 * (m.BF / 32);
  const size_t smem =
      smem_bytes(m, 2 * kb * rsb + ROWS * (kb + 16), true);
  int per_sm = 0;
  cudaError_t err = prepare<moe_gate_up_kernel<TT>>(threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  moe_gate_up_kernel<TT><<<sms * per_sm, threads, smem, st>>>(m);
  return cudaGetLastError();
}

template <int TT, typename TO>
cudaError_t launch_down(const Moe& m, int sms, cudaStream_t st) {
  const int kb = m.BF % 64 == 0 ? 64 : 32;
  const size_t smem =
      smem_bytes(m, kb * DOWN_COLS + ROWS * (kb + 16), false);
  int per_sm = 0;
  cudaError_t err =
      prepare<moe_down_kernel<TT, TO>>(DOWN_THREADS, smem, &per_sm);
  if (err != cudaSuccess) return err;
  // a programmatic dependent launch: its prologue overlaps the gate/up
  // launch's last items
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sms * per_sm);
  cfg.blockDim = dim3(DOWN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, moe_down_kernel<TT, TO>, m);
}

template <int TT>
cudaError_t launch_all(const Moe& m, int out_bf16, int sms,
                       cudaStream_t st) {
  cudaError_t err = launch_gate_up<TT>(m, sms, st);
  if (err != cudaSuccess) return err;
  return out_bf16 ? launch_down<TT, __nv_bfloat16>(m, sms, st)
                  : launch_down<TT, float>(m, sms, st);
}

}  // namespace

// tt: token tiles of 8 rows multiplied against each weight tile (the
// wrapper sizes it by the most kept rows an expert can have, B * C, up to
// TT_MAX); n_groups_max: the work list's room, E * ceil(B * C / 32).
extern "C" int stamp_grouped_moe(
    const void* qx, const float* sx, const float* zx, const int* counts,
    int B, int E, int C, int D, int F, int BF, const void* qwg,
    const float* swg, const float* zwg, const int* wsg, const void* qwu,
    const float* swu, const float* zwu, const int* wsu, const void* qwd,
    const float* swd, const float* zwd, const int* wsd, void* qa, float* sa,
    float* za, int* qas, void* out, int out_bf16, int tt, int n_groups_max,
    int sms, void* wbytes, void* stream) {
  if (D % 16 || BF % 32 || BF > MAX_BF || F % BF || C > 255 || C < 1 ||
      (B * C + ROWS - 1) / ROWS > 256 || E >= (1 << 23) || sms < 1)
    return (int)cudaErrorInvalidValue;
  Moe m{static_cast<const int8_t*>(qx), sx, zx, counts, B, E, C, D, F, BF,
        F / BF, n_groups_max,
        static_cast<const int8_t*>(qwg), swg, zwg, wsg,
        static_cast<const int8_t*>(qwu), swu, zwu, wsu,
        static_cast<const int8_t*>(qwd), swd, zwd, wsd,
        static_cast<int8_t*>(qa), sa, za, qas, out,
        static_cast<unsigned long long*>(wbytes)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tt) {
    case 1: return (int)launch_all<1>(m, out_bf16, sms, st);
    case 2: return (int)launch_all<2>(m, out_bf16, sms, st);
    case 4: return (int)launch_all<4>(m, out_bf16, sms, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
