// The long-span link of the fused STaMP linears for Hopper (sm_90a):
// stamp_span_transform.
//
// Replaces no TPU kernel of its own.  It is the third link of the chain that
// replaces stamp_quant_matmul_pallas / stamp_quant_dual_matmul_pallas
// (src/repro/kernels/stamp_matmul.py) over spans longer than K2's 128-row
// tile (csrc/stamp_matmul.cu, "long spans"): forward, the f32 sequence
// transform of the bf16 or f32 activation for K1 to quantize with transform
// none; inverse, the inverse transform of K2's f32 products, then the bias,
// the dual silu(g + b)*(u + b_up) and the cast to the output type.  Every
// value goes through the plain version's operations in its order, so the
// result is the same bits (built with -fmad=false: the WHT's scale and the
// bias stay a multiply and an add).
//
// Bound on the H100: bytes, one read and one write of the tensor (two reads
// for the dual).  The transform is a few adds a value; what costs is
// moving the rows, so both designs read each row once, in 16-byte pieces
// along N, with many loads in flight, and fuse the epilogue into the store.
//
// Haar DWT: row windows.  The host runs the transform symbolically and plans
// windows of 16 output rows (32 forward) (kernels/stamp_matmul.py:
// span_passes, row_windows, as K1 does): each window's input rows, its
// butterflies on slots in the plain version's order, and which slot holds
// which output row.  An inverse output row needs its detail row at every
// level and one approximation, so a window of 16 rows loads 16 rows and
// one more a level past the fourth (rows that neighbouring windows share
// are loaded again, from L2).  A block takes one (span, window) over a
// strip of up to 256 columns: it copies the window's rows into shared
// memory (cp.async for f32, eight loads in flight a thread for bf16), runs
// the butterflies one column a thread (each thread down its own column: no
// barrier between them), and stores the output rows with the epilogue.  A
// forward window of an approximation row needs 2^levels input rows, so the
// forward runs as many levels a launch as its windows hold, the low-pass
// band (contiguous at the front of the span) going to an f32 scratch that
// the next launch reads as its span: each value still goes through the
// same operations in the same order.
//
// WHT: K10's sequence-mode tile (csrc/wht_tile.cuh): a block transforms the
// p-row block of one span (rows 1..p under skip_first) for w columns in
// register phases of three position bits with XOR-swizzled exchanges
// through shared memory.  Its last phase scales by f32(1/sqrt p) and adds
// the bias; the dual transforms the up products first and keeps them in a
// second shared tile, then the gate's last phase applies silu(g)*u and the
// cast.  Where a block cannot hold the p rows, the stages run over more
// launches through f32 scratch (as K10 splits them), each launch taking the
// next range of stage bits.  The rows outside the block (the sink row, the
// rows past p) pass through the first launch's blocks of tile 0, which
// split them as one run of 16-byte pieces, with the epilogue.

#include <type_traits>

#include "wht_tile.cuh"

namespace {

using namespace wht_tile;

constexpr int SL_HDR = 8;            // ints of a window's program header
constexpr int SL_MAX_COLS = 256;     // columns of a window block's strip
constexpr int SL_BATCH = 8;          // 16-byte loads a thread has in flight
constexpr int WL_MAX_THREADS = 1024;

// jax.nn.silu's steps, then the product with the up value
__device__ __forceinline__ float silu_mul(float g, float u) {
  return (g * (1.0f / (1.0f + expf(-g)))) * u;
}

// four bias values from column c (those below N)
__device__ __forceinline__ float4 bias4(const float* b, int c, int N) {
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < N) v[e] = __ldg(b + c + e);
  return make_float4(v[0], v[1], v[2], v[3]);
}

// the epilogue of four columns from c: bias, then the dual's silu(g)*u
template <bool DUAL>
__device__ __forceinline__ float4 epilogue(float4 g, float4 u,
                                           const float* b0, const float* b1,
                                           int c, int N) {
  if (b0) {
    const float4 b = bias4(b0, c, N);
    g = make_float4(g.x + b.x, g.y + b.y, g.z + b.z, g.w + b.w);
  }
  if (DUAL) {
    if (b1) {
      const float4 b = bias4(b1, c, N);
      u = make_float4(u.x + b.x, u.y + b.y, u.z + b.z, u.w + b.w);
    }
    g = make_float4(silu_mul(g.x, u.x), silu_mul(g.y, u.y),
                    silu_mul(g.z, u.z), silu_mul(g.w, u.w));
  }
  return g;
}

// four columns from c of a row at p: one vector access (vec) or the ones
// below N
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int c, int N, bool vec) {
  if (vec) return ld4(p);
  float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < N) v[e] = ld(p + e);
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 a, int c, int N,
                                       bool vec) {
  if (vec) {
    st4(p, a);
    return;
  }
  const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (c + e < N) st(p + e, v[e]);
}

// ------------------------------------------------------------ windows ----

// Block (x = span * n_win + window, y = column strip of blockDim.x columns):
// the window's program (kernels/stamp_matmul.py: tq_program) into shared
// memory, its input rows of x0 (and x1) into slots [row][column], the
// butterflies, then each output (slot, row): row >= 0 an output row of out
// with the epilogue, row < 0 row -1 - row of the f32 scratch.
template <typename TI, typename TO, bool DUAL>
__global__ void __launch_bounds__(SL_MAX_COLS)
window_kernel(const TI* __restrict__ x0, const TI* __restrict__ x1,
              int S_in, int N, const int* __restrict__ prog, int n_win,
              int room, float r, const float* __restrict__ b0,
              const float* __restrict__ b1, TO* __restrict__ out, int S_out,
              float* __restrict__ scr0, float* __restrict__ scr1, int S_scr,
              int vec) {
  extern __shared__ __align__(16) int pg[];
  const int C = blockDim.x, tid = threadIdx.x, V = C / 4;
  const int win = blockIdx.x % n_win, span = blockIdx.x / n_win;
  const int n0 = blockIdx.y * C;
  const int* hdr = prog + SL_HDR * win;
  const int ni = hdr[0], nops = hdr[1], nout = hdr[2];
  for (int i = tid; i < ni + nops + 2 * nout; i += C)
    pg[i] = prog[hdr[3] + i];
  const int* ins = pg;
  const int* ops = pg + ni;
  const int* outs = pg + ni + nops;
  float* X0 = reinterpret_cast<float*>(pg + room);
  float* X1 = X0 + (size_t)ni * C;
  __syncthreads();

  const size_t in_base = (size_t)span * S_in * N;
  const int items = ni * V;
  if constexpr (std::is_same<TI, float>::value) {
    // f32 rows straight into the slots (cp.async: no registers held)
    for (int i = tid; i < items; i += C) {
      const int c = n0 + 4 * (i % V);
      const size_t g = in_base + (size_t)ins[i / V] * N + c;
      const size_t at = (size_t)(i / V) * C + 4 * (i % V);
      if (vec && c < N) {
        cp_async16(X0 + at, x0 + g);
        if (DUAL) cp_async16(X1 + at, x1 + g);
      } else {
        *reinterpret_cast<float4*>(X0 + at) = load4(x0 + g, c, N, false);
        if (DUAL)
          *reinterpret_cast<float4*>(X1 + at) = load4(x1 + g, c, N, false);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {       // bf16 rows: eight 8-byte loads in flight a thread
    for (int i0 = 0; i0 < items; i0 += SL_BATCH * C) {
      float4 v0[SL_BATCH], v1[SL_BATCH];
#pragma unroll
      for (int k = 0; k < SL_BATCH; ++k) {
        const int i = i0 + k * C + tid;
        const int c = n0 + 4 * (i % V);
        if (i < items && c < N) {
          const size_t g = in_base + (size_t)ins[i / V] * N + c;
          v0[k] = load4(x0 + g, c, N, vec);
          if (DUAL) v1[k] = load4(x1 + g, c, N, vec);
        } else {
          v0[k] = v1[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int k = 0; k < SL_BATCH; ++k) {
        const int i = i0 + k * C + tid;
        if (i < items) {
          const size_t at = (size_t)(i / V) * C + 4 * (i % V);
          *reinterpret_cast<float4*>(X0 + at) = v0[k];
          if (DUAL) *reinterpret_cast<float4*>(X1 + at) = v1[k];
        }
      }
    }
  }
  __syncthreads();

  // the butterflies (a, b) -> ((a + b) r, (a - b) r), one column a thread
  for (int k = 0; k < nops; ++k) {
    const int op = ops[k];
    const int i = ((op >> 14) & 0x3fff) * C + tid, j = (op & 0x3fff) * C + tid;
    const float a = X0[i], b = X0[j];
    X0[i] = (a + b) * r;
    X0[j] = (a - b) * r;
    if (DUAL) {
      const float c = X1[i], d = X1[j];
      X1[i] = (c + d) * r;
      X1[j] = (c - d) * r;
    }
  }
  __syncthreads();

  const size_t out_base = (size_t)span * S_out * N;
  const size_t scr_base = (size_t)span * S_scr * N;
  for (int i = tid; i < nout * V; i += C) {
    const int o = i / V, c4 = 4 * (i % V), c = n0 + c4;
    if (c >= N) continue;
    const int sl = outs[2 * o], dst = outs[2 * o + 1];
    const float4 g =
        *reinterpret_cast<const float4*>(X0 + (size_t)sl * C + c4);
    if (dst < 0) {
      const size_t at = scr_base + (size_t)(-1 - dst) * N + c;
      store4(scr0 + at, g, c, N, vec);
      if (DUAL)
        store4(scr1 + at,
               *reinterpret_cast<const float4*>(X1 + (size_t)sl * C + c4), c,
               N, vec);
    } else {
      float4 u = g;
      if (DUAL) u = *reinterpret_cast<const float4*>(X1 + (size_t)sl * C + c4);
      store4(out + out_base + (size_t)dst * N + c,
             epilogue<DUAL>(g, u, b0, b1, c, N), c, N, vec);
    }
  }
}

template <typename TI, typename TO, bool DUAL>
cudaError_t launch_windows(const void* x0, const void* x1, int S_in, int B,
                           int N, const int* prog, int n_win, int room,
                           int cols, int smem, float r, const float* b0,
                           const float* b1, void* out, int S_out, float* scr0,
                           float* scr1, int S_scr, cudaStream_t st) {
  // 16-byte rows pieces (8-byte in bf16) where N and the pointers allow
  const auto aligned = [](const void* p, size_t a) {
    return p == nullptr || reinterpret_cast<uintptr_t>(p) % a == 0;
  };
  const int vec = N % 4 == 0 && aligned(x0, 4 * sizeof(TI)) &&
                  aligned(x1, 4 * sizeof(TI)) &&
                  aligned(out, 4 * sizeof(TO)) && aligned(scr0, 16) &&
                  aligned(scr1, 16);
  cudaError_t e = cudaFuncSetAttribute(
      window_kernel<TI, TO, DUAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((long long)B * n_win), (N + cols - 1) / cols);
  window_kernel<TI, TO, DUAL><<<grid, cols, smem, st>>>(
      static_cast<const TI*>(x0), static_cast<const TI*>(x1), S_in, N, prog,
      n_win, room, r, b0, b1, static_cast<TO*>(out), S_out, scr0, scr1,
      S_scr, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- WHT ----

// the last-phase policies of a link tile (wht_tile.cuh: phase); `shift`
// moves an input chunk's offset to its place in the output
struct RawOut {           // an earlier launch: f32 into the scratch
  float* y;
  long long shift;
  __device__ __forceinline__ void operator()(const Tile& t, int p, int q,
                                             float4 a) const {
    bool ok;
    const long long off = chunk_off(t, p, q, ok) + shift;
    if (ok) st4(y + off, a);
  }
};

struct KeepUp {           // the dual's up transform, scaled, with its bias
  float4* usm;
  float r;
  const float* b1;
  __device__ __forceinline__ void operator()(const Tile& t, int p, int q,
                                             float4 a) const {
    const int c = t.c0 + 4 * q;
    if (c >= t.nvec) return;
    a = make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
    if (b1) {
      const float4 b = bias4(b1, c, t.nvec);
      a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
    usm[slot((p << t.lq) | q, t.lq)] = a;
  }
};

template <typename TO, bool DUAL>
struct LinkOut {          // the last launch: scale, epilogue, cast
  TO* y;
  long long shift;
  float r;
  const float* b0;
  const float4* usm;
  __device__ __forceinline__ void operator()(const Tile& t, int p, int q,
                                             float4 a) const {
    bool ok;
    const long long off = chunk_off(t, p, q, ok) + shift;
    if (!ok) return;
    a = make_float4(a.x * r, a.y * r, a.z * r, a.w * r);
    float4 u = a;
    if (DUAL) u = usm[slot((p << t.lq) | q, t.lq)];
    st4(y + off, epilogue<DUAL>(a, u, b0, nullptr, t.c0 + 4 * q, t.nvec));
  }
};

// the rows of a span that the WHT leaves as they are (the sink row, the
// rows past the block): the epilogue from x0 (x1) to y, rows relative to
// the block's first row, as one run of four-column chunks that the span's
// `parts` blocks split between them; four chunks in flight a thread
template <typename TI, typename TO, bool DUAL>
__device__ __forceinline__ void copy_rows(const TI* x0, const TI* x1, TO* y,
                                          int part, int parts, int nvec,
                                          long long ax, int crows, int off,
                                          int p, const float* b0,
                                          const float* b1) {
  constexpr int U = 4;
  const int Q = nvec / 4;
  const long long total = (long long)crows * Q;
  const long long per = (total + parts - 1) / parts;
  const long long lo = part * per, hi = lo + per < total ? lo + per : total;
  for (long long i0 = lo + threadIdx.x; i0 < hi; i0 += U * blockDim.x) {
    float4 g[U], u[U];
    long long at[U];
    int c[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const long long i = i0 + (long long)k * blockDim.x;
      const int row = (int)(i / Q);
      c[k] = i < hi ? 4 * (int)(i % Q) : nvec;
      at[k] = (long long)(row < off ? row - off : row + p - off) * ax + c[k];
      if (c[k] < nvec) {
        g[k] = ld4(x0 + at[k]);
        if (DUAL) u[k] = ld4(x1 + at[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < U; ++k)
      if (c[k] < nvec)
        st4(y + at[k], epilogue<DUAL>(g[k], DUAL ? u[k] : g[k], b0, b1,
                                      c[k], nvec));
  }
}

// Block (x, y, z): columns [x*w, x*w + w) of tile y of batch z (grid-strided
// past the grid), element j of column c of tile t at z*bstride + c +
// (t*tmul + j*istride)*ax of the input (in_bstride) and of the output
// (out_bstride).  LAST: scale, epilogue and cast into y0 (TO); else raw f32
// into y0 (and y1 for the dual's up products).  FIRST reads the input and
// its tile-0 blocks (all column groups of a batch) also write the span's
// `crows` rows around the block (its first row at `off`, p rows) into cy
// (TO, cstride a batch).
template <typename TI, typename TO, bool DUAL, bool FIRST, bool LAST>
__global__ void __launch_bounds__(WL_MAX_THREADS)
wht_link_kernel(const TI* x0, const TI* x1, long long in_bstride, void* y0,
                void* y1, long long out_bstride, int batches, int tiles,
                int lt, int tmul, int istride, long long ax, int nvec, int w,
                float r, const float* b0, const float* b1, TO* cy,
                long long cstride, int crows, int off, int p) {
  extern __shared__ float4 sm[];
  const int lw = __ffs(w) - 1;
  float4* usm = sm + ((1 << lt) << (lw - 2));
  for (int z = blockIdx.z; z < batches; z += gridDim.z)
    for (int ty = blockIdx.y; ty < tiles; ty += gridDim.y) {
      Tile t;
      t.chunk_pos = false;
      t.c0 = blockIdx.x * w;
      t.nvec = nvec;
      t.vstride = 1;
      t.pstride = (long long)istride * ax;
      const long long rel = (long long)ty * tmul * ax;
      t.base = (long long)z * in_bstride + rel;
      t.lp = lt;
      t.lq = lw - 2;
      const long long shift = (long long)z * out_bstride + rel - t.base;
      __syncthreads();              // the previous tile's slots are read
      if constexpr (LAST) {
        if constexpr (DUAL) {
          run_tile<false, 3>(t, x1, KeepUp{usm, r, b1}, sm, nullptr, 0,
                             [] {});
          __syncthreads();
        }
        run_tile<false, 3>(
            t, x0, LinkOut<TO, DUAL>{static_cast<TO*>(y0), shift, r, b0, usm},
            sm, nullptr, 0, [] {});
      } else {
        run_tile<false, 3>(t, x0, RawOut{static_cast<float*>(y0), shift}, sm,
                           nullptr, 0, [] {});
        if constexpr (DUAL) {
          __syncthreads();
          run_tile<false, 3>(t, x1, RawOut{static_cast<float*>(y1), shift},
                             sm, nullptr, 0, [] {});
        }
      }
      if constexpr (FIRST)
        if (ty == 0 && crows > 0)
          copy_rows<TI, TO, DUAL>(
              x0 + (long long)z * in_bstride,
              DUAL ? x1 + (long long)z * in_bstride : nullptr,
              cy + (long long)z * cstride, blockIdx.x, gridDim.x, nvec, ax,
              crows, off, p, b0, b1);
    }
}

template <typename TI, typename TO, bool DUAL, bool FIRST, bool LAST>
cudaError_t launch_wht(const void* x0, const void* x1, long long in_bstride,
                       void* y0, void* y1, long long out_bstride, int batches,
                       int T, int tiles, int tmul, int istride, long long ax,
                       int nvec, int w, float r, const float* b0,
                       const float* b1, void* cy, long long cstride,
                       int crows, int off, int p, cudaStream_t st) {
  const long long chunks = (long long)T * w / 4;
  const long long threads = chunks >= 8 ? chunks / 8 : 1;
  const int nthr = (int)(threads < 32 ? 32
                         : threads > WL_MAX_THREADS ? WL_MAX_THREADS
                                                    : threads);
  const size_t smem = (size_t)chunks * sizeof(float4) * (DUAL && LAST ? 2 : 1);
  cudaError_t e = cudaFuncSetAttribute(
      wht_link_kernel<TI, TO, DUAL, FIRST, LAST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((nvec + w - 1) / w, tiles < 65535 ? tiles : 65535,
                  batches < 65535 ? batches : 65535);
  wht_link_kernel<TI, TO, DUAL, FIRST, LAST><<<grid, nthr, smem, st>>>(
      static_cast<const TI*>(x0), static_cast<const TI*>(x1), in_bstride, y0,
      y1, out_bstride, batches, tiles, __builtin_ctz(T), tmul, istride, ax,
      nvec, w, r, b0, b1, static_cast<TO*>(cy), cstride, crows, off, p);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t launch_wht_mode(int dual, int first, int last, const void* x0,
                            const void* x1, long long in_bstride, void* y0,
                            void* y1, long long out_bstride, int batches,
                            int T, int tiles, int tmul, int istride,
                            long long ax, int nvec, int w, float r,
                            const float* b0, const float* b1, void* cy,
                            long long cstride, int crows, int off, int p,
                            cudaStream_t st) {
#define WL_ARGS x0, x1, in_bstride, y0, y1, out_bstride, batches, T, tiles, \
                tmul, istride, ax, nvec, w, r, b0, b1, cy, cstride, crows,  \
                off, p, st
#define WL_DUAL(F, L) (dual ? launch_wht<TI, TO, true, F, L>(WL_ARGS) \
                            : launch_wht<TI, TO, false, F, L>(WL_ARGS))
  if (first) return last ? WL_DUAL(true, true) : WL_DUAL(true, false);
  // later launches read the f32 scratch
  if constexpr (std::is_same<TI, float>::value)
    return last ? WL_DUAL(false, true) : WL_DUAL(false, false);
  return cudaErrorInvalidValue;
#undef WL_DUAL
#undef WL_ARGS
}

}  // namespace

// One launch of row windows (kernels/stamp_matmul.py: span_passes): x0
// (x1: the dual's up values), B spans of S_in rows x N columns, f32 or
// (in_bf16) bf16; prog: n_win windows (tq_program's layout, output row -1 -
// i for scratch row i); `cols` columns a block, `smem` bytes (the
// program's `room` ints, then the slots); out: spans of S_out rows, f32 or
// (out_bf16) bf16, with the optional f32 biases b0 / b1 and the dual's
// silu(g)*u; scr0 / scr1: f32 scratch, spans of S_scr rows.
extern "C" int span_windows(const void* x0, const void* x1, int in_bf16,
                            int S_in, int B, int N, const int* prog,
                            int n_win, int room, int cols, int smem,
                            float inv_sqrt2, const float* b0, const float* b1,
                            void* out, int out_bf16, int S_out, float* scr0,
                            float* scr1, int S_scr, void* stream) {
  if (cols < 32 || cols > SL_MAX_COLS || cols % 32 ||
      n_win < 1 || room % 4 || smem < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
#define SW_ARGS x0, x1, S_in, B, N, prog, n_win, room, cols, smem, \
                inv_sqrt2, b0, b1, out, S_out, scr0, scr1, S_scr, st
  const int k = (x1 != nullptr) * 4 + in_bf16 * 2 + out_bf16;
  switch (k) {
    case 0: return (int)launch_windows<float, float, false>(SW_ARGS);
    case 1: return (int)launch_windows<float, bf, false>(SW_ARGS);
    case 2: return (int)launch_windows<bf, float, false>(SW_ARGS);
    case 3: return (int)launch_windows<bf, bf, false>(SW_ARGS);
    case 4: return (int)launch_windows<float, float, true>(SW_ARGS);
    case 5: return (int)launch_windows<float, bf, true>(SW_ARGS);
    case 6: return (int)launch_windows<bf, float, true>(SW_ARGS);
    default: return (int)launch_windows<bf, bf, true>(SW_ARGS);
  }
#undef SW_ARGS
}

// One launch of the WHT link (kernels/stamp_matmul.py: span_wht_plan) over
// `batches` batches: tiles of T positions, element j of column c of tile t
// at z*bstride + c + (t*tmul + j*istride)*ax of x0 (x1) and of y0 (y1), w
// columns a block; `last` scales by r, adds the biases, combines the dual
// and writes y0 in out_bf16 ? bf16 : f32, else y0 / y1 get raw f32 (and
// in_bf16 = 0 for a launch after the first); `first` also writes the
// crows rows of each span around its p-row block (the block's first row
// at `off`) from x0 (x1) into cy, cstride a span, with the epilogue.
extern "C" int span_wht(const void* x0, const void* x1, int in_bf16,
                        long long in_bstride, void* y0, void* y1,
                        int out_bf16, long long out_bstride, int batches,
                        int T, int tiles, int tmul, int istride, long long ax,
                        int nvec, int w, int first, int last, float r,
                        const float* b0, const float* b1, void* cy,
                        long long cstride, int crows, int off, int p,
                        void* stream) {
  if (T < 1 || (T & (T - 1)) || w < 4 || (w & (w - 1)) || tiles < 1 ||
      batches < 0 || nvec % 4 || (!first && in_bf16) ||
      (first && crows > 0 && cy == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batches == 0 || nvec == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  const int dual = x1 != nullptr;
#define WM_ARGS dual, first, last, x0, x1, in_bstride, y0, y1, out_bstride, \
                batches, T, tiles, tmul, istride, ax, nvec, w, r, b0, b1,   \
                cy, cstride, crows, off, p, st
  switch (in_bf16 * 2 + out_bf16) {
    case 0: return (int)launch_wht_mode<float, float>(WM_ARGS);
    case 1: return (int)launch_wht_mode<float, bf>(WM_ARGS);
    case 2: return (int)launch_wht_mode<bf, float>(WM_ARGS);
    default: return (int)launch_wht_mode<bf, bf>(WM_ARGS);
  }
#undef WM_ARGS
}
