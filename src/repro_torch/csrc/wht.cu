// Orthonormal Walsh-Hadamard transform for Hopper (sm_90a): K10.
//
// Replaces the Pallas kernel wht_pallas (src/repro/kernels/wht.py): the
// WHT of (b, s, d) activations along the sequence (axis -2) or the features
// (axis -1), butterfly stages h = 1, 2, 4, ... in f32 and one scale by
// f32(1/sqrt n) at the end.
//
// Bound on the H100: bytes.  A stage is one add and one subtract per pair,
// log2(n) stages in all, so one read and one write of the activation is
// what it needs.
//
// Design.  A launch transforms tiles of T elements spaced `istride` apart
// along the transform axis; a block takes one tile of `w` vectors.  Its
// values move in chunks of four elements that sit side by side in memory:
// four neighbouring vectors when the vectors are contiguous (sequence mode:
// four columns, 8 bytes of bf16 or 16 of f32), or four neighbouring
// elements of one vector (feature mode), whose two stages run inside the
// chunk first.  The tile is P chunk positions by Q chunk columns.  A thread
// holds R = 8 chunks whose positions differ in three bits and runs those
// three stages in registers; the tile then passes once through shared
// memory (f32, XOR-swizzled so that no access conflicts) and the threads
// take the next three bits.  So a transform of 2^11 positions is four
// register phases with three exchanges in between, where a stage a barrier
// was eleven.  The first phase reads its chunks from device memory and the
// last writes them scaled, so each element is read and written once.
// Every stage is the same elementwise a + b, a - b on the same values in
// stage order, so every output's tree of additions is the plain version's
// and the result is bit for bit its result; no multiply meets an add, so
// no FMA contraction can occur.
//
// A sequence tile of 1024 positions or more is one block an SM, so that
// the loads still overlap the work: the blocks are persistent, and while a
// block runs a tile's later phases, cp.async copies its next tile's raw rows
// (32-byte pieces, rows permuted so that the first phase's reads do not
// conflict) into a staging buffer beside the f32 tile.  Its later phases
// take four bits (16 chunks a thread, 512 threads), so 2^11 positions need
// two exchanges.
//
// Where a tile would not fit a block (long sequences), the wrapper splits
// the stages over two launches through an f32 scratch: the stages h < T1
// on tiles of T1 contiguous positions, then the stages h >= T1 on tiles of
// positions spaced T1 apart.  Vectors of fewer than four elements in feature
// mode take a plain one-thread-a-vector kernel.

#include "wht_tile.cuh"

namespace {

using namespace wht_tile;

constexpr int MAX_THREADS = 1024;
constexpr int STAGED_THREADS = 512;   // 128 registers: 16 chunks a thread

// Block (x, y, z): vectors [x*w, x*w + w) of tile y of batch z; element j of
// vector c of tile t lies at z*bstride + c*vstride + (t*tmul + j*istride)*ax.
template <typename TI, typename TO>
__global__ void __launch_bounds__(MAX_THREADS)
wht_kernel(const TI* x, TO* y, long long bstride, int lt, int tmul,
           int istride, long long ax, int nvec, long long vstride, int w,
           int scale, float r) {
  extern __shared__ float4 sm[];
  Tile t;
  t.chunk_pos = istride * ax == 1;
  t.c0 = blockIdx.x * w;
  t.nvec = nvec;
  t.vstride = vstride;
  t.pstride = (long long)istride * ax;
  t.base = (long long)blockIdx.z * bstride +
           (long long)blockIdx.y * tmul * ax;
  const int lw = __ffs(w) - 1;
  t.lp = t.chunk_pos ? lt - 2 : lt;
  t.lq = t.chunk_pos ? lw : lw - 2;
  run_tile<false, 3>(t, x, Store<TO>{y, scale, r}, sm, nullptr, 0, [] {});
}

// Sequence mode, one whole-sequence tile (positions ax apart) of w columns
// a block, the blocks persistent over the (column block, batch) tiles; the
// next tile's rows are staged by cp.async while this one's later phases run;
// the later phases take four position bits (16 chunks a thread)
template <typename TI, typename TO>
__global__ void __launch_bounds__(STAGED_THREADS)
wht_staged_kernel(const TI* x, TO* y, int batches, long long bstride, int lt,
                  long long ax, int nvec, int w, int scale, float r) {
  extern __shared__ float4 sm[];
  const int T = 1 << lt, lw = __ffs(w) - 1;
  const int rb = w * (int)sizeof(TI);        // a staged row's bytes
  uint8_t* stage = reinterpret_cast<uint8_t*>(sm + (T << lw) / 4);
  const int ncx = (nvec + w - 1) / w, total = ncx * batches;
  auto fetch = [&](int tau) {
    const int c0 = (tau % ncx) * w;
    const TI* src = x + (long long)(tau / ncx) * bstride + c0;
    constexpr int PER = 16 / sizeof(TI);     // elements a 16-byte piece
    const int pieces = rb / 16;
    for (int i = threadIdx.x; i < T * pieces; i += blockDim.x) {
      const int p = i / pieces, h = i % pieces;
      if (c0 + h * PER < nvec)
        cp_async16(stage + staged_row(p, rb) * rb + 16 * h,
                   src + p * ax + h * PER);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  int tau = blockIdx.x;
  if (tau < total) fetch(tau);
  for (; tau < total; tau += gridDim.x) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    Tile t;
    t.chunk_pos = false;
    t.c0 = (tau % ncx) * w;
    t.nvec = nvec;
    t.vstride = 1;
    t.pstride = ax;
    t.base = (long long)(tau / ncx) * bstride;
    t.lp = lt;
    t.lq = lw - 2;
    const int next = tau + gridDim.x;
    run_tile<true, 4>(t, x, Store<TO>{y, scale, r}, sm, stage, rb, [&] {
      __syncthreads();                       // the staged rows are read
      if (next < total) fetch(next);
    });
  }
}

// feature mode with vectors of 1 or 2 elements: one thread a vector
template <typename TI, typename TO>
__global__ void wht_short_kernel(const TI* x, TO* y, int T, int nvec,
                                 int scale, float r) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nvec) return;
  float a = ld(x + (long long)c * T), b = 0.0f;
  if (T == 2) {
    b = ld(x + (long long)c * T + 1);
    const float s = a + b, d = a - b;
    a = s;
    b = d;
  }
  if (scale) {
    a = a * r;
    b = b * r;
  }
  st(y + (long long)c * T, a);
  if (T == 2) st(y + (long long)c * T + 1, b);
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, void* y, int batches, long long bstride,
                   int T, int tiles, int tmul, int istride, long long ax,
                   int nvec, long long vstride, int w, int scale, float r,
                   cudaStream_t st) {
  const TI* xi = static_cast<const TI*>(x);
  TO* yo = static_cast<TO*>(y);
  // positions side by side in memory: feature mode
  const bool chunk_pos = (long long)istride * ax == 1;
  if (chunk_pos && T < 4) {
    if (tiles != 1 || batches != 1 || vstride != T)
      return cudaErrorInvalidValue;
    wht_short_kernel<TI, TO><<<(nvec + 255) / 256, 256, 0, st>>>(
        xi, yo, T, nvec, scale, r);
    return cudaGetLastError();
  }
  // chunks along the vectors need whole chunks of them; chunk positions
  // P and chunk columns Q; a thread holds 8 chunks in the widest phase
  if (!chunk_pos && (vstride != 1 || w < 4 || nvec % 4))
    return cudaErrorInvalidValue;
  const long long chunks = (long long)T * w / 4;
  const long long threads = chunks >= 8 ? chunks / 8 : 1;
  const int nthr = (int)(threads < 32 ? 32
                         : threads > MAX_THREADS ? MAX_THREADS : threads);
  const int lt = __builtin_ctz(T);
  const int lp = chunk_pos ? lt - 2 : lt;
  const size_t staged_smem = (size_t)chunks * sizeof(float4) +
                             (size_t)T * w * sizeof(TI);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  if (!chunk_pos && tiles == 1 && T >= 1024 &&
      (w * (int)sizeof(TI)) % 16 == 0 && staged_smem <= (size_t)optin) {
    // a whole-sequence tile: persistent blocks staging the next tile
    const size_t smem = staged_smem;
    e = cudaFuncSetAttribute(wht_staged_kernel<TI, TO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    const int sthr = nthr < STAGED_THREADS ? nthr : STAGED_THREADS;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, wht_staged_kernel<TI, TO>, sthr, smem)) != cudaSuccess)
      return e;
    const long long total = (long long)((nvec + w - 1) / w) * batches;
    const int grid = (int)(total < (long long)sms * per_sm
                               ? total : (long long)sms * per_sm);
    if (grid < 1) return cudaErrorInvalidConfiguration;
    wht_staged_kernel<TI, TO><<<grid, sthr, smem, st>>>(
        xi, yo, batches, bstride, lt, ax, nvec, w, scale, r);
    return cudaGetLastError();
  }
  // one phase (at most 3 position bits) needs no shared memory
  const size_t smem = lp > 3 ? (size_t)chunks * sizeof(float4) : 0;
  e = cudaFuncSetAttribute(
      wht_kernel<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((nvec + w - 1) / w, tiles, batches);
  wht_kernel<TI, TO><<<grid, nthr, smem, st>>>(
      xi, yo, bstride, lt, tmul, istride, ax, nvec, vstride, w, scale, r);
  return cudaGetLastError();
}

}  // namespace

// One launch of the tiled transform.  dtypes: 0 f32, 1 bf16, 2 f16; a pair
// (in, out) is either equal or has one side f32 (the split's scratch).
extern "C" int wht_tiles(const void* x, int in_dtype, void* y, int out_dtype,
                         int batches, long long bstride, int T, int tiles,
                         int tmul, int istride, long long ax, int nvec,
                         long long vstride, int w, int scale, float r,
                         void* stream) {
  if (T < 1 || (T & (T - 1)) || w < 1 || (w & (w - 1)) || tiles < 1 ||
      batches < 0 || tiles > 65535 || batches > 65535)
    return (int)cudaErrorInvalidValue;
  if (batches == 0 || nvec == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf;
  const int k = in_dtype * 3 + out_dtype;
#define WHT_ARGS x, y, batches, bstride, T, tiles, tmul, istride, ax, nvec, \
                 vstride, w, scale, r, st
  switch (k) {
    case 0: return (int)launch<float, float>(WHT_ARGS);
    case 1: return (int)launch<float, bf>(WHT_ARGS);
    case 2: return (int)launch<float, __half>(WHT_ARGS);
    case 3: return (int)launch<bf, float>(WHT_ARGS);
    case 4: return (int)launch<bf, bf>(WHT_ARGS);
    case 6: return (int)launch<__half, float>(WHT_ARGS);
    case 8: return (int)launch<__half, __half>(WHT_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef WHT_ARGS
}
