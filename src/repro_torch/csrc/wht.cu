// Orthonormal Walsh-Hadamard transform for Hopper (sm_90a): K10.
//
// Replaces the Pallas kernel wht_pallas (src/repro/kernels/wht.py): the
// WHT of (b, s, d) activations along the sequence (axis -2) or the features
// (axis -1), butterfly stages h = 1, 2, 4, ... in f32 and one scale by
// f32(1/sqrt n) at the end.
//
// Bound on the H100: bytes.  A stage is one add and one subtract per pair,
// log2(n) stages in all, so one read and one write of the activation is
// what it needs.  Design: a block stages a tile of w transform vectors (w
// columns in sequence mode, w rows in feature mode) of T elements each in
// dynamic shared memory as f32 (padded to T + 1 a vector so both the
// loads and the stages avoid bank conflicts), runs the tile's stages with a
// barrier between them, scales if asked and writes the tile out (tile
// lengths and widths are powers of two, so indices take shifts and masks,
// no integer division).  When the whole transform fits one tile (T = n)
// that is one launch.  Otherwise the
// wrapper splits the stages over two launches through an f32 scratch: the
// stages h < 2^a on contiguous tiles of 2^a elements, then the stages
// h >= 2^a on tiles of elements spaced 2^a apart.  Each stage is the same
// elementwise a + b, a - b on the same values, so every output's tree of
// additions is the plain version's and the result is bit for bit its
// result.  No multiply meets an add, so no FMA contraction can occur.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;

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

// Tile (blockIdx.y, blockIdx.x, blockIdx.z): batch z, tile t = y along the
// transform axis, vectors [x*w, x*w + w).  Element j of vector c of tile t
// sits at  z*bstride + (t*tmul + j*istride)*ax + c*vstride.  T and w are
// powers of two, so every index splits with shifts and masks.
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
wht_tile_kernel(const TI* x, TO* y, long long bstride, int T, int tmul,
                int istride, long long ax, int nvec, long long vstride, int w,
                int scale, float r) {
  extern __shared__ float sm[];
  const int P = T + 1;
  const int lg_t = __ffs(T) - 1, lg_w = __ffs(w) - 1;
  const int c0 = blockIdx.x * w;
  const long long base = (long long)blockIdx.z * bstride +
                         (long long)blockIdx.y * tmul * ax;
  const long long jstep = (long long)istride * ax;
  // sequence mode reads rows of w contiguous columns; feature mode reads
  // each vector's T contiguous elements
  const bool vec_fast = vstride == 1;
  const int n = T << lg_w;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int cc = vec_fast ? e & (w - 1) : e >> lg_t;
    const int j = vec_fast ? e >> lg_w : e & (T - 1);
    const int c = c0 + cc;
    float v = 0.0f;
    if (c < nvec) v = ld(x + base + j * jstep + c * vstride);
    sm[cc * P + j] = v;
  }
  const int half = T >> 1, lg_half = lg_t - 1;
  int lg_h = 0;
  for (int h = 1; h < T; h <<= 1, ++lg_h) {
    __syncthreads();
    for (int p = threadIdx.x; p < (half << lg_w); p += THREADS) {
      const int cc = p >> lg_half, q = p & (half - 1);
      const int i = ((q >> lg_h) << (lg_h + 1)) | (q & (h - 1));
      float* col = sm + cc * P;
      const float a = col[i], b = col[i + h];
      col[i] = a + b;
      col[i + h] = a - b;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int cc = vec_fast ? e & (w - 1) : e >> lg_t;
    const int j = vec_fast ? e >> lg_w : e & (T - 1);
    const int c = c0 + cc;
    if (c >= nvec) continue;
    float v = sm[cc * P + j];
    if (scale) v = v * r;
    st(y + base + j * jstep + c * vstride, v);
  }
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, void* y, int batches, long long bstride,
                   int T, int tiles, int tmul, int istride, long long ax,
                   int nvec, long long vstride, int w, int scale, float r,
                   cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)w * (T + 1);
  cudaError_t e = cudaFuncSetAttribute(
      wht_tile_kernel<TI, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((nvec + w - 1) / w, tiles, batches);
  wht_tile_kernel<TI, TO><<<grid, THREADS, smem, st>>>(
      static_cast<const TI*>(x), static_cast<TO*>(y), bstride, T, tmul,
      istride, ax, nvec, vstride, w, scale, r);
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
