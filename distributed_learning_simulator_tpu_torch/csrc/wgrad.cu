// Weight gradient of a 3x3, stride-1, zero-padded (SAME) convolution on
// channels-last activations, on Hopper:
//
//   dW[dy, dx, ci, co] = sum over (b, h, w) of
//                        x[b, h + dy - 1, w + dx - 1, ci] * g[b, h, w, co]
//
// with x [B, H, W, C] the convolution's input, g [B, H, W, C] the gradient
// of its output, and x read as 0 outside the image. dW is [3, 3, C, C] f32
// (HWIO, the JAX package's kernel layout).
//
// It replaces scripts/exp_pallas_wgrad.py `_wgrad_kernel` (called through
// `pallas_wgrad`), the TPU prototype that computed the same gradient for
// ResNet's stage-1 convolutions as 18 rank-2 contractions on a W-folded
// layout. The fold was a TPU lane-layout device; here the layout is the
// plain NHWC one the model keeps, and each of the 9 taps is one [C, K]x[K, C]
// contraction over the K = B*H*W positions.
//
// What bounds it on an H100: at the main path's shape (B=25, 32x32, C=64,
// bf16) the function moves 6.7 MB and does 1.89 GFLOP, so on the tensor
// cores bytes and operations would both take about 2 us. This first version
// does its multiply-adds in f32 on the CUDA cores (67 TFLOP/s peak), so
// operations bound it, about 15x above the tensor-core bound; moving the
// inner product to mma.sync/wgmma with TMA-fed tiles is later work.
//
// Design (simple and deterministic):
// * Pass 1, `wgrad_partial_kernel`: the grid is (K chunk, tap, output tile).
//   A block owns one (tap, K chunk) pair and one 64x64 tile of (ci, co). It
//   stages 32 rows at a time of the shifted x (zero-filled outside the
//   image) and of g in shared memory as f32, 16-byte vector loads along C,
//   and each of its 256 threads accumulates a 4x4 piece of the tile in f32
//   registers. Each block writes its tile to its own slot of a partial
//   buffer [chunk][tap][ci][co]: nothing is carried across blocks.
// * Pass 2, `wgrad_reduce_kernel`: sums the partials over the chunks in
//   chunk order. No float atomics, so a rerun is bitwise equal.
//
// Plain C interface for ctypes: every function returns cudaGetLastError()
// right after its launches, and the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, a 4x4 piece each
constexpr int kTile = 64;      // ci and co extent of one block's tile
constexpr int kRows = 32;      // K rows staged in shared memory per step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One 16-byte vector of channels, widened to f32.
template <typename T>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) dst[j] = to_f32(v[j]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     float* __restrict__ partial, int h, int w, int c,
                     int k_total, int rows_per_block) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = kTile / VEC;  // 16-byte vectors per staged row
  __shared__ __align__(16) float xs[kRows][kTile];
  __shared__ __align__(16) float gs[kRows][kTile];

  const int chunk = blockIdx.x;
  const int tap = blockIdx.y;  // dy * 3 + dx
  const int dy = tap / 3;
  const int dx = tap % 3;
  const int n_tiles = (c + kTile - 1) / kTile;
  const int ci0 = (blockIdx.z / n_tiles) * kTile;
  const int co0 = (blockIdx.z % n_tiles) * kTile;
  const int k0 = chunk * rows_per_block;
  const int k1 = min(k0 + rows_per_block, k_total);

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // co = co0 + 4 * tx + j
  const int ty = tid / 16;  // ci = ci0 + 4 * ty + i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = k0; kb < k1; kb += kRows) {
    for (int v = tid; v < kRows * VPR; v += kThreads) {
      const int r = v / VPR;
      const int cv = (v % VPR) * VEC;
      const int k = kb + r;
      float xv[VEC], gv[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        xv[j] = 0.f;
        gv[j] = 0.f;
      }
      if (k < k1) {
        // C is a multiple of 8 (checked by the wrapper), so a vector that
        // starts inside C ends inside it.
        if (co0 + cv < c) load_vec(g + (int64_t)k * c + co0 + cv, gv);
        const int wi = k % w;
        const int hi = (k / w) % h;
        const int hs = hi + dy - 1;
        const int ws = wi + dx - 1;
        if (ci0 + cv < c && hs >= 0 && hs < h && ws >= 0 && ws < w) {
          // Same sample, shifted row: k + (dy - 1) * W + (dx - 1).
          const int64_t ks = (int64_t)k + (dy - 1) * w + (dx - 1);
          load_vec(x + ks * c + ci0 + cv, xv);
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        xs[r][cv + j] = xv[j];
        gs[r][cv + j] = gv[j];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partial + ((int64_t)chunk * 9 + tap) * c * c;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + ty * 4 + i;
    if (ci >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx * 4 + j;
      if (co < c) out[(int64_t)ci * c + co] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                    int n_chunks, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_chunks; ++k) s += partial[(int64_t)k * n + i];
    out[i] = s;
  }
}

template <typename T>
int launch_wgrad(const void* x, const void* g, void* partial, void* out, int b,
                 int h, int w, int c, int rows_per_block, int n_chunks,
                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (c + kTile - 1) / kTile;
  const dim3 grid(n_chunks, 9, n_tiles * n_tiles);
  wgrad_partial_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)x, (const T*)g, (float*)partial, h, w, c, b * h * w,
      rows_per_block);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 9 * c * c;
  int blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;
  wgrad_reduce_kernel<<<blocks, kThreads, 0, s>>>((const float*)partial,
                                                  (float*)out, n_chunks, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dls_wgrad_bf16(const void* x, const void* g, void* partial, void* out,
                   int b, int h, int w, int c, int rows_per_block,
                   int n_chunks, void* stream) {
  return launch_wgrad<__nv_bfloat16>(x, g, partial, out, b, h, w, c,
                                     rows_per_block, n_chunks, stream);
}

int dls_wgrad_f32(const void* x, const void* g, void* partial, void* out,
                  int b, int h, int w, int c, int rows_per_block, int n_chunks,
                  void* stream) {
  return launch_wgrad<float>(x, g, partial, out, b, h, w, c, rows_per_block,
                             n_chunks, stream);
}

}  // extern "C"
