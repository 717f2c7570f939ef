// GroupNorm forward for channels-last activations x [B, HW, C] on Hopper.
//
// Two kernels, the counterparts of the TPU kernels in
// distributed_learning_simulator_tpu/ops/gn_pallas.py:
//
//   gn_stats_kernel      replaces _stats_kernel (and the host glue
//                        _per_group / rsqrt after it): per (sample, group)
//                        mean and rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps).
//   gn_normalize_kernel  replaces _norm_kernel:
//                        y = (x - mean_g) * (rstd_g * scale_c) + bias_c,
//                        computed in f32 and cast once to the output type.
//
// What bounds them on an H100: bytes. The stats pass reads x once (3 flops
// per element against 2 bytes); the normalize pass reads x once and writes
// y once. Both are far below the card's ops-per-byte balance point, so the
// design is about reading each activation byte exactly once, in 16-byte
// coalesced vectors along C, with all arithmetic in registers:
//
// * Stats: one block per sample. Threads are laid out [rows][C / VEC]; each
//   thread owns one 16-byte channel vector and walks the HW axis with a
//   stride of `rows` (the loop replaces the TPU grid's sequential HW axis,
//   which carried the sums across grid steps -- CUDA blocks run in no
//   order, so nothing is carried across blocks). Per-thread f32 partial
//   sums are combined through shared memory in a fixed order, pooled into
//   groups in f32 adds, and turned into mean/rstd in the same kernel. No
//   float atomics: a rerun is bitwise equal.
// * Normalize: a grid-stride loop over the flat tensor, one 16-byte vector
//   (8 bf16 / 4 f32 values) per thread step. C is a multiple of the vector
//   width (checked by the wrapper), so a vector never straddles a row.
//
// Known limit of this first version: with B=25 per training step the stats
// grid has only 25 blocks for 132 SMs. Splitting HW across blocks needs a
// second reduction pass; that is left to a later performance change.
//
// Plain C interface for ctypes: every function returns cudaGetLastError()
// right after its launch, and the Python wrapper raises if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;  // 16 bytes of bf16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean_out,
                float* __restrict__ rstd_out, int hw, int c, int g,
                float eps) {
  constexpr int VEC = 16 / sizeof(T);
  // [rows][c] partial sums, then reused for per-channel totals.
  __shared__ float sh1[kThreads * kMaxVec];
  __shared__ float sh2[kThreads * kMaxVec];

  const int nvec = c / VEC;            // 16-byte vectors per HW row
  const int rows = kThreads / nvec;    // HW rows in flight per block
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const T* xb = x + (int64_t)b * hw * c;

  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    s1[j] = 0.f;
    s2[j] = 0.f;
  }
  const int r = tid / nvec;
  const int v = tid % nvec;
  if (r < rows) {
    const uint4* base = reinterpret_cast<const uint4*>(xb) + v;
#pragma unroll 4
    for (int row = r; row < hw; row += rows) {
      const uint4 raw = __ldg(base + (int64_t)row * nvec);
      const T* in = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(in[j]);
        s1[j] += f;
        s2[j] += f * f;
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sh1[r * c + v * VEC + j] = s1[j];
      sh2[r * c + v * VEC + j] = s2[j];
    }
  }
  __syncthreads();
  // Per-channel totals over the rows, in row order (deterministic).
  float t1[kMaxVec], t2[kMaxVec];
  int nmine = 0;
  for (int ch = tid; ch < c; ch += kThreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      a1 += sh1[rr * c + ch];
      a2 += sh2[rr * c + ch];
    }
    t1[nmine] = a1;
    t2[nmine] = a2;
    ++nmine;
  }
  __syncthreads();
  nmine = 0;
  for (int ch = tid; ch < c; ch += kThreads) {
    sh1[ch] = t1[nmine];
    sh2[ch] = t2[nmine];
    ++nmine;
  }
  __syncthreads();
  // Pool channels into groups with plain f32 adds (no reduced-precision
  // matmul passes), then the statistics.
  const int cpg = c / g;
  const float cnt = (float)hw * (float)cpg;
  for (int gi = tid; gi < g; gi += kThreads) {
    float g1 = 0.f, g2 = 0.f;
    for (int i = 0; i < cpg; ++i) {
      g1 += sh1[gi * cpg + i];
      g2 += sh2[gi * cpg + i];
    }
    const float m = g1 / cnt;
    const float var = fmaxf(g2 / cnt - m * m, 0.f);
    mean_out[b * g + gi] = m;
    rstd_out[b * g + gi] = rsqrtf(var + eps);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_normalize_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                    const float* __restrict__ rstd,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ y,
                    int64_t n_vec, int hw, int c, int g) {
  constexpr int VEC = 16 / sizeof(T);
  const int cpg = c / g;
  const int64_t per_sample = (int64_t)hw * c;
  const uint4* xin = reinterpret_cast<const uint4*>(x);
  uint4* yout = reinterpret_cast<uint4*>(y);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_vec;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i * VEC;
    const int b = (int)(e / per_sample);
    const int c0 = (int)(e % c);
    const uint4 raw = __ldg(xin + i);
    const T* in = reinterpret_cast<const T*>(&raw);
    uint4 raw_out;
    T* out = reinterpret_cast<T*>(&raw_out);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ch = c0 + j;
      const int gi = b * g + ch / cpg;
      // Subtract first, then one multiply by a = rstd * scale, then the
      // bias; explicit _rn ops keep nvcc from contracting into an FMA, so
      // the rounding matches the plain PyTorch version op for op.
      const float a = __fmul_rn(__ldg(rstd + gi), __ldg(scale + ch));
      const float d = __fsub_rn(to_f32(in[j]), __ldg(mean + gi));
      out[j] = from_f32<T>(__fadd_rn(__fmul_rn(d, a), __ldg(bias + ch)));
    }
    yout[i] = raw_out;
  }
}

template <typename T>
int launch_stats(const void* x, void* mean, void* rstd, int b, int hw, int c,
                 int g, float eps, void* stream) {
  gn_stats_kernel<T><<<b, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (float*)mean, (float*)rstd, hw, c, g, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_normalize(const void* x, const void* mean, const void* rstd,
                     const void* scale, const void* bias, void* y, int b,
                     int hw, int c, int g, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t n_vec = (int64_t)b * hw * c / VEC;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  // 132 SMs x 8 resident blocks of 256 threads fill the card twice over;
  // larger tensors take the grid-stride loop.
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  gn_normalize_kernel<T><<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const T*)x, (const float*)mean, (const float*)rstd,
      (const float*)scale, (const float*)bias, (T*)y, n_vec, hw, c, g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dls_gn_stats_bf16(const void* x, void* mean, void* rstd, int b, int hw,
                      int c, int g, float eps, void* stream) {
  return launch_stats<__nv_bfloat16>(x, mean, rstd, b, hw, c, g, eps,
                                     stream);
}

int dls_gn_stats_f32(const void* x, void* mean, void* rstd, int b, int hw,
                     int c, int g, float eps, void* stream) {
  return launch_stats<float>(x, mean, rstd, b, hw, c, g, eps, stream);
}

int dls_gn_normalize_bf16(const void* x, const void* mean, const void* rstd,
                          const void* scale, const void* bias, void* y, int b,
                          int hw, int c, int g, void* stream) {
  return launch_normalize<__nv_bfloat16>(x, mean, rstd, scale, bias, y, b, hw,
                                         c, g, stream);
}

int dls_gn_normalize_f32(const void* x, const void* mean, const void* rstd,
                         const void* scale, const void* bias, void* y, int b,
                         int hw, int c, int g, void* stream) {
  return launch_normalize<float>(x, mean, rstd, scale, bias, y, b, hw, c, g,
                                 stream);
}

}  // extern "C"
