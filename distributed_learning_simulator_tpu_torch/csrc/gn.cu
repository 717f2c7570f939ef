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
// * Stats: one kernel whose grid is B x S CTAs, launched as thread-block
//   clusters of S CTAs per sample (cudaLaunchKernelEx with a cluster
//   dimension; S in {1, 2, 4, 8}). CTA rank r of a cluster reads the r-th
//   contiguous slice of the sample's HW rows. Its threads are laid out
//   [rows][C / VEC]; each owns one 16-byte channel vector and walks its
//   slice with a stride of `rows`, kInFlight predicated loads issued
//   together per batch (one memory round trip). ops/gn_cuda.py
//   `stats_split` picks S: a split divides the batches by S, but a cluster
//   launch and its barriers cost about 1.5 round trips on an H100, so at
//   the training batch of 25 only stage 1 (HW 1024, 4 batches on one CTA)
//   splits (S = 4), and S = 1 once B fills the card (B >= 264).
//   Per-thread f32 sums meet in shared memory. Where C and G are powers of
//   two (ResNet's widths, G = 32) the lanes of a group each add VEC of its
//   slots in order and a fixed xor shuffle tree adds the lanes; otherwise
//   channels are totalled over the rows in row order and pooled in channel
//   order. At S = 1 the tree's lane 0 writes mean/rstd directly. At S > 1
//   each CTA leaves its group sums in shared memory, and after
//   cluster.sync() rank 0 reads the S sums of every group through
//   distributed shared memory, all S reads in flight at once (read one after
//   another, S x C remote reads cost microseconds), adds them in rank order
//   and writes mean/rstd; a second cluster.sync() keeps every CTA's shared
//   memory alive until rank 0 has read it. The loop replaces the TPU grid's
//   sequential HW axis, which carried the sums across grid steps; CUDA
//   blocks run in no order, so nothing is carried across blocks except
//   through the cluster's shared memory. No global scratch, no second
//   launch, no float atomics: a rerun is bitwise equal.
// * Normalize: a grid-stride loop over the flat tensor, one 16-byte vector
//   (8 bf16 / 4 f32 values) per thread step. C is a multiple of the vector
//   width (checked by the wrapper), so a vector never straddles a row.
//
// Plain C interface for ctypes: every function returns cudaGetLastError()
// right after its launch, and the Python wrapper raises if it is not 0.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;    // 16 bytes of bf16
constexpr int kMaxSplit = 8;  // CTAs per cluster (portable limit)
constexpr int kInFlight = 8;  // independent 16-byte loads per thread

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
__device__ __forceinline__ void accumulate(const uint4& raw, float* s1,
                                           float* s2) {
  constexpr int VEC = 16 / sizeof(T);
  const T* in = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float f = to_f32(in[j]);
    s1[j] += f;
    s2[j] += f * f;
  }
}

// mean and rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps) of one group from its
// sums over `cnt` elements.
__device__ __forceinline__ void write_stats(float s1, float s2, float cnt,
                                            float eps, float* mean,
                                            float* rstd) {
  const float m = s1 / cnt;
  *mean = m;
  *rstd = rsqrtf(fmaxf(s2 / cnt - m * m, 0.f) + eps);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean_out,
                float* __restrict__ rstd_out, int hw, int c, int g,
                float eps) {
  constexpr int VEC = 16 / sizeof(T);
  // [rows][c] partial sums, then per-channel totals in row 0, then group
  // sums in each group's first channel slot.
  __shared__ float sh1[kThreads * kMaxVec];
  __shared__ float sh2[kThreads * kMaxVec];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / split;
  const int per = (hw + split - 1) / split;
  const int row0 = min(hw, rank * per);
  const int row1 = min(hw, row0 + per);

  const int nvec = c / VEC;            // 16-byte vectors per HW row
  const int rows = kThreads / nvec;    // HW rows in flight per block
  const int tid = threadIdx.x;
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
    // kInFlight predicated loads issued together, then summed in row order.
    for (int row = row0 + r; row < row1; row += kInFlight * rows) {
      uint4 raw[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int rr = row + u * rows;
        raw[u] = rr < row1 ? __ldg(base + (int64_t)rr * nvec)
                           : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (row + u * rows < row1) accumulate<T>(raw[u], s1, s2);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sh1[r * c + v * VEC + j] = s1[j];
      sh2[r * c + v * VEC + j] = s2[j];
    }
  }
  __syncthreads();
  // This CTA's group sums, into each group's first channel slot of row 0.
  const int cpg = c / g;
  if (kThreads % nvec == 0 && kThreads % g == 0 && g >= 8) {
    // C and G are powers of two: the lanes of a group are consecutive,
    // kThreads / G <= 32 of them, and each sums VEC of its group's
    // rows * cpg slots (entry e = rr * cpg + i, in order), then a fixed xor
    // tree adds the lanes. Every lane ends with the same sum.
    const int lanes = kThreads / g;
    const int gi = tid / lanes;
    const int sub = tid % lanes;
    const int shift = __ffs(cpg) - 1;  // log2(cpg)
    float g1 = 0.f, g2 = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int e = sub + k * lanes;
      const int at = (e >> shift) * c + gi * cpg + (e & (cpg - 1));
      g1 += sh1[at];
      g2 += sh2[at];
    }
    for (int off = lanes / 2; off > 0; off /= 2) {
      g1 += __shfl_xor_sync(0xffffffffu, g1, off);
      g2 += __shfl_xor_sync(0xffffffffu, g2, off);
    }
    if (split == 1) {  // the sample's sums are complete: no second pass
      if (sub == 0) write_stats(g1, g2, (float)hw * (float)cpg, eps,
                                mean_out + b * g + gi, rstd_out + b * g + gi);
      return;
    }
    __syncthreads();  // every slot has been read
    if (sub == 0) {
      sh1[gi * cpg] = g1;
      sh2[gi * cpg] = g2;
    }
  } else {
    // Any C and G: per-channel totals over the rows in row order (each
    // column belongs to one thread), then channels pooled in order.
    for (int ch = tid; ch < c; ch += kThreads) {
      float a1 = 0.f, a2 = 0.f;
      for (int rr = 0; rr < rows; ++rr) {
        a1 += sh1[rr * c + ch];
        a2 += sh2[rr * c + ch];
      }
      sh1[ch] = a1;
      sh2[ch] = a2;
    }
    __syncthreads();
    for (int gi = tid; gi < g; gi += kThreads) {
      float g1 = 0.f, g2 = 0.f;
      for (int i = 0; i < cpg; ++i) {
        g1 += sh1[gi * cpg + i];
        g2 += sh2[gi * cpg + i];
      }
      sh1[gi * cpg] = g1;
      sh2[gi * cpg] = g2;
    }
  }
  // A one-CTA cluster needs no cluster barrier (and pays none).
  if (split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (rank == 0) {
    // The cluster's group sums, read from each rank's shared memory (its
    // own included) with all kMaxSplit reads in flight, added in rank order
    // (ranks past the cluster add +0).
    const float cnt = (float)hw * (float)cpg;
    for (int gi = tid; gi < g; gi += kThreads) {
      float v1[kMaxSplit], v2[kMaxSplit];
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q) {
        v1[q] = q < split ? cluster.map_shared_rank(sh1, q)[gi * cpg] : 0.f;
        v2[q] = q < split ? cluster.map_shared_rank(sh2, q)[gi * cpg] : 0.f;
      }
      float g1 = 0.f, g2 = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxSplit; ++q) {
        g1 += v1[q];
        g2 += v2[q];
      }
      write_stats(g1, g2, cnt, eps, mean_out + b * g + gi,
                  rstd_out + b * g + gi);
    }
  }
  // The other ranks' shared memory stays until rank 0 has read it.
  if (split > 1) cluster.sync();
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
                 int g, float eps, int split, void* stream) {
  if (split == 1) {  // one CTA per sample: a plain launch
    gn_stats_kernel<T><<<b, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (float*)mean, (float*)rstd, hw, c, g, eps);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)b * split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_stats_kernel<T>, (const T*)x, (float*)mean, (float*)rstd, hw,
      c, g, eps);
  if (err != cudaSuccess) return (int)err;
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
                      int c, int g, float eps, int split, void* stream) {
  return launch_stats<__nv_bfloat16>(x, mean, rstd, b, hw, c, g, eps, split,
                                     stream);
}

int dls_gn_stats_f32(const void* x, void* mean, void* rstd, int b, int hw,
                     int c, int g, float eps, int split, void* stream) {
  return launch_stats<float>(x, mean, rstd, b, hw, c, g, eps, split, stream);
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
