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
//                        scale/bias are one [C] row for every sample, or
//                        one row per model ([M, C]) when the batch stacks M
//                        models' samples (x [M*B, HW, C], sample s reads
//                        row s / B): the TPU kernel under the client vmap,
//                        where each client's GroupNorm has its own affine.
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
// * Normalize: a grid of B x slices CTAs; CTA (b, s) normalizes the s-th
//   contiguous slice of sample b's HW rows (ops/gn_cuda.py
//   `normalize_plan` sizes the slices: at most one CTA per SM, and never
//   more than kInFlight rows a thread). Threads are laid out [rows][C / VEC]
//   as in the stats kernel, so each owns one fixed 16-byte channel vector
//   (8 bf16 / 4 f32 values; C is a multiple of VEC, checked by the wrapper).
//   A thread holds its channels' a_c = rstd_g * scale_c, mean_g and bias_c
//   in registers: the TPU kernel's per-(sample, channel) a_c / mean_c
//   blocks. It issues its (at most kInFlight) predicated 16-byte loads of x
//   together, one memory round trip, then the arithmetic with no division
//   and no scalar load, then 16-byte stores (ordinary ones: the ReLU or
//   residual add that follows reads y at once, from L2). scale and bias are
//   read in their own dtype (bf16 under bf16 local training, else f32) and
//   widened exactly, once per thread. With a per-model affine the CTA's
//   sample picks the row (every CTA lies inside one sample, so inside one
//   model): a pointer offset per CTA, nothing per element.
//
// Programmatic dependent launch (PDL), inside group_norm only. group_norm
// launches the stats kernel and, right behind it on the same stream, the
// normalize kernel with cudaLaunchAttributeProgrammaticStreamSerialization;
// the stats kernel executes griddepcontrol.launch_dependents at its start,
// so the normalize CTAs are scheduled while the stats kernel still runs. A
// normalize thread first loads its scale/bias and its x, then executes
// griddepcontrol.wait, and only then reads mean/rstd. What makes the reads
// before the wait safe is the condition that the kernel just before the
// normalize on the stream is that gn_stats kernel:
// * griddepcontrol.wait returns once the primary grid has completed and its
//   writes are visible to this grid, so mean/rstd are read after the stats
//   kernel wrote them. Nothing promises that the primary's writes are
//   visible before the wait.
// * The primary (gn_stats) writes only mean/rstd. x, scale and bias were
//   written before it began: it is an ordinary launch, so it starts only
//   after everything before it on the stream has completed.
// * Every normalize thread waits, so no normalize completes before its
//   primary, and it never triggers early itself: stream order holds for
//   every later kernel, exactly as without PDL.
// * At B <= 264 every stats CTA is resident before the trigger takes
//   effect, so early normalize CTAs cannot starve it; at larger B the
//   dependent launch starts only once the last stats wave has started.
// The public gn_normalize, which may follow any kernel (one that wrote x,
// scale or bias included), launches the same kernel without the attribute:
// it starts only once its predecessor has completed, and its wait returns
// at once.
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

// Programmatic dependent launch (file comment): let the grid launched after
// this one on the stream start; and wait for the grid before this one to
// complete and flush its memory.
__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
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

  allow_dependent_launch();
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

// y = (x - mean_g) * (rstd_g * scale_c) + bias_c for one channel vector:
// subtract first, then one multiply by a, then the bias; explicit _rn ops
// keep nvcc from contracting into an FMA, so the rounding matches the plain
// PyTorch version op for op.
template <typename T>
__device__ __forceinline__ uint4 normalize_vec(const uint4& raw,
                                               const float* m, const float* a,
                                               const float* bi) {
  constexpr int VEC = 16 / sizeof(T);
  const T* in = reinterpret_cast<const T*>(&raw);
  uint4 raw_out;
  T* out = reinterpret_cast<T*>(&raw_out);
#pragma unroll
  for (int j = 0; j < VEC; ++j)
    out[j] = from_f32<T>(
        __fadd_rn(__fmul_rn(__fsub_rn(to_f32(in[j]), m[j]), a[j]), bi[j]));
  return raw_out;
}

// T: the dtype of x and y; P: the dtype of scale and bias. A slice holds at
// most kInFlight * rows HW rows (launch_normalize checks it), so each thread
// has at most kInFlight of them: rows row, row + rows, ...
template <typename T, typename P>
__global__ void __launch_bounds__(kThreads)
gn_normalize_kernel(const T* __restrict__ x, const float* mean,
                    const float* rstd, const P* __restrict__ scale,
                    const P* __restrict__ bias, T* __restrict__ y, int hw,
                    int c, int g, int slices, int rows_per_slice,
                    int rows_per_model) {
  constexpr int VEC = 16 / sizeof(T);
  const int b = blockIdx.x / slices;
  if (rows_per_model > 0) {  // [M, C] scale/bias: this sample's model's row
    const int64_t row_off = (int64_t)(b / rows_per_model) * c;
    scale += row_off;
    bias += row_off;
  }
  const int row0 = min(hw, (int)(blockIdx.x % slices) * rows_per_slice);
  const int row1 = min(hw, row0 + rows_per_slice);
  const int nvec = c / VEC;          // 16-byte vectors per HW row
  const int rows = kThreads / nvec;  // HW rows a CTA covers per step
  const int r = threadIdx.x / nvec;
  const int v = threadIdx.x % nvec;
  const int c0 = v * VEC;
  const int64_t sample = (int64_t)b * hw * nvec;  // in vectors
  const uint4* xin = reinterpret_cast<const uint4*>(x) + sample + v;
  uint4* yout = reinterpret_cast<uint4*>(y) + sample + v;
  // The kThreads % nvec threads past the last whole row of vectors load and
  // store nothing (they still wait below).
  const int row = r < rows ? row0 + r : row1;

  // 1. What the stats kernel does not write (under PDL its predecessor on
  //    the stream; file comment): this vector's scale, bias and groups, and
  //    its x, all loads issued together.
  const int cpg = c / g;
  float sc[VEC], bi[VEC];
  int gi[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sc[j] = to_f32(scale[c0 + j]);
    bi[j] = to_f32(bias[c0 + j]);
    gi[j] = b * g + (c0 + j) / cpg;
  }
  uint4 raw[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int rr = row + u * rows;
    raw[u] = rr < row1 ? __ldg(xin + (int64_t)rr * nvec)
                       : make_uint4(0, 0, 0, 0);
  }

  // 2. The stats kernel has completed (without the PDL attribute the wait
  // returns at once); 3. its mean/rstd, read once by
  // ordinary (coherent, L1-cached) loads: not __ldg, whose non-coherent
  // path assumes data that no grid writes while this one runs, and not
  // __ldcg, which sends every thread's read to the same few L2 lines (a
  // diagnostic build with it took up to 1.6x as long at B=25).
  wait_for_primary_grid();
  float m[VEC], a[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    m[j] = mean[gi[j]];
    a[j] = __fmul_rn(rstd[gi[j]], sc[j]);
  }
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int rr = row + u * rows;
    if (rr < row1)
      yout[(int64_t)rr * nvec] = normalize_vec<T>(raw[u], m, a, bi);
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

// One CTA per (sample, slice). after_stats != 0 makes it a programmatic
// dependent launch of the kernel before it on the stream, which must then
// be the gn_stats kernel that wrote mean/rstd (file comment); 0 makes it an
// ordinary launch. rows_per_model: 0 for a [C] scale/bias, else B of an
// [M, C] one (x holds M * B samples).
template <typename T, typename P>
int launch_normalize(const void* x, const void* mean, const void* rstd,
                     const void* scale, const void* bias, void* y, int b,
                     int hw, int c, int g, int slices, int rows_per_slice,
                     int rows_per_model, int after_stats, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (rows_per_slice > kInFlight * (kThreads / (c / VEC)))
    return (int)cudaErrorInvalidValue;  // more than one batch a thread
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)b * (unsigned)slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = after_stats ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gn_normalize_kernel<T, P>, (const T*)x, (const float*)mean,
      (const float*)rstd, (const P*)scale, (const P*)bias, (T*)y, hw, c, g,
      slices, rows_per_slice, rows_per_model);
  if (err != cudaSuccess) return (int)err;
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

// dls_gn_normalize_<x dtype>_<scale/bias dtype>
#define DLS_GN_NORMALIZE(NAME, T, P)                                         \
  int NAME(const void* x, const void* mean, const void* rstd,                \
           const void* scale, const void* bias, void* y, int b, int hw,      \
           int c, int g, int slices, int rows_per_slice, int rows_per_model, \
           int after_stats, void* stream) {                                  \
    return launch_normalize<T, P>(x, mean, rstd, scale, bias, y, b, hw, c,   \
                                  g, slices, rows_per_slice, rows_per_model, \
                                  after_stats, stream);                      \
  }
DLS_GN_NORMALIZE(dls_gn_normalize_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
DLS_GN_NORMALIZE(dls_gn_normalize_bf16_f32, __nv_bfloat16, float)
DLS_GN_NORMALIZE(dls_gn_normalize_f32_bf16, float, __nv_bfloat16)
DLS_GN_NORMALIZE(dls_gn_normalize_f32_f32, float, float)
#undef DLS_GN_NORMALIZE

}  // extern "C"
