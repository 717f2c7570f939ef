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
//   dimension; S in {1, 2, 4, 8}; ops/gn_cuda.py `stats_split` picks S).
//   The order of a group's sums belongs to the group: the bits of its
//   sum x and sum x^2 are a function of (HW, C/G, dtype) alone, not of C
//   (how many models sit side by side on the channel axis), B or S, so a
//   model's statistics are the same whatever launch it shares:
//     - L = stats_lanes(HW) row lanes (the least power of two >= HW, at
//       most 32); lane k sums the rows = k mod L of each channel in row
//       order, from 0, with explicit _rn ops (the square rounded, then
//       added; one fused op for bf16, whose square is exact);
//     - the L lane sums of a channel meet in the balanced pairwise tree
//       (lanes 2i and 2i+1, then pairs of pairs, ...);
//     - the cpg channel totals of a group meet in the same balanced tree
//       (a channel past the group adds nothing); then mean = s1 / n, var =
//       s2 / n - mean^2, rstd as above, op for op as the plain version
//       (ops/gn_cuda.py `gn_stats_plain`) does.
//   Every cut of the work follows the tree: CTA rank r of a cluster owns
//   lanes [r L/S, (r+1) L/S), a subtree; its threads are laid out
//   [tlanes][C / VEC] (16-byte channel vectors, so coalesced rows), and
//   thread (t, v) owns q = L / S / tlanes consecutive lanes of vector v, a
//   subtree: it sums P = min(q, 4) of them side by side (kInFlight
//   predicated loads issued together), adds their subtree, and keeps the
//   q / P subtree roots on a log2(q / P)-deep counter
//   (push_subtree); where all its loads make one batch it issues them
//   together and sums a channel at a time. q is a template argument, so
//   every add is resolved at compile time. The threads' roots go to shared
//   memory, where one thread a channel adds its rows in the same tree (a
//   counter in registers), and at S > 1 rank 0 reads the S ranks' channel
//   roots through distributed shared memory (all reads in flight, after
//   cluster.sync()) and adds them in the same tree; a second
//   cluster.sync() keeps every CTA's shared memory alive until rank 0 has
//   read it. Rank 0 pools each group's channels (by shuffles among the
//   threads that hold them for a power-of-two group of at most 32, else a
//   tree level at a time in shared memory) and writes mean/rstd. Each
//   element is read once, in 16-byte vectors; no global scratch, no
//   second launch, no float atomics: a rerun is bitwise equal. The loop
//   replaces the TPU grid's sequential HW axis, which carried the sums
//   across grid steps; CUDA blocks run in no order, so nothing is carried
//   across blocks except through the cluster's shared memory.
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
constexpr int kLanes = 32;    // the stats order's most lanes

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

// s1 += f and s2 += f^2, rounded as the plain version rounds: the square
// of a bf16 value is exact in f32, so one fused op rounds as its
// square-then-add does; an f32 square rounds on its own.
template <typename T>
__device__ __forceinline__ void add_one(float f, float& s1, float& s2) {
  s1 = __fadd_rn(s1, f);
  if constexpr (sizeof(T) == 2) {
    s2 = __fmaf_rn(f, f, s2);
  } else {
    s2 = __fadd_rn(s2, __fmul_rn(f, f));
  }
}

template <typename T>
__device__ __forceinline__ void accumulate(const uint4& raw, float* s1,
                                           float* s2) {
  constexpr int VEC = 16 / sizeof(T);
  const T* in = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) add_one<T>(to_f32(in[j]), s1[j], s2[j]);
}

// mean and rstd = rsqrt(max(E[x^2] - mean^2, 0) + eps) of one group from its
// sums over `cnt` elements, op for op as the plain version computes them.
__device__ __forceinline__ void write_stats(float s1, float s2, float cnt,
                                            float eps, float* mean,
                                            float* rstd) {
  const float m = __fdiv_rn(s1, cnt);
  *mean = m;
  const float var = __fsub_rn(__fdiv_rn(s2, cnt), __fmul_rn(m, m));
  *rstd = rsqrtf(__fadd_rn(fmaxf(var, 0.f), eps));
}

// Subtree j (of a thread's kQ / P subtrees of P lanes, in order) has its
// sums in (a1, a2): the balanced tree over them, kept as a binary counter.
// Level lv of (t1, t2) holds the root of the last finished run of 2^lv
// subtrees while its right sibling is being summed; a subtree whose index
// has bit lv set is such a right sibling, and is added to it (left +
// right) before carrying on up. After the last one (a1, a2) hold the root
// of all of them. j is a compile-time constant where it is called, so
// only the adds it needs are emitted.
template <int VEC, int kDepth>
__device__ __forceinline__ void push_subtree(int j, float* a1, float* a2,
                                             float (*t1)[VEC],
                                             float (*t2)[VEC]) {
  bool carry = true;
#pragma unroll
  for (int lv = 0; lv < kDepth; ++lv) {
    if (carry) {
      if ((j >> lv) & 1) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          a1[k] = __fadd_rn(t1[lv][k], a1[k]);
          a2[k] = __fadd_rn(t2[lv][k], a2[k]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          t1[lv][k] = a1[k];
          t2[lv][k] = a2[k];
        }
        carry = false;
      }
    }
  }
}

// log2 of a power of two, at compile time.
__host__ __device__ constexpr int log2_of(int n) {
  return n > 1 ? 1 + log2_of(n / 2) : 0;
}

// The stats kernel (file comment: "the order of a group's sums"). One CTA
// per (sample, cluster rank); each thread owns kQ consecutive lanes of one
// channel vector (kQ a power of two, set at launch). kS > 0: a lane holds
// at most kS rows and a thread's kQ x kS loads are one batch, issued
// together and summed a channel at a time, each lane's rows in row order
// and then the lanes' tree (few registers: no lane keeps a vector of sums).
// CTAs an SM asked of the compiler: 4 with kS (64 registers), 3 with one
// or two lanes a thread (85), else 1. On an H100 (chip_step_ab.py) ResNet's
// 16x16 stage ran 4% faster at 80 registers than at 90, and its 8x8 stage
// 20% slower at 72 registers than at 64.
template <typename T, int kQ, int kS>
__global__ void __launch_bounds__(kThreads, kS > 0 ? 4 : kQ <= 2 ? 3 : 1)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ mean_out,
                float* __restrict__ rstd_out, float* __restrict__ sums_out,
                int hw, int c, int g, int lanes, int tlanes, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  // Lanes summed side by side (their loads in flight together), then
  // their subtree, then the next P; the kQ / P subtrees on a counter.
  constexpr int P = kQ < 4 ? kQ : 4;
  constexpr int kGroups = kQ / P;
  constexpr int kDepth = log2_of(kGroups) + 1;
  constexpr int kSlots = kInFlight / P;  // slots of the P lanes a batch
  // [tlanes][c] subtree roots of the threads, reduced in place to row 0:
  // this CTA's channel totals.
  __shared__ float sh1[kThreads * kMaxVec];
  __shared__ float sh2[kThreads * kMaxVec];

  allow_dependent_launch();
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / split;
  const int per_cta = lanes / split;   // this CTA's lanes: one subtree
  const int slots = (hw + lanes - 1) / lanes;  // rows a lane (at most)
  const int nvec = c / VEC;
  const int tid = threadIdx.x;
  const int tl = tid / nvec;
  const int v = tid % nvec;
  const T* xb = x + (int64_t)b * hw * c;

  if (tl < tlanes) {
    const uint4* base = reinterpret_cast<const uint4*>(xb) + v;
    float a1[P][VEC], a2[P][VEC], t1[kDepth][VEC], t2[kDepth][VEC];
    if constexpr (kS > 0) {
      const int lane = rank * per_cta + tl * kQ;
      uint4 raw[kQ][kS];
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
#pragma unroll
        for (int u = 0; u < kS; ++u) {
          const int row = lane + j + u * lanes;
          raw[j][u] = u < slots && row < hw
                          ? __ldg(base + (int64_t)row * nvec)
                          : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float v1[kQ], v2[kQ];
#pragma unroll
        for (int j = 0; j < kQ; ++j) {
          v1[j] = 0.f;
          v2[j] = 0.f;
#pragma unroll
          for (int u = 0; u < kS; ++u) {
            if (u < slots && lane + j + u * lanes < hw)
              add_one<T>(to_f32(reinterpret_cast<const T*>(&raw[j][u])[k]),
                         v1[j], v2[j]);
          }
        }
#pragma unroll
        for (int w = 1; w < kQ; w *= 2) {
#pragma unroll
          for (int j = 0; j + w < kQ; j += 2 * w) {
            v1[j] = __fadd_rn(v1[j], v1[j + w]);
            v2[j] = __fadd_rn(v2[j], v2[j + w]);
          }
        }
        a1[0][k] = v1[0];
        a2[0][k] = v2[0];
      }
    }
#pragma unroll
    for (int grp = 0; grp < (kS > 0 ? 0 : kGroups); ++grp) {
      const int lane = rank * per_cta + tl * kQ + grp * P;
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          a1[p][k] = 0.f;
          a2[p][k] = 0.f;
        }
      }
      // kSlots slots of the P lanes: kInFlight predicated loads issued
      // together, then added, each lane's rows in row order.
      for (int s0 = 0; s0 < slots; s0 += kSlots) {
        uint4 raw[kSlots][P];
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int row = lane + p + (s0 + u) * lanes;
            raw[u][p] = s0 + u < slots && row < hw
                            ? __ldg(base + (int64_t)row * nvec)
                            : make_uint4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int u = 0; u < kSlots; ++u) {
#pragma unroll
          for (int p = 0; p < P; ++p) {
            if (s0 + u < slots && lane + p + (s0 + u) * lanes < hw)
              accumulate<T>(raw[u][p], a1[p], a2[p]);
          }
        }
      }
      // The P lanes' subtree (lanes 2i and 2i+1, then the pairs).
#pragma unroll
      for (int w = 1; w < P; w *= 2) {
#pragma unroll
        for (int p = 0; p + w < P; p += 2 * w) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            a1[p][k] = __fadd_rn(a1[p][k], a1[p + w][k]);
            a2[p][k] = __fadd_rn(a2[p][k], a2[p + w][k]);
          }
        }
      }
      if (kGroups > 1) push_subtree<VEC, kDepth>(grp, a1[0], a2[0], t1, t2);
    }
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      *reinterpret_cast<float4*>(sh1 + tl * c + v * VEC + k) =
          make_float4(a1[0][k], a1[0][k + 1], a1[0][k + 2], a1[0][k + 3]);
      *reinterpret_cast<float4*>(sh2 + tl * c + v * VEC + k) =
          make_float4(a2[0][k], a2[0][k + 1], a2[0][k + 2], a2[0][k + 3]);
    }
  }
  __syncthreads();
  // A channel's thread rows meet in the same tree in one thread's
  // registers (a counter, row by row); the root goes to row 0: the thread
  // is the only one that reads or writes its column.
  for (int ch = tid; ch < c; ch += kThreads) {
    float c1[log2_of(kLanes) + 1][1], c2[log2_of(kLanes) + 1][1];
    float root1 = 0.f, root2 = 0.f;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (j >= tlanes) break;
      float x1 = sh1[j * c + ch], x2 = sh2[j * c + ch];
      push_subtree<1, log2_of(kLanes) + 1>(j, &x1, &x2, c1, c2);
      root1 = x1;  // the root once row tlanes - 1 is in
      root2 = x2;
    }
    sh1[ch] = root1;
    sh2[ch] = root2;
  }
  // A one-CTA cluster needs no cluster barrier (and pays none).
  if (split > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (rank == 0) {
    // The group's channel totals meet in the balanced tree too: channel i
    // of a group takes channel i + w for every i a multiple of 2w (a
    // channel past the group adds nothing). A power-of-two group of at
    // most 32 channels by shuffles among the threads that hold them (a
    // warp-uniform loop: the channels past C hold zeros); any other a
    // level at a time in shared memory.
    const int cpg = c / g;
    const float cnt = (float)hw * (float)cpg;
    const bool by_shuffle = (cpg & (cpg - 1)) == 0 && cpg <= 32;
    for (int ch0 = 0; ch0 < c; ch0 += kThreads) {
      const int ch = ch0 + tid;
      float tot1 = 0.f, tot2 = 0.f;
      if (ch < c) {
        if (split > 1) {
          // The cluster's subtree roots of the channel, read from each
          // rank's shared memory (its own included) with all reads in
          // flight, meet in the same tree; ranks past the cluster are
          // never read.
          float r1[kMaxSplit], r2[kMaxSplit];
#pragma unroll
          for (int r = 0; r < kMaxSplit; ++r) {
            r1[r] = r < split ? cluster.map_shared_rank(sh1, r)[ch] : 0.f;
            r2[r] = r < split ? cluster.map_shared_rank(sh2, r)[ch] : 0.f;
          }
#pragma unroll
          for (int w = 1; w < kMaxSplit; w *= 2) {
#pragma unroll
            for (int r = 0; r + w < kMaxSplit; r += 2 * w) {
              if (r + w < split) {
                r1[r] = __fadd_rn(r1[r], r1[r + w]);
                r2[r] = __fadd_rn(r2[r], r2[r + w]);
              }
            }
          }
          tot1 = r1[0];
          tot2 = r2[0];
        } else {
          tot1 = sh1[ch];
          tot2 = sh2[ch];
        }
      }
      if (by_shuffle) {
        for (int off = 1; off < cpg; off *= 2) {
          tot1 = __fadd_rn(tot1, __shfl_xor_sync(0xffffffffu, tot1, off));
          tot2 = __fadd_rn(tot2, __shfl_xor_sync(0xffffffffu, tot2, off));
        }
        if (ch < c && ch % cpg == 0) {
          const int gi = ch / cpg;
          write_stats(tot1, tot2, cnt, eps, mean_out + b * g + gi,
                      rstd_out + b * g + gi);
          if (sums_out != nullptr) {
            sums_out[2 * (b * g + gi)] = tot1;
            sums_out[2 * (b * g + gi) + 1] = tot2;
          }
        }
      } else if (ch < c) {
        // Only this thread reads or writes rank 0's column ch.
        sh1[ch] = tot1;
        sh2[ch] = tot2;
      }
    }
    if (!by_shuffle) {
      __syncthreads();
      for (int w = 1; w < cpg; w *= 2) {
        for (int ch = tid; ch < c; ch += kThreads) {
          const int i = ch % cpg;
          if (i % (2 * w) == 0 && i + w < cpg) {
            sh1[ch] = __fadd_rn(sh1[ch], sh1[ch + w]);
            sh2[ch] = __fadd_rn(sh2[ch], sh2[ch + w]);
          }
        }
        __syncthreads();
      }
      for (int gi = tid; gi < g; gi += kThreads) {
        const float g1 = sh1[gi * cpg], g2 = sh2[gi * cpg];
        write_stats(g1, g2, cnt, eps, mean_out + b * g + gi,
                    rstd_out + b * g + gi);
        if (sums_out != nullptr) {
          sums_out[2 * (b * g + gi)] = g1;
          sums_out[2 * (b * g + gi) + 1] = g2;
        }
      }
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

// The order's lanes (file comment): the least power of two >= HW, at most
// kLanes. A function of HW alone.
int stats_lanes(int hw) {
  int lanes = 1;
  while (lanes < hw && lanes < kLanes) lanes *= 2;
  return lanes;
}

// B x split CTAs, in clusters of `split` per sample (a plain launch at 1).
// Each CTA takes lanes / split whole lanes; its threads are laid out
// [tlanes][C / VEC], tlanes the most (a power of two) that fit kThreads,
// so a thread owns q = lanes / split / tlanes whole lanes. sums: null, or
// [B, G, 2] f32 for each group's (sum x, sum x^2) (the card tests).
template <typename T>
int launch_stats(const void* x, void* mean, void* rstd, void* sums, int b,
                 int hw, int c, int g, float eps, int split, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int lanes = stats_lanes(hw);
  const int nvec = c / VEC;
  if (split < 1 || split > kMaxSplit || lanes % split || c % VEC ||
      nvec < 1 || nvec > kThreads || g < 1 || c % g)
    return (int)cudaErrorInvalidValue;
  const int per_cta = lanes / split;
  int tlanes = 1;
  while (tlanes * 2 <= per_cta && tlanes * 2 * nvec <= kThreads) tlanes *= 2;
  const int q = per_cta / tlanes;
  // A thread's loads in one batch: the kS path, kS the least power of two
  // >= the rows a lane holds.
  const int slots = (hw + lanes - 1) / lanes;
  const int ks = q > 1 && q * slots <= kInFlight ? (slots == 1   ? 1
                                                    : slots == 2 ? 2
                                                                 : 4)
                                                 : 0;
  void (*kernel)(const T*, float*, float*, float*, int, int, int, int, int,
                 float) =
      q == 1                ? gn_stats_kernel<T, 1, 0>
      : q == 2 && ks == 1   ? gn_stats_kernel<T, 2, 1>
      : q == 2 && ks == 2   ? gn_stats_kernel<T, 2, 2>
      : q == 2 && ks == 4   ? gn_stats_kernel<T, 2, 4>
      : q == 2              ? gn_stats_kernel<T, 2, 0>
      : q == 4 && ks == 1   ? gn_stats_kernel<T, 4, 1>
      : q == 4 && ks == 2   ? gn_stats_kernel<T, 4, 2>
      : q == 4              ? gn_stats_kernel<T, 4, 0>
      : q == 8 && ks == 1   ? gn_stats_kernel<T, 8, 1>
      : q == 8              ? gn_stats_kernel<T, 8, 0>
      : q == 16             ? gn_stats_kernel<T, 16, 0>
                            : gn_stats_kernel<T, 32, 0>;
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
  cfg.numAttrs = split > 1 ? 1 : 0;  // one CTA per sample: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)x, (float*)mean, (float*)rstd, (float*)sums,
      hw, c, g, lanes, tlanes, eps);
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

int dls_gn_stats_bf16(const void* x, void* mean, void* rstd, void* sums,
                      int b, int hw, int c, int g, float eps, int split,
                      void* stream) {
  return launch_stats<__nv_bfloat16>(x, mean, rstd, sums, b, hw, c, g, eps,
                                     split, stream);
}

int dls_gn_stats_f32(const void* x, void* mean, void* rstd, void* sums,
                     int b, int hw, int c, int g, float eps, int split,
                     void* stream) {
  return launch_stats<float>(x, mean, rstd, sums, b, hw, c, g, eps, split,
                             stream);
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
