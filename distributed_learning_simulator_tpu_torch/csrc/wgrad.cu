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
// plain NHWC one the model keeps, and each of the 9 taps is one
// dW_tap = X_tap^T G contraction (M = ci, N = co, K = B*H*W positions).
//
// What bounds it on an H100: at the main path's shape (B=25, 32x32, C=64,
// bf16) the function moves 6.70 MB (x and g read once, dW written once):
// 2.00 us at 3.35 TB/s; and does 1.89 GFLOP: 1.91 us at the 989 TFLOP/s
// dense bf16 tensor-core peak. Bytes and operations bound it about equally.
//
// Both passes split K into n_chunks runs of whole row pairs (rows 2p, 2p + 1
// of one sample; with H odd a sample's last pair has one row), balanced to
// within one pair (ops/wgrad_cuda.py `chunking` plans them; a run may span
// two samples, a pair never does), write one f32 partial per (chunk, tap)
// and leave the sum over chunks to `wgrad_reduce_kernel`, which adds them in
// a fixed order. No float atomics: a rerun is bitwise equal.
//
// bf16 inputs (every main path): `wgrad_tc_partial_kernel`, on the tensor
// cores.
// * One CTA per (K-chunk, dy, 64x64 output tile): 44 chunks x 3 dy = 132
//   CTAs at C = 64, one per SM, 9 or 10 row pairs each. A CTA computes the
//   three taps (dy, 0..2) at once: for a fixed dy they read the same x rows,
//   shifted by one column each. A staged piece holds 32 positions of one
//   g row and the 34 x columns w0-1 .. w0+32 around them, so tap dx is the x
//   view starting at column dx: a 16-deep K slab is 16 consecutive staged
//   rows, and the shift is an address offset per lane.
// * Staging is TMA: thread 0 issues per stage (one piece of both rows of a
//   pair) four box loads of 4-D (C, W, H, B) tensor maps, completed on an
//   mbarrier, into a ring of kStages stages. The maps zero-fill what lies
//   outside the tensor: the SAME padding (image row -1 or H, column -1 or
//   W), the ragged end of a row and channels past C, so no thread computes
//   an address or a mask (staged with cp.async from every thread, that
//   arithmetic took about as long as the MMAs on an H100).
// * Products are mma.sync.m16n8k16 bf16 x bf16 -> f32. Both operands sit in
//   shared memory as [k][c] rows of 64 channels (128 bytes), MN-major, so
//   both are loaded with ldmatrix.trans. The TMA's 128-byte swizzle XORs the
//   16-byte chunk index of each row with row % 8 (boxes start at 1024-byte
//   boundaries), so the eight rows one ldmatrix phase reads fall in eight
//   different bank groups. 8 warps each own a 16 (ci) x 32 (co) piece of
//   the tile for all three taps: 48 f32 accumulators a thread, kept in
//   registers. Per 16-deep slab a warp issues 2 ldmatrix.x4 for g (shared by
//   the three taps), 3 for x, then 12 MMAs.
// * Cost beyond the bound, at (25, 32, 32, 64): each of the 3 dy CTAs of a
//   chunk stages its own x and g rows, so x and g cross L2 3 times (about
//   20 MB of TMA traffic against 6.55 MB of inputs); the partials are 44 x
//   9 taps x 64 x 64 f32 = 6.5 MB (chunks x taps x C x C), written once
//   and read back by the reduce. A cluster of the three dy CTAs sharing the
//   g and x boxes by TMA multicast (half the traffic) ran slower on an H100:
//   its slot hand-off waits for the slowest of the three every stage.
//
// f32 inputs: `wgrad_f32_partial_kernel`, f32 FMAs on the CUDA cores. The
// tensor cores would take f32 only as TF32 (about three decimal digits),
// which breaks the 1e-4 f32 parity gate and the f32 ResNet-18 card-vs-CPU
// check; no main path gives this kernel f32. A block owns one (K chunk,
// tap, 64x64 tile), stages 32 positions at a time of the shifted x and of g
// in shared memory as f32, and each of its 256 threads accumulates a 4x4
// piece of the tile in registers.
//
// Plain C interface for ctypes: every function returns cudaGetLastError()
// right after its launches, and the Python wrapper raises if it is not 0.

#include <cuda.h>  // CUtensorMap; the encoder comes from the runtime
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // ci and co extent of one block's output tile

// ---------------------------------------------------------------------------
// bf16: tensor cores.

constexpr int kTcThreads = 256;  // 8 warps: 4 along ci x 2 along co
constexpr int kSeg = 32;         // g positions of one image row per piece
constexpr int kXSeg = kSeg + 2;  // x columns per piece: w0-1 .. w0+kSeg
constexpr int kPieces = 2;       // pieces per stage: the rows of a pair
constexpr int kStages = 4;       // ring depth
// Shared-memory layout of a stage, in 128-byte rows (64 bf16 channels):
// the pieces' g boxes, then their x boxes, each at a 1024-byte boundary
// (the TMA 128-byte swizzle repeats every 8 rows).
constexpr int kXStride = 40;                              // rows per x box
constexpr int kXRow0 = kPieces * kSeg;                    // 64
constexpr int kStageRows = kXRow0 + kPieces * kXStride;  // 144
constexpr int kTcSmemBytes = kStages * kStageRows * 128 + 1024;  // + align
constexpr uint32_t kStageBytes = kPieces * (kSeg + kXSeg) * 128;  // 16,896

// Byte offset of 16-byte chunk `chunk` (0..7) of shared-memory row `row`:
// the TMA's 128-byte swizzle for boxes at 1024-byte boundaries.
__device__ __forceinline__ uint32_t swizzle(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-D tensor map at coordinates (c0, c1, c2, c3) into shared
// memory at `dst`; completion is counted on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Units [u0, u1) of the B * ceil(H/2) row pairs (a pair never spans two
// samples; with H odd a sample's last pair has one row) that K-chunk `chunk`
// of `n_chunks` covers: a balanced split.
__device__ __forceinline__ void chunk_units(int chunk, int n_chunks,
                                            int total_units, int& u0,
                                            int& u1) {
  u0 = (int)((int64_t)chunk * total_units / n_chunks);
  u1 = (int)((int64_t)(chunk + 1) * total_units / n_chunks);
}

// xmap and gmap view x and g as 4-D (C, W, H, B) tensors with 64 x 34 and
// 64 x 32 (channel x column) boxes of one image row, 128-byte swizzled.
__global__ void __launch_bounds__(kTcThreads, 1)
wgrad_tc_partial_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap gmap,
                        float* __restrict__ partial, int b, int h, int w,
                        int c) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  const uint32_t sbase =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023) & ~1023u;
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(full);

  const int chunk = blockIdx.x;
  const int dy = blockIdx.y;
  const int n_tiles = (c + kTile - 1) / kTile;
  const int ci0 = (blockIdx.z / n_tiles) * kTile;
  const int co0 = (blockIdx.z % n_tiles) * kTile;
  const int pairs = (h + 1) / 2;  // row pairs per sample
  int u0, u1;
  chunk_units(chunk, gridDim.x, b * pairs, u0, u1);
  const int pieces_per_row = (w + kSeg - 1) / kSeg;
  // Stage s: piece s % pieces_per_row of row pair u0 + s / pieces_per_row.
  const int n_steps = (u1 - u0) * pieces_per_row;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 stages `step` into ring slot step % kStages: for rows h0 and
  // h0 + 1 of the pair one g box each (32 columns from w0) and one x box
  // each (34 columns from w0 - 1, image rows h0 + dy - 1 and h0 + dy). The
  // tensor maps zero-fill whatever lies outside the image: the SAME
  // padding, row h0 + 1 = H when H is odd, the ragged end of a row and
  // channels past C.
  auto issue = [&](int step) {
    const int slot = step % kStages;
    const uint32_t bar = bar0 + 8 * slot;
    const uint32_t dst = sbase + slot * kStageRows * 128;
    const int unit = u0 + step / pieces_per_row;
    const int w0 = (step % pieces_per_row) * kSeg;
    const int sample = unit / pairs;
    const int h0 = 2 * (unit - sample * pairs);
    mbar_expect_tx(bar, kStageBytes);
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      tma_load_4d(dst + q * kSeg * 128, &gmap, bar, co0, w0, h0 + q, sample);
      tma_load_4d(dst + (kXRow0 + q * kXStride) * 128, &xmap, bar, ci0,
                  w0 - 1, h0 + q + dy - 1, sample);
    }
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages - 1 && s < n_steps; ++s) issue(s);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3;   // ci rows 16 wm .. 16 wm + 15 of the tile
  const int wn = warp >> 2;  // co columns 32 wn .. 32 wn + 31
  // ldmatrix row and chunk offsets of this lane (see the fragment layouts of
  // mma.m16n8k16: A's four 8x8 blocks are (m, k) = (0,0) (8,0) (0,8) (8,8),
  // B's two n8 tiles each (k 0..7) and (k 8..15)).
  const int a_row = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int a_chunk = wm * 2 + ((lane >> 3) & 1);
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_chunk = wn * 4 + (lane >> 4);

  float acc[3][4][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][n][e] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    mbar_wait(bar0 + 8 * (step % kStages), (step / kStages) & 1);
    __syncthreads();  // every warp is done with slot step - 1: refill it
    if (threadIdx.x == 0 && step + kStages - 1 < n_steps) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(step + kStages - 1);
    }
    const int slot_row = (step % kStages) * kStageRows;
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      const int g_row = slot_row + q * kSeg;
      const int x_row = slot_row + kXRow0 + q * kXStride;
#pragma unroll
      for (int t = 0; t < kSeg / 16; ++t) {
        uint32_t b[4][2];
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
          ldmatrix_x4_trans(
              sbase + swizzle(g_row + 16 * t + b_row, b_chunk + 2 * nb),
              b[2 * nb][0], b[2 * nb][1], b[2 * nb + 1][0], b[2 * nb + 1][1]);
        uint32_t a[3][4];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          ldmatrix_x4_trans(
              sbase + swizzle(x_row + 16 * t + dx + a_row, a_chunk),
              a[dx][0], a[dx][1], a[dx][2], a[dx][3]);
        // All five fragments are loaded before the twelve MMAs use them.
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(acc[dx][n], a[dx], b[n][0], b[n][1]);
      }
    }
  }

  // Accumulator (m, n) of lane: rows gid and gid + 8, columns 2 tq, 2 tq + 1.
  const int gid = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    float* out = partial + ((int64_t)chunk * 9 + dy * 3 + dx) * c * c;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int co = co0 + wn * 32 + n * 8 + 2 * tq;
      if (co >= c) continue;  // C % 8 == 0: the pair is in or out together
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ci = ci0 + wm * 16 + gid + 8 * half;
        if (ci < c)
          *reinterpret_cast<float2*>(out + (int64_t)ci * c + co) =
              make_float2(acc[dx][n][2 * half], acc[dx][n][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.

constexpr int kThreads = 256;  // 16 x 16 threads, a 4x4 piece each
constexpr int kRows = 32;      // K rows staged in shared memory per step

__global__ void __launch_bounds__(kThreads)
wgrad_f32_partial_kernel(const float* __restrict__ x,
                         const float* __restrict__ g,
                         float* __restrict__ partial, int b, int h, int w,
                         int c) {
  constexpr int VEC = 4;
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
  const int pairs = (h + 1) / 2;
  int u0, u1;
  chunk_units(chunk, gridDim.x, b * pairs, u0, u1);
  // Unit u starts at image row (u / pairs) * H + 2 * (u % pairs).
  const int64_t k0 = ((int64_t)(u0 / pairs) * h + 2 * (u0 % pairs)) * w;
  const int64_t k1 = ((int64_t)(u1 / pairs) * h + 2 * (u1 % pairs)) * w;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // co = co0 + 4 * tx + j
  const int ty = tid / 16;  // ci = ci0 + 4 * ty + i
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t kb = k0; kb < k1; kb += kRows) {
    for (int v = tid; v < kRows * VPR; v += kThreads) {
      const int r = v / VPR;
      const int cv = (v % VPR) * VEC;
      const int64_t k = kb + r;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 gv = xv;
      if (k < k1) {
        // C is a multiple of 8 (checked by the wrapper), so a vector that
        // starts inside C ends inside it.
        if (co0 + cv < c)
          gv = __ldg(reinterpret_cast<const float4*>(g + k * c + co0 + cv));
        const int wi = (int)(k % w);
        const int hi = (int)((k / w) % h);
        const int hs = hi + dy - 1;
        const int ws = wi + dx - 1;
        if (ci0 + cv < c && hs >= 0 && hs < h && ws >= 0 && ws < w) {
          // Same sample, shifted row: k + (dy - 1) * W + (dx - 1).
          const int64_t ks = k + (dy - 1) * w + (dx - 1);
          xv = __ldg(reinterpret_cast<const float4*>(x + ks * c + ci0 + cv));
        }
      }
      *reinterpret_cast<float4*>(&xs[r][cv]) = xv;
      *reinterpret_cast<float4*>(&gs[r][cv]) = gv;
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

// ---------------------------------------------------------------------------
// Both: the partials summed over the chunks in a fixed order. A block owns
// kRedCols float4 columns of the [n_chunks][9 C C] partials; thread group q
// sums chunks q, q + kRedGroups, ... in order (about n_chunks / 8 loads in
// flight a thread instead of one n_chunks-long chain), and the groups'
// sums are added in group order.

constexpr int kRedCols = 32;
constexpr int kRedGroups = kThreads / kRedCols;

__global__ void __launch_bounds__(kThreads)
wgrad_reduce_kernel(const float4* __restrict__ partial,
                    float4* __restrict__ out, int n_chunks, int n4) {
  __shared__ float4 sums[kRedGroups][kRedCols];
  const int lane = threadIdx.x % kRedCols;
  const int q = threadIdx.x / kRedCols;
  const int col = blockIdx.x * kRedCols + lane;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < n4) {
#pragma unroll 4
    for (int k = q; k < n_chunks; k += kRedGroups) {
      const float4 v = __ldg(partial + (int64_t)k * n4 + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  sums[q][lane] = s;
  __syncthreads();
  if (q == 0 && col < n4) {
#pragma unroll
    for (int i = 1; i < kRedGroups; ++i) {
      s.x += sums[i][lane].x;
      s.y += sums[i][lane].y;
      s.z += sums[i][lane].z;
      s.w += sums[i][lane].w;
    }
    out[col] = s;
  }
}

int launch_reduce(const void* partial, void* out, int n_chunks, int c,
                  cudaStream_t s) {
  const int n4 = 9 * c * c / 4;  // C % 8 == 0
  wgrad_reduce_kernel<<<(n4 + kRedCols - 1) / kRedCols, kThreads, 0, s>>>(
      (const float4*)partial, (float4*)out, n_chunks, n4);
  return (int)cudaGetLastError();
}

// The 4-D (C, W, H, B) tensor map of a [B, H, W, C] bf16 tensor with boxes
// of 64 channels x `box_w` columns of one image row, 128-byte swizzled;
// out-of-bounds elements read as zero.
cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int b, int h,
                            int w, int c, int box_w) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess) return cudaErrorNotSupported;
    encode = (PFN_cuTensorMapEncodeTiled_v12000)fn;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h,
                              (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2,
                                 (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kTile, (cuuint32_t)box_w, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int dls_wgrad_bf16(const void* x, const void* g, void* partial, void* out,
                   int b, int h, int w, int c, int n_chunks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap xmap, gmap;
  cudaError_t err = encode_rows_map(&xmap, x, b, h, w, c, kXSeg);
  if (err != cudaSuccess) return (int)err;
  err = encode_rows_map(&gmap, g, b, h, w, c, kSeg);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wgrad_tc_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (c + kTile - 1) / kTile;
  const dim3 grid(n_chunks, 3, n_tiles * n_tiles);
  wgrad_tc_partial_kernel<<<grid, kTcThreads, kTcSmemBytes, s>>>(
      xmap, gmap, (float*)partial, b, h, w, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, out, n_chunks, c, s);
}

int dls_wgrad_f32(const void* x, const void* g, void* partial, void* out,
                  int b, int h, int w, int c, int n_chunks, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (c + kTile - 1) / kTile;
  const dim3 grid(n_chunks, 9, n_tiles * n_tiles);
  wgrad_f32_partial_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)x, (const float*)g, (float*)partial, b, h, w, c);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, out, n_chunks, c, s);
}

}  // extern "C"
