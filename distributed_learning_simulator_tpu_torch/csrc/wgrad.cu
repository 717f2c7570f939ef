// Weight gradient of a 3x3, stride-1, zero-padded (SAME) convolution on
// channels-last activations, on Hopper:
//
//   dW[dy, dx, ci, co] = sum over (b, h, w) of
//                        x[b, h + dy - 1, w + dx - 1, ci] * g[b, h, w, co]
//
// with x [B, H, W, C] the convolution's input, g [B, H, W, C] the gradient
// of its output, and x read as 0 outside the image. dW is [3, 3, C, C] f32
// (HWIO, the JAX package's kernel layout). A launch computes it for N
// clients at once: x, g [N, B, H, W, C] -> dW [N, 3, 3, C, C], as the TPU
// kernel's grid runs over its client axis (N = 1 is one client's call).
//
// It replaces scripts/exp_pallas_wgrad.py `_wgrad_kernel` (called through
// `pallas_wgrad`), the TPU prototype that computed the same gradient for
// ResNet's stage-1 convolutions as 18 rank-2 contractions on a W-folded
// layout, its grid (N, 3, TILES) adding each client's tiles into that
// client's output in the same order whatever N is. The fold was a TPU
// lane-layout device; here the layout is the plain NHWC one the model
// keeps, and each of the 9 taps is one dW_tap = X_tap^T G contraction
// (M = ci, N = co, K = B*H*W positions).
//
// What bounds it on an H100 (bytes: x and g read once, dW written once, at
// 3.35 TB/s; operations at the 989 TFLOP/s dense bf16 tensor-core peak):
// one client (25, 32, 32, 64) moves 6.70 MB (2.00 us) and does 1.89 GFLOP
// (1.91 us); the flagship's chunk of 40 clients moves 268 MB (0.0800 ms)
// and does 75.5 GFLOP (0.0763 ms). Bytes and operations bound it about
// equally at both.
//
// The order, the same for a client whatever N is and whichever layout
// computes it. A client's K (its B * ceil(H/2) row pairs: rows 2p, 2p + 1
// of one sample; with H odd a sample's last pair has one row) is cut into
// n_runs runs of whole pairs, balanced to within one pair, by a rule of
// (B, H, W, C) alone (ops/wgrad_cuda.py `chunking`: 44 runs at the main
// shape). Run i's partial p_i is accumulated from zero by one warpgroup
// (one block in f32) over the run's positions in one fixed sequence of
// products. The client's dW is ((p_0 + p_1) + p_2) + ..., added left to
// right in f32. No float atomics: a rerun is bitwise equal, and a client's
// row of an N-client call is bitwise its one-client call's.
//
// bf16 inputs (every main path): `wgrad_tc_kernel`, on the tensor cores.
// A CTA computes the three taps (dy, 0..2) of one 64x64 (ci, co) tile: one
// consumer warpgroup (warps 0-3) holds their f32 accumulators (96 a
// thread), and one producer warp keeps TMA loads in flight. The wrapper
// lays the work out by N (ops/wgrad_cuda.py `chunking`), every layout with
// the same bits:
// * FEW (under 36 CTAs of the next kind, N < 12 at C = 64): one CTA per
//   (client, run, dy, tile), 132 CTAs for one client; each writes its
//   run's partial to scratch, and `wgrad_reduce_kernel` adds a client's
//   partials left to right (with one run the CTA writes dW itself);
// * WALK (up to one a SM): one CTA per (client, dy, tile) walks all of its
//   client's runs: at each run's end it adds the finished partial to a
//   running total in shared memory (each thread its own 96 floats) and
//   starts the next run from zero, so no partial leaves the SM; an 8-deep
//   ring, one CTA an SM (past 132 CTAs, N > 44 at C = 64, a second wave:
//   no main path launches that many bf16 clients).
// chip_smoke.py phase 1d on an H100 80GB HBM3 at 700 W, (N, 25, 32, 32,
// 64), ms: FEW 0.0140 at N = 1, 0.1233 at 10, 0.2331 at 20 (about 0.012 a
// client); WALK 0.1412-0.1435 from N = 1 to 40 (one CTA walks its
// client's 400 row pairs, so its time is flat while the CTAs fit the
// card), 0.4353 at 80 (two waves). Walking pays from 12 clients on.
// * Staging: a stage is one piece of a row pair: 32 positions of g rows
//   h0, h0 + 1 (one 64 x 32 x 2 box) and the 34 x columns w0-1 .. w0+32
//   around them in rows h0 + dy - 1, h0 + dy (two boxes), loaded once for
//   the three taps. The 4-D (C, W, H, N*B) tensor maps zero-fill what lies
//   outside: the SAME padding, row H when H is odd, the ragged end of a row
//   and channels past C, so no thread computes an address or a mask. The
//   ring has full and empty mbarriers per slot: the producer waits for a
//   slot's release, the consumers for its bytes, and no CTA-wide barrier
//   runs in the loop.
// * Products: one wgmma.m64n192k16 bf16 x bf16 -> f32 per 16 positions,
//   both operands read from shared memory through descriptors: A = G^T (co
//   x 16 positions) and B = the three taps' x views side by side (16
//   positions x (dx, ci)), so D[co][dx, ci] = dW[dy, dx]^T. Both are staged
//   as [position][64 channels] rows of 128 bytes, 128-byte swizzled
//   (MN-major, taken transposed). Tap dx's view starts dx rows into the x
//   box: B's three 64-channel blocks are 128 bytes apart (the descriptor's
//   leading offset), and since the swizzle follows the absolute address
//   bits, a view off the 1024-byte atom needs no base offset (one box
//   serves the three taps; three boxes shifted by dx would stage x three
//   times). One product per slab reads G once for the three taps, where
//   three m64n64k16 products would read it three times.
// * The four limits of the mma.sync kernel this replaces, and what the
//   design does about each: (1) each of a client's three dy CTAs staged its
//   own x and g rows: they still do (a CTA owns one dy; holding all nine
//   taps, 288 accumulators, takes three warpgroups and a shared total of
//   147 KB), about 811 MB through L2 at N = 40, but a CTA stages each row
//   once for its three taps, and the running total keeps one CTA per
//   (client, dy) with no partials; (2) ldmatrix traffic: gone, wgmma reads
//   both operands from shared memory, G once per three taps; (3) mma.sync:
//   wgmma; (4) idle SMs and the lockstep loop: the producer warp and the
//   two mbarrier rings replace the per-stage __syncthreads. 120 CTAs at
//   N = 40 still leave 12 SMs idle: the order rule keeps a client's runs
//   on one chain, and smaller units (co halves, single taps) give an SM at
//   most 1/120 of the work all the same.
//
// f32 inputs: `wgrad_f32_partial_kernel`, f32 FMAs on the CUDA cores. The
// tensor cores would take f32 only as TF32 (about three decimal digits),
// which breaks the 1e-4 f32 parity gate and the f32 ResNet-18 card-vs-CPU
// check. A block owns one (client, run, tap, 64x64 tile), stages 32
// positions at a time of the shifted x and of g in shared memory as f32,
// and each of its 256 threads accumulates a 4x4 piece of the tile in
// registers; the partials meet in `wgrad_reduce_kernel` as above.
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

constexpr int kConsumers = 128;                   // one warpgroup
constexpr int kTcThreads = kConsumers + 32;       // + the producer warp
constexpr int kSeg = 32;         // g positions of one image row per piece
constexpr int kXSeg = kSeg + 2;  // x columns per piece: w0-1 .. w0+kSeg
// Shared-memory layout of a stage, in 128-byte rows (64 bf16 channels):
// the g box (row q * kSeg + p: row h0 + q, column w0 + p), then one x box
// per row of the pair, each at a 1024-byte boundary (the 128-byte swizzle
// repeats every 8 rows).
constexpr int kGRows = 2 * kSeg;                        // 64
constexpr int kXStride = 40;                            // rows per x box
constexpr int kStageRows = kGRows + 2 * kXStride;       // 144
constexpr uint32_t kStageBytes = (kGRows + 2 * kXSeg) * 128;  // 16,896
constexpr int kFewStages = 4;      // ring of a few-client CTA: 2 an SM
constexpr int kWalkStages = 8;     // ring of a walking CTA alone on its SM
constexpr int kAccs = 3 * 32;   // f32 accumulators a consumer thread holds

constexpr int tc_smem_bytes(int stages, bool walk) {
  return stages * kStageRows * 128 + (walk ? kAccs * kConsumers * 4 : 0) +
         1024;  // + alignment
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// The wgmma descriptor of an operand staged as [position][64 channels] rows
// of 128 bytes from `addr`, 128-byte swizzled, MN-major: 16 positions as
// two 8-row core groups 1024 bytes apart (the stride field) and blocks of
// 64 channels `lead` bytes apart (the leading field). The swizzle follows
// the absolute shared-memory address bits, so a view that starts some rows
// into a 1024-byte-aligned box keeps base offset 0.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr,
                                                 uint32_t lead) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products.
__device__ __forceinline__ void fence_accs(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 192 f32, 96 a thread) += A x B with A (64 x 16) and B (16 x 192)
// bf16 in shared memory, both transposed (MN-major).
__device__ __forceinline__ void wgmma_m64n192k16(float* d, uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(1));
}

// First row pair of run `run` of `n_runs` over `total_units` pairs: a
// balanced split (run r covers [run_start(r), run_start(r + 1))).
__device__ __forceinline__ int run_start(int run, int n_runs,
                                         int total_units) {
  return (int)((int64_t)run * total_units / n_runs);
}

// Accumulator i of thread (warp, lane) of the warpgroup is element (co,
// n) of the product: co = 16 warp + lane / 4 + 8 ((i / 2) % 2), n = 8 (i /
// 4) + 2 (lane % 4) + i % 2, with n = 64 dx + ci. So i / 32 is the tap's
// dx, and even i and i + 1 are ci and ci + 1 of one co.
__device__ __forceinline__ void store_tap(float* out, const float* d, int c,
                                          int ci0, int co0, int tid) {
  const int co = co0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const int ci_base = ci0 + 2 * (tid & 3);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int ci = ci_base + 8 * (i >> 2);
    const int co_i = co + 8 * ((i >> 1) & 1);
    // C % 8 == 0: ci and ci + 1 are in or out together.
    if (ci < c && co_i < c) {
      out[(int64_t)ci * c + co_i] = d[i];
      out[(int64_t)(ci + 1) * c + co_i] = d[i + 1];
    }
  }
}

// xmap and gmap view x and g as 4-D (C, W, H, N*B) tensors with 64 x 34 x
// 1 and 64 x 32 x 2 (channel x column x row) boxes, 128-byte swizzled.
// Few clients: blockIdx.x is client * n_runs + run, and `partial` holds a
// [n_runs][9][C][C] block per client (or is dW when n_runs == 1). Many
// clients (kWalk): blockIdx.x is the client, and `partial` is dW.
template <int kStages, bool kWalk>
__global__ void __launch_bounds__(kTcThreads, 1)
wgrad_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap gmap,
                float* __restrict__ partial, int b, int h, int w, int c,
                int n_runs) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  const uint32_t sbase =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023) & ~1023u;
  const uint32_t full0 = (uint32_t)__cvta_generic_to_shared(full);
  const uint32_t empty0 = (uint32_t)__cvta_generic_to_shared(empty);

  const int client = kWalk ? blockIdx.x : blockIdx.x / n_runs;
  const int run0 = kWalk ? 0 : blockIdx.x % n_runs;
  const int run1 = kWalk ? n_runs : run0 + 1;
  const int dy = blockIdx.y;
  const int n_tiles = (c + kTile - 1) / kTile;
  const int ci0 = (blockIdx.z / n_tiles) * kTile;
  const int co0 = (blockIdx.z % n_tiles) * kTile;
  const int pairs = (h + 1) / 2;  // row pairs per sample
  const int units = b * pairs;
  const int u0 = run_start(run0, n_runs, units);
  const int pieces_per_row = (w + kSeg - 1) / kSeg;
  // Step s stages piece s % pieces_per_row of row pair u0 + s /
  // pieces_per_row: the CTA's runs are consecutive, so its steps are too.
  const int n_steps = (run_start(run1, n_runs, units) - u0) * pieces_per_row;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer: one thread keeps the ring full. Slot s's k-th fill
    // waits for the consumers' (k-1)-th release (parity 1 passes at once).
    if (threadIdx.x != kConsumers) return;
    for (int step = 0; step < n_steps; ++step) {
      const int slot = step % kStages;
      mbar_wait(empty0 + 8 * slot, ((step / kStages) + 1) & 1);
      const uint32_t bar = full0 + 8 * slot;
      const uint32_t dst = sbase + slot * kStageRows * 128;
      const int unit = u0 + step / pieces_per_row;
      const int w0 = (step % pieces_per_row) * kSeg;
      const int sample = unit / pairs;
      const int h0 = 2 * (unit - sample * pairs);
      const int row4 = client * b + sample;  // the maps' fourth coordinate
      mbar_expect_tx(bar, kStageBytes);
      tma_load_4d(dst, &gmap, bar, co0, w0, h0, row4);
#pragma unroll
      for (int q = 0; q < 2; ++q)
        tma_load_4d(dst + (kGRows + q * kXStride) * 128, &xmap, bar, ci0,
                    w0 - 1, h0 + q + dy - 1, row4);
    }
    return;
  }

  // The consumers: warpgroup 0. acc[32 dx + i] is tap (dy, dx)'s
  // accumulator i.
  const int tid = threadIdx.x;
  float acc[kAccs];
#pragma unroll
  for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  // The running total of the many-client layout: thread tid's accumulator
  // i at total[i * kConsumers + tid] (consecutive threads, consecutive
  // banks).
  float* total = reinterpret_cast<float*>(
      smem_raw + (sbase - (uint32_t)__cvta_generic_to_shared(smem_raw)) +
      kStages * kStageRows * 128);

  int step = 0;
  int held = -1;  // the slot whose products may still be reading it
  for (int run = run0; run < run1; ++run) {
    const int run_end =
        (run_start(run + 1, n_runs, units) - u0) * pieces_per_row;
    for (; step < run_end; ++step) {
      const int slot = step % kStages;
      mbar_wait(full0 + 8 * slot, (step / kStages) & 1);
      const uint32_t base = sbase + slot * kStageRows * 128;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int t = 0; t < kSeg / 16; ++t) {
          const uint32_t g_at = base + (q * kSeg + 16 * t) * 128;
          const uint32_t x_at = base + (kGRows + q * kXStride + 16 * t) * 128;
          // D [co][dx, ci] += G^T X: the three taps' x views, one row
          // apart, are the three 64-channel blocks of one B operand.
          wgmma_m64n192k16(acc, operand_desc(g_at, 1024),
                           operand_desc(x_at, 128));
        }
      wgmma_commit();
      // Every group but this step's is done: the previous slot is free.
      wgmma_wait<1>();
      if (held >= 0) mbar_arrive(empty0 + 8 * held);
      held = slot;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 3; ++t) fence_accs(acc + 32 * t);
    mbar_arrive(empty0 + 8 * held);
    held = -1;
    if (kWalk) {
      // total = p_0, then total = total + p_r: left to right.
#pragma unroll
      for (int i = 0; i < kAccs; ++i) {
        float* s = total + i * kConsumers + tid;
        *s = run == 0 ? acc[i] : *s + acc[i];
      }
    } else {
      float* out = partial + ((int64_t)blockIdx.x * 9 + dy * 3) * c * c;
#pragma unroll
      for (int t = 0; t < 3; ++t)
        store_tap(out + (int64_t)t * c * c, acc + 32 * t, c, ci0,
                         co0, tid);
    }
#pragma unroll
    for (int i = 0; i < kAccs; ++i) acc[i] = 0.f;
  }
  if (kWalk) {
#pragma unroll
    for (int i = 0; i < kAccs; ++i) acc[i] = total[i * kConsumers + tid];
    float* out = partial + ((int64_t)client * 9 + dy * 3) * c * c;
#pragma unroll
    for (int t = 0; t < 3; ++t)
      store_tap(out + (int64_t)t * c * c, acc + 32 * t, c, ci0, co0,
                       tid);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores.

constexpr int kThreads = 256;  // 16 x 16 threads, a 4x4 piece each
constexpr int kRows = 32;      // K rows staged in shared memory per step

// blockIdx.x is client * n_runs + run, as in the few-client bf16 layout.
__global__ void __launch_bounds__(kThreads)
wgrad_f32_partial_kernel(const float* __restrict__ x,
                         const float* __restrict__ g,
                         float* __restrict__ partial, int b, int h, int w,
                         int c, int n_runs) {
  constexpr int VEC = 4;
  constexpr int VPR = kTile / VEC;  // 16-byte vectors per staged row
  __shared__ __align__(16) float xs[kRows][kTile];
  __shared__ __align__(16) float gs[kRows][kTile];

  const int client = blockIdx.x / n_runs;
  const int run = blockIdx.x % n_runs;
  const int64_t client_elems = (int64_t)b * h * w * c;
  x += client * client_elems;
  g += client * client_elems;
  const int tap = blockIdx.y;  // dy * 3 + dx
  const int dy = tap / 3;
  const int dx = tap % 3;
  const int n_tiles = (c + kTile - 1) / kTile;
  const int ci0 = (blockIdx.z / n_tiles) * kTile;
  const int co0 = (blockIdx.z % n_tiles) * kTile;
  const int pairs = (h + 1) / 2;
  const int u0 = run_start(run, n_runs, b * pairs);
  const int u1 = run_start(run + 1, n_runs, b * pairs);
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

  float* out = partial + ((int64_t)blockIdx.x * 9 + tap) * c * c;
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
// Both: each client's partials added left to right. A thread owns one
// float4 of one client's (blockIdx.y) [n_runs][9 C C] partials: s = p_0,
// then s = s + p_r for r = 1, 2, ... (the loads are independent, so the
// unrolled loop keeps several in flight; only the adds are a chain).

constexpr int kRedThreads = 128;

__global__ void __launch_bounds__(kRedThreads)
wgrad_reduce_kernel(const float4* __restrict__ partial,
                    float4* __restrict__ out, int n_runs, int n4) {
  const int col = blockIdx.x * kRedThreads + threadIdx.x;
  if (col >= n4) return;
  const float4* p = partial + (int64_t)blockIdx.y * n_runs * n4 + col;
  float4 s = __ldg(p);
#pragma unroll 8
  for (int r = 1; r < n_runs; ++r) {
    const float4 v = __ldg(p + (int64_t)r * n4);
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[(int64_t)blockIdx.y * n4 + col] = s;
}

// With one run a client the partial kernel wrote dW itself (`partial` is
// `out`): nothing to add.
int launch_reduce(const void* partial, void* out, int n, int n_runs, int c,
                  cudaStream_t s) {
  if (n_runs == 1) return (int)cudaSuccess;
  const int n4 = 9 * c * c / 4;  // C % 8 == 0
  const dim3 grid((n4 + kRedThreads - 1) / kRedThreads, n);
  wgrad_reduce_kernel<<<grid, kRedThreads, 0, s>>>(
      (const float4*)partial, (float4*)out, n_runs, n4);
  return (int)cudaGetLastError();
}

// The 4-D (C, W, H, B) tensor map of a [B, H, W, C] bf16 tensor (B = N*B
// rows of N clients) with boxes of 64 channels x `box_w` columns x `box_h`
// rows of one sample, 128-byte swizzled; out-of-bounds elements read as
// zero.
cudaError_t encode_rows_map(CUtensorMap* map, const void* base, int b, int h,
                            int w, int c, int box_w, int box_h) {
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
  const cuuint32_t box[4] = {(cuuint32_t)kTile, (cuuint32_t)box_w,
                             (cuuint32_t)box_h, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kStages, bool kWalk>
cudaError_t launch_tc(const CUtensorMap& xmap, const CUtensorMap& gmap,
                      float* partial, int n, int b, int h, int w, int c,
                      int n_runs, cudaStream_t s) {
  constexpr int smem = tc_smem_bytes(kStages, kWalk);
  // Per call: the attribute is the current device's.
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_tc_kernel<kStages, kWalk>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (c + kTile - 1) / kTile;
  const dim3 grid(kWalk ? n : n * n_runs, 3, n_tiles * n_tiles);
  wgrad_tc_kernel<kStages, kWalk><<<grid, kTcThreads, smem, s>>>(
      xmap, gmap, partial, b, h, w, c, n_runs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x, g [N, B, H, W, C] -> out [N, 3, 3, C, C], in layout 0 (one CTA per
// run; `partial` holds N x n_runs x 9 C C floats, or is `out` when n_runs
// == 1) or 1 (one CTA per client and dy walking the runs, a deep ring, one
// CTA an SM). Both layouts give the same bits.
int dls_wgrad_bf16(const void* x, const void* g, void* partial, void* out,
                   int n, int b, int h, int w, int c, int n_runs, int layout,
                   void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  CUtensorMap xmap, gmap;
  cudaError_t err = encode_rows_map(&xmap, x, n * b, h, w, c, kXSeg, 1);
  if (err != cudaSuccess) return (int)err;
  err = encode_rows_map(&gmap, g, n * b, h, w, c, kSeg, 2);
  if (err != cudaSuccess) return (int)err;
  if (layout == 1)
    return (int)launch_tc<kWalkStages, true>(xmap, gmap, (float*)out, n, b,
                                             h, w, c, n_runs, s);
  if (layout != 0) return (int)cudaErrorInvalidValue;
  err = launch_tc<kFewStages, false>(xmap, gmap, (float*)partial, n, b, h,
                                     w, c, n_runs, s);
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, out, n, n_runs, c, s);
}

int dls_wgrad_f32(const void* x, const void* g, void* partial, void* out,
                  int n, int b, int h, int w, int c, int n_runs, int layout,
                  void* stream) {
  if (layout != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n_tiles = (c + kTile - 1) / kTile;
  const dim3 grid(n * n_runs, 9, n_tiles * n_tiles);
  wgrad_f32_partial_kernel<<<grid, kThreads, 0, s>>>(
      (const float*)x, (const float*)g, (float*)partial, b, h, w, c, n_runs);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(partial, out, n, n_runs, c, s);
}

}  // extern "C"
