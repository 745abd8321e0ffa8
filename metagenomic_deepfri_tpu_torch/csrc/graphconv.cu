// Fused GraphConv kernels for Hopper (sm_90a): the aligned contact adjacency
// is rebuilt tile by tile from projected CA coordinates and never exists in
// device memory.
//
// Counterparts of the Pallas kernels in
// metagenomic_deepfri_tpu/ops/graphconv_pallas.py:
//   contact_degrees      <- contact_degrees      (graphconv_pallas.py:143-196)
//   graphconv_aggregate  <- graphconv_aggregate  (graphconv_pallas.py:199-282)
//
// Adjacency semantics (graphconv_pallas.py:102-134, cmap_align.py:179-224),
// for a protein of length n in a batch padded to L:
//   A[i][j] = (contact(i, j) || i == j || band(i, j)) && i < n && j < n
//   contact: squared distance < thr^2, summed x, y, z in float32 without
//            fused multiply-add, and both ends real (x < 0.5 * 1e6; unmapped
//            positions carry sentinel coordinates 1e6 + 1e3 * i)
//   band:    0 < |i - j| <= generated_contacts and either end an insertion
//
// The distance uses __fmul_rn / __fadd_rn, which nvcc never contracts into
// an FMA: a contracted form rounds differently from the reference's
// mul-then-add and flips pairs that sit within an ulp of the threshold.
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// nothing allocates, every launch goes on the caller's stream, and each entry
// point returns cudaGetLastError() so a refused launch reaches the caller.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kRealLimit = 0.5f * 1.0e6f;

// Every term is evaluated and combined with | and &, not with branches: the
// result is the same, and a warp whose lanes disagree on a term does not
// diverge (the A fragments of graphconv_aggregate take 16 of these a stage).
__device__ __forceinline__ bool adjacent(int i, int j, float xi, float yi,
                                         float zi, bool ins_i, float xj,
                                         float yj, float zj, bool ins_j,
                                         float thr2, int gen) {
  const bool eye = i == j;
  const int off = i > j ? i - j : j - i;
  const bool band = (off <= gen) & (ins_i | ins_j);
  const bool real = (xi < kRealLimit) & (xj < kRealLimit);
  const float dx = __fsub_rn(xi, xj);
  const float dy = __fsub_rn(yi, yj);
  const float dz = __fsub_rn(zi, zj);
  const float dist =
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                __fmul_rn(dz, dz));
  return eye | band | (real & (dist < thr2));
}

// ---------------------------------------------------------------------------
// contact_degrees: deg[b][i] = sum_j A[b][i][j]   (B, L) float32
//
// Replaces graphconv_pallas.py::contact_degrees. Bound by arithmetic: about
// 9 float32 operations a pair over the sum of n^2 pairs (0.7 us at B = 32,
// L = 512 on an H100), with O(n) bytes read; that is below the launch floor
// of a few microseconds, so the design keeps the whole card busy and the
// loads' latency hidden. One block of 8 warps per (32-row tile, protein):
// the block stages the protein's column coordinates and insertion flags in
// shared memory (16 bytes a position, 1024 positions at a time), each warp
// owns 4 rows, and each lane walks every 32nd column for all 4 rows at once,
// so one shared-memory load feeds 4 independent adjacency tests. Each row's
// integer count is summed across the warp with shuffles (exact in any
// order). At B = 32, L = 512 the grid is 512 blocks, about 4 per SM, all
// resident at once. Rows >= n get degree 0.
// ---------------------------------------------------------------------------

constexpr int kDegThreads = 256;
constexpr int kDegRowsPerWarp = 4;
constexpr int kDegRows = kDegThreads / 32 * kDegRowsPerWarp;  // 32 a block
constexpr int kDegChunk = 1024;  // column positions staged at a time

__global__ void __launch_bounds__(kDegThreads)
contact_degrees_kernel(const float* __restrict__ coords,
                       const uint8_t* __restrict__ ins,
                       const int* __restrict__ lengths,
                       float* __restrict__ deg, int L, float thr2, int gen) {
  __shared__ float4 cols[kDegChunk];  // x, y, z, insertion flag

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int i0 = blockIdx.x * kDegRows;
  const int n = min(max(lengths[b], 0), L);
  const float* cb = coords + static_cast<size_t>(b) * L * 3;
  const uint8_t* ib = ins + static_cast<size_t>(b) * L;
  float* db = deg + static_cast<size_t>(b) * L;

  if (i0 >= n) {  // block-uniform: every row of the tile is past n
    if (t < kDegRows && i0 + t < L) db[i0 + t] = 0.f;
    return;
  }

  const int reach = max(gen, 0);
  int row[kDegRowsPerWarp], count[kDegRowsPerWarp];
  float rx[kDegRowsPerWarp], ry[kDegRowsPerWarp], rz[kDegRowsPerWarp];
  bool rins[kDegRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kDegRowsPerWarp; ++r) {
    const int i = i0 + (t / 32) * kDegRowsPerWarp + r;
    const bool ok = i < n;
    row[r] = i;
    count[r] = 0;
    rx[r] = ok ? cb[3 * i] : 0.f;
    ry[r] = ok ? cb[3 * i + 1] : 0.f;
    rz[r] = ok ? cb[3 * i + 2] : 0.f;
    rins[r] = ok && ib[i] != 0;
  }

  for (int c0 = 0; c0 < n; c0 += kDegChunk) {
    const int m = min(kDegChunk, n - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int k = t; k < m; k += kDegThreads) {
      const int j = c0 + k;
      cols[k] = make_float4(cb[3 * j], cb[3 * j + 1], cb[3 * j + 2],
                            ib[j] != 0 ? 1.f : 0.f);
    }
    __syncthreads();
    for (int k = lane; k < m; k += 32) {
      const float4 c = cols[k];
      const bool ins_j = c.w != 0.f;
      // Columns c0 + k - lane .. + 31 against the warp's rows: where all are
      // more than generated_contacts apart (warp-uniform), the identity and
      // band terms are false and only the distance test is left.
      const int jw = c0 + k - lane;
      if (jw <= row[0] + kDegRowsPerWarp - 1 + reach &&
          row[0] <= jw + 31 + reach) {
#pragma unroll
        for (int r = 0; r < kDegRowsPerWarp; ++r) {
          if (row[r] < n)  // warp-uniform
            count[r] += adjacent(row[r], c0 + k, rx[r], ry[r], rz[r],
                                 rins[r], c.x, c.y, c.z, ins_j, thr2, gen);
        }
      } else {
#pragma unroll
        for (int r = 0; r < kDegRowsPerWarp; ++r) {
          if (row[r] < n)
            count[r] += adjacent(0, 1, rx[r], ry[r], rz[r], false, c.x, c.y,
                                 c.z, false, thr2, gen);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kDegRowsPerWarp; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      count[r] += __shfl_xor_sync(0xffffffffu, count[r], off);
    if (lane == 0 && row[r] < L) db[row[r]] = static_cast<float>(count[r]);
  }
}

// ---------------------------------------------------------------------------
// graphconv_aggregate: out[b][i][:] = sum_j A[b][i][j] * xs[b][j][:]
//   xs (B, L, D) float32 -> out (B, L, D) float32
//
// Replaces graphconv_pallas.py::graphconv_aggregate. The TPU kernel walks a
// sequential grid axis over column tiles and accumulates into its output
// block; here that axis is a loop inside the block.
//
// Bound: bytes. The valid rows of xs are read once and all of out written
// once: at B = 32, bucket 512, D = 1024 that is 118 MB, 35 us at 3.35 TB/s.
// The 2 * sum(n^2) * D products take 10.5 us at the bf16 tensor-core rate,
// 31 us for the three planes of exact float32 (below), 155 us on the
// float32 CUDA cores; so the products go to the tensor cores.
//
// Design: wgmma (m64n128k16, bf16 inputs, float32 accumulator) with the
// adjacency as the A operand taken from registers. One block of two
// warpgroups per (128-row tile, 128-feature tile, protein), two blocks an
// SM; the grid runs every tile of a protein next to each other, so the
// protein's xs is read from HBM about once and re-read from L2 by its other
// tiles. Each thread computes the A-fragment entries it owns (2 rows, 4
// columns of each k16 slice) with adjacent(): its two rows' coordinates stay
// in registers for the whole K loop, and each slice's column coordinates and
// flags come from shared memory. {0, 1} is exact in bf16, so A never
// touches shared memory. Where a warp's rows and a stage's columns are more
// than generated_contacts apart, the identity and band terms are false by
// construction and only the distance test runs.
// The K loop covers column tiles below n only, 32 columns a stage, as a
// software pipeline with one barrier a stage. While the tensor cores run
// stage k's wgmmas, the block
//   - streams xs tiles (32 x 128 float32) into a ring of 4 stages (3 for
//     float32 compute), 3 (2) ahead: one TMA copy a tile, issued by one
//     thread and completed on an mbarrier, when D % 4 == 0 and xs is
//     16-byte aligned (a tensor map's rows must be); else 4-byte cp.async
//     copies by every thread. Features >= D arrive as zeros and rows >= n
//     are zeroed in the tail stage, so padding never reaches a product;
//   - splits stage k + 1's float32 tile into bf16 planes (double-buffered,
//     in the layout the wgmma B descriptor reads) and builds stage k + 1's
//     A fragments. The split is x = hi + mid + lo with hi = bf16_rz(x),
//     mid = bf16_rz(x - hi), lo = x - hi - mid (exact in bf16). Three 8-bit
//     significands hold float32's 24, so the split is exact for finite
//     |x| from 2^-103 up to float32's largest value (every nonzero plane a
//     normal bf16), and no plane or partial sum exceeds |x|. Below 2^-103
//     lo may be subnormal, and below about 2^-110 bits are lost. An
//     infinite or NaN x is carried by hi alone. bfloat16 compute uses
//     bf16_rn(x) only, the rounding of the plain twin and of the Pallas
//     kernel;
//   - A * hi, A * mid and A * lo are exact products, so one A fragment feeds
//     1 or 3 wgmmas into the same float32 accumulator.
// What still bounds it on an H100 is the CUDA-core work beside the tensor
// cores: the adjacency tests (redone for each 128-feature tile, since the
// accumulators of one tile fill the registers) and the plane split
// (PERF.md). Row tiles at or past n write zeros; rows >= n are written as
// zero; ragged L and D are masked.
// ---------------------------------------------------------------------------

namespace agg {

constexpr int kRows = 128;            // two warpgroups of 64 rows
constexpr int kFeat = 128;            // wgmma N
constexpr int kCols = 32;             // adjacency columns (K) a stage
constexpr int kSlices = kCols / 16;   // k16 steps a stage
constexpr int kThreads = 256;
constexpr int kAcc = kFeat / 2;       // accumulator floats a thread
// B-operand layout: K-major with the 64-byte swizzle. Each feature f is a
// 64-byte row holding the stage's 32 columns as four 16-byte chunks; chunk c
// sits at position c ^ ((f >> 1) & 3), so the 8 rows of a core-matrix group
// (512 bytes apart) spread over all 32 banks when the tensor cores read
// them (hopper::desc_k32_sw64). The planes are aligned to the swizzle's
// 512-byte period, so that the swizzle the hardware computes from address
// bits matches the offsets written here.
constexpr int kSmemAlign = 512;
static_assert(kCols == 32, "one 64-byte swizzle row per feature a stage");
static_assert(kCols / 8 * kFeat % kThreads == 0, "whole items a thread");

// xs ring depth (kStages - 1 loads ahead): 4 stages, 3 for the float32
// planes, so that two blocks' shared memory fits an SM.
template <int kPlanes>
constexpr int kStages = kPlanes == 3 ? 3 : 4;

template <int kPlanes>
struct __align__(kSmemAlign) Smem {
  __nv_bfloat16 plane[2][kPlanes][kCols * kFeat];  // hi, mid, lo; 2 buffers
  float xs[kStages<kPlanes>][kCols][kFeat];
  float4 col[2][kCols];                            // x, y, z, insertion flag
  uint64_t full[kStages<kPlanes>];  // mbarriers: a TMA tile has landed
};

// Element offset of B[k][f] (column k of the stage, feature f) in a plane;
// k is a multiple of 8 (a 16-byte chunk).
__device__ __forceinline__ int plane_offset(int k, int f) {
  return f * kCols + ((k / 8) ^ ((f >> 1) & 3)) * 8;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_addr(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}

// Two elements' planes, each as a packed bf16 pair (x0 in the low half):
// for float32 compute hopper::split_bf16x3 (hi and mid truncated, so no
// plane or partial sum of a finite x is infinite).
template <int kPlanes>
__device__ __forceinline__ void split(float x0, float x1, uint32_t* out) {
  if constexpr (kPlanes == 1) {
    out[0] = hopper::bits(__floats2bfloat162_rn(x0, x1));
  } else {
    hopper::split_bf16x3(x0, x1, out[0], out[1], out[2]);
  }
}

}  // namespace agg

template <int kPlanes, bool kVec4>
__global__ void __launch_bounds__(agg::kThreads, 2)
graphconv_aggregate_kernel(const float* __restrict__ coords,
                           const uint8_t* __restrict__ ins,
                           const int* __restrict__ lengths,
                           const float* __restrict__ xs,
                           float* __restrict__ out, int L, int D, float thr2,
                           int gen, const __grid_constant__ CUtensorMap map) {
  using namespace agg;
  using hopper::smem_addr;
  constexpr int kRing = kStages<kPlanes>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t skew =
      (kSmemAlign - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw))
                        % kSmemAlign) % kSmemAlign;
  Smem<kPlanes>& sm = *reinterpret_cast<Smem<kPlanes>*>(smem_raw + skew);

  const int tiles_f = (D + kFeat - 1) / kFeat;
  const int d0 = (blockIdx.x % tiles_f) * kFeat;
  const int i0 = (blockIdx.x / tiles_f) * kRows;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int n = min(max(lengths[b], 0), L);
  const float* cb = coords + static_cast<size_t>(b) * L * 3;
  const uint8_t* ib = ins + static_cast<size_t>(b) * L;
  const float* xb = xs + static_cast<size_t>(b) * L * D;
  float* ob = out + static_cast<size_t>(b) * L * D;

  // wgmma fragment ownership: warp w (0..7) holds rows 16w.. of the tile
  // (warps 0-3 form warpgroup 0, rows 0-63); lane (g = lane / 4,
  // q = lane % 4) holds rows g and g + 8, A columns 2q, 2q + 1, 2q + 8,
  // 2q + 9 of each k16 slice, and accumulator columns 8c + 2q, 8c + 2q + 1.
  const int lane = t % 32;
  const int q = lane % 4;
  const int rows[2] = {i0 + (t / 32) * 16 + lane / 4,
                       i0 + (t / 32) * 16 + lane / 4 + 8};

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  if (i0 < n) {  // block-uniform: a row tile past n stays zero
    float rx[2], ry[2], rz[2];
    bool rins[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = rows[h];
      const bool ok = i < n;
      rx[h] = ok ? cb[3 * i] : 0.f;
      ry[h] = ok ? cb[3 * i + 1] : 0.f;
      rz[h] = ok ? cb[3 * i + 2] : 0.f;
      rins[h] = ok && ib[i] != 0;
    }
    const int nk = (n + kCols - 1) / kCols;

    // Stage k's xs tile into ring slot k % kRing: with 16-byte rows, one
    // TMA copy issued by thread 0 that completes on the slot's mbarrier
    // (features >= D and rows >= L arrive as zeros); otherwise 4-byte
    // cp.async copies by every thread as one group (rows >= n and features
    // >= D zero-filled; an empty group past the last stage keeps the group
    // count uniform).
    auto load_xs = [&](int k) {
      if (k < nk) {
        float (*dst)[kFeat] = sm.xs[k % kRing];
        const int j0 = k * kCols;
        if constexpr (kVec4) {
          if (t == 0) {
            const uint32_t bar = smem_addr(&sm.full[k % kRing]);
            asm volatile(
                "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                    "r"(bar),
                "r"(kCols * kFeat * 4)
                : "memory");
            asm volatile(
                "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
                "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
                    smem_addr(dst)),
                "l"(&map), "r"(d0), "r"(j0), "r"(b), "r"(bar)
                : "memory");
          }
        } else {
#pragma unroll
          for (int u = 0; u < kCols * kFeat / kThreads; ++u) {
            const int e = t + u * kThreads;
            const int r = e / kFeat, c = e % kFeat;
            const int j = j0 + r, d = d0 + c;
            const bool ok = j < n && d < D;
            cp_async4(&dst[r][c],
                      ok ? xb + static_cast<size_t>(j) * D + d : xb, ok);
          }
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // Column j's coordinates and flag (threads t < kCols, one column each).
    auto load_col = [&](int j) {
      return j < n ? make_float4(cb[3 * j], cb[3 * j + 1], cb[3 * j + 2],
                                 ib[j] != 0 ? 1.f : 0.f)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    // Stage k's float32 tile -> bf16 planes of buffer k & 1: each item is 8
    // columns of one feature, one 16-byte row of a core matrix a plane.
    auto convert = [&](int k) {
      if constexpr (kVec4)
        hopper::wait_parity(&sm.full[k % kRing], k / kRing & 1);
      const float (*x)[kFeat] = sm.xs[k % kRing];
      const int live = n - k * kCols;  // rows of the tile below n
#pragma unroll
      for (int u = 0; u < kCols / 8 * kFeat / kThreads; ++u) {
        const int e = t + u * kThreads;
        const int f = e % kFeat, c = e / kFeat * 8;
        float v8[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) v8[v] = x[c + v][f];
        if (live < kCols) {  // block-uniform: the tail stage
#pragma unroll
          for (int v = 0; v < 8; ++v) v8[v] = c + v < live ? v8[v] : 0.f;
        }
        uint32_t p[4][3];
#pragma unroll
        for (int v = 0; v < 4; ++v) split<kPlanes>(v8[2 * v], v8[2 * v + 1], p[v]);
        const int off = plane_offset(c, f);
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl)
          *reinterpret_cast<uint4*>(&sm.plane[k & 1][pl][off]) =
              make_uint4(p[0][pl], p[1][pl], p[2][pl], p[3][pl]);
      }
      // Make the planes visible to wgmma (the async proxy).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    };
    // Stage k's A fragments: register 2 * half + h of slice s holds
    // (row h, columns 16s + 8 * half + 2q, + 1) as a bf16 pair. Where every
    // column of the stage is more than generated_contacts from every row of
    // the warp (warp-uniform, from indices only), the identity and band
    // terms are false, and adjacent() is called with indices and flags that
    // say so, which leaves the distance test alone.
    auto build = [&](uint32_t (&a)[kSlices][4], int k, auto near) {
#pragma unroll
      for (int s = 0; s < kSlices; ++s) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          uint32_t pair[2] = {0u, 0u};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = 16 * s + 8 * half + 2 * q + e;
            const float4 c = sm.col[k & 1][cc];
            const int j = k * kCols + cc;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bool adj =
                  decltype(near)::value
                      ? adjacent(rows[h], j, rx[h], ry[h], rz[h], rins[h],
                                 c.x, c.y, c.z, c.w != 0.f, thr2, gen)
                      : adjacent(0, 1, rx[h], ry[h], rz[h], false, c.x, c.y,
                                 c.z, false, thr2, gen);
              const bool on = (rows[h] < n) & (j < n) & adj;
              pair[h] |= static_cast<uint32_t>(on) *
                         (e ? 0x3F800000u : 0x3F80u);
            }
          }
          a[s][2 * half] = pair[0];
          a[s][2 * half + 1] = pair[1];
        }
      }
    };
    auto fragments = [&](uint32_t (&a)[kSlices][4], int k) {
      const int w0 = i0 + (t / 32) * 16;  // the warp's first row
      const int reach = max(gen, 0);
      if (k * kCols <= w0 + 15 + reach && w0 <= k * kCols + kCols - 1 + reach)
        build(a, k, std::true_type{});
      else
        build(a, k, std::false_type{});
    };

    // Prologue: stages 0 .. kRing - 2 in flight, columns of stages 0 and
    // 1 in shared memory, stage 0's planes and fragments ready.
    if (kVec4 && t == 0) {
      for (int k = 0; k < kRing; ++k)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                         smem_addr(&sm.full[k]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    for (int k = 0; k < kRing - 1; ++k) load_xs(k);
    if (t < kCols) {
      sm.col[0][t] = load_col(t);
      sm.col[1][t] = load_col(kCols + t);
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
    __syncthreads();
    uint32_t a_cur[kSlices][4];
    convert(0);
    fragments(a_cur, 0);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 3) : "memory");
    __syncthreads();

    for (int kb = 0; kb < nk; ++kb) {
      // Stage kb's products, asynchronously on the tensor cores.
      hopper::pin(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s = 0; s < kSlices; ++s) {
#pragma unroll
        for (int pl = 0; pl < kPlanes; ++pl)
          hopper::wgmma_m64n128k16(
              acc, a_cur[s], hopper::desc_k32_sw64(sm.plane[kb & 1][pl], s), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

      // Meanwhile: the xs tile kRing - 1 ahead, stage kb + 2's columns
      // (into registers), and stage kb + 1's planes and fragments.
      load_xs(kb + kRing - 1);
      const float4 col2 = t < kCols && kb + 2 < nk
                              ? load_col((kb + 2) * kCols + t)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      uint32_t a_next[kSlices][4] = {};
      if (kb + 1 < nk) {  // block-uniform
        convert(kb + 1);
        fragments(a_next, kb + 1);
      }

      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      hopper::pin(acc);
#pragma unroll
      for (int s = 0; s < kSlices; ++s) {
        hopper::pin(a_cur[s]);
#pragma unroll
        for (int r = 0; r < 4; ++r) a_cur[s][r] = a_next[s][r];
      }
      if (t < kCols && kb + 2 < nk) sm.col[kb & 1][t] = col2;
      // On the cp.async path stage kb + 2's tile has landed (the next stage
      // converts it; on the TMA path convert() waits on its mbarrier); the
      // planes and columns written above are visible to every thread.
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 3) : "memory");
      __syncthreads();
    }
  }

  const bool pairs = (D & 1) == 0;
#pragma unroll
  for (int c = 0; c < kFeat / 8; ++c) {
    const int d = d0 + 8 * c + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = rows[h];
      if (i >= L) continue;
      const float v0 = i < n ? acc[4 * c + 2 * h] : 0.f;
      const float v1 = i < n ? acc[4 * c + 2 * h + 1] : 0.f;
      float* dst = ob + static_cast<size_t>(i) * D + d;
      if (pairs && d + 1 < D) {
        *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
      } else {
        if (d < D) dst[0] = v0;
        if (d + 1 < D) dst[1] = v1;
      }
    }
  }
}

// Tensor map of xs (B, L, D) float32 for the TMA path: a box of kCols rows
// x kFeat features of one protein, zeros outside the tensor. The encoder
// comes from the driver at run time, so the library needs no -lcuda.
cudaError_t xs_tensor_map(CUtensorMap* map, const float* xs, int B, int L,
                          int D) {
  hopper::TensorMapEncoder encode;
  const cudaError_t err = hopper::tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 4,
                                 static_cast<cuuint64_t>(L) * D * 4};
  const cuuint32_t box[3] = {agg::kFeat, agg::kCols, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(xs), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kPlanes, bool kVec4>
cudaError_t launch_aggregate(const float* coords, const uint8_t* ins,
                             const int* lengths, const float* xs, float* out,
                             int B, int L, int D, float thr2, int gen,
                             cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  // Dynamic smem limit set, per device. Host threads may launch at once,
  // each on its own current device, so the flags are atomic; two threads
  // that both find a flag unset both set the same attribute, which is
  // harmless.
  static std::atomic<bool> ready[kMaxDevices];
  auto kernel = graphconv_aggregate_kernel<kPlanes, kVec4>;
  const int bytes =
      static_cast<int>(sizeof(agg::Smem<kPlanes>)) + agg::kSmemAlign;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  CUtensorMap map = {};
  if (kVec4) {
    err = xs_tensor_map(&map, xs, B, L, D);
    if (err != cudaSuccess) return err;
  }
  const int tiles = (L + agg::kRows - 1) / agg::kRows *
                    ((D + agg::kFeat - 1) / agg::kFeat);
  kernel<<<dim3(tiles, B), agg::kThreads, bytes, stream>>>(
      coords, ins, lengths, xs, out, L, D, thr2, gen, map);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int mdf_contact_degrees(const void* coords, const void* ins,
                        const void* lengths, void* deg, int B, int L,
                        float thr2, int gen, void* stream) {
  const dim3 grid((L + kDegRows - 1) / kDegRows, B);
  contact_degrees_kernel<<<grid, kDegThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const uint8_t*>(ins),
      static_cast<const int*>(lengths), static_cast<float*>(deg), L, thr2,
      gen);
  return static_cast<int>(cudaGetLastError());
}

int mdf_graphconv_aggregate(const void* coords, const void* ins,
                            const void* lengths, const void* xs, void* out,
                            int B, int L, int D, float thr2, int gen,
                            int round_bf16, void* stream) {
  const auto c = static_cast<const float*>(coords);
  const auto i = static_cast<const uint8_t*>(ins);
  const auto n = static_cast<const int*>(lengths);
  const auto x = static_cast<const float*>(xs);
  const auto o = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(xs) % 16 == 0;
  cudaError_t err;
  if (round_bf16)
    err = vec4 ? launch_aggregate<1, true>(c, i, n, x, o, B, L, D, thr2, gen, s)
               : launch_aggregate<1, false>(c, i, n, x, o, B, L, D, thr2, gen,
                                            s);
  else
    err = vec4 ? launch_aggregate<3, true>(c, i, n, x, o, B, L, D, thr2, gen, s)
               : launch_aggregate<3, false>(c, i, n, x, o, B, L, D, thr2, gen,
                                            s);
  return static_cast<int>(err);
}

const char* mdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
