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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kRealLimit = 0.5f * 1.0e6f;

__device__ __forceinline__ bool adjacent(int i, int j, float xi, float yi,
                                         float zi, bool ins_i, float xj,
                                         float yj, float zj, bool ins_j,
                                         float thr2, int gen) {
  if (i == j) return true;
  const int off = i > j ? i - j : j - i;
  if (off <= gen && (ins_i || ins_j)) return true;
  if (!(xi < kRealLimit) || !(xj < kRealLimit)) return false;
  const float dx = __fsub_rn(xi, xj);
  const float dy = __fsub_rn(yi, yj);
  const float dz = __fsub_rn(zi, zj);
  const float dist =
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                __fmul_rn(dz, dz));
  return dist < thr2;
}

// ---------------------------------------------------------------------------
// contact_degrees: deg[b][i] = sum_j A[b][i][j]   (B, L) float32
//
// Replaces graphconv_pallas.py::contact_degrees. Bound by the O(n^2)
// adjacency test (about 12 flops a pair) with O(n) bytes read: one launch
// per batch, shared by the three GraphConv layers, and small next to the
// aggregation. Design: one block per (128-row tile, protein), one thread per
// row; column coordinates and insertion flags are staged through shared
// memory in 128-wide chunks, and only columns j < n are visited (entries
// with j >= n are 0 by definition). Rows >= n get degree 0.
// ---------------------------------------------------------------------------

constexpr int kDegRows = 128;

__global__ void __launch_bounds__(kDegRows)
contact_degrees_kernel(const float* __restrict__ coords,
                       const uint8_t* __restrict__ ins,
                       const int* __restrict__ lengths,
                       float* __restrict__ deg, int L, float thr2, int gen) {
  __shared__ float sx[kDegRows], sy[kDegRows], sz[kDegRows];
  __shared__ uint8_t sins[kDegRows];

  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int i0 = blockIdx.x * kDegRows;
  const int i = i0 + t;
  const int n = min(max(lengths[b], 0), L);
  const float* cb = coords + static_cast<size_t>(b) * L * 3;
  const uint8_t* ib = ins + static_cast<size_t>(b) * L;

  const bool row_valid = i < n;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  bool ins_i = false;
  if (row_valid) {
    xi = cb[3 * i];
    yi = cb[3 * i + 1];
    zi = cb[3 * i + 2];
    ins_i = ib[i] != 0;
  }

  int count = 0;
  if (i0 < n) {  // block-uniform: the whole tile past n has degree 0
    for (int c0 = 0; c0 < n; c0 += kDegRows) {
      const int j = c0 + t;
      if (j < n) {
        sx[t] = cb[3 * j];
        sy[t] = cb[3 * j + 1];
        sz[t] = cb[3 * j + 2];
        sins[t] = ib[j];
      }
      __syncthreads();
      if (row_valid) {
        const int m = min(kDegRows, n - c0);
        for (int k = 0; k < m; ++k) {
          count += adjacent(i, c0 + k, xi, yi, zi, ins_i, sx[k], sy[k], sz[k],
                            sins[k] != 0, thr2, gen);
        }
      }
      __syncthreads();
    }
  }
  if (i < L) deg[static_cast<size_t>(b) * L + i] = static_cast<float>(count);
}

// ---------------------------------------------------------------------------
// graphconv_aggregate: out[b][i][:] = sum_j A[b][i][j] * xs[b][j][:]
//   xs (B, L, D) float32 -> out (B, L, D) float32
//
// Replaces graphconv_pallas.py::graphconv_aggregate. The TPU kernel walks a
// sequential grid axis over column tiles and accumulates into its output
// block; here that axis is a loop inside the block. Bound by the
// 2 * n^2 * D multiply-adds (arithmetic, not bytes: xs is read once per
// 64-row tile and the adjacency never leaves the SM). Design: one block per
// (64-feature tile, 64-row tile, protein), 256 threads, each holding a 4x4
// float32 accumulator in registers. For each 64-wide column tile up to
// ceil(n / 64), the block builds the 64x64 0/1 adjacency tile in shared
// memory from the two coordinate tiles, stages the matching xs tile, and
// accumulates with FFMA. Ragged L and D are masked, with no padded copies;
// rows >= n are written as zero. With round_bf16, each xs element is
// rounded to bfloat16 as it is loaded and multiplied in float32: {0, 1} is
// exact, so this is the bf16-product, f32-sum math of the Pallas kernel.
// Tensor cores (wgmma), TMA and skipping empty adjacency tiles are left for
// later work.
// ---------------------------------------------------------------------------

constexpr int kTile = 64;
constexpr int kAggThreads = 256;
constexpr int kPerThread = 4;  // 4x4 outputs per thread, 16x16 threads

__global__ void __launch_bounds__(kAggThreads)
graphconv_aggregate_kernel(const float* __restrict__ coords,
                           const uint8_t* __restrict__ ins,
                           const int* __restrict__ lengths,
                           const float* __restrict__ xs,
                           float* __restrict__ out, int L, int D, float thr2,
                           int gen, int round_bf16) {
  __shared__ __align__(16) float adj[kTile][kTile];  // [col j][row r]
  __shared__ __align__(16) float xt[kTile][kTile];   // [col j][feature c]
  __shared__ float rx[kTile], ry[kTile], rz[kTile];
  __shared__ float cx[kTile], cy[kTile], cz[kTile];
  __shared__ uint8_t rins[kTile], cins[kTile];

  const int d0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const int t = threadIdx.x;
  const int ty = t / (kTile / kPerThread);  // row group 0..15
  const int tx = t % (kTile / kPerThread);  // feature group 0..15
  const int n = min(max(lengths[b], 0), L);
  const float* cb = coords + static_cast<size_t>(b) * L * 3;
  const uint8_t* ib = ins + static_cast<size_t>(b) * L;
  const float* xb = xs + static_cast<size_t>(b) * L * D;
  float* ob = out + static_cast<size_t>(b) * L * D;

  float acc[kPerThread][kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r)
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) acc[r][c] = 0.f;

  if (i0 < n) {  // block-uniform: a row tile past n stays zero
    if (t < kTile) {
      const int i = i0 + t;
      const bool ok = i < n;
      rx[t] = ok ? cb[3 * i] : 0.f;
      ry[t] = ok ? cb[3 * i + 1] : 0.f;
      rz[t] = ok ? cb[3 * i + 2] : 0.f;
      rins[t] = ok ? ib[i] : 0;
    }
    for (int j0 = 0; j0 < n; j0 += kTile) {
      if (t < kTile) {
        const int j = j0 + t;
        const bool ok = j < n;
        cx[t] = ok ? cb[3 * j] : 0.f;
        cy[t] = ok ? cb[3 * j + 1] : 0.f;
        cz[t] = ok ? cb[3 * j + 2] : 0.f;
        cins[t] = ok ? ib[j] : 0;
      }
      __syncthreads();
#pragma unroll 4
      for (int e = t; e < kTile * kTile; e += kAggThreads) {
        const int jj = e / kTile;
        const int r = e % kTile;
        const int i = i0 + r;
        const int j = j0 + jj;
        const bool a = i < n && j < n &&
                       adjacent(i, j, rx[r], ry[r], rz[r], rins[r] != 0,
                                cx[jj], cy[jj], cz[jj], cins[jj] != 0, thr2,
                                gen);
        adj[jj][r] = a ? 1.f : 0.f;
        const int d = d0 + r;  // reuse r as the feature index of xt
        float v = 0.f;
        if (j < n && d < D) {
          v = xb[static_cast<size_t>(j) * D + d];
          if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
        }
        xt[jj][r] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int jj = 0; jj < kTile; ++jj) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(&adj[jj][ty * kPerThread]);
        const float4 x4 =
            *reinterpret_cast<const float4*>(&xt[jj][tx * kPerThread]);
        const float av[kPerThread] = {a4.x, a4.y, a4.z, a4.w};
        const float xv[kPerThread] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int r = 0; r < kPerThread; ++r)
#pragma unroll
          for (int c = 0; c < kPerThread; ++c)
            acc[r][c] = fmaf(av[r], xv[c], acc[r][c]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = i0 + ty * kPerThread + r;
    if (i >= L) continue;
#pragma unroll
    for (int c = 0; c < kPerThread; ++c) {
      const int d = d0 + tx * kPerThread + c;
      if (d < D) ob[static_cast<size_t>(i) * D + d] = i < n ? acc[r][c] : 0.f;
    }
  }
}

}  // namespace

extern "C" {

int mdf_contact_degrees(const void* coords, const void* ins,
                        const void* lengths, void* deg, int B, int L,
                        float thr2, int gen, void* stream) {
  const dim3 grid((L + kDegRows - 1) / kDegRows, B);
  contact_degrees_kernel<<<grid, kDegRows, 0,
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
  const dim3 grid((D + kTile - 1) / kTile, (L + kTile - 1) / kTile, B);
  graphconv_aggregate_kernel<<<grid, kAggThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const uint8_t*>(ins),
      static_cast<const int*>(lengths), static_cast<const float*>(xs),
      static_cast<float*>(out), L, D, thr2, gen, round_bf16);
  return static_cast<int>(cudaGetLastError());
}

const char* mdf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
