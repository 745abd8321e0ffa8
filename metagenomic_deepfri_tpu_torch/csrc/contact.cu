// Dense contact map for Hopper (sm_90a): (B, L, 3) CA coordinates ->
// (B, L, L) float32 0/1 map.
//
// Counterpart of the Pallas kernel in metagenomic_deepfri_tpu/ops/contact.py:
//   contact_map  <- contact_map_fused -> _contact_map_fused_impl
//                   (contact.py:126-199, pallas_call at :193)
//
// Semantics, for a protein of length n in a batch padded to L:
//   C[i][j] = dist2(i, j) < thr^2 && i < n && j < n
//   dist2:   (dx * dx + dy * dy) + dz * dz in float32, each product and sum
//            rounded on its own (no fused multiply-add), with dx = x_i - x_j
// The diagonal is 1 only because dist2 = 0; there is no identity, insertion
// or sentinel logic (unlike the aligned adjacency of graphconv.cu). NaN
// coordinates compare false and give 0. thr^2 arrives as the float32 the
// reference compares against.
//
// The distance uses __fsub_rn / __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA: a contracted form rounds differently from the
// reference's mul-then-add and flips pairs within an ulp of the threshold.
//
// Bound by the store of the B * L^2 output (4 bytes an entry against about
// 9 flops): at B = 8, L = 512 that is 8.4 MB, a few microseconds of HBM3
// writes, so launch cost dominates at the shapes of a training batch.
// Design: one block per (64-column tile, 64-row tile, protein), 256 threads.
// The block stages its 64 row and 64 column coordinates in shared memory;
// thread (tx, ty) owns column tx of the tile and rows ty, ty + 4, ...,
// ty + 60, so each warp stores 32 consecutive floats of a row (coalesced).
// L is not padded: loads and stores are masked, and every entry of the
// output, padding included, is written (0 or 1). A tile wholly at or past
// n only writes zeros. Vectorised float4 stores and TMA are later work.
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// nothing allocates, the launch goes on the caller's stream, and the entry
// point returns cudaGetLastError() so a refused launch reaches the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kRowGroups = 4;  // blockDim = (kTile, kRowGroups)

__global__ void __launch_bounds__(kTile * kRowGroups)
contact_map_kernel(const float* __restrict__ coords,
                   const int* __restrict__ lengths, float* __restrict__ out,
                   int L, float thr2) {
  __shared__ float rx[kTile], ry[kTile], rz[kTile];
  __shared__ float cx[kTile], cy[kTile], cz[kTile];

  const int j0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * kTile;
  const int b = blockIdx.z;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int n = min(max(lengths[b], 0), L);
  const float* cb = coords + static_cast<size_t>(b) * L * 3;
  float* ob = out + static_cast<size_t>(b) * L * L;
  const int j = j0 + tx;

  if (i0 >= n || j0 >= n) {  // block-uniform: the whole tile is padding
#pragma unroll 4
    for (int r = ty; r < kTile; r += kRowGroups) {
      const int i = i0 + r;
      if (i < L && j < L) ob[static_cast<size_t>(i) * L + j] = 0.f;
    }
    return;
  }

  if (ty == 0) {
    const int i = i0 + tx;
    const bool ok = i < n;
    rx[tx] = ok ? cb[3 * i] : 0.f;
    ry[tx] = ok ? cb[3 * i + 1] : 0.f;
    rz[tx] = ok ? cb[3 * i + 2] : 0.f;
  } else if (ty == 1) {
    const bool ok = j < n;
    cx[tx] = ok ? cb[3 * j] : 0.f;
    cy[tx] = ok ? cb[3 * j + 1] : 0.f;
    cz[tx] = ok ? cb[3 * j + 2] : 0.f;
  }
  __syncthreads();

  const float xj = cx[tx], yj = cy[tx], zj = cz[tx];
  const bool col_valid = j < n;
#pragma unroll 4
  for (int r = ty; r < kTile; r += kRowGroups) {
    const int i = i0 + r;
    if (i >= L || j >= L) continue;
    const float dx = __fsub_rn(rx[r], xj);
    const float dy = __fsub_rn(ry[r], yj);
    const float dz = __fsub_rn(rz[r], zj);
    const float dist =
        __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                  __fmul_rn(dz, dz));
    const bool c = col_valid && i < n && dist < thr2;
    ob[static_cast<size_t>(i) * L + j] = c ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" {

int mdf_contact_map(const void* coords, const void* lengths, void* out, int B,
                    int L, float thr2, void* stream) {
  const int tiles = (L + kTile - 1) / kTile;
  const dim3 grid(tiles, tiles, B);
  const dim3 block(kTile, kRowGroups);
  contact_map_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coords), static_cast<const int*>(lengths),
      static_cast<float*>(out), L, thr2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
