// Float32-exact GEMM on Hopper's tensor cores for the transformer trunks'
// projections (ESM-2's, ProtT5's and ESM C's; sm_90a):  y = epilogue(x W [+ b])
//   x (M, K) float32, W given as three bf16 planes (3, N, Kp) K-major,
//   b (N) float32 or none, y (M, N) float32; epilogue: nothing more,
//   erf-GELU, ReLU, a float32 residual added, or SwiGLU (ESM C's fc1:
//   silu(a) * b of the product's halves [a | b], y (M, N / 2); see below).
//   Bias or none and the epilogue are template parameters, so each kernel
//   instance's main loop is the same code and only its store differs.
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA.
// It exists because PyTorch runs a float32 matmul with TF32 off on the
// CUDA cores (cuBLAS / CUTLASS SIMT sgemm, at most 67 TFLOP/s on an H100),
// and the trunk's four projections (qkv, out, fc1, fc2) are ~80 % of the
// ESM-2 cells' device time.
//
// Exactness. Every float32 operand is split exactly into three bf16 planes,
// v = hi + mid + lo (hi = bf16_rz(v), mid = bf16_rz(v - hi), lo = v - hi -
// mid: hopper.cuh's split_bf16x3, B1's, whose plain twin is
// ops/graphconv.py::_split_bf16x3).
// Of the nine plane products six are computed: hi*hi, hi*mid, mid*hi,
// hi*lo, mid*mid, lo*hi. Each dropped one (mid*lo, lo*mid, lo*lo) is at
// most 2^-24 |x||w| a term, float32's own unit roundoff. Every bf16 product
// is exact in the tensor cores. Their float32 accumulator rounds toward
// zero, and a bias that grows with the sum's magnitude would make the
// result worse than a float32 GEMM, so the tensor cores sum only 64 of k
// at a time (24 wgmmas into a fresh accumulator), and each such partial
// sum is added to the running sum in registers, rounded to nearest.
//
// Bound: operations. At M = 33,280 token slots, 2MKN is 0.33 TFLOP (qkv)
// to 0.44 (fc1, fc2) against ~0.34 GB of float32 in and out (ProtT5's
// wi and wo at M = 33,024: 1.11 TFLOP against 2.3 GB): six bf16
// products at 989 TFLOP/s give a ceiling of 165 TFLOP/s of float32 work
// against the SIMT units' 67.
//
// Design: one block a 128 x 128 output tile, 384 threads: a producer
// warpgroup (40 registers a thread, one thread at work) and two consumer
// warpgroups of 64 rows each (232 registers, setmaxnreg).
//   - The producer keeps a ring of 5 stages full by TMA: x's 128 x 32
//     float32 tile (128-byte swizzle) and W's three 128 x 32 bf16 planes
//     (one 3-D box, 64-byte swizzle, the layout wgmma's B descriptor reads),
//     40 KB a stage, on a full/empty mbarrier pair a stage. Rows >= M and
//     columns >= K arrive as zeros.
//   - Each consumer thread reads its wgmma A fragments of x straight from
//     the float32 tile (float2 loads, conflict-free under the swizzle) and
//     splits them in registers, so x's planes never exist in memory: x
//     moves 4 bytes an element from L2 into shared memory, where splitting
//     it in a kernel of its own would write and re-read 6 more.
//   - The tensor cores run one stage's 12 products (wgmma m64n128k16, A
//     from registers, B from shared memory) while the next stage's
//     fragments are loaded and split into the other of two fragment sets;
//     a stage goes back to the producer once its products have completed.
//   - The epilogue adds the bias (where there is one), then GELU, ReLU or
//     the residual, and stores float2s; rows >= M and columns >= N are not
//     written.
//   - SwiGLU: the planes hold W's gate and up columns interleaved in blocks
//     of 64 (ops/esm_gemm.py::interleave_swiglu), so a tile's columns 0-63
//     are gates and 64-127 their up columns. In the m64n128 accumulator a
//     thread that holds column j (block c of 8) holds column j + 64 (block
//     c + 8) too, so each thread pairs its own registers and writes 64
//     columns of y a tile, with no shuffle and no 2N-wide intermediate.
// Grid: the N tiles of one row tile next to each other, so a row tile of x
// is read from device memory once and from L2 by its other column tiles.
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// nothing allocates, every launch goes on the caller's stream, and the entry
// point returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {
namespace esm {

constexpr int kBM = 128;                  // rows a block: two warpgroups
constexpr int kBN = 128;                  // wgmma N
constexpr int kBK = 32;                   // k a stage: two k16 slices
constexpr int kStages = 5;
constexpr int kConsumers = 256;           // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// Registers a thread, moved from the producer to the consumers:
// 256 * 232 + 128 * 40 <= 65,536.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kAcc = kBN / 2;             // accumulator floats a thread
constexpr int kPlaneBytes = kBN * kBK * 2;
constexpr int kABytes = kBM * kBK * 4;
constexpr int kStageBytes = kABytes + 3 * kPlaneBytes;

enum Epilogue {
  kBias = 0, kGelu = 1, kResidual = 2, kRelu = 3, kSwiglu = 4
};
constexpr int kGate = kBN / 2;            // gate columns a SwiGLU tile

struct __align__(1024) Stage {
  float a[kBM * kBK];                       // 128-byte swizzle
  __nv_bfloat16 b[3][kBN * kBK];            // hi, mid, lo; 64-byte swizzle
};
static_assert(sizeof(Stage) == kStageBytes, "no padding in a stage");
static_assert(sizeof(Stage) % 1024 == 0, "stages keep the swizzle period");
static_assert(kBK == 32 && kBN == 128, "hopper::desc_k32_sw64, m64n128k16");

struct Smem {
  Stage stage[kStages];
  uint64_t full[kStages];   // the stage's TMA copies have landed
  uint64_t empty[kStages];  // every consumer warp is done with the stage
};

// A fragments of both k16 slices of a stage, as planes: frag[s][p][r] is
// register r of plane p (0 hi, 1 mid, 2 lo) of slice s.
using Frags = uint32_t[2][3][4];

// Register 2 * half + h of slice s holds (row h, columns 16s + 8 half + 2q,
// + 1); the float32 tile's 16-byte chunk c of row r sits at chunk
// c ^ (r % 8) (TMA's 128-byte swizzle).
__device__ __forceinline__ void load_split(Frags& f, const float* a, int r0,
                                           int q) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        const int chunk = 4 * s + 2 * half + q / 2;
        const float2 v = *reinterpret_cast<const float2*>(
            a + r * kBK + ((chunk ^ (r & 7)) * 4) + (q & 1) * 2);
        hopper::split_bf16x3(v.x, v.y, f[s][0][2 * half + h],
                             f[s][1][2 * half + h], f[s][2][2 * half + h]);
      }
    }
  }
}

__device__ __forceinline__ float gelu(float v) {
  // F.gelu's erf form, as PyTorch's CUDA kernel writes it.
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752440f));
}

__device__ __forceinline__ float relu(float v) {
  // torch.relu's: NaN stays NaN.
  return v < 0.f ? 0.f : v;
}

__device__ __forceinline__ float silu(float v) {
  // F.silu's, as PyTorch's CUDA kernel writes it.
  return v / (1.0f + expf(-v));
}

// Columns of W's planes, and so of the product, for y's n: n itself, or
// for SwiGLU twice n rounded up to whole blocks of gates.
__host__ __device__ constexpr int product_width(int epilogue, int n) {
  return epilogue == kSwiglu ? (n + kGate - 1) / kGate * kBN : n;
}

}  // namespace esm

template <int kEpilogue, bool kHasBias>
__global__ void __launch_bounds__(esm::kThreads, 1)
esm_gemm_kernel(const float* __restrict__ bias,
                const float* __restrict__ residual, float* __restrict__ y,
                int M, int N, int K,
                const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap) {
  using namespace esm;
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t skew =
      (1024 - smem_addr(smem_raw) % 1024) % 1024;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + skew);

  const int tiles_n = (product_width(kEpilogue, N) + kBN - 1) / kBN;
  const int n0 = (blockIdx.x % tiles_n) * kBN;
  const int m0 = (blockIdx.x / tiles_n) * kBM;
  // Stages of k: an even number (a stage past K reads zeros), two an
  // iteration of the consumers' loop.
  const int nk = ((K + kBK - 1) / kBK + 1) / 2 * 2;
  const int t = threadIdx.x;

  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&sm.full[s]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(&sm.empty[s])),
                   "r"(kConsumers / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (t >= kConsumers) {
    // The producer warpgroup: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (t == kConsumers) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % kStages;
        const int round = kb / kStages;
        if (round > 0) wait_parity(&sm.empty[s], (round - 1) & 1);
        const uint32_t bar = smem_addr(&sm.full[s]);
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                bar),
            "r"(kStageBytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
                smem_addr(sm.stage[s].a)),
            "l"(&xmap), "r"(kb * kBK), "r"(m0), "r"(bar)
            : "memory");
        asm volatile(
            "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
            "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
                smem_addr(sm.stage[s].b)),
            "l"(&wmap), "r"(kb * kBK), "r"(n0), "r"(0), "r"(bar)
            : "memory");
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // Consumers. wgmma fragment ownership: warp w (0..7) holds rows 16w.. of
  // the tile (warps 0-3 form warpgroup 0, rows 0-63); lane (g = lane / 4,
  // q = lane % 4) holds rows g and g + 8 and accumulator columns 8c + 2q,
  // 8c + 2q + 1.
  const int lane = t % 32;
  const int q = lane % 4;
  const int r0 = (t / 32) * 16 + lane / 4;

  float sum[kAcc];
  float part[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) sum[i] = part[i] = 0.f;

  // Stage k's 12 products, asynchronously: (lo, hi), (mid, mid), (hi, lo),
  // (mid, hi), (hi, mid), (hi, hi) of each k16 slice, as (x plane, W
  // plane), the smallest first; a fresh stage overwrites part.
  auto issue = [&](const Frags& f, int k, bool fresh) {
    const Stage& st = sm.stage[k % kStages];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      wgmma_m64n128k16(part, f[sl][2], desc_k32_sw64(st.b[0], sl),
                       !(fresh && sl == 0));
      wgmma_m64n128k16(part, f[sl][1], desc_k32_sw64(st.b[1], sl), 1);
      wgmma_m64n128k16(part, f[sl][0], desc_k32_sw64(st.b[2], sl), 1);
      wgmma_m64n128k16(part, f[sl][1], desc_k32_sw64(st.b[0], sl), 1);
      wgmma_m64n128k16(part, f[sl][0], desc_k32_sw64(st.b[1], sl), 1);
      wgmma_m64n128k16(part, f[sl][0], desc_k32_sw64(st.b[0], sl), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  };
  auto fetch = [&](Frags& f, int k) {
    wait_parity(&sm.full[k % kStages], (k / kStages) & 1);
    load_split(f, sm.stage[k % kStages].a, r0, q);
  };
  // Stage k goes back to the producer: this warp read its fragments
  // before issuing its products, and those have completed.
  auto release = [&](int k) {
    __syncwarp();
    if (lane == 0)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                       smem_addr(&sm.empty[k % kStages]))
                   : "memory");
  };

  // Two stages an iteration, their 24 products one partial sum. Stage kb's
  // products run from fragment set f0 while stage kb + 1's fragments are
  // loaded and split into f1; then stage kb + 1's run while stage kb + 2's
  // go into f0; then the partial sum joins the running sum. The other
  // warpgroup's products keep the tensor cores busy meanwhile.
  Frags f0, f1;
  fetch(f0, 0);
  for (int kb = 0; kb < nk; kb += 2) {
    issue(f0, kb, true);
    fetch(f1, kb + 1);
    issue(f1, kb + 1, false);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int p = 0; p < 3; ++p) pin(f0[sl][p]);
    release(kb);
    if (kb + 2 < nk) fetch(f0, kb + 2);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    pin(part);
#pragma unroll
    for (int sl = 0; sl < 2; ++sl)
#pragma unroll
      for (int p = 0; p < 3; ++p) pin(f1[sl][p]);
    release(kb + 1);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) sum[i] = __fadd_rn(sum[i], part[i]);
  }

  const bool pairs = (N & 1) == 0;
  if constexpr (kEpilogue == kSwiglu) {
    // Gate column 8c + 2q (+ 1) of the tile in sum[4c + 2h (+ 1)], its up
    // column 64 further in sum[4(c + 8) + 2h (+ 1)]; y's column is the
    // gate's index among all gates.
    const int f0 = (blockIdx.x % tiles_n) * kGate;
#pragma unroll
    for (int c = 0; c < kGate / 8; ++c) {
      const int n = f0 + 8 * c + 2 * q;
      if (n >= N) continue;
      const bool two = n + 1 < N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + 8 * h;
        if (m >= M) continue;
        const int g = 4 * c + 2 * h;
        const int u = 4 * (c + kGate / 8) + 2 * h;
        const float v0 = silu(sum[g]) * sum[u];
        const float v1 = silu(sum[g + 1]) * sum[u + 1];
        const size_t at = static_cast<size_t>(m) * N + n;
        if (pairs && two) {
          *reinterpret_cast<float2*>(y + at) = make_float2(v0, v1);
        } else {
          y[at] = v0;
          if (two) y[at + 1] = v1;
        }
      }
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kBN / 8; ++c) {
    const int n = n0 + 8 * c + 2 * q;
    if (n >= N) continue;
    const bool two = n + 1 < N;
    float b0 = 0.f, b1 = 0.f;
    if constexpr (kHasBias) {
      b0 = bias[n];
      b1 = two ? bias[n + 1] : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r0 + 8 * h;
      if (m >= M) continue;
      float v0 = sum[4 * c + 2 * h];
      float v1 = sum[4 * c + 2 * h + 1];
      if constexpr (kHasBias) {
        v0 = __fadd_rn(v0, b0);
        v1 = __fadd_rn(v1, b1);
      }
      const size_t at = static_cast<size_t>(m) * N + n;
      if constexpr (kEpilogue == kGelu) {
        v0 = gelu(v0);
        v1 = gelu(v1);
      } else if constexpr (kEpilogue == kRelu) {
        v0 = relu(v0);
        v1 = relu(v1);
      } else if constexpr (kEpilogue == kResidual) {
        v0 = __fadd_rn(residual[at], v0);
        if (two) v1 = __fadd_rn(residual[at + 1], v1);
      }
      if (pairs && two) {
        *reinterpret_cast<float2*>(y + at) = make_float2(v0, v1);
      } else {
        y[at] = v0;
        if (two) y[at + 1] = v1;
      }
    }
  }
}

// x (M, K) float32, row stride ldx elements: boxes of 32 columns x 128 rows,
// 128-byte swizzle. W's planes (3, N, ldw) bf16: boxes of 32 x 128 x 3,
// 64-byte swizzle. Zeros outside either tensor.
cudaError_t tensor_maps(CUtensorMap* xmap, CUtensorMap* wmap, const float* x,
                        const void* planes, int M, int N, int K, int ldx,
                        int ldw) {
  hopper::TensorMapEncoder encode;
  cudaError_t err = hopper::tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint32_t unit[3] = {1, 1, 1};
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t xstrides[1] = {static_cast<cuuint64_t>(ldx) * 4};
  const cuuint32_t xbox[2] = {esm::kBK, esm::kBM};
  CUresult r = encode(xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                      const_cast<float*>(x), xdims, xstrides, xbox, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t wdims[3] = {static_cast<cuuint64_t>(ldw),
                               static_cast<cuuint64_t>(N), 3};
  const cuuint64_t wstrides[2] = {static_cast<cuuint64_t>(ldw) * 2,
                                  static_cast<cuuint64_t>(N) * ldw * 2};
  const cuuint32_t wbox[3] = {esm::kBK, esm::kBN, 3};
  r = encode(wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(planes), wdims, wstrides, wbox, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int kEpilogue, bool kHasBias>
cudaError_t launch(const float* x, const void* planes, const float* bias,
                   const float* residual, float* y, int M, int N, int K,
                   int ldx, int ldw, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  // Dynamic smem limit set, per device (host threads may launch at once,
  // each on its own device; setting it twice is harmless).
  static std::atomic<bool> ready[kMaxDevices];
  auto kernel = esm_gemm_kernel<kEpilogue, kHasBias>;
  const int bytes = static_cast<int>(sizeof(esm::Smem)) + 1024;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  CUtensorMap xmap = {}, wmap = {};
  const int np = esm::product_width(kEpilogue, N);
  err = tensor_maps(&xmap, &wmap, x, planes, M, np, K, ldx, ldw);
  if (err != cudaSuccess) return err;
  const int tiles = (M + esm::kBM - 1) / esm::kBM *
                    ((np + esm::kBN - 1) / esm::kBN);
  kernel<<<tiles, esm::kThreads, bytes, stream>>>(bias, residual, y, M, N,
                                                  K, xmap, wmap);
  return cudaGetLastError();
}

// The instance for a bias or none.
template <int kEpilogue>
cudaError_t launch_epilogue(const float* x, const void* planes,
                            const float* bias, const float* residual,
                            float* y, int M, int N, int K, int ldx, int ldw,
                            cudaStream_t stream) {
  return bias != nullptr
             ? launch<kEpilogue, true>(x, planes, bias, residual, y, M, N, K,
                                       ldx, ldw, stream)
             : launch<kEpilogue, false>(x, planes, bias, residual, y, M, N,
                                        K, ldx, ldw, stream);
}

}  // namespace

extern "C" {

// y (M, N) = epilogue(x (M, K) W [+ bias]). planes: W's (3, N, ldw) bf16
// split, ldw >= K a multiple of 8, zero past K; x 16-byte aligned with ldx
// a multiple of 4; bias (N) or null for none; epilogue 0 (nothing more),
// 1 (GELU), 2 (residual (M, N) added), 3 (ReLU), 4 (SwiGLU, no bias: the
// planes hold 2 * ceil(N / 64) * 64 columns, gates and ups interleaved in
// blocks of 64, and y's N columns are silu(gate) * up).
int mdf_esm_gemm(const void* x, const void* planes, const void* bias,
                 const void* residual, void* y, int M, int N, int K, int ldx,
                 int ldw, int epilogue, void* stream) {
  const auto xp = static_cast<const float*>(x);
  const auto bp = static_cast<const float*>(bias);
  const auto rp = static_cast<const float*>(residual);
  const auto yp = static_cast<float*>(y);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (epilogue) {
    case esm::kBias:
      err = launch_epilogue<esm::kBias>(xp, planes, bp, rp, yp, M, N, K, ldx,
                                        ldw, s);
      break;
    case esm::kGelu:
      err = launch_epilogue<esm::kGelu>(xp, planes, bp, rp, yp, M, N, K, ldx,
                                        ldw, s);
      break;
    case esm::kResidual:
      err = launch_epilogue<esm::kResidual>(xp, planes, bp, rp, yp, M, N, K,
                                            ldx, ldw, s);
      break;
    case esm::kRelu:
      err = launch_epilogue<esm::kRelu>(xp, planes, bp, rp, yp, M, N, K, ldx,
                                        ldw, s);
      break;
    case esm::kSwiglu:
      err = bp != nullptr
                ? cudaErrorInvalidValue
                : launch<esm::kSwiglu, false>(xp, planes, bp, rp, yp, M, N, K,
                                              ldx, ldw, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
