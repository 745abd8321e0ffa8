// Hopper (sm_90a) building blocks shared by the wgmma kernels:
// graphconv.cu (B1's aggregation), esm_gemm.cu (the trunks' projections)
// and attention.cu (the trunks' attention).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait until the mbarrier has completed the phase of the given parity.
__device__ __forceinline__ void wait_parity(const uint64_t* bar,
                                            uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// wgmma descriptor of k16 slice s of a bf16 B tile stored K-major with the
// 64-byte swizzle: each row (one n) holds 32 k as four 16-byte chunks, chunk
// c at position c ^ ((n >> 1) & 3), the layout TMA's 64-byte swizzle
// writes; 8-row groups 512 bytes apart (SBO); the tile aligned to the
// swizzle's 512-byte period. The start address moves 32 bytes a slice
// inside the swizzled rows; LBO is unused for a swizzled K-major operand (1
// by convention), layout type 2 is the 64-byte swizzle.
__device__ __forceinline__ uint64_t desc_k32_sw64(const void* tile, int s) {
  constexpr uint32_t kSbo = 8 * 32 * 2;
  const uint32_t addr = smem_addr(tile) + 32 * s;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(kSbo >> 4) << 32 |
         static_cast<uint64_t>(2) << 62;
}

// wgmma descriptor of a bf16 B operand stored MN-major (read with trans-b)
// in the 64-byte swizzle: each k a row of 32 n (64 bytes, 16-byte chunk c
// at c ^ ((k >> 1) & 3)), 8-row groups of k SBO bytes apart, blocks of 32 n
// LBO bytes apart; start at the slice's first k row, on a 512-byte atom.
__device__ __forceinline__ uint64_t desc_mn_sw64(const void* start,
                                                 uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = smem_addr(start);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(2) << 62;
}

// d (+)= A (registers, m64 x k16) * B (descriptor, k16 x n128), bf16 ->
// f32, asynchronous; with accumulate == 0 d is overwritten. The register
// fragments: lane (g = lane / 4, q = lane % 4) of warp w of the warpgroup
// holds A rows 16w + g and 16w + g + 8, columns 2q, 2q + 1, 2q + 8, 2q + 9
// (a[2 * half + h]: row h, columns 8 half + 2q, + 1, as a bf16 pair), and
// d[4c + 2h], d[4c + 2h + 1]: row h, columns 8c + 2q, + 1.
// kTransB = 1 reads B MN-major (n contiguous) instead: desc_mn_sw64.
template <int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 const uint32_t (&a)[4],
                                                 uint64_t desc,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}

// The same product at n64 (B 64 wide): d[4c + 2h], d[4c + 2h + 1] hold row
// h, columns 8c + 2q, + 1, for c < 8.
template <int kTransB = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate), "n"(kTransB));
}

// d (+)= A (descriptor, m64 x k16) * B (descriptor, k16 x n64), bf16 ->
// f32, asynchronous, both operands K-major in shared memory (A's 64 rows
// laid out as B's n rows: desc_k32_sw64); accumulator layout as above.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t adesc,
                                                   uint64_t bdesc,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(accumulate));
}

// Keep registers that an asynchronous wgmma reads or writes where they are
// until it has completed (the compiler does not know the asm is async).
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma's operand reads, TMA) once it has passed a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16_rz of two floats, packed (x0 in the low half): the top 16 bits of
// each; infinities stay infinite and NaN stays NaN.
__device__ __forceinline__ uint32_t bf16x2_rz(float x0, float x1) {
  uint32_t d;
  asm("cvt.rz.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(x1), "f"(x0));
  return d;
}

// Two floats' bf16 planes, x = hi + mid + lo, each a packed pair (x0 in the
// low half): hi = bf16_rz(x), mid = bf16_rz(x - hi), lo = x - hi - mid
// (exact in bf16), the differences taken in float32, where they are exact.
// Three 8-bit significands hold float32's 24, so the split is exact for
// finite |x| from 2^-103 up to float32's largest value (every nonzero plane
// a normal bf16), and truncation keeps |hi| and |hi + mid| at most |x|, so
// no plane or partial sum of a finite x is infinite (round to nearest
// would give hi = inf past 3.3895e38, and at float32's largest value
// hi + mid = 2^128). Below 2^-103 lo may be subnormal, and below about
// 2^-110 bits are lost. An infinite or NaN x is carried by hi alone.
// ops/graphconv.py::_split_bf16x3 is its plain twin.
__device__ __forceinline__ void split_bf16x3(float x0, float x1,
                                             uint32_t& hi, uint32_t& mid,
                                             uint32_t& lo) {
  hi = bf16x2_rz(x0, x1);
  float r0 = isfinite(x0) ? __fsub_rn(x0, __uint_as_float(hi << 16)) : 0.f;
  float r1 =
      isfinite(x1) ? __fsub_rn(x1, __uint_as_float(hi & 0xFFFF0000u)) : 0.f;
  mid = bf16x2_rz(r0, r1);
  r0 = __fsub_rn(r0, __uint_as_float(mid << 16));
  r1 = __fsub_rn(r1, __uint_as_float(mid & 0xFFFF0000u));
  lo = bits(__floats2bfloat162_rn(r0, r1));
}

using TensorMapEncoder = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once a process through the CUDA
// runtime's entry-point query, so that the library needs no -lcuda
// (CUDA >= 12.5).
inline cudaError_t tensor_map_encoder(TensorMapEncoder* out) {
  static std::atomic<void*> found_fn{nullptr};
  void* fn = found_fn.load(std::memory_order_acquire);
  if (fn == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    found_fn.store(fn, std::memory_order_release);
  }
  *out = reinterpret_cast<TensorMapEncoder>(fn);
  return cudaSuccess;
}

}  // namespace hopper
