// E2: float32-exact attention on Hopper's tensor cores for the transformer
// trunks (ESM-2's and ProtT5's; sm_90a):
//   out[b, i, h, :] = softmax_j(q[b, h, i] . k[b, h, j] + bias[h, j - i])
//                     v[b, h, j]          over keys j < n_b,
// q, k, v float32 (B, H, T, D) read through their strides (D contiguous),
// out float32 (B, T, H * D), D 64 (ESM-2: q scaled and rotated beforehand,
// no bias) or 128 (ProtT5: no scale, T5's relative-position bias), n_b
// each row's valid token count. Head dim and bias-or-none are template
// parameters; the entry point picks the instance from D and whether a bias
// table is passed.
//
// Replaces no TPU kernel: the JAX package has no transformer trunk. It
// replaces PyTorch's fused attention call (SDPA), whose float32 path runs
// on the CUDA cores (CUTLASS's memory-efficient SIMT kernel, 10-12 TFLOP/s
// of real work in the trunk cells on an H100) and computes every padded pair of a
// batch, and which for ProtT5 read a (B, H, T, T) float32 bias (4.3 GB at
// bucket 1024) on every layer.
//
// Exactness, as in esm_gemm.cu (E1). Every float32 operand is split into
// three bf16 planes, x = hi + mid + lo (split3: hopper.cuh's split_bf16x3
// without its checks for infinite and NaN operands), and six
// of the nine plane products are summed (lo*hi, mid*mid, hi*lo, mid*hi,
// hi*mid, hi*hi, smallest first, each over all of a partial sum's k16
// slices before the next, so that the accumulator, which rounds toward
// zero, meets the large hi*hi terms last); each dropped one is at most
// 2^-24 |a||b| a term. The tensor cores sum at most 64 of k into one
// accumulator:
// S = q k^T is one partial sum at D 64 and two, added in registers, at D
// 128; P V is one partial sum a 64-key tile, which joins the float32 output
// accumulator as o = o * alpha + partial (one rounding, fmaf). The softmax
// is online in float32: the running max and sum in registers, 2^x (the
// SFU's ex2) of log2(e)-scaled logits (one fmaf, so the common factor
// 2^(-m log2 e) cancels in the normalisation), the output times the sum's
// reciprocal at the end.
//
// Padding. Each row's keys past n_b are neither loaded nor computed: the
// block runs ceil(n_b / 64) key tiles and masks the last one's keys >= n_b
// (-inf, so their weight is exactly 0, as the additive mask gave them). A
// warpgroup whose 64 queries all start at or past n_b writes zeros and does
// nothing else; a block whose 128 do returns at once. Queries past n_b
// inside a computed tile get the values of real attention over the valid
// keys: finite, and read by no real position.
//
// ProtT5's bias. The host passes T5's bucket of every distance j - i in
// -(T-1) .. T-1 as one int8 table (2T - 1 entries, made once a length) and
// the (buckets, H) float32 table R. Each block gathers R[bucket(d), h] for
// the distances its 128 queries meet into shared memory (n + 127 floats at
// most), and adds tab[j - i + 127] to each logit: bit for bit the value of
// the (H, T, T) tensor this replaces.
//
// Bound. At the trunks' shapes the operations, counted on the tensor cores:
// six bf16 products a float32 product give at most 989 / 6 = 165 TFLOP/s of
// float32 work. ProtT5 at bucket 1024 (32 rows, 32 heads of 128): ~0.23
// TFLOP a layer over its real pairs, ~1.4 ms at that rate, against ~1.4 GB
// of q, k, v and output, ~0.41 ms at 3.35 TB/s. The benchmark's roofline
// divides the operations by the bf16 peak, so there the bytes are the
// bound, and a kernel at the six-product ceiling reads about 50 %.
//
// Design: one block a (row, head, 128-query tile), 384 threads: a producer
// warpgroup (88 registers a thread) and two consumer warpgroups of 64
// queries (208 registers, setmaxnreg).
//   - The producer reads each 64-key tile of K and of V from device memory
//     (mostly L2: the row's other query tiles read the same keys), splits
//     it into bf16 planes in registers and writes them into a ring of slots
//     in shared memory, both as they are laid out (rows = keys, head dims
//     contiguous, 32-column subtiles in the 64-byte swizzle): wgmma reads
//     K's as the K-major B operand of q K^T and V's as the MN-major
//     (transposed) B operand of P V, so nothing is transposed. The split is
//     made in the kernel, not in a pre-pass: a pre-pass would write the
//     planes (6 bytes an element) and read them back once a query tile,
//     where the kernel reads the 4-byte float32 and spends producer issue
//     slots that the tensor-core work leaves free. Slots alternate K, V, K,
//     ... on a full/empty mbarrier pair each: 4 slots of 24 KB at D 64, 2 of
//     48 KB at D 128.
//   - Each consumer warpgroup splits its 64 queries into planes in shared
//     memory once, and at D 64 loads them as wgmma A fragments into
//     registers (at D 128 they would not fit beside the S and O
//     accumulators), then per key tile: S = q K^T (wgmma m64n64k16, q from
//     registers at D 64 and from shared memory at D 128, 6 D / 16
//     products), the bias, the mask (last tile only) and the online softmax
//     in registers, P split into planes in registers and fed as wgmma's A
//     operand (the accumulator's layout is the A fragments'), the partial
//     P V (m64nDk16, 24 products), and the rescaled sum. One warpgroup's
//     softmax runs while the tensor cores work on the other's products, as
//     far as the two drift apart (issuing them in turns through named
//     barriers measured no faster).
//   - The producer's and the consumers' writes to shared memory reach the
//     tensor cores through fence.proxy.async before their barrier.
//
// C interface, bound with ctypes: every pointer and the stream are void*,
// nothing allocates, every launch goes on the caller's stream, and the
// entry point returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {
namespace attn {

constexpr int kRows = 64;                  // queries a warpgroup, keys a tile
constexpr int kBlockRows = 2 * kRows;      // queries a block
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
// Registers a thread, moved from the producer to the consumers: the launch
// gives each of the 384 threads 168, and 128 * 88 + 256 * 208 = 384 * 168.
// (On an H100 a producer of 72 registers read its tiles at half the rate
// at heads of 64; one of 40 or 56 spills.)
constexpr int kConsumerRegs = 208;
constexpr int kProducerRegs = 88;
constexpr int kSub = kRows * 32;           // bf16 of a 64-row, k32 subtile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSmem = 232448;           // a block's dynamic maximum

// A tile's three planes of 64 x D bf16 each (q, K or V).
template <int D>
struct Dims {
  static constexpr int kPlane = kRows * D;
  static constexpr int kTile = 3 * kPlane;
  static constexpr int kSlots = D == 64 ? 4 : 2;
  static constexpr int kAcc = D / 2;       // output accumulator floats
};

template <int D>
struct __align__(1024) Smem {
  // Per consumer warpgroup, its queries: plane p, k32 subtile c, at
  // q[wg] + p * kPlane + c * kSub.
  __nv_bfloat16 q[2][Dims<D>::kTile];
  // K or V tile: plane p, subtile c (head dims 32c..) at p * kPlane +
  // c * kSub, 64 key rows.
  __nv_bfloat16 slot[Dims<D>::kSlots][Dims<D>::kTile];
  uint64_t full[Dims<D>::kSlots];   // the producer's 128 threads wrote it
  uint64_t empty[Dims<D>::kSlots];  // every computing consumer warp is done
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  const int* valid;       // (B) valid token count of each row
  const float* rel;       // (buckets, H) or null
  const int8_t* buckets;  // (2T - 1): bucket of distance d at d + T - 1
  long long sq[3], sk[3], sv[3];  // strides of b, h, t, in elements
  int H, T;
};

// Element offset of (row r, k < 32) in a subtile of 32 k a row, 64-byte
// swizzle: 16-byte chunk k / 8 at position (k / 8) ^ ((r >> 1) & 3).
__device__ __forceinline__ int sw64(int r, int k) {
  return r * 32 + ((((k >> 3) ^ (r >> 1)) & 3) << 3) + (k & 7);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// hopper::split_bf16x3 for finite x0, x1, without its checks: an infinite
// or NaN operand of the attention makes its output NaN, as it makes the
// float32 attention's.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = hopper::bf16x2_rz(x0, x1);
  float r0 = __fsub_rn(x0, __uint_as_float(hi << 16));
  float r1 = __fsub_rn(x1, __uint_as_float(hi & 0xFFFF0000u));
  mid = hopper::bf16x2_rz(r0, r1);
  r0 = __fsub_rn(r0, __uint_as_float(mid << 16));
  r1 = __fsub_rn(r1, __uint_as_float(mid & 0xFFFF0000u));
  lo = hopper::bits(__floats2bfloat162_rn(r0, r1));
}

// Rows [0, 64) of a float32 matrix (row r at src + r * ld, D contiguous
// floats; rows >= nrows read as zeros) as three bf16 planes, row-major in
// 32-column subtiles with the 64-byte swizzle, into dst (plane p, subtile c
// at dst + p * kPlane + c * kSub): q's and K's as wgmma's K-major operands
// (k = head dim), V's as its MN-major B operand (k = key, n = head dim).
// t is the thread's index among the 128 that share the work. A warp's 32
// lanes take two rows of 64 columns (float4 each): 256-byte runs from
// device memory, 8-byte stores that fill two 128-byte wavefronts.
template <int D>
__device__ __forceinline__ void split_rows(__nv_bfloat16* dst,
                                           const float* src, long long ld,
                                           int nrows, int t) {
  constexpr int kUnits = kRows * D / 4;
  constexpr int kBatch = 8;
  static_assert(kUnits % (128 * kBatch) == 0, "whole batches");
#pragma unroll 1
  for (int u0 = t; u0 < kUnits; u0 += 128 * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + 128 * i;
      const int f = u & 15, r = (u >> 4) & 63, blk = u >> 10;
      v[i] = r < nrows ? load4(src + r * ld + blk * 64 + 4 * f)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int u = u0 + 128 * i;
      const int f = u & 15, r = (u >> 4) & 63, blk = u >> 10;
      const int at = (2 * blk + (f >> 3)) * kSub + sw64(r, 4 * (f & 7));
      uint32_t h0, m0, l0, h1, m1, l1;
      split3(v[i].x, v[i].y, h0, m0, l0);
      split3(v[i].z, v[i].w, h1, m1, l1);
      *reinterpret_cast<uint2*>(dst + at) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(dst + Dims<D>::kPlane + at) =
          make_uint2(m0, m1);
      *reinterpret_cast<uint2*>(dst + 2 * Dims<D>::kPlane + at) =
          make_uint2(l0, l1);
    }
  }
}

// Zeros into rows [r0, r1) of the output's D columns (row i at out + i *
// ld); t of n threads.
template <int D>
__device__ __forceinline__ void zero_rows(float* out, long long ld, int r0,
                                          int r1, int t, int n) {
  for (int u = t; u < (r1 - r0) * (D / 4); u += n) {
    const int r = r0 + u / (D / 4), c = 4 * (u % (D / 4));
    *reinterpret_cast<float4*>(out + r * ld + c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   hopper::smem_addr(bar))
               : "memory");
}

// P V's product of one k16 slice, V read MN-major: n64 at D 64, n128 at
// D 128.
template <int D>
__device__ __forceinline__ void mma_pv(float (&d)[D / 2],
                                       const uint32_t (&a)[4], uint64_t desc,
                                       int accumulate) {
  if constexpr (D == 64) {
    hopper::wgmma_m64n64k16<1>(d, a, desc, accumulate);
  } else {
    hopper::wgmma_m64n128k16<1>(d, a, desc, accumulate);
  }
}

// A shared-memory descriptor that the compiler must recompute where it is
// used (a tile's 48 or 96 descriptors, hoisted out of the loop, would take
// as many registers).
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// 2^x by the SFU (ex2.approx.ftz: relative error about 2^-22, results
// below 2^-126 flushed to zero, where exp2f adds a denormal path; the
// softmax's weights that small are below float32's rounding of the sum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Product x of the six, smallest first: (A plane, B plane) = (lo, hi),
// (mid, mid), (hi, lo), (mid, hi), (hi, mid), (hi, hi).
__device__ __forceinline__ constexpr int plane_a(int x) {
  return x == 0 ? 2 : x == 1 || x == 3 ? 1 : 0;
}

__device__ __forceinline__ constexpr int plane_b(int x) {
  return x == 2 ? 2 : x == 1 || x == 4 ? 1 : 0;
}

}  // namespace attn

template <int D, bool kHasBias>
__global__ void __launch_bounds__(attn::kThreads, 1)
attention_kernel(const attn::Params p) {
  using namespace attn;
  using namespace hopper;
  constexpr int kPlane = Dims<D>::kPlane;
  constexpr int kSlots = Dims<D>::kSlots;
  constexpr int kAcc = Dims<D>::kAcc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t skew = (1024 - smem_addr(smem_raw) % 1024) % 1024;
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + skew);
  float* tab = reinterpret_cast<float*>(smem_raw + skew + sizeof(Smem<D>));

  const int b = blockIdx.z, h = blockIdx.y, qb = blockIdx.x * kBlockRows;
  const int T = p.T;
  const int n = min(p.valid[b], T);
  const long long ldo = static_cast<long long>(p.H) * D;
  float* out = p.out + static_cast<long long>(b) * T * ldo + h * D;
  const int t = threadIdx.x;
  if (qb >= n) {
    zero_rows<D>(out, ldo, qb, min(qb + kBlockRows, T), t, kThreads);
    return;
  }
  const int computing = qb + kRows < n ? 2 : 1;  // consumer warpgroups
  const int tiles = (n + kRows - 1) / kRows;     // key tiles

  if (t == 0) {
    for (int s = 0; s < kSlots; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(&sm.full[s])),
                   "r"(128)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_addr(&sm.empty[s])),
                   "r"(4 * computing)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kHasBias) {
    // tab[j - (i - qb) + 127] = R[bucket(j - i), h] for the block's
    // queries i and the keys j of its tiles.
    const int size = tiles * kRows + kBlockRows - 1;
    for (int x = t; x < size; x += kThreads) {
      const int d = min(max(x - (kBlockRows - 1) - qb, 1 - T), T - 1);
      tab[x] = p.rel[static_cast<int>(p.buckets[d + T - 1]) * p.H + h];
    }
  }
  __syncthreads();

  if (t >= kConsumers) {
    // The producer warpgroup: each key tile's K, then its V, into the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int tp = t - kConsumers;
    const float* kbase = p.k + b * p.sk[0] + h * p.sk[1];
    const float* vbase = p.v + b * p.sv[0] + h * p.sv[1];
#pragma unroll 1
    for (int x = 0; x < 2 * tiles; ++x) {
      const int s = x % kSlots, round = x / kSlots;
      const int j0 = (x / 2) * kRows;
      if (round > 0) wait_parity(&sm.empty[s], (round - 1) & 1);
      if (x % 2 == 0) {
        split_rows<D>(sm.slot[s], kbase + j0 * p.sk[2], p.sk[2], n - j0, tp);
      } else {
        split_rows<D>(sm.slot[s], vbase + j0 * p.sv[2], p.sv[2], n - j0, tp);
      }
      fence_proxy_async();
      arrive(&sm.full[s]);
    }
    return;
  }

  const int wg = t / 128;
  const int q0 = qb + wg * kRows;
  if (wg >= computing) {
    zero_rows<D>(out, ldo, q0, min(q0 + kRows, T), t % 128, 128);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // wgmma fragment ownership: warp w (0..3) of the warpgroup holds rows
  // 16w.. of its 64; lane (g = lane / 4, q = lane % 4) rows g and g + 8 and
  // columns 8c + 2q, + 1.
  const int lane = t % 32;
  const int qd = lane % 4;
  const int r0 = ((t / 32) % 4) * 16 + lane / 4;
  __nv_bfloat16* qs = sm.q[wg];
  split_rows<D>(qs, p.q + b * p.sq[0] + h * p.sq[1] + q0 * p.sq[2], p.sq[2],
                T - q0, t % 128);
  fence_proxy_async();
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  // At heads of 64, q's planes as wgmma A fragments in registers (48), so
  // that S reads only K from shared memory; at 128 they would take 96, and
  // wgmma reads them from shared memory.
  uint32_t qa[D == 64 ? 4 : 1][3][4];
  if constexpr (D == 64) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int pl = 0; pl < 3; ++pl)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int k = 16 * ks + 8 * half + 2 * qd;
            qa[ks][pl][2 * half + hh] = *reinterpret_cast<const uint32_t*>(
                qs + pl * kPlane + (k / 32) * kSub +
                sw64(r0 + 8 * hh, k % 32));
          }
  }

  float o[kAcc];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kAcc; ++i) o[i] = 0.f;

  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) arrive(&sm.empty[s]);
  };

#pragma unroll 1
  for (int kt = 0; kt < tiles; ++kt) {
    const int xk = 2 * kt, xv = 2 * kt + 1;
    const int sk = xk % kSlots, sv = xv % kSlots;
    // S = q K^T: D / 16 k16 slices, a partial sum each 64 of k. The
    // accumulators of a tile are declared in it: each product chain starts
    // fresh, so nothing of them lives from one tile to the next.
    float s[32], s2[32];
    wait_parity(&sm.full[sk], (xk / kSlots) & 1);
    {
      // Descriptors move 16 bytes a unit: a plane kPlane / 8 units, a
      // subtile kSub / 8, a k16 slice 2.
      [[maybe_unused]] const uint64_t qd = opaque(desc_k32_sw64(qs, 0));
      const uint64_t kd = opaque(desc_k32_sw64(sm.slot[sk], 0));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int x = 0; x < 6; ++x) {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const int at = (ks / 2) * kSub / 8 + (ks % 2) * 2;
          const uint64_t ad = qd + plane_a(x) * kPlane / 8 + at;
          const uint64_t bd = kd + plane_b(x) * kPlane / 8 + at;
          const int acc = !(ks % 4 == 0 && x == 0);
          if constexpr (D == 64) {
            wgmma_m64n64k16(s, qa[ks][plane_a(x)], bd, acc);
          } else if (ks < 4) {
            wgmma_m64n64k16_ss(s, ad, bd, acc);
          } else {
            wgmma_m64n64k16_ss(s2, ad, bd, acc);
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(s);
      if constexpr (D > 64) pin(s2);
    }
    release(sk);
    if constexpr (D > 64) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = __fadd_rn(s[i], s2[i]);
    }

    // The bias, the mask, and the online softmax of rows r0 and r0 + 8.
    const int j0 = kt * kRows;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + 8 * c + 2 * qd + e;
          float& x = s[4 * c + 2 * hh + e];
          if constexpr (kHasBias) {
            x = __fadd_rn(x, tab[j - (wg * kRows + r0 + 8 * hh) +
                                 kBlockRows - 1]);
          }
          if (kt == tiles - 1 && j >= n) x = -INFINITY;
          mx[hh] = fmaxf(mx[hh], x);
        }
      }
    }
    float alpha[2], ml[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float mn = fmaxf(m[hh], mx[hh]);
      alpha[hh] = ex2((m[hh] - mn) * kLog2e);
      m[hh] = mn;
      ml[hh] = mn * kLog2e;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i / 2) % 2;
      s[i] = ex2(fmaf(s[i], kLog2e, -ml[hh]));
      sum[hh] += s[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = fmaf(l[hh], alpha[hh], sum[hh]);

    // P's planes as A fragments: slice ks holds columns 16ks.. of S, the
    // accumulator's c = 2ks (half 0) and 2ks + 1 (half 1).
    uint32_t pa[4][3][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int c = 2 * ks + half;
          split3(s[4 * c + 2 * hh], s[4 * c + 2 * hh + 1],
                 pa[ks][0][2 * half + hh], pa[ks][1][2 * half + hh],
                 pa[ks][2][2 * half + hh]);
        }
      }
    }

    // part = P V over the tile's 64 keys; o = o * alpha + part.
    float part[kAcc];
    wait_parity(&sm.full[sv], (xv / kSlots) & 1);
    {
      // V's slice ks: key rows 16ks.. (1024 bytes in), 32-column subtiles
      // kSub apart (LBO), 8-row groups 512 bytes apart (SBO).
      const uint64_t vd =
          opaque(desc_mn_sw64(sm.slot[sv], kSub * 2, 8 * 32 * 2));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int x = 0; x < 6; ++x) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          mma_pv<D>(part, pa[ks][plane_a(x)],
                    vd + plane_b(x) * kPlane / 8 + ks * 64,
                    !(ks == 0 && x == 0));
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      pin(part);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int pl = 0; pl < 3; ++pl) pin(pa[ks][pl]);
    }
    release(sv);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) o[i] = fmaf(o[i], alpha[(i / 2) % 2], part[i]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = q0 + r0 + 8 * hh;
    if (i >= T) continue;
    // o / l as o times 1 / l: two roundings, at most an ulp more than the
    // division, at a D-th of its cost.
    const float rl = __frcp_rn(l[hh]);
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      *reinterpret_cast<float2*>(out + i * ldo + 8 * c + 2 * qd) =
          make_float2(__fmul_rn(o[4 * c + 2 * hh], rl),
                      __fmul_rn(o[4 * c + 2 * hh + 1], rl));
    }
  }
}

template <int D, bool kHasBias>
cudaError_t launch(const attn::Params& p, int B, cudaStream_t stream) {
  constexpr int kMaxDevices = 64;
  // Dynamic smem limit set once per device (host threads may launch at
  // once, each on its own device; setting it twice is harmless).
  static std::atomic<bool> ready[kMaxDevices];
  auto kernel = attention_kernel<D, kHasBias>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !ready[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, attn::kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) ready[dev].store(true, std::memory_order_release);
  }
  const long long tiles = (p.T + attn::kRows - 1) / attn::kRows;
  const long long bytes =
      static_cast<long long>(sizeof(attn::Smem<D>)) + 1024 +
      (kHasBias ? (tiles * attn::kRows + attn::kBlockRows) * 4 : 0);
  if (bytes > attn::kMaxSmem) return cudaErrorInvalidValue;
  const dim3 grid((p.T + attn::kBlockRows - 1) / attn::kBlockRows, p.H, B);
  kernel<<<grid, attn::kThreads, static_cast<int>(bytes), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, T, H * D) = attention of q, k, v (B, H, T, D) float32, element
// strides (b, h, t) of each in strides[0..2], [3..5], [6..8], the last
// dimension contiguous, every row 16-byte aligned; valid (B) int32 on the
// device; rel (buckets, H) float32 and buckets (2T - 1) int8, both null
// for no bias. D 64 or 128.
int mdf_attention(const void* q, const void* k, const void* v, void* out,
                  const void* valid, const void* rel, const void* buckets,
                  const long long* strides, int B, int H, int T, int D,
                  void* stream) {
  attn::Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.valid = static_cast<const int*>(valid);
  p.rel = static_cast<const float*>(rel);
  p.buckets = static_cast<const int8_t*>(buckets);
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
  }
  p.H = H;
  p.T = T;
  if (B < 1 || H < 1 || T < 1 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool bias = rel != nullptr;
  cudaError_t err;
  if (D == 64) {
    err = bias ? launch<64, true>(p, B, s) : launch<64, false>(p, B, s);
  } else if (D == 128) {
    err = bias ? launch<128, true>(p, B, s) : launch<128, false>(p, B, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
