// What staging a backward work item costs on Hopper (sm_90a): a probe,
// with a plain C entry point.
//
// Counterpart of the TPU probe tools/exp_bwd_dma.py ``build`` (:31, its
// pallas_call at :99), at the pxg/px_f tile backward's shapes: N work
// items, T2 = 256 pixels, FB = 128 lanes, GPI = 16 groups, NTR = 18 rows.
// Item i reads its face block face[i] ([106, 128]) and writes its
// gradient block gout[i] ([84, 128]), whose every row is s[l] = sum_t
// acc[t, l], with
//
//   base    acc[t, l] = face[i, 0, l] * 1e-6
//   dma16   base, after 16 copies slab[:, g, :] = px[seg[16 i + g]]
//   dma1r   base, after one copy slab[0:18] = px[seg[16 i] : +18]
//   tr256   dma16, + slab[l / 16, l % 16, t] * 1e-6 (the slab transposed)
//   dots    tr256, + sum_{c < 11} slab[c, l / 8, t]: 11 [256, 16] x
//           [16, 128] products with the 0/1 matrix em[g, l] = (l / 8 == g)
//
// (the TPU probe's sixth variant, tr256x11, does not trace: it reshapes
// 16 values into 256; it has no counterpart here.)  The kernel also writes
// stage_sum[i], the wrapping uint32 sum of the bits of every float it
// staged, which its plain version computes too, so no staged byte is
// dead.
//
// Design.  A block of 512 threads per item; warp w takes pixels 16 w to
// 16 w + 15, and acc lives in registers as the C fragments of mma.sync
// m16n8k8 ([16 pixels, 128 lanes] a warp, 64 floats a thread).  The face
// block comes in by one TMA bulk copy (cp.async.bulk, completion on an
// mbarrier).  The TPU slab, [16, 16, 256] float32 = 256 KB (288 KB for
// dma1r), does not fit a block's 227 KB, so the px rows stream through a
// ring of 4 slots of 16 KB:
//   dma16, tr256, dots  chunk c = row c of the 16 groups' px rows (16
//                       strips of 1 KB), staged by cp.async, 16 B a
//                       thread, as K4, K6 and K9 stage their rows, with
//                       3 chunks in flight while one is consumed; a strip
//                       is padded to 264 floats, so the products' operand
//                       reads hit 32 banks and the transpose's 16 (2-way)
//   dma1r               chunk r = px row seg[16 i] + r, contiguous 16 KB,
//                       by one TMA bulk copy each, 4 in flight
// Chunk c holds slab[c] whole: the transpose reads its lanes' pixels at
// c < 8 and the product's A operand at c < 11.  The ring of 4 (130 KB
// with the face block) keeps 48-64 KB in flight per SM; registers (64
// accumulators a thread) allow one block an SM anyway.  The dots:
//   default                  tensor cores, TF32 with A split in two (big +
//                            small) and em exact in TF32: float32 products
//                            to about 22 bits (the TPU's HIGHEST)
//   PROBE_BWD_DMA_DOT = 1    the same products by FFMA (16 a value)
//   PROBE_BWD_DMA_DOT = 2    the selection as one add a value
//
// Bound.  Bytes: the face blocks read and the gradient blocks written
// once, the px rows that the items read counted once each (the rows are
// 16 KB and the items read them in sorted order, so much of the 16 or 18
// rows an item copies comes from L2); the operations are far below.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PROBE_BWD_DMA_DOT
#define PROBE_BWD_DMA_DOT 0
#endif

namespace probes {

constexpr int kT2 = 256, kFB = 128, kGPI = 16, kNTR = 18, kC = 16;
constexpr int kFaceRows = 106, kOutRows = 84;
constexpr int kThreads = 512, kWarps = kThreads / 32;
constexpr int kStride = 264;                        // floats of a staged strip
constexpr int kSlotFloats = kGPI * kStride;         // a chunk: 16 strips
constexpr int kRowBytes = kC * kT2 * 4;             // a px row: 16,384 B
constexpr int kFaceFloats = kFaceRows * kFB;
constexpr int kFaceBytes = kFaceFloats * 4;         // 54,272 B
constexpr int kRing = 4;                            // slots of the ring
enum Variant { kBase = 0, kDma16 = 1, kDma1r = 2, kTr256 = 3, kDots = 4 };

struct BwdDmaArgs {
  const float* face;   // [N, 106, 128]
  const float* px;     // [rows, 16, 256]
  const int* seg;      // [N * 16] rows of px, non-decreasing
  float* gout;         // [N, 84, 128]
  int* stage_sum;      // [N] the staged floats' bits summed as uint32
  int N, px_rows, variant;
};

// shared memory: the face block, the ring, the warps' column sums, the
// item's sums, the warps' checksums, the mbarriers (ring slots, face)
constexpr size_t kRingOff = kFaceBytes;
constexpr size_t kRedOff = kRingOff + (size_t)kRing * kSlotFloats * 4;
constexpr size_t kSumOff = kRedOff + (size_t)kWarps * kFB * 4;
constexpr size_t kCkOff = kSumOff + kFB * 4;
constexpr size_t kBarOff = kCkOff + kWarps * 4;
constexpr size_t kSmem = kBarOff + (kRing + 1) * 8;
static_assert(kBarOff % 8 == 0, "mbarriers need 8-byte alignment");
static_assert(kSmem <= 232448, "the block's shared memory passes 227 KB");

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1) : "memory");
}

// Arm the barrier for one phase of ``bytes`` and copy them by TMA.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(saddr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits_sum(uint4 v) {
  return v.x + v.y + v.z + v.w;
}

__global__ void __launch_bounds__(kThreads, 1) probe_bwd_dma_kernel(const BwdDmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* face = reinterpret_cast<float*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kRingOff);
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  float* sums = reinterpret_cast<float*>(smem + kSumOff);
  uint32_t* ck_w = reinterpret_cast<uint32_t*>(smem + kCkOff);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kBarOff);
  const int i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, gl = lane >> 2, q = lane & 3;
  const int t0 = warp * 16 + gl, t1 = t0 + 8;    // this thread's pixels
  const int variant = a.variant;
  const bool tma = variant == kDma1r;
  const int chunks = variant == kBase ? 0 : (tma ? kNTR : kC);
  const int* seg = a.seg + (size_t)i * kGPI;

  if (tid == 0) {
    for (int s = 0; s <= kRing; ++s) mbar_init(saddr(bar + s));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) bulk_copy(face, a.face + (size_t)i * kFaceFloats, kFaceBytes, saddr(bar + kRing));

  // cp.async: this thread's two 16-B pieces of a chunk, strips g and g + 8
  const int g0 = tid >> 6, off = (tid & 63) * 4;
  const float* src0 = nullptr;
  const float* src1 = nullptr;
  if (chunks && !tma) {
    src0 = a.px + (size_t)seg[g0] * kC * kT2 + off;
    src1 = a.px + (size_t)seg[g0 + 8] * kC * kT2 + off;
  }
  auto issue = [&](int c) {
    float* slot = ring + (c % kRing) * kSlotFloats;
    if (tma) {
      if (tid == 0)
        bulk_copy(slot, a.px + ((size_t)seg[0] + c) * kC * kT2, kRowBytes,
                  saddr(bar + c % kRing));
      return;
    }
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(saddr(slot + g0 * kStride + off)),
                 "l"(src0 + c * kT2) : "memory");
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 ::"r"(saddr(slot + (g0 + 8) * kStride + off)), "l"(src1 + c * kT2) : "memory");
  };
  if (tma) {
    for (int c = 0; c < kRing && c < chunks; ++c) issue(c);
  } else {
    for (int c = 0; c < kRing - 1; ++c) {
      if (c < chunks) issue(c);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
  }

  // acc = face[i, 0, l] * 1e-6 (C fragments: pixels t0 / t1, lanes 8 nt + 2 q + b)
  mbar_wait(saddr(bar + kRing), 0);
  float acc[16][4];
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float v = __fmul_rn(face[8 * nt + 2 * q + b], 1e-6f);
      acc[nt][b] = v;
      acc[nt][2 + b] = v;
    }
  }

  uint32_t ck = 0;
  for (int c = 0; c < chunks; ++c) {
    const float* slot = ring + (c % kRing) * kSlotFloats;
    if (tma) {
      mbar_wait(saddr(bar + c % kRing), (c / kRing) & 1);
      const uint4* s4 = reinterpret_cast<const uint4*>(slot);
      ck += bits_sum(s4[tid]) + bits_sum(s4[tid + kThreads]);
    } else {
      if (c + kRing - 1 < chunks) issue(c + kRing - 1);
      asm volatile("cp.async.commit_group;" ::: "memory");
      asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 1) : "memory");
      __syncthreads();
      ck += bits_sum(*reinterpret_cast<const uint4*>(slot + g0 * kStride + off)) +
            bits_sum(*reinterpret_cast<const uint4*>(slot + (g0 + 8) * kStride + off));
    }
    // the transpose: lanes 16 c to 16 c + 15 take slab[c, l % 16, t]
    if ((variant == kTr256 || variant == kDots) && c < 8) {
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        if ((nt >> 1) != c) continue;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int g = 8 * (nt & 1) + 2 * q + b;
          acc[nt][b] = __fadd_rn(acc[nt][b], __fmul_rn(slot[g * kStride + t0], 1e-6f));
          acc[nt][2 + b] = __fadd_rn(acc[nt][2 + b], __fmul_rn(slot[g * kStride + t1], 1e-6f));
        }
      }
    }
    // the products: acc[t, l] += sum_g slab[c, g, t] em[g, l]
    if (variant == kDots && c < 11) {
#if PROBE_BWD_DMA_DOT == 0
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float x0 = slot[(8 * ks + q) * kStride + t0], x1 = slot[(8 * ks + q) * kStride + t1];
        const float x2 = slot[(8 * ks + q + 4) * kStride + t0];
        const float x3 = slot[(8 * ks + q + 4) * kStride + t1];
        uint32_t big[4] = {to_tf32(x0), to_tf32(x1), to_tf32(x2), to_tf32(x3)};
        uint32_t small[4] = {to_tf32(x0 - __uint_as_float(big[0])),
                             to_tf32(x1 - __uint_as_float(big[1])),
                             to_tf32(x2 - __uint_as_float(big[2])),
                             to_tf32(x3 - __uint_as_float(big[3]))};
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          // em's B fragment: (g = 8 ks + q, lane 8 nt + gl) and (g + 4, ...)
          const uint32_t b0 = nt == 8 * ks + q ? 0x3f800000u : 0u;
          const uint32_t b1 = nt == 8 * ks + q + 4 ? 0x3f800000u : 0u;
          mma_tf32(acc[nt], small, b0, b1);
          mma_tf32(acc[nt], big, b0, b1);
        }
      }
#elif PROBE_BWD_DMA_DOT == 1
      float x[2][kGPI];
#pragma unroll
      for (int g = 0; g < kGPI; ++g) {
        x[0][g] = slot[g * kStride + t0];
        x[1][g] = slot[g * kStride + t1];
      }
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = acc[nt][e];
#pragma unroll
          for (int g = 0; g < kGPI; ++g) v = fmaf(x[e >> 1][g], nt == g ? 1.0f : 0.0f, v);
          acc[nt][e] = v;
        }
      }
#else
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const float v0 = slot[nt * kStride + t0], v1 = slot[nt * kStride + t1];
        acc[nt][0] += v0;
        acc[nt][1] += v0;
        acc[nt][2] += v1;
        acc[nt][3] += v1;
      }
#endif
    }
    __syncthreads();
    if (tma && tid == 0 && c + kRing < chunks) {
      // the slot's reads (generic proxy) before the copy into it (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(c + kRing);
    }
  }

  // s[l] = sum over the 256 pixels: a thread's two, the warp's 16, the warps in order
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      float v = acc[nt][b] + acc[nt][2 + b];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gl == 0) red[warp * kFB + 8 * nt + 2 * q + b] = v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ck += __shfl_xor_sync(0xffffffffu, ck, o);
  if (lane == 0) ck_w[warp] = ck;
  __syncthreads();
  if (tid < kFB) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += red[w * kFB + tid];
    sums[tid] = v;
  }
  if (tid == 0) {
    uint32_t v = 0;
    for (int w = 0; w < kWarps; ++w) v += ck_w[w];
    a.stage_sum[i] = (int)v;
  }
  __syncthreads();
  float4* out = reinterpret_cast<float4*>(a.gout + (size_t)i * kOutRows * kFB);
  const float4* s4 = reinterpret_cast<const float4*>(sums);
  for (int k = tid; k < kOutRows * kFB / 4; k += kThreads) out[k] = s4[k % (kFB / 4)];
}

}  // namespace probes

extern "C" int probe_bwd_dma(const probes::BwdDmaArgs* args, void* stream) {
  using namespace probes;
  const BwdDmaArgs& a = *args;
  if (a.N < 1 || a.variant < kBase || a.variant > kDots ||
      (a.variant != kBase && a.px_rows < kNTR))
    return (int)cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        probe_bwd_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  probe_bwd_dma_kernel<<<a.N, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes and blocks an SM: out[0..2].
extern "C" int probe_bwd_dma_occupancy(int* out) {
  using namespace probes;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, probe_bwd_dma_kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(probe_bwd_dma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_bwd_dma_kernel, kThreads,
                                                        kSmem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return (int)err;
}

extern "C" int probe_bwd_dma_dot() { return PROBE_BWD_DMA_DOT; }

extern "C" int probe_bwd_dma_smem() { return (int)probes::kSmem; }

extern "C" int probe_bwd_dma_args_size() { return (int)sizeof(probes::BwdDmaArgs); }
