// What one grid step of a px_f-style kernel costs on Hopper (sm_90a): a
// probe, with a plain C entry point.
//
// Counterpart of the TPU probe tools/exp_micro.py ``build`` (:23, its
// pallas_call at :63): a grid of N steps, step i reading one [16, 128]
// block data[i] and doing a px_f-style step on [T2, 128] (pixel, face)
// pairs:
//
//   f   = data[i][0] after n_face chained ops f * 1.0000001 + 1e-7 * (j + 1)
//   x   = f + 1 (every pixel), + data[i][j % 16] for j < n_slice, then
//         n_pair chained FMAs x * 1.0000001 + 1e-9
//   d   = n_dot products data[i][0:4] @ x^T ([4, T2], float32 semantics)
//   acc[t] += sum_f x[t, f] + sum_t d[0, t]
//
// Design.  The TPU carries acc from step to step in scratch memory; here
// blocks run in no order, so a block per step writes its step's row
// partial[i, t] = sum_f x[t, f] + sum_t d[0, t], and a second kernel sums
// the rows in step order (out[t], no float atomics).  A block has T2
// threads; a warp covers 32 pixels in 4 groups of 8, and lane l takes
// pixel 8g + l / 4 of group g and faces 8k + l % 4 and 8k + l % 4 + 4 of
// each chunk k of 8 faces: the B fragment of mma.sync m16n8k8, so the
// dots read their operand from the registers that computed it.  The
// step's block is staged whole into shared memory by cp.async (that copy
// is part of the step's price), the n_face chain is done once per face
// into shared memory (as the TPU does it once on a [1, 128] row), and the
// n_pair chain runs on every (pixel, face) pair in registers: each group
// adds its own opaque 1.0, so the compiler cannot fold the four groups'
// equal values into one.  The dots:
//   default               mma.sync m16n8k8 TF32 on the tensor cores, A =
//                         data rows 0-3 padded to 16, with the 3xTF32
//                         split (big x big + big x small + small x big),
//                         which stays near float32 (the TPU's HIGHEST);
//                         each chunk's three products start from zero and
//                         are added to the sums in float32
//   PROBE_MICRO_DOT_FFMA  the same products by FFMA on the CUDA cores
// Each step also writes its four dot rows' sums (dots[i, k]), so no row
// of the product is dead code in either build.
//
// Bound.  Operations at the float32 rate (67 TFLOP/s): per pair 2 n_pair
// (FMAs) + n_slice + 2 (the 1 and the face sum), per face 2 n_face, per
// dot 2 * 4 * 128 * T2; bytes (the data once, partial rows and out) are
// far below.  Tensor-core products count at their float32 operations,
// since they compute a float32 product.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef PROBE_MICRO_DOT_FFMA
#define PROBE_MICRO_DOT_FFMA 0
#endif

namespace probes {

constexpr int kFB = 128;                    // faces of a step (the TPU's FB)
constexpr int kRows = 16;                   // rows of a step's block
constexpr int kMaxThreads = 1024;           // T2 at most: a thread a pixel
constexpr int kSumThreads = 256;

struct MicroArgs {
  const float* data;   // [N, 16, 128]
  float* partial;      // [N, T2] each step's row
  float* dots;         // [N, 4] each step's dot rows' sums over the pixels
  float* out;          // [T2] the rows summed in step order
  int N, T2, n_pair, n_face, n_slice, n_dot;
};

__device__ __forceinline__ float opaque(float v) {
  float r;
  asm volatile("mov.b32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// (big, small) TF32 parts of v: big + small carries about 22 bits.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  // rows 8-15 of A are zero (a1 = a3 = 0)
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// One chunk's 3xTF32 product (8 faces) from zero, added to c in float32:
// the tensor cores add into their accumulator without rounding to
// nearest, which over the 1,200 products of a step biased the sums by
// -4e-5 when they accumulated in c itself.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], uint32_t ab0, uint32_t as0,
                                           uint32_t ab2, uint32_t as2, uint32_t bb0,
                                           uint32_t bs0, uint32_t bb1, uint32_t bs1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, ab0, ab2, bs0, bs1);
  mma_tf32(t, as0, as2, bb0, bb1);
  mma_tf32(t, ab0, ab2, bb0, bb1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

__global__ void __launch_bounds__(kMaxThreads) probe_micro_kernel(const MicroArgs a) {
  __shared__ __align__(16) float blk[kRows * kFB];
  __shared__ float fsm[kFB];
  __shared__ float wsum[kMaxThreads / 32][4];
  __shared__ float dsum[4];
  const int i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, gl = lane >> 2, q = lane & 3;

  // the step's block, 16 B a copy
  const float* src = a.data + (size_t)i * kRows * kFB;
  for (int k = tid; k < kRows * kFB / 4; k += blockDim.x) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(blk + 4 * k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src + 4 * k)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  for (int k = tid; k < kFB; k += blockDim.x) {
    float f = blk[k];
    for (int j = 0; j < a.n_face; ++j) f = fmaf(f, 1.0000001f, (float)(1e-7 * (j + 1)));
    fsm[k] = f;
  }
  __syncthreads();

  float one[4], sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < 4; ++g) one[g] = opaque(1.0f);
#if PROBE_MICRO_DOT_FFMA
  float dacc[4][4] = {};   // [row][group]
#else
  float c[4][4] = {};      // [group] C fragment
#endif
  for (int k = 0; k < kFB / 8; ++k) {
    const int f0 = 8 * k + q, f1 = f0 + 4;
    float x[4][2];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      x[g][0] = fsm[f0] + one[g];
      x[g][1] = fsm[f1] + one[g];
    }
    for (int j = 0; j < a.n_slice; ++j) {
      const float r0 = blk[(j & 15) * kFB + f0], r1 = blk[(j & 15) * kFB + f1];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        x[g][0] += r0;
        x[g][1] += r1;
      }
    }
#pragma unroll 4
    for (int j = 0; j < a.n_pair; ++j) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        x[g][0] = fmaf(x[g][0], 1.0000001f, 1e-9f);
        x[g][1] = fmaf(x[g][1], 1.0000001f, 1e-9f);
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) sx[g] += x[g][0] + x[g][1];
    if (a.n_dot == 0) continue;
#if PROBE_MICRO_DOT_FFMA
    float av[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      av[r][0] = blk[r * kFB + f0];
      av[r][1] = blk[r * kFB + f1];
    }
    for (int j = 0; j < a.n_dot; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dacc[r][g] = fmaf(av[r][0], x[g][0], dacc[r][g]);
          dacc[r][g] = fmaf(av[r][1], x[g][1], dacc[r][g]);
        }
      }
    }
#else
    // A: row gl of the block (rows 4-15 are zero), columns f0 and f1
    uint32_t ab0 = 0, as0 = 0, ab2 = 0, as2 = 0;
    if (gl < 4) {
      split_tf32(blk[gl * kFB + f0], ab0, as0);
      split_tf32(blk[gl * kFB + f1], ab2, as2);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(x[g][0], bb0, bs0);
      split_tf32(x[g][1], bb1, bs1);
      for (int j = 0; j < a.n_dot; ++j) mma_3xtf32(c[g], ab0, as0, ab2, as2, bb0, bs0, bb1, bs1);
    }
#endif
  }

  // each pixel's face sum: its four lanes (q = 0..3)
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    sx[g] += __shfl_xor_sync(0xffffffffu, sx[g], 1);
    sx[g] += __shfl_xor_sync(0xffffffffu, sx[g], 2);
  }
  // the dot rows' sums over the warp's pixels, then over the warps in order
#if PROBE_MICRO_DOT_FFMA
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float v = dacc[r][0] + dacc[r][1] + dacc[r][2] + dacc[r][3];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) wsum[warp][r] = v;
  }
#else
  {
    // C: row gl, pixels 2q and 2q + 1 of each group
    float v = 0.f;
#pragma unroll
    for (int g = 0; g < 4; ++g) v += c[g][0] + c[g][1];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (q == 0 && gl < 4) wsum[warp][gl] = v;
  }
#endif
  __syncthreads();
  if (tid < 4) {
    float v = 0.f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) v += wsum[w][tid];
    dsum[tid] = v;
    a.dots[(size_t)i * 4 + tid] = v;
  }
  __syncthreads();
  if (q == 0) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      a.partial[(size_t)i * a.T2 + warp * 32 + 8 * g + gl] = sx[g] + dsum[0];
  }
}

// out[t]: the steps' rows added in step order, a thread a pixel.
__global__ void __launch_bounds__(kSumThreads) probe_micro_sum_kernel(const MicroArgs a) {
  const int t = blockIdx.x * kSumThreads + threadIdx.x;
  if (t >= a.T2) return;
  float v = 0.f;
  for (int i = 0; i < a.N; ++i) v += a.partial[(size_t)i * a.T2 + t];
  a.out[t] = v;
}

}  // namespace probes

extern "C" int probe_micro(const probes::MicroArgs* args, void* stream) {
  using namespace probes;
  const MicroArgs& a = *args;
  if (a.T2 < 32 || a.T2 > kMaxThreads || a.T2 % 32 || a.N < 1 || a.n_pair < 0 ||
      a.n_face < 0 || a.n_slice < 0 || a.n_dot < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_micro_kernel<<<a.N, a.T2, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  probe_micro_sum_kernel<<<(a.T2 + kSumThreads - 1) / kSumThreads, kSumThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes and blocks an SM of the step kernel at
// T2 threads a block: out[0..2].
extern "C" int probe_micro_occupancy(int T2, int* out) {
  using namespace probes;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, probe_micro_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, probe_micro_kernel, T2, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return (int)err;
}

extern "C" int probe_micro_dot_ffma() { return PROBE_MICRO_DOT_FFMA; }

extern "C" int probe_micro_args_size() { return (int)sizeof(probes::MicroArgs); }
