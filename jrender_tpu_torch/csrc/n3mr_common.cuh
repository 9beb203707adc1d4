// Shared device helpers of the N3MR kernels (n3mr_maps.cu, n3mr_texbwd.cu,
// n3mr_edgebwd.cu).
//
// Arithmetic that feeds a comparison is written with round-to-nearest
// intrinsics (__fmul_rn, __fadd_rn, __fdiv_rn ...), one per operation of the
// plain PyTorch version (jrender_tpu_torch/ops/n3mr/torch_impl.py) and in its
// order: nvcc never contracts them into FMAs, so kernel and plain version take
// the same side of the inside test, of a depth comparison and of a floor.
#pragma once

#include <cuda_runtime.h>

namespace n3mr {

// per-face row of the z-buffer: face 9, pixel-space inverse 9, front 1
constexpr int kRow = 19;
constexpr int kInv = 9;
constexpr int kFront = 18;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// clamp that lets NaN through, as torch.clamp does
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Texture-volume coordinate of one axis (torch_impl.sampling_tif):
// clip(weight * (ts - 1) * (depth / zcorn), 0, ts - 1 - eps).
__device__ __forceinline__ float sampling_tif(float weight, float depth, float z,
                                              int ts, float eps) {
  const float t = __fmul_rn(__fmul_rn(weight, (float)(ts - 1)), __fdiv_rn(depth, z));
  return clamp_nan(t, 0.0f, __fsub_rn((float)(ts - 1), eps));
}

// Tent weight of texel i (torch_impl.tent_weights): max(0, 1 - |tif - i|).
__device__ __forceinline__ float tent(float tif, int i) {
  return fmaxf(1.0f - fabsf(tif - (float)i), 0.0f);
}

}  // namespace n3mr
