// SoftRas backward of the dir route for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/dir_impl.py
// _make_bwd_kernel_dir (:480, launched at :720 by soft_rasterize_bwd_dir)
// and the un-permutation after it (:729-734).  It computes the reference's
// top-K truncated backward (soft_rasterize.py:523-1358): for every
// candidate pair with zp <= the pixel's threshold (every tied face kept),
// the gradient of the pixel with respect to the face's 9 coordinates and
// its texture values, summed over the pixels per face, in the faces'
// original order.  The per-pair terms are K2's (softras_grad.cuh); the
// hard-rgb winner is matched on the original id, as dir_impl.py:596-599.
//
// Design.  The TPU kernel adds every tile's contribution into one
// gradient block that stays resident across a sequential grid.  Blocks on
// Hopper run in no order, so the sum is face-major and takes two kernels,
// with every sum in a fixed order and no atomics: two runs give the same
// bits.
//
//  softras_dir_bwd_kernel: one warp per (face, split, batch element),
//    eight to a block, each warp on its own (no block barrier).  The
//    face's pixel bbox (its inflated bbox, clipped to the screen) is read
//    row-major in chunks of 32 pixels, one per lane, and split j takes
//    chunks j, j + splits, ...  The wrapper sets splits from the image's
//    area (1 up to 128 px, 64 from 1024 px), so a face that fills the
//    screen is spread over as many warps and a small face over as many as
//    it has chunks; a split past the face's last chunk, and a NaN face,
//    which the forward culls, return after reading the face's bbox.  The
//    lanes read the 11 pixel maps (image 4, aggregates 2, incoming gradient
//    4, threshold 1) straight from device memory, neighbouring lanes on
//    neighbouring pixels.  The warp sums its lanes' terms with a butterfly
//    (surface texels through the warp's sums in shared memory, which the
//    lanes add to in lane order) into one partial row [B, F, splits, GC].
//    Why a warp and interleaved chunks: a face of a few pixels (demo 2's
//    64-px views) would leave most warps of a block idle, and whole row
//    bands would leave a mid-size face (the 288-face sphere at 1024 px) to
//    a few warps (PERF.md, PR 4).
//  softras_dir_bwd_sum_kernel: one warp per face adds its splits' partial
//    rows in ascending order and writes the face's original row of
//    grad_face [B, F, 9] and grad_tex [B, F, GC - 9]: no un-permute pass.
//
// Bound.  Operations: the pair math of every pair in a face's bbox up to
// the depth, and some 120 more for a pair within the threshold.  Bytes:
// the face rows, 11 floats per pixel, one gradient row per face out; the
// partial rows between the two kernels are this design's cost on top of
// that.  chip_smoke.py counts both from its run.
#include <cuda_runtime.h>

#include "softras_grad.cuh"

namespace softras {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct DirBwdArgs {
  const float* rows;         // [B, F, row] face rows, Morton order
  const float* bbox;         // [B, F, 4] xmin, xmax, ymin, ymax (inflated)
  const int* ids;            // [B, F] original id of each face
  const float* image;        // [B, 4, H, W] the forward's output
  const float* aggrs;        // [B, 2, H, W]
  const float* grad;         // [B, 4, H, W] incoming gradient
  const float* thr;          // [B, H, W], or null: no truncation
  float* part;               // [B, F, splits, GC]
  float* grad_face;          // [B, F, 9], original order
  float* grad_tex;           // [B, F, GC - 9], original order
  int B, F, row, image_size, splits, GC;
  int dist_func, rgb_func, alpha_func;
  Scalars s;
};

// The face's pixel bbox on the screen, from its inflated bbox row (the
// rounding of pixel_range in softras_grad.cuh), or false: no pixel, or a
// NaN face.  Both kernels call it, so they agree on every face's chunks.
__device__ __forceinline__ bool face_pixels(const DirBwdArgs& a, size_t f, int* c0,
                                            int* c1, int* r0, int* r1) {
  const float4 q = reinterpret_cast<const float4*>(a.bbox)[f];
  if (!(q.x <= q.y && q.z <= q.w)) return false;
  const float isf = (float)a.image_size;
  *c0 = (int)fminf(fmaxf(floorf((q.x * isf + isf - 1.0f) * 0.5f), 0.0f), isf);
  *c1 = (int)fmaxf(fminf(ceilf((q.y * isf + isf - 1.0f) * 0.5f), isf - 1.0f), -1.0f);
  *r0 = (int)fminf(fmaxf(floorf((isf - 1.0f - q.w * isf) * 0.5f), 0.0f), isf);
  *r1 = (int)fmaxf(fminf(ceilf((isf - 1.0f - q.z * isf) * 0.5f), isf - 1.0f), -1.0f);
  return *c0 <= *c1 && *r0 <= *r1;
}

// Chunks of 32 pixels in the face's pixel bbox.
__device__ __forceinline__ int face_chunks(int c0, int c1, int r0, int r1) {
  return ((c1 - c0 + 1) * (r1 - r0 + 1) + 31) / 32;
}

template <int DIST>
__global__ void __launch_bounds__(kThreads)
    softras_dir_bwd_kernel(const __grid_constant__ DirBwdArgs a) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long item = (long long)blockIdx.x * kWarps + warp;  // (b * F + pos) * splits + j
  if (item >= (long long)a.B * a.F * a.splits) return;
  const int split = (int)(item % a.splits);
  const size_t f = (size_t)(item / a.splits);
  const int b = (int)(f / a.F);
  int c0, c1, r0, r1;
  if (!face_pixels(a, f, &c0, &c1, &r0, &r1)) return;
  if (split >= face_chunks(c0, c1, r0, r1)) return;

  const bool surface = a.s.texture_type == 0;
  const int T3 = a.GC - 9, T3s = surface ? T3 : 0;
  float* srow = smem + warp * (a.row + T3s);  // [row] the face's row
  float* wtex = srow + a.row;                 // [T3] the warp's texel sums
  for (int i = lane; i < a.row; i += 32) srow[i] = a.rows[f * a.row + i];
  for (int i = lane; i < T3s; i += 32) wtex[i] = 0.0f;
  __syncwarp();

  const int fid = a.ids[f];
  const int is = a.image_size;
  const float isf = (float)is;
  const size_t HW = (size_t)is * is;
  const GradCfg cfg{a.s, a.F, a.rgb_func, a.alpha_func, a.thr != nullptr};
  const int w = c1 - c0 + 1;
  float acc[9], tacc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = tacc[c] = 0.0f;
  const int np = w * (r1 - r0 + 1);
  for (int k0 = 32 * split; k0 < np; k0 += 32 * a.splits) {
    const int k = k0 + lane;
    const bool active = k < np;
    const int col = c0 + (active ? k % w : 0);
    const int rowp = r0 + (active ? k / w : 0);
    const size_t p = (size_t)rowp * is + col;
    PixelIn px;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      px.o[c] = a.image[((size_t)b * 4 + c) * HW + p];
      px.g[c] = a.grad[((size_t)b * 4 + c) * HW + p];
    }
    px.ag0 = a.aggrs[((size_t)b * 2) * HW + p];
    px.ag1 = a.aggrs[((size_t)b * 2 + 1) * HW + p];
    px.thr = a.thr != nullptr ? a.thr[(size_t)b * HW + p] : 0.0f;
    const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
    const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
    add_pair<DIST>(srow, fid, active, xp, yp, px, cfg, lane, acc, tacc, wtex);
  }
  // the lanes by butterfly into the item's partial row
  float* out = a.part + (size_t)item * a.GC;
  float mine = 0.0f, mine_t = 0.0f;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const float v = warp_sum(acc[c]);
    if (lane == c) mine = v;
  }
  if (lane < 9) out[lane] = mine;
  if (!surface) {
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const float v = warp_sum(tacc[c]);
      if (lane == c) mine_t = v;
    }
    if (lane < 9) out[9 + lane] = mine_t;
  } else {
    __syncwarp();
    for (int i = lane; i < T3; i += 32) out[9 + i] = wtex[i];
  }
}

__global__ void __launch_bounds__(kThreads)
    softras_dir_bwd_sum_kernel(const __grid_constant__ DirBwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long gw = (long long)blockIdx.x * kWarps + warp;  // b * F + place
  if (gw >= (long long)a.B * a.F) return;
  const size_t f = (size_t)gw;
  const int b = (int)(gw / a.F);
  const size_t out = (size_t)b * a.F + a.ids[f];   // the face's original row
  int c0, c1, r0, r1, n = 0;
  if (face_pixels(a, f, &c0, &c1, &r0, &r1)) n = min(a.splits, face_chunks(c0, c1, r0, r1));
  const int T3 = a.GC - 9;
  for (int c = lane; c < a.GC; c += 32) {
    float v = 0.0f;
    for (int j = 0; j < n; ++j) v += a.part[(f * a.splits + j) * a.GC + c];
    if (c < 9) {
      a.grad_face[out * 9 + c] = v;
    } else {
      a.grad_tex[out * T3 + (c - 9)] = v;
    }
  }
}

template <int DIST>
cudaError_t launch(const DirBwdArgs& a, cudaStream_t stream) {
  const int T3s = a.s.texture_type == 0 ? a.GC - 9 : 0;
  const size_t smem = (size_t)kWarps * (a.row + T3s) * sizeof(float);
  const long long items = (long long)a.B * a.F * a.splits;
  softras_dir_bwd_kernel<DIST><<<(unsigned)((items + kWarps - 1) / kWarps), kThreads, smem,
                                 stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long faces = (long long)a.B * a.F;
  softras_dir_bwd_sum_kernel<<<(unsigned)((faces + kWarps - 1) / kWarps), kThreads, 0,
                               stream>>>(a);
  return cudaGetLastError();
}

}  // namespace softras

extern "C" int softras_dir_bwd(const softras::DirBwdArgs* args, void* stream) {
  using namespace softras;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (args->dist_func) {
    case kDistHard: err = launch<kDistHard>(*args, st); break;
    case kDistBary: err = launch<kDistBary>(*args, st); break;
    default: err = launch<kDistEuclid>(*args, st); break;
  }
  return (int)err;
}

extern "C" int softras_dir_bwd_args_size() { return (int)sizeof(softras::DirBwdArgs); }
