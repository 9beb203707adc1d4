// SoftRas backward over grouped work items (the pxg route) for Hopper
// (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pxg_impl.py
// _make_bwd_kernel_pxg (:758, launched at :989 by soft_rasterize_bwd_pxg).
// With the segment sum by face id that follows it there (:998-1011, here
// csrc/segment_sum.cu) it computes the reference's top-K truncated
// backward (soft_rasterize.py:523-1358): for every candidate pair with
// zp <= thr (:803-804), the gradient of the pixel with respect to the
// face's 9 coordinates and its texture values, summed over the pixels per
// face.  The pair terms are softras_grad.cuh's (pxg_impl.py:801-932:
// surface texels enter as their value, vertex colours without perspective
// correction, :844-850).  The TPU's 11-channel per-group pixel gather
// (:963-969) is a lane-layout device and has no counterpart: a block
// reads its tile's maps itself.
//
// Design.  One block of 8 warps per work item, as the forward cuts the
// lists.  It stages its tile's pixel maps (image 4, aggrs 2, incoming
// gradient 4, threshold 1) and its faces' rows in shared memory and gives
// each staged face to one warp, which walks the pixels of the face's
// inflated bbox inside the tile, 32 at a time, as the binned backward does
// (softras_bwd.cu); lanes add their pixels in order, a butterfly adds the
// lanes.  It writes one gradient row per entry of the item, grows [E, GC],
// which the segment sum adds per face in ascending entry (tile) order.
// Big faces are entries like the others, one per tile of their range: no
// block walks a whole screen-filling face.  No atomics, every sum in a
// fixed order: two runs give the same bits.  Scratch: E rows of GC floats
// (at 1024 px on the 39,474-face sphere about 150,000 entries of 84
// floats).
//
// Bound.  Operations: the forward's pair math for every pair in a bbox
// plus the gradient terms of the pairs within the threshold.  Bytes of
// the function this kernel and the face sum compute together: the face
// rows, the lists, the 11 maps of the pixels with a candidate, one
// gradient row per face out.  The entry rows between them are this
// two-pass design's cost and count only in the sum's own bound, as its
// input.
#include <cuda_runtime.h>

#include "softras_grad.cuh"

namespace softras {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 11;  // per-pixel inputs: out 4, aggrs 2, grad 4, thr 1

struct PxgBwdArgs {
  const float* rows;      // [B, F, row]
  const int* entries;     // [E] face ids, tile after tile
  const int* items;       // [W, 3] (global tile, first entry, end entry)
  const float* image;     // [B, 4, H, W] the forward's output
  const float* aggrs;     // [B, 2, H, W]
  const float* grad;      // [B, 4, H, W] incoming gradient
  const float* thr;       // [B, H, W], or null: no truncation
  float* grows;           // [E, GC] one gradient row per entry
  int W, F, row, image_size, tiles_x, chunk, GC;
  int dist_func, rgb_func, alpha_func;
  Scalars s;
};

template <int DIST>
__global__ void __launch_bounds__(kThreads)
    softras_pxg_bwd_kernel(const PxgBwdArgs a) {
  extern __shared__ float smem[];
  const GradCfg cfg{a.s, a.F, a.rgb_func, a.alpha_func, a.thr != nullptr};
  const int T3 = a.GC - 9;
  float* srow = smem;                                          // [chunk, row]
  int* sid = reinterpret_cast<int*>(smem + a.chunk * a.row);   // [chunk]
  float* spx = smem + a.chunk * (a.row + 1);                   // [kPix, 256]
  float* swtex = spx + kPix * kThreads;                        // [kWarps, T3]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int item = blockIdx.x;
  const int tile_g = a.items[3 * item];
  const int first = a.items[3 * item + 1];
  const int total = a.items[3 * item + 2] - first;
  const int NT = a.tiles_x * a.tiles_x;
  const int b = tile_g / NT, tile = tile_g - b * NT;
  const int tile_y = tile / a.tiles_x, tile_x = tile - tile_y * a.tiles_x;
  const int is = a.image_size;
  const float isf = (float)is;
  const float* rows_b = a.rows + (size_t)b * a.F * a.row;
  const size_t HW = (size_t)is * is;

  // the tile's pixel maps, pixel (ly, lx) at ly * 16 + lx
  {
    const int col = tile_x * kTile + tid % kTile;
    const int rowp = tile_y * kTile + tid / kTile;
    const bool live = col < is && rowp < is;
    const size_t px = (size_t)rowp * is + col;
    for (int c = 0; c < 4; ++c) {
      spx[c * kThreads + tid] = live ? a.image[((size_t)b * 4 + c) * HW + px] : 0.0f;
      spx[(6 + c) * kThreads + tid] = live ? a.grad[((size_t)b * 4 + c) * HW + px] : 0.0f;
    }
    for (int c = 0; c < 2; ++c)
      spx[(4 + c) * kThreads + tid] = live ? a.aggrs[((size_t)b * 2 + c) * HW + px] : 0.0f;
    spx[10 * kThreads + tid] = (live && a.thr != nullptr) ? a.thr[(size_t)b * HW + px] : 0.0f;
  }
  float* wtex = swtex + warp * T3;
  if (a.s.texture_type == 0)
    for (int i = lane; i < T3; i += 32) wtex[i] = 0.0f;

  const int tc0 = tile_x * kTile, tr0 = tile_y * kTile;
  const int tc1 = min(tc0 + kTile - 1, is - 1), tr1 = min(tr0 + kTile - 1, is - 1);

  for (int base = 0; base < total; base += a.chunk) {
    const int n = min(a.chunk, total - base);
    __syncthreads();  // the previous chunk has been consumed
    if (tid < n) sid[tid] = a.entries[first + base + tid];
    __syncthreads();
    for (int i = tid; i < n * a.row; i += kThreads) {
      const int j = i / a.row;
      srow[i] = rows_b[(size_t)sid[j] * a.row + (i - j * a.row)];
    }
    __syncthreads();

    for (int j = warp; j < n; j += kWarps) {
      const float* r = srow + j * a.row;
      const int fid = sid[j];
      float acc[9], tacc[9];
#pragma unroll
      for (int c = 0; c < 9; ++c) acc[c] = tacc[c] = 0.0f;
      int c0, c1, r0, r1;
      if (pixel_range(r, a.s.sq, isf, tc0, tc1, tr0, tr1, &c0, &c1, &r0, &r1)) {
        const int w = c1 - c0 + 1;
        const int np = w * (r1 - r0 + 1);
        for (int k0 = 0; k0 < np; k0 += 32) {
          const int k = k0 + lane;
          const bool active = k < np;
          const int col = c0 + (active ? k % w : 0);
          const int rowp = r0 + (active ? k / w : 0);
          const int lp = (rowp - tr0) * kTile + (col - tc0);
          PixelIn px;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            px.o[c] = spx[c * kThreads + lp];
            px.g[c] = spx[(6 + c) * kThreads + lp];
          }
          px.ag0 = spx[4 * kThreads + lp];
          px.ag1 = spx[5 * kThreads + lp];
          px.thr = spx[10 * kThreads + lp];
          const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
          const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
          add_pair<DIST>(r, fid, active, xp, yp, px, cfg, lane, acc, tacc, wtex);
        }
      }
      // the warp's sums into the entry's row
      float* out = a.grows + (size_t)(first + base + j) * a.GC;
      float mine = 0.0f, mine_t = 0.0f;
#pragma unroll
      for (int c = 0; c < 9; ++c) {
        const float v = warp_sum(acc[c]);
        if (lane == c) mine = v;
      }
      if (lane < 9) out[lane] = mine;
      if (a.s.texture_type != 0) {
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          const float v = warp_sum(tacc[c]);
          if (lane == c) mine_t = v;
        }
        if (lane < 9) out[9 + lane] = mine_t;
      } else {
        __syncwarp();
        for (int i = lane; i < T3; i += 32) {
          out[9 + i] = wtex[i];
          wtex[i] = 0.0f;
        }
        __syncwarp();
      }
    }
  }
}

template <int DIST>
cudaError_t launch(const PxgBwdArgs& a, cudaStream_t stream) {
  const int T3 = a.s.texture_type == 0 ? a.GC - 9 : 0;
  const size_t smem = ((size_t)a.chunk * (a.row + 1) + kPix * kThreads +
                       (size_t)kWarps * T3) * sizeof(float);
  softras_pxg_bwd_kernel<DIST><<<a.W, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace softras

extern "C" int softras_pxg_bwd(const softras::PxgBwdArgs* args, void* stream) {
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

extern "C" int softras_pxg_bwd_args_size() { return (int)sizeof(softras::PxgBwdArgs); }
