// SoftRas backward over work items (a screen tile of any shape and a run
// of its face list): the kernel of the f_px route (softras_fpx_bwd.cu, K4)
// and of the px_f route (softras_pxf_bwd.cu, K6).  The TPU kernels write
// one gradient slot per (work item, face) summed over the tile's pixels,
// and XLA segment-sums the slots per face (pallas_impl.py:670-678 and
// :1713-1724); here the slots are the entry rows of the lists and the
// face sum is the segment sum (segment_sum.cu), which adds each face's
// rows in ascending entry (tile) order.
//
// Design.  One block of 8 warps per work item.  The block stages its
// faces' rows in shared memory and gives each staged face to one warp,
// which walks the pixels of the face's inflated bbox inside the tile, 32
// at a time, as the binned and pxg backward kernels do; a lane reads its
// pixel's maps (image 4, aggregates 2, incoming gradient 4, threshold 1)
// from device memory, where the tile's other faces find them in L1.
// softras_grad.cuh's add_pair gives the pair's terms; lanes add their
// pixels in order, a butterfly adds the lanes, and the warp writes the
// entry's row of GC values.  With a threshold a pair sends gradient when
// zp <= thr (the top-K truncation); without one, every candidate does
// (the reference's naive backward, pallas_impl.py:12-16).  The maps are
// band-local (ty0): pixel centres use the global row.  No atomics and
// every sum in a fixed order: two runs give the same bits.
#pragma once

#include <cuda_runtime.h>

#include "softras_grad.cuh"

namespace softras {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

struct TileBwdArgs {
  const float* rows;      // [B, F, row]
  const int* entries;     // [E] face ids of every tile's list, tile after tile
  const int* items;       // [W, 3] (global tile b * NT + t, first entry, end entry)
  const float* image;     // [B, 4, Hb, is] the forward's output, band-local
  const float* aggrs;     // [B, 2, Hb, is]
  const float* grad;      // [B, 4, Hb, is] incoming gradient
  const float* thr;       // [B, Hb, is], or null: no truncation
  float* grows;           // [E, GC] one gradient row per entry
  int W, F, row, image_size, tile_h, tile_w, tiles_x, tiles_y, ty0, band_h, chunk, GC;
  int dist_func, rgb_func, alpha_func;
  Scalars s;
};

template <int DIST>
__global__ void __launch_bounds__(kBwdThreads)
    softras_tile_bwd_kernel(const TileBwdArgs a) {
  extern __shared__ float smem[];
  const GradCfg cfg{a.s, a.F, a.rgb_func, a.alpha_func, a.thr != nullptr};
  const int T3 = a.GC - 9;
  float* srow = smem;                                          // [chunk, row]
  int* sid = reinterpret_cast<int*>(smem + a.chunk * a.row);   // [chunk]
  float* swtex = smem + a.chunk * (a.row + 1);                 // [kBwdWarps, T3]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int item = blockIdx.x;
  const int tile_g = a.items[3 * item];
  const int first = a.items[3 * item + 1];
  const int total = a.items[3 * item + 2] - first;
  const int NT = a.tiles_x * a.tiles_y;
  const int b = tile_g / NT, tile = tile_g - b * NT;
  const int tile_y = tile / a.tiles_x, tile_x = tile - tile_y * a.tiles_x;
  const int is = a.image_size;
  const float isf = (float)is;
  const float* rows_b = a.rows + (size_t)b * a.F * a.row;
  const size_t HW = (size_t)a.band_h * is;
  const int row0 = a.ty0 * a.tile_h;   // global row of the maps' first row

  float* wtex = swtex + warp * T3;
  if (a.s.texture_type == 0)
    for (int i = lane; i < T3; i += 32) wtex[i] = 0.0f;

  const int tc0 = tile_x * a.tile_w, tr0 = tile_y * a.tile_h;
  const int tc1 = min(tc0 + a.tile_w - 1, is - 1), tr1 = min(tr0 + a.tile_h - 1, is - 1);

  for (int base = 0; base < total; base += a.chunk) {
    const int n = min(a.chunk, total - base);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < n; i += kBwdThreads) sid[i] = a.entries[first + base + i];
    __syncthreads();
    for (int i = tid; i < n * a.row; i += kBwdThreads) {
      const int j = i / a.row;
      srow[i] = rows_b[(size_t)sid[j] * a.row + (i - j * a.row)];
    }
    __syncthreads();

    for (int j = warp; j < n; j += kBwdWarps) {
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
          const size_t px = (size_t)(rowp - row0) * is + col;
          PixelIn pin;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            pin.o[c] = __ldg(a.image + ((size_t)b * 4 + c) * HW + px);
            pin.g[c] = __ldg(a.grad + ((size_t)b * 4 + c) * HW + px);
          }
          pin.ag0 = __ldg(a.aggrs + (size_t)b * 2 * HW + px);
          pin.ag1 = __ldg(a.aggrs + ((size_t)b * 2 + 1) * HW + px);
          pin.thr = a.thr != nullptr ? __ldg(a.thr + (size_t)b * HW + px) : 0.0f;
          const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
          const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
          add_pair<DIST>(r, fid, active, xp, yp, pin, cfg, lane, acc, tacc, wtex);
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
cudaError_t tile_bwd_launch(const TileBwdArgs& a, cudaStream_t stream) {
  const int T3 = a.s.texture_type == 0 ? a.GC - 9 : 0;
  const size_t smem = ((size_t)a.chunk * (a.row + 1) + (size_t)kBwdWarps * T3) * sizeof(float);
  softras_tile_bwd_kernel<DIST><<<a.W, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

inline cudaError_t tile_bwd_dispatch(const TileBwdArgs& a, cudaStream_t stream) {
  switch (a.dist_func) {
    case kDistHard: return tile_bwd_launch<kDistHard>(a, stream);
    case kDistBary: return tile_bwd_launch<kDistBary>(a, stream);
    default: return tile_bwd_launch<kDistEuclid>(a, stream);
  }
}

}  // namespace softras
