// SoftRas backward over work items (a screen tile of any shape and a run
// of its face list): the kernel of the f_px route (softras_fpx_bwd.cu, K4)
// and of the px_f route (softras_pxf_bwd.cu, K6).  The TPU kernels write
// one gradient slot per (work item, face) summed over the tile's pixels,
// and XLA segment-sums the slots per face (pallas_impl.py:670-678 and
// :1713-1724); here the slots are the entry rows of the lists and the
// face sum is the segment sum (segment_sum.cu), which adds each face's
// rows in ascending entry (tile) order.
//
// What a row is.  One warp computes each entry's row: it walks the pixels
// of the face's inflated bbox inside the tile, 32 at a time, lane k on the
// k-th pixel of each 32 in row-major order; softras_grad.cuh's pair_grad
// gives a pair's terms; each lane adds its pixels in order, a butterfly
// adds the lanes, and surface texels are added to the warp's 3T sums in
// shared memory in ascending lane order.  So a row does not depend on the
// block, the warp, the work item or any of the choices below, and every
// build gives the same bits (no atomics on values, every sum in a fixed
// order; two runs give the same bits).  With a threshold a pair sends
// gradient when zp <= thr (the top-K truncation); without one, every
// candidate does (the reference's naive backward, pallas_impl.py:12-16).
// The maps are band-local (ty0): pixel centres use the global row.
//
// Design.  One block of 8 warps per work item (a tile and at most a route's
// group of faces of its list, 32 on both routes; tiled.tile_work): items
// of 32 faces spread a frame's work over the SMs more evenly than the TPU
// kernel's 128 (px_f).  The warps wait on each pair's chain of divisions
// and an exponential and, with surface texels, on shared-memory adds, so
// the register cap that lets 3 blocks share an SM (80 registers, some
// spill) and the texel adds in rounds gain the most.  A lane reads its
// pixel's maps from device memory at every pair, where the tile's other
// faces find them in L1 (staging the tile's maps in shared memory measured
// slower on both routes, PERF.md).  Compile-time choices (each source sets
// them, PERF.md has the readings; tools/time_tile_bwd.py times the others):
//
//  SOFTRAS_TILE_BWD_MIN_BLOCKS  blocks an SM is to hold, the register cap
//      of __launch_bounds__ (0: no cap);
//  SOFTRAS_TILE_BWD_ROWS  1: each warp takes the item's next face from a
//      counter in shared memory when it is done with one (the faces of an
//      item spread over the warps by their work, not by their place), and
//      stages that face's row with cp.async into a buffer of its own while
//      it walks the previous one, double-buffered, so only warp barriers
//      order the buffers; 0: the block stages chunks of rows behind three
//      block barriers a chunk and warp w walks faces w, w + 8, ...;
//  SOFTRAS_TILE_BWD_TEXEL  1: a step's texel adds go in rounds: the lanes
//      that select the same texel form a group (__match_any_sync), and round
//      r adds each group's r-th lane, so a texel still takes its lanes'
//      values in ascending lane order (the same bits) in as many rounds as
//      the largest group has lanes; 0: add_pair's loop, one lane after the
//      other.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "softras_grad.cuh"

#ifndef SOFTRAS_TILE_BWD_MIN_BLOCKS
#error "define SOFTRAS_TILE_BWD_MIN_BLOCKS before including softras_tile_bwd.cuh"
#endif
#ifndef SOFTRAS_TILE_BWD_ROWS
#error "define SOFTRAS_TILE_BWD_ROWS before including softras_tile_bwd.cuh"
#endif
#ifndef SOFTRAS_TILE_BWD_TEXEL
#error "define SOFTRAS_TILE_BWD_TEXEL before including softras_tile_bwd.cuh"
#endif

namespace softras {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdRows = SOFTRAS_TILE_BWD_ROWS;
constexpr int kBwdTexel = SOFTRAS_TILE_BWD_TEXEL;
constexpr size_t kBwdSmemDefault = 48 * 1024;

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

// Shared memory of a block, in bytes: the face rows (two buffers a warp,
// or a chunk of rows and ids), the warps' texel sums (surface texels) and
// the face counter.
__host__ __device__ inline size_t tile_bwd_smem(const TileBwdArgs& a, bool surface) {
  size_t f = kBwdRows ? (size_t)kBwdWarps * 2 * a.row : (size_t)a.chunk * (a.row + 1);
  f += surface ? (size_t)kBwdWarps * (a.GC - 9) : 0;
  return 4 * f + 16;
}

// Where a warp finds the item's tile and its maps.
struct TileView {
  int b, tc0, tc1, tr0, tr1, row0;
};

// One entry's row: the warp walks face `fid` (its row `r`, in shared
// memory) over the pixels of its bbox inside the tile and writes the row
// of entry `entry`.  wtex holds the warp's 3T texel sums (surface), zero
// on entry and on exit.
template <int DIST, bool SURFACE>
__device__ __forceinline__ void tile_bwd_entry(const TileBwdArgs& a, const GradCfg& cfg,
                                               const TileView& v, const float* r, int fid,
                                               int entry, float* wtex, int lane) {
  const int is = a.image_size;
  const float isf = (float)is;
  const size_t HW = (size_t)a.band_h * is;
  float acc[9], tacc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = tacc[c] = 0.0f;
  int c0, c1, r0, r1;
  if (pixel_range(r, a.s.sq, isf, v.tc0, v.tc1, v.tr0, v.tr1, &c0, &c1, &r0, &r1)) {
    const int w = c1 - c0 + 1;
    const int np = w * (r1 - r0 + 1);
    // pixel k of the bbox is (k / w, k % w); lane k0 + lane steps by 32
    int dr = lane / w, dc = lane - (lane / w) * w;
    const int sr = 32 / w, sc = 32 - (32 / w) * w;
    for (int k0 = 0; k0 < np; k0 += 32) {
      const bool active = k0 + lane < np;
      const int col = c0 + (active ? dc : 0);
      const int rowp = r0 + (active ? dr : 0);
      dc += sc;
      dr += sr;
      if (dc >= w) {
        dc -= w;
        ++dr;
      }
      PixelIn pin;
      const size_t px = (size_t)(rowp - v.row0) * is + col;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        pin.o[c] = __ldg(a.image + ((size_t)v.b * 4 + c) * HW + px);
        pin.g[c] = __ldg(a.grad + ((size_t)v.b * 4 + c) * HW + px);
      }
      pin.ag0 = __ldg(a.aggrs + (size_t)v.b * 2 * HW + px);
      pin.ag1 = __ldg(a.aggrs + ((size_t)v.b * 2 + 1) * HW + px);
      pin.thr = a.thr != nullptr ? __ldg(a.thr + (size_t)v.b * HW + px) : 0.0f;
      const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
      const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
      if (kBwdTexel)
        add_pair_rounds<DIST, SURFACE>(r, fid, active, xp, yp, pin, cfg, lane, acc, tacc, wtex);
      else
        add_pair<DIST>(r, fid, active, xp, yp, pin, cfg, lane, acc, tacc, wtex);
    }
  }
  // the warp's sums into the entry's row
  float* out = a.grows + (size_t)entry * a.GC;
  float mine = 0.0f, mine_t = 0.0f;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const float s = warp_sum(acc[c]);
    if (lane == c) mine = s;
  }
  if (lane < 9) out[lane] = mine;
  if (!SURFACE) {
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const float s = warp_sum(tacc[c]);
      if (lane == c) mine_t = s;
    }
    if (lane < 9) out[9 + lane] = mine_t;
  } else {
    __syncwarp();
    for (int i = lane; i < a.GC - 9; i += 32) {
      out[9 + i] = wtex[i];
      wtex[i] = 0.0f;
    }
    __syncwarp();
  }
}

// Face j's row into dst with cp.async by the warp's lanes (not committed).
__device__ __forceinline__ void tile_bwd_stage_row(const float* rows_b, int row, int fid,
                                                   float* dst, int lane) {
  const float* src = rows_b + (size_t)fid * row;
  for (int k = lane; k < row; k += 32) __pipeline_memcpy_async(dst + k, src + k, 4);
}

#if SOFTRAS_TILE_BWD_MIN_BLOCKS > 0
#define SOFTRAS_TILE_BWD_BOUNDS __launch_bounds__(kBwdThreads, SOFTRAS_TILE_BWD_MIN_BLOCKS)
#else
#define SOFTRAS_TILE_BWD_BOUNDS __launch_bounds__(kBwdThreads)
#endif

template <int DIST, bool SURFACE>
__global__ void SOFTRAS_TILE_BWD_BOUNDS softras_tile_bwd_kernel(const TileBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const GradCfg cfg{a.s, a.F, a.rgb_func, a.alpha_func, a.thr != nullptr};
  const int T3 = SURFACE ? a.GC - 9 : 0;
  const int row = a.row;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int item = blockIdx.x;
  const int tile_g = a.items[3 * item];
  const int first = a.items[3 * item + 1];
  const int n = a.items[3 * item + 2] - first;
  const int NT = a.tiles_x * a.tiles_y;
  TileView v;
  v.b = tile_g / NT;
  const int tile = tile_g - v.b * NT;
  const int tile_y = tile / a.tiles_x, tile_x = tile - tile_y * a.tiles_x;
  const int is = a.image_size;
  v.tc0 = tile_x * a.tile_w;
  v.tr0 = tile_y * a.tile_h;
  v.tc1 = min(v.tc0 + a.tile_w - 1, is - 1);
  v.tr1 = min(v.tr0 + a.tile_h - 1, is - 1);
  v.row0 = a.ty0 * a.tile_h;   // global row of the maps' first row
  const float* rows_b = a.rows + (size_t)v.b * a.F * row;

  if (kBwdRows) {
    float* wrow = smem + (size_t)warp * 2 * row;                 // [2, row] this warp's
    float* wtex = smem + (size_t)kBwdWarps * 2 * row + warp * T3;
    int* snext = reinterpret_cast<int*>(smem + (size_t)kBwdWarps * (2 * row + T3));
    if (tid == 0) *snext = kBwdWarps;
    if (SURFACE)
      for (int i = lane; i < T3; i += 32) wtex[i] = 0.0f;
    // warp w's first face is face w of the item
    int j = warp;
    int fid = j < n ? a.entries[first + j] : 0;
    if (j < n) tile_bwd_stage_row(rows_b, row, fid, wrow, lane);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();   // the first rows and the counter are in
    for (int k = 0; j < n; ++k) {
      const int cur = k & 1;
      int jn = 0;
      if (lane == 0) jn = atomicAdd(snext, 1);
      jn = __shfl_sync(0xffffffffu, jn, 0);
      const int fid_n = jn < n ? a.entries[first + jn] : 0;
      if (jn < n) tile_bwd_stage_row(rows_b, row, fid_n, wrow + (cur ^ 1) * row, lane);
      __pipeline_commit();
      __pipeline_wait_prior(1);
      __syncwarp();   // face j's row is in
      tile_bwd_entry<DIST, SURFACE>(a, cfg, v, wrow + cur * row, fid, first + j, wtex, lane);
      __syncwarp();   // done with buffer `cur`, which face jn's successor takes
      j = jn;
      fid = fid_n;
    }
    __pipeline_wait_prior(0);
  } else {
    // chunks of rows staged by the block behind block barriers, warp w
    // walks faces w, w + 8, ... of a chunk
    float* srow = smem;                                               // [chunk, row]
    int* sid = reinterpret_cast<int*>(smem + (size_t)a.chunk * row);  // [chunk]
    float* wtex = smem + (size_t)a.chunk * (row + 1) + warp * T3;
    if (SURFACE)
      for (int i = lane; i < T3; i += 32) wtex[i] = 0.0f;
    for (int base = 0; base < n; base += a.chunk) {
      const int m = min(a.chunk, n - base);
      __syncthreads();  // the previous chunk has been consumed
      for (int i = tid; i < m; i += kBwdThreads) sid[i] = a.entries[first + base + i];
      __syncthreads();
      for (int i = tid; i < m * row; i += kBwdThreads) {
        const int jj = i / row;
        srow[i] = rows_b[(size_t)sid[jj] * row + (i - jj * row)];
      }
      __syncthreads();
      for (int jj = warp; jj < m; jj += kBwdWarps)
        tile_bwd_entry<DIST, SURFACE>(a, cfg, v, srow + jj * row, sid[jj], first + base + jj,
                                      wtex, lane);
    }
  }
}

// static: its `ready` must be this library's own, not one shared with a
// variant build (a static local of a function with external linkage is one
// symbol across every library loaded).
template <int DIST, bool SURFACE>
static int tile_bwd_launch(const TileBwdArgs& a, cudaStream_t stream) {
  const auto kernel = softras_tile_bwd_kernel<DIST, SURFACE>;
  const size_t smem = tile_bwd_smem(a, SURFACE);
  if (a.tile_h % 8 || a.tile_w % 8 || a.row < 1 || a.GC < 9 ||
      (!kBwdRows && (a.chunk < 1 || a.chunk > 1024)))
    return (int)cudaErrorInvalidValue;
  static size_t ready = 0;
  if (ready < smem) {
    cudaError_t err = cudaSuccess;
    if (smem > kBwdSmemDefault)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = smem;
  }
  kernel<<<a.W, kBwdThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers, local (spill) bytes and blocks an SM of the kernel that these
// arguments launch: out[0..2].
template <int DIST, bool SURFACE>
static int tile_bwd_occupancy(const TileBwdArgs& a, int* out) {
  const auto kernel = softras_tile_bwd_kernel<DIST, SURFACE>;
  const size_t smem = tile_bwd_smem(a, SURFACE);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess && smem > kBwdSmemDefault)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBwdThreads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return (int)err;
}

template <int DIST>
static int tile_bwd_by_texture(const TileBwdArgs& a, cudaStream_t stream, int* occupancy) {
  if (a.s.texture_type == 0)
    return occupancy ? tile_bwd_occupancy<DIST, true>(a, occupancy)
                     : tile_bwd_launch<DIST, true>(a, stream);
  return occupancy ? tile_bwd_occupancy<DIST, false>(a, occupancy)
                   : tile_bwd_launch<DIST, false>(a, stream);
}

// Launch the kernel for these arguments, or (occupancy != null) report
// its registers, spill bytes and blocks an SM instead.
static int tile_bwd_dispatch(const TileBwdArgs& a, cudaStream_t stream, int* occupancy) {
  switch (a.dist_func) {
    case kDistHard: return tile_bwd_by_texture<kDistHard>(a, stream, occupancy);
    case kDistBary: return tile_bwd_by_texture<kDistBary>(a, stream, occupancy);
    default: return tile_bwd_by_texture<kDistEuclid>(a, stream, occupancy);
  }
}

}  // namespace softras
