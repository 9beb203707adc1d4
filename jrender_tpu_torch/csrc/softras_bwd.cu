// SoftRas backward kernels for Hopper (sm_90a), with plain C entry points.
//
// Replace the TPU kernel jrender_tpu/ops/softras/pxt_impl.py
// _make_bwd_kernel_pxt (:856, launched at :1116 by soft_rasterize_bwd_pxt)
// and the face reduction that follows it there (:1128-1171).  They compute
// the reference's top-K truncated backward (soft_rasterize.py:523-1358),
// not the derivative of the forward: for every candidate pair (tk_valid)
// with zp <= thr, the gradient of the pixel with respect to the face's 9
// coordinates and its texture values, summed over the pixels per face.
// The per-pair terms are those of pxt_impl.py:913-1038 (pair_grad in
// softras_grad.cuh, which the dir backward shares).
//
// What bounds it.  The pair math of the pairs in a face's bbox, and the
// gradient terms of the candidates within the threshold (chip_smoke.py
// counts both from its run).  What bounded the first design, one block of
// 8 warps per tile, was the busiest tile: at 1024^2 on the 39,474-face
// sphere it holds 1,158 faces against a mean of 127, its 8 warps walked
// some 145 faces each in series, and that block alone took 1.05 of the
// kernel's 1.67 ms.  The rest is bulk: a warp walks a face's bbox pixels
// 32 at a time, and a small face's bbox inside a tile has fewer than 32,
// so lanes idle (left for a later design).
//
// Design.  Three kernels, two entry points.
//
//  softras_bwd_kernel: kSplit blocks of 8 warps per (screen tile, batch
//    element); rank r takes chunks r, r + kSplit, ... of the tile's sorted
//    run, so the busiest tile's run is walked by kSplit blocks at once.  A
//    rank without a chunk returns before it reads anything more; the
//    others stage the tile's pixel maps (image 4, aggrs 2, incoming
//    gradient 4, threshold 1) in shared memory.  Unlike the forward it
//    gives each staged face to one WARP, which walks the pixels of the
//    face's inflated bbox inside the tile, 32 at a time.  So the sum over a
//    tile's pixels of one face stays inside a warp: each lane adds its
//    pixels in ascending order, one xor-butterfly of shuffles adds the
//    lanes, and no block barrier or shared-memory atomic is needed per
//    face; pixels outside the bbox (three quarters of a tile list's pairs
//    on the bench sphere) are never visited.  Face rows are staged with
//    cp.async, double-buffered: warp w copies the rows of faces w, w + 8,
//    ... of a chunk, which it then walks itself, so the next chunk's rows
//    are in flight while it walks and only warp barriers order the
//    buffers.  Surface texels: a pair adds 3 values to the texel its
//    clipped barycentrics select, so a warp keeps 3T sums in shared memory
//    and its lanes add to them one after the other in lane order.  The
//    warp writes one row of gslots [B, L, 9 + tex] per (tile, face), at
//    the pair's position in the binning's sorted run: one warp per row,
//    over the same pixels in the same order whichever rank and warp it is,
//    so the rows do not depend on kSplit or the chunk size.
//  softras_bwd_big_kernel: the faces of the big-face list span more tiles
//    than the binning emits pairs for and have no slots.  One block per
//    big face walks the face's whole bbox, 256 pixels at a time, and
//    reduces over its warps in a fixed order into gbig [B, F, 9 + tex]
//    (row g = the g-th big face).  The grid has a block for every face;
//    blocks past the list's length return at once (no host sync to learn
//    the length).  A mesh made of a few screen-filling faces is served by
//    few blocks: correct, and slow.
//  softras_bwd_reduce_kernel: one warp per face (or 32 / G faces a warp,
//    G = 4 or 16 lanes each, where a face's float4 columns need that few:
//    T = 1 and T = 9) sums the
//    face's slots in ascending tile order through gsrc [B, F, mt], the
//    inverse of the binning's sort (the analogue of the TPU path's
//    prep['gsrc']), or takes the face's gbig row, and writes
//    grad_face_vertices [B,F,9] and grad_textures [B,F,tex].  It is bound
//    by the slot rows' bytes; what held its first design back was latency:
//    each lane read gsrc[j] and then that row, one row at a time, in each
//    of ceil(GC / 32) passes.  So a face's lanes load a window of its gsrc
//    entries at once and a ballot hands out the emitted ones, a lane
//    starts kReduceRows rows' loads before it adds them (in ascending tile
//    order: the same bits), and where GC % 4 == 0 and the rows are 16-byte
//    aligned a lane loads 4 columns as one float4 (GC 84: one pass).
//
// Bands (the band arguments of soft_rasterize_bwd_pxt, pxt_impl.py:1049;
// softras_fwd.cu has the layout): the per-tile kernel's grid runs over the
// band's tile rows and reads the band's maps, the binning emitted the
// band's pairs only, so the reduction sums the band's slot rows (the
// others have no gsrc entry), and the big-face kernel walks only the band's
// rows of a face's box, in band-row order: the band's pixels, each once.
// The whole image is the band (0, tiles_y, 1), whose walk is the one
// without bands, bit for bit.
//
// The reduction is deterministic: no atomics anywhere, every sum in a
// fixed order, so two runs give the same bits.  Scratch: L = F * mt slot
// rows, 39,474 * 12 * 84 floats = 159 MB at the bench's full width;
// rows of pairs the binning did not emit are neither written nor read.
// There is no cap: lists of any length, every face kept.
//
// Bound.  Operations: the forward's pair math for every pair in a bbox
// plus about 120 more for a pair within the threshold.  Bytes of the
// function that the two kernels compute together: the face rows and
// lists, 11 floats per pixel, one gradient row per face out.  The slot
// rows, written here and read by the reduction, are this two-pass
// design's cost on top of that, not the function's; they count only in
// the reduction's own bound, as its input.  Counted over the pixels with a
// candidate, operations bind on the bench sphere (chip_smoke.py computes
// both from its run).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "softras_grad.cuh"

// The blocks that share one tile's run, a compile-time constant (PERF.md
// has the times of 2, 4 and 8).
#ifndef SOFTRAS_BWD_SPLIT
#define SOFTRAS_BWD_SPLIT 8
#endif

namespace softras {

constexpr int kReduceRows = 4;  // slot rows whose loads a lane starts before it adds them
constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 11;  // per-pixel inputs: out 4, aggrs 2, grad 4, thr 1
constexpr int kMaxChunk = 64;                 // faces of a staged chunk, at most
constexpr int kPerWarp = kMaxChunk / kWarps;  // faces a warp stages per chunk
constexpr int kSplit = SOFTRAS_BWD_SPLIT;
// blocks an SM holds at once: the register cap (80 a thread) lets 3 blocks
// share an SM where 128 registers let 2
constexpr int kMinBlocks = 3;
static_assert(kSplit >= 1, "a tile needs a block");

struct BwdArgs {
  const float* rows;         // [B, F, row]
  const int* faces_sorted;   // [B, L]
  const int* starts;         // [B, NT]
  const int* run_counts;     // [B, NT]
  const int* glist;          // [B, F]
  const int* gcount;         // [B]
  const float* image;        // [B, 4, H, W] the forward's output
  const float* aggrs;        // [B, 2, H, W]
  const float* grad;         // [B, 4, H, W] incoming gradient
  const float* thr;          // [B, H, W], or null: no truncation
  float* gslots;             // [B, L, GC]
  float* gbig;               // [B, F, GC]
  int B, F, L, row, image_size, tiles_x, tiles_y, chunk, GC;
  int dist_func, rgb_func, alpha_func;
  int ty0, ty_band, ty_stride, band_h;  // the band of tile rows, its maps' rows
  Scalars s;
};

__device__ __forceinline__ GradCfg grad_cfg(const BwdArgs& a) {
  return GradCfg{a.s, a.F, a.rgb_func, a.alpha_func, a.thr != nullptr};
}

struct ReduceArgs {
  const float* gslots;       // [B, L, GC]
  const float* gbig;         // [B, F, GC]
  const int* gsrc;           // [B, F, mt] slot of each emitted pair, or -1
  const int* gpos;           // [B, F] place in the big-face list, or -1
  float* grad_face;          // [B, F, 9]
  float* grad_tex;           // [B, F, GC - 9]
  int B, F, L, mt, GC;
};

// Lane q < kPerWarp of warp w: the id of face w + kWarps * q of chunk c of
// the tile's run (which starts at `run`), or -1 past the chunk's n faces.
__device__ __forceinline__ int chunk_ids(const int* run, int chunk, int c, int n, int warp,
                                         int lane) {
  const int j = warp + kWarps * lane;
  return (lane < kPerWarp && j < n) ? run[c * chunk + j] : -1;
}

// Warp w copies the rows of faces w, w + kWarps, ... of a chunk of n faces
// (ids from chunk_ids) into srow / sid with cp.async and commits them as
// one group: the faces the warp will walk itself.
__device__ __forceinline__ void stage(const float* rows_b, int row, float* srow, int* sid,
                                      int n, int ids, int warp, int lane) {
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    const int j = warp + kWarps * q;
    const int id = __shfl_sync(0xffffffffu, ids, q);
    if (j < n) {
      if (lane == 0) sid[j] = id;
      const float* src = rows_b + (size_t)id * row;
      float* dst = srow + j * row;
      for (int k = lane; k < row; k += 32) __pipeline_memcpy_async(dst + k, src + k, 4);
    }
  }
  __pipeline_commit();
}

template <int DIST>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    softras_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const GradCfg cfg = grad_cfg(a);
  const int T3 = a.GC - 9;
  const int chunk = a.chunk, row = a.row;
  float* srows = smem;                                                 // [2, chunk, row]
  int* sids = reinterpret_cast<int*>(smem + 2 * chunk * row);          // [2, chunk]
  float* spx = smem + 2 * chunk * (row + 1);                           // [kPix, 256]
  float* swtex = spx + kPix * kThreads;                                // [kWarps, T3]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rank = blockIdx.x % kSplit;
  const int tile_x = blockIdx.x / kSplit, b = blockIdx.z;
  const int tile_y = a.ty0 + blockIdx.y * a.ty_stride;  // the band's row blockIdx.y
  const int is = a.image_size;
  const float isf = (float)is;
  const int NT = a.tiles_x * a.tiles_y;
  const int tile = tile_y * a.tiles_x + tile_x;
  const int run = a.run_counts[b * NT + tile];
  const int nch = (run + chunk - 1) / chunk;
  // this rank's chunks are rank, rank + kSplit, ...; without one it returns
  // before it reads the tile's maps
  if (rank >= nch) return;
  const int start = a.starts[b * NT + tile];
  const int* run_ids = a.faces_sorted + (size_t)b * a.L + start;
  const float* rows_b = a.rows + (size_t)b * a.F * row;
  const size_t HW = (size_t)a.band_h * is;

  // the first chunk's rows are in flight while the maps are read
  stage(rows_b, row, srows, sids, min(chunk, run - rank * chunk),
        chunk_ids(run_ids, chunk, rank, min(chunk, run - rank * chunk), warp, lane), warp, lane);
  int c_next = rank + kSplit;
  int ids_next = c_next < nch ? chunk_ids(run_ids, chunk, c_next,
                                          min(chunk, run - c_next * chunk), warp, lane) : -1;

  // the tile's pixel maps, pixel (ly, lx) at ly * 16 + lx, from the
  // band's rows
  {
    const int col = tile_x * kTile + tid % kTile;
    const int rowp = tile_y * kTile + tid / kTile;
    const bool live = col < is && rowp < is;
    const size_t px = (size_t)(blockIdx.y * kTile + tid / kTile) * is + col;
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
  __syncthreads();  // the maps are in

  const int tc0 = tile_x * kTile, tr0 = tile_y * kTile;
  const int tc1 = min(tc0 + kTile - 1, is - 1), tr1 = min(tr0 + kTile - 1, is - 1);

  // a warp walks the faces it staged itself, so only warp barriers order
  // the buffers
  for (int k = 0, c = rank; c < nch; ++k, c += kSplit) {
    const int cur = k & 1;
    const int n = min(chunk, run - c * chunk);
    const float* srow = srows + cur * chunk * row;
    const int* sid = sids + cur * chunk;
    if (c_next < nch) {
      stage(rows_b, row, srows + (cur ^ 1) * chunk * row, sids + (cur ^ 1) * chunk,
            min(chunk, run - c_next * chunk), ids_next, warp, lane);
      c_next += kSplit;
      ids_next = c_next < nch ? chunk_ids(run_ids, chunk, c_next,
                                          min(chunk, run - c_next * chunk), warp, lane) : -1;
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncwarp();  // chunk c's rows of this warp's faces are in

    for (int j = warp; j < n; j += kWarps) {
      const float* r = srow + j * row;
      const int fid = sid[j];
      float acc[9], tacc[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) acc[q] = tacc[q] = 0.0f;
      int c0, c1, r0, r1;
      if (pixel_range(r, a.s.sq, isf, tc0, tc1, tr0, tr1, &c0, &c1, &r0, &r1)) {
        const int w = c1 - c0 + 1;
        const int np = w * (r1 - r0 + 1);
        for (int k0 = 0; k0 < np; k0 += 32) {
          const int kp = k0 + lane;
          const bool active = kp < np;
          const int col = c0 + (active ? kp % w : 0);
          const int rowp = r0 + (active ? kp / w : 0);
          const int lp = (rowp - tr0) * kTile + (col - tc0);
          PixelIn px;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            px.o[q] = spx[q * kThreads + lp];
            px.g[q] = spx[(6 + q) * kThreads + lp];
          }
          px.ag0 = spx[4 * kThreads + lp];
          px.ag1 = spx[5 * kThreads + lp];
          px.thr = spx[10 * kThreads + lp];
          const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
          const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
          add_pair<DIST>(r, fid, active, xp, yp, px, cfg, lane, acc, tacc, wtex);
        }
      }
      // the warp's sums into the pair's slot row
      float* slot = a.gslots + ((size_t)b * a.L + start + c * chunk + j) * a.GC;
      float mine = 0.0f, mine_t = 0.0f;
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const float v = warp_sum(acc[q]);
        if (lane == q) mine = v;
      }
      if (lane < 9) slot[lane] = mine;
      if (a.s.texture_type != 0) {
#pragma unroll
        for (int q = 0; q < 9; ++q) {
          const float v = warp_sum(tacc[q]);
          if (lane == q) mine_t = v;
        }
        if (lane < 9) slot[9 + lane] = mine_t;
      } else {
        __syncwarp();
        for (int i = lane; i < T3; i += 32) {
          slot[9 + i] = wtex[i];
          wtex[i] = 0.0f;
        }
        __syncwarp();
      }
    }
    __syncwarp();  // this warp is done with buffer `cur`, which chunk c + 2 * kSplit takes
  }
}

// The band rows [*lr0, *lr1] whose image rows lie in [r0, r1]; false where
// there are none.  Band rows map to image rows in ascending order, so
// every band row between the two lies in [r0, r1] too.
__device__ __forceinline__ bool band_span(const BwdArgs& a, int r0, int r1, int* lr0,
                                          int* lr1) {
  const int t0 = r0 / kTile, t1 = r1 / kTile;
  if (t1 < a.ty0) return false;
  // the first band row at or after tile row t0, the last at or before t1
  const int k0 = t0 <= a.ty0 ? 0 : (t0 - a.ty0 + a.ty_stride - 1) / a.ty_stride;
  const int k1 = min((t1 - a.ty0) / a.ty_stride, a.ty_band - 1);
  if (k0 > k1) return false;
  *lr0 = k0 * kTile + (a.ty0 + k0 * a.ty_stride == t0 ? r0 % kTile : 0);
  *lr1 = k1 * kTile + (a.ty0 + k1 * a.ty_stride == t1 ? r1 % kTile : kTile - 1);
  return *lr0 <= *lr1;
}

template <int DIST>
__global__ void __launch_bounds__(kThreads)
    softras_bwd_big_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  const GradCfg cfg = grad_cfg(a);
  const int T3 = a.GC - 9;
  float* srow = smem;                       // [row]
  float* swarp = smem + a.row;              // [kWarps, 18]
  float* swtex = swarp + kWarps * 18;       // [kWarps, T3]

  const int g = blockIdx.x, b = blockIdx.y;
  if (g >= a.gcount[b]) return;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int fid = a.glist[(size_t)b * a.F + g];
  const int is = a.image_size;
  const float isf = (float)is;
  const size_t HW = (size_t)a.band_h * is;
  for (int i = tid; i < a.row; i += kThreads)
    srow[i] = a.rows[((size_t)b * a.F + fid) * a.row + i];
  const bool surface = a.s.texture_type == 0;
  float* wtex = swtex + warp * T3;
  if (surface)
    for (int i = lane; i < T3; i += 32) wtex[i] = 0.0f;
  __syncthreads();

  float acc[9], tacc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = tacc[c] = 0.0f;
  int c0, c1, r0, r1, lr0, lr1;
  // the box's pixels in the band's rows, band row lr at image row rowp
  if (pixel_range(srow, a.s.sq, isf, 0, is - 1, 0, is - 1, &c0, &c1, &r0, &r1) &&
      band_span(a, r0, r1, &lr0, &lr1)) {
    const int w = c1 - c0 + 1;
    const int np = w * (lr1 - lr0 + 1);
    for (int k0 = 0; k0 < np; k0 += kThreads) {
      const int k = k0 + tid;
      const bool active = k < np;
      const int col = c0 + (active ? k % w : 0);
      const int lr = lr0 + (active ? k / w : 0);
      const int rowp = (a.ty0 + lr / kTile * a.ty_stride) * kTile + lr % kTile;
      const size_t p = (size_t)lr * is + col;
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
  }
  // lanes by butterfly, then the warps in ascending order
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const float v = warp_sum(acc[c]);
    const float vt = warp_sum(tacc[c]);
    if (lane == 0) {
      swarp[warp * 18 + c] = v;
      swarp[warp * 18 + 9 + c] = vt;
    }
  }
  __syncthreads();
  float* out = a.gbig + ((size_t)b * a.F + g) * a.GC;
  for (int i = tid; i < a.GC; i += kThreads) {
    float v = 0.0f;
    if (i < 9 || !surface) {
      for (int wp = 0; wp < kWarps; ++wp) v += swarp[wp * 18 + i];
    } else {
      for (int wp = 0; wp < kWarps; ++wp) v += swtex[wp * T3 + (i - 9)];
    }
    out[i] = v;
  }
}

// Lane l's W columns of a row: W = 4 as one 16-byte load
template <int W>
__device__ __forceinline__ void load_cols(const float* row, int c, int GC, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(row + c);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
    v[0] = c < GC ? row[c] : 0.0f;
  }
}

// Add to acc the slot rows of the emitted pairs in `m` (bit l: slots[l]), in
// ascending bit order, with the loads of kReduceRows rows in flight at once
template <int W>
__device__ __forceinline__ void add_rows(const ReduceArgs& a, int b, int c, unsigned m,
                                         const int* slots, float (&acc)[W]) {
  constexpr int R = kReduceRows;
  while (m) {
    int sl[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      sl[u] = -1;
      if (m) {
        sl[u] = slots[__ffs(m) - 1];
        m &= m - 1;
      }
    }
    float v[R][W];
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (sl[u] >= 0 && c < a.GC)
        load_cols<W>(a.gslots + ((size_t)b * a.L + sl[u]) * a.GC, c, a.GC, v[u]);
#pragma unroll
    for (int u = 0; u < R; ++u)
      if (sl[u] >= 0) {
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] += v[u][w];
      }
  }
}

// W: columns a lane loads at once (1, or 4 as a float4 where GC % 4 == 0 and
// the rows are 16-byte aligned); G: lanes a face (32, or 4 or 16 to run
// 32 / G faces a warp where a face's float4 columns need that few lanes)
template <int W, int G>
__global__ void __launch_bounds__(kThreads)
    softras_bwd_reduce_kernel(const ReduceArgs a) {
  __shared__ int s_slot[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / G, lig = lane % G;
  const long long gw = ((long long)blockIdx.x * kWarps + warp) * (32 / G) + grp;  // b*F + f
  const bool live = gw < (long long)a.B * a.F;
  const int b = live ? (int)(gw / a.F) : 0;
  const int g = live ? a.gpos[gw] : -1;
  const bool walk = live && g < 0;           // the face's emitted rows, not a big-face row
  const int T3 = a.GC - 9;
  for (int c0 = 0; c0 < a.GC; c0 += G * W) {
    const int c = c0 + lig * W;
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;
    // the face's emitted pairs in ascending tile order: a window of G of its
    // gsrc entries loaded by its lanes at once, the emitted ones handed out
    // through shared memory by a ballot (every lane of the warp takes part)
    const unsigned gmask = G == 32 ? 0xffffffffu : (1u << G) - 1u;
    for (int j0 = 0; j0 < a.mt; j0 += G) {
      const int j = j0 + lig;
      const int sl = walk && j < a.mt ? a.gsrc[gw * a.mt + j] : -1;
      const unsigned m = (__ballot_sync(0xffffffffu, sl >= 0) >> (grp * G)) & gmask;
      s_slot[warp][lane] = sl;
      __syncwarp();
      add_rows<W>(a, b, c, m, s_slot[warp] + grp * G, acc);
      __syncwarp();
    }
    if (live && g >= 0 && c < a.GC)
      load_cols<W>(a.gbig + ((size_t)b * a.F + g) * a.GC, c, a.GC, acc);
    if (!live) continue;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int col = c + w;
      if (col >= a.GC) break;
      if (col < 9) {
        a.grad_face[gw * 9 + col] = acc[w];
      } else {
        a.grad_tex[gw * T3 + (col - 9)] = acc[w];
      }
    }
  }
}

template <int W, int G>
cudaError_t launch_reduce(const ReduceArgs& a, cudaStream_t stream) {
  const long long faces = (long long)a.B * a.F;
  const long long per_block = (long long)kWarps * (32 / G);
  const unsigned blocks = (unsigned)((faces + per_block - 1) / per_block);
  softras_bwd_reduce_kernel<W, G><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The float4 columns of a surface row: GC = 9 + 3T with GC % 4 == 0 takes
// GC / 4 = 3 (T = 1), 9 (T = 9) or 21 and more lanes
cudaError_t launch_reduce_vec(const ReduceArgs& a, cudaStream_t stream) {
  const int lanes = a.GC / 4;
  if (lanes <= 4) return launch_reduce<4, 4>(a, stream);
  if (lanes <= 16) return launch_reduce<4, 16>(a, stream);
  return launch_reduce<4, 32>(a, stream);
}

template <int DIST>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const int T3 = a.s.texture_type == 0 ? a.GC - 9 : 0;
  const size_t smem = (2 * (size_t)a.chunk * (a.row + 1) + kPix * kThreads +
                       (size_t)kWarps * T3) * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)  // a face row of many texels: the kernel asks for more
    err = cudaFuncSetAttribute(softras_bwd_kernel<DIST>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  softras_bwd_kernel<DIST><<<dim3(a.tiles_x * kSplit, a.ty_band, a.B), kThreads, smem,
                             stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_big = ((size_t)a.row + kWarps * 18 + (size_t)kWarps * T3) *
                          sizeof(float);
  softras_bwd_big_kernel<DIST><<<dim3(a.F, a.B), kThreads, smem_big, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace softras

extern "C" int softras_bwd(const softras::BwdArgs* args, void* stream) {
  using namespace softras;
  if (args->chunk < 1 || args->chunk > kMaxChunk || !band_ok(*args))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (args->dist_func) {
    case kDistHard: err = launch<kDistHard>(*args, st); break;
    case kDistBary: err = launch<kDistBary>(*args, st); break;
    default: err = launch<kDistEuclid>(*args, st); break;
  }
  return (int)err;
}

extern "C" int softras_bwd_reduce(const softras::ReduceArgs* args, void* stream) {
  using namespace softras;
  const ReduceArgs& a = *args;
  if ((long long)a.B * a.F == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = a.GC % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.gslots) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.gbig) % 16 == 0;
  return (int)(vec ? launch_reduce_vec(a, st) : launch_reduce<1, 32>(a, st));
}

extern "C" int softras_bwd_args_size() { return (int)sizeof(softras::BwdArgs); }

extern "C" int softras_bwd_reduce_args_size() {
  return (int)sizeof(softras::ReduceArgs);
}

extern "C" int softras_bwd_split() { return softras::kSplit; }
