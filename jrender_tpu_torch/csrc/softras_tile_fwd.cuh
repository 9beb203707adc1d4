// SoftRas forward over screen tiles of any shape, each tile's face list
// split over a thread-block cluster: the kernel of the f_px route
// (softras_fpx_fwd.cu, K3) and of the px_f route (softras_pxf_fwd.cu, K5).
// The TPU kernels carry their per-pixel accumulators in VMEM scratch from
// one (tile, face chunk) grid step to the next, on one core in order
// (pallas_impl.py:313-440 and :894-1158).  Blocks of a CUDA grid run in
// no order, so the sequential chunk dimension becomes a loop inside the
// block and the accumulators live in registers for the whole walk.
//
// What bounded the first design.  A tile was split over blocks by pixels
// only (4 blocks per 16 x 128 tile, 2 per 32 x 32 tile), and every block
// walked the tile's whole list: at 1024^2 on the 39,474-face sphere the
// busiest 16 x 128 tile holds 2,490 faces and the busiest 32 x 32 tile
// 1,755, and one block's walk of them set the kernel's time while the
// other SMs idled (PERF.md).  Each chunk's rows were gathered by the
// computing threads behind three block barriers, K5's per-thread K-smallest
// lists sat in local memory, and its bisection walked the whole list.
//
// Design: the binned forward's cluster split (softras_fwd.cu) at the wide
// tiles.  A tile's pixels are cut into parts of at most 32 x 16 (a 16 x
// 128 tile into 4, a 32 x 32 tile into 2), a block of 256 threads a part,
// 2 pixels a thread; a warp takes an 8 x 8 block of pixels, each thread
// one pixel of its upper 8 x 4 half and the one 4 rows below.  A small
// face's bbox meets few such warps, and the lanes of a warp that meets it
// mostly work: a strip of 32 pixels of one row (the first design of this
// split) ran most of a small face's pairs on a few lanes of a warp, and
// took 2.8 ms of K3 against 0.85 ms of K1 for the same pairs.  One
// thread-block cluster of kTileSplit blocks takes each (part, tile of the
// band, batch element), grid.x = tiles_x * parts * kTileSplit.  Rank r of the
// cluster walks the contiguous share [r * per, (r + 1) * per), per =
// ceil(total / kTileSplit), of the tile's list (ops/softras/tiled.py
// tile_work: the tile's big faces, then its sorted run;
// cuda_impl.rank_shares), so the busiest tile's list is walked by
// kTileSplit SMs at once for each of its parts.
//  Staging: chunks of a share's face rows are copied into shared memory
//    with cp.async, double-buffered, one block barrier per chunk: warp w
//    copies the rows of faces w, w + warps, ... of a chunk, its lanes along
//    a row, from ids its lanes loaded one chunk ahead.  Every thread then
//    reads the same row, a broadcast.
//  Partial states: each thread keeps, for each of its pixels and its
//    rank's share, what the pxg partials keep (pxg_impl.item_partials):
//    the online softmax's numerators, S and M without the background (M =
//    -1e30 without a candidate), rescaled when the max rises; for hard rgb
//    the winner's colour, depth and id (the lowest id on a depth tie);
//    alpha as a product, a sum or a max; the candidate count.
//  Merge: the ranks write their states to their own shared memory; after
//    a cluster barrier rank 0 reads them through distributed shared memory,
//    in rank order, and merges them by the pxg combine's rule
//    (pxg_impl.merge_partials): M = max(eps, M_r), each share scaled by
//    exp((M_r - M) / gamma), the background term exp((eps - M) / gamma)
//    once; hard rgb the least depth and the lowest id among equal depths,
//    across ranks too; alpha 1 - product, sum / F or max; counts summed.
//    A second cluster barrier keeps every block resident until rank 0 has
//    read its state.  A tile whose list has at most one face has rank 0
//    alone at work, which writes its result with no barrier or merge.
//    Rank 0 writes the background and the initial aggregates of a tile
//    with an empty list (the TPU layout's fill of its uncovered tiles,
//    pallas_impl.py:1610-1624), so no assembly pass follows.
//  Threshold (THR, the px_f route): the K-th smallest candidate depth of
//    each pixel, counted with multiplicity, and `far` where a pixel has
//    at most K candidates, as on the binned route.  kThrList (K <=
//    kListMax): each rank keeps its share's K smallest depths of each
//    pixel in shared memory, [K][kTilePix] (a warp's lanes on distinct
//    banks); after the first cluster barrier rank 0 inserts the other
//    ranks' lists, read through distributed shared memory, into its own.
//    The K-th smallest of a union is a value of the union, so the map is
//    the unsplit walk's to the bit.  kThrBisect (K > kListMax): bisection
//    on the depth's order-preserving key between those of near and far;
//    every rank reads the ranks' counts after the first barrier, and in
//    each step counts its own share's candidates at or below the trial,
//    the counts summed through distributed shared memory after one cluster
//    barrier a step (two count buffers, so a rank may write the next
//    step's count while another reads this one's).  Every rank sees the
//    same sums, so all take the same steps and the same barriers, and the
//    result is exact.
// The band (ty0, ty_band) selects tile rows: pixel centres use the global
// row, the outputs are band-local.  The grid is fixed by the image size
// and the band, so nothing waits on the host.  No atomics: the output is
// deterministic; counts, hard winners and thresholds equal the unsplit
// walk's, sums move by rounding.  Lists have no cap.
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

// The blocks that share one tile's list, a compile-time constant (PERF.md
// has the times of 2, 4 and 8).
#ifndef SOFTRAS_TILE_SPLIT
#define SOFTRAS_TILE_SPLIT 8
#endif
// Blocks an SM is to hold at once, __launch_bounds__' register cap: each
// source that includes this sets its own (tools/time_tile_fwd.py times 1
// to 4).  The kernel waits on its staging, its merges and its divisions,
// so warps resident to hide that latency count more than registers.
#ifndef SOFTRAS_TILE_MIN_BLOCKS
#error "define SOFTRAS_TILE_MIN_BLOCKS before including softras_tile_fwd.cuh"
#endif

namespace softras {

namespace cg = cooperative_groups;

constexpr int kTileThreads = 256;                   // threads of a block at most
constexpr int kTilePPT = 2;                         // pixels a thread
constexpr int kTilePix = kTileThreads * kTilePPT;   // stride of per-pixel arrays in shared memory
constexpr int kTileSplit = SOFTRAS_TILE_SPLIT;
constexpr int kTileMaxChunk = 64;                   // faces of a staged chunk, at most
constexpr int kTileState = 7;                       // channels of a partial state
constexpr int kGeomRow = kTex;                      // floats of a row that hold geometry
constexpr int kThrNone = 0, kThrList = 1, kThrBisect = 2;
constexpr float kTileNoMax = -1e30f;                // M of a share without a candidate
constexpr int kTileNoCluster = -1;                  // the cluster cannot be resident
constexpr int kTileMergeBatch = 8;                  // remote depths a list merge reads at once
constexpr size_t kTileSmemDefault = 48 * 1024;      // dynamic shared memory without asking
constexpr size_t kTileSmemMax = 227 * 1024;         // the most a block can ask for
static_assert(kTileSplit >= 1 && kTileSplit <= 8, "a portable cluster holds 1 to 8 blocks");

struct TileFwdArgs {
  const float* rows;     // [B, F, row]
  const int* entries;    // [E] face ids of every tile's list, tile after tile
  const int* tile_off;   // [B * NT + 1] first entry of each tile
  float* image;          // [B, 4, Hb, is], Hb = ty_band * tile_h
  float* aggrs;          // [B, 2, Hb, is]
  int* counts;           // [B, Hb, is]
  float* thr;            // [B, Hb, is], or null
  int B, F, row, image_size, tile_h, tile_w, tiles_x, tiles_y, ty0, ty_band, chunk;
  int K;                 // the threshold's K
  unsigned bis_lo, bis_hi;  // depth keys of near and far (bisection)
  int bis_iters;
  int dist_func, rgb_func, alpha_func;
  Scalars s;
};

// A tile of tile_h x tile_w pixels (multiples of 8) is cut into parts of
// tile_part_w x tile_part_h pixels, at most 32 x 16; a warp takes an
// 8 x 8 block of a part, each thread 2 pixels 4 rows apart, so a block
// has tile_part_w * tile_part_h / 2 threads, at most kTileThreads.
__host__ __device__ inline int tile_part_w(int tile_w) { return tile_w < 32 ? tile_w : 32; }
__host__ __device__ inline int tile_part_h(int tile_h) { return tile_h < 16 ? tile_h : 16; }

// Dynamic shared memory of a block: the staging buffers (rows [2, chunk,
// row], ids [2, chunk]) or, over them once the walk is done, the partial
// state [kTileState, kTilePix]; then the threshold's own: the lists
// [K, kTilePix] and their counts [kTilePix] (kThrList) or two count
// buffers [2, kTilePix] (kThrBisect).
__host__ __device__ inline size_t tile_fwd_smem(int chunk, int row, int thr, int K) {
  const size_t stage = 2 * (size_t)chunk * (row + 1) * sizeof(float);
  const size_t state = (size_t)kTileState * kTilePix * sizeof(float);
  const size_t own = thr == kThrList     ? (size_t)(K + 1) * kTilePix * sizeof(float)
                     : thr == kThrBisect ? 2 * (size_t)kTilePix * sizeof(int)
                                         : 0;
  return (stage > state ? stage : state) + own;
}

// Lane q of warp w (of nw): the id of face w + nw * q of the chunk of n
// faces at ids[base], or -1.
__device__ __forceinline__ int tile_chunk_ids(const int* ids, int base, int n, int warp, int nw,
                                              int lane) {
  const int j = warp + nw * lane;
  return j < n ? ids[base + j] : -1;
}

// Warp w copies the first `width` floats of the rows of faces w, w + nw,
// ... of a chunk of n faces (ids from tile_chunk_ids) into srow [n, width]
// / sid with cp.async, and commits them as one group.
__device__ __forceinline__ void tile_stage(const float* rows_b, int row, int width, float* srow,
                                           int* sid, int n, int ids, int warp, int nw,
                                           int lane) {
  const int mine = n > warp ? (n - warp + nw - 1) / nw : 0;
  for (int q = 0; q < mine; ++q) {
    const int j = warp + nw * q;
    const int id = __shfl_sync(0xffffffffu, ids, q);
    if (lane == 0) sid[j] = id;
    const float* src = rows_b + (size_t)id * row;
    float* dst = srow + j * width;
    for (int k = lane; k < width; k += 32) __pipeline_memcpy_async(dst + k, src + k, 4);
  }
  __pipeline_commit();
}

// Walks the share ids[0, len) once, the first `width` floats of each row
// staged (the whole row, or its geometry): visit(row, face id) sees every
// face, on every thread.  Every thread of the block calls it.
template <class Visit>
__device__ __forceinline__ void tile_walk(const float* rows_b, int row, const int* ids, int len,
                                          int width, int chunk, float* buf, Visit&& visit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nw = blockDim.x / 32;
  int* const sid0 = reinterpret_cast<int*>(buf + 2 * chunk * width);
  const int nch = (len + chunk - 1) / chunk;
  if (nch == 0) return;
  tile_stage(rows_b, row, width, buf, sid0, min(chunk, len),
             tile_chunk_ids(ids, 0, min(chunk, len), warp, nw, lane), warp, nw, lane);
  int ids_next = nch > 1 ? tile_chunk_ids(ids, chunk, min(chunk, len - chunk), warp, nw, lane) : -1;
  for (int c = 0; c < nch; ++c) {
    const int cur = c & 1;
    const int n = min(chunk, len - c * chunk);
    const float* srow = buf + cur * chunk * width;
    const int* sid = sid0 + cur * chunk;
    __pipeline_wait_prior(0);
    // chunk c's rows and ids are in; every thread is done with chunk
    // c - 1, whose buffers chunk c + 1 takes
    __syncthreads();
    if (c + 1 < nch) {
      tile_stage(rows_b, row, width, buf + (cur ^ 1) * chunk * width, sid0 + (cur ^ 1) * chunk,
                 min(chunk, len - (c + 1) * chunk), ids_next, warp, nw, lane);
      ids_next = c + 2 < nch ? tile_chunk_ids(ids, (c + 2) * chunk,
                                              min(chunk, len - (c + 2) * chunk), warp, nw, lane)
                             : -1;
    }
    for (int j = 0; j < n; ++j) visit(srow + j * width, sid[j]);
  }
  __syncthreads();  // the staging buffers are free again
}

template <int DIST, int RGB, int THR>
__global__ void __launch_bounds__(kTileThreads, SOFTRAS_TILE_MIN_BLOCKS)
    softras_tile_fwd_kernel(const TileFwdArgs a) {
  extern __shared__ float smem[];
  constexpr int PPT = kTilePPT;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int pw = tile_part_w(a.tile_w), ph = tile_part_h(a.tile_h);
  const int parts_x = (a.tile_w + pw - 1) / pw;
  const int parts = parts_x * ((a.tile_h + ph - 1) / ph);
  const int rank = blockIdx.x % kTileSplit;         // this_cluster().block_rank()
  const int tp = blockIdx.x / kTileSplit;           // tile_x * parts + part
  const int tile_x = tp / parts, part = tp - tile_x * parts;
  const int band_y = blockIdx.y, b = blockIdx.z;
  // the thread's first pixel in the tile: its warp's 8 x 8 block of the
  // part, its lane's place in the block's upper 8 x 4 half
  const int warp = tid / 32, lane = tid % 32;
  const int lx = (part % parts_x) * pw + (warp % (pw / 8)) * 8 + lane % 8;
  const int ly = (part / parts_x) * ph + (warp / (pw / 8)) * 8 + lane / 8;
  const int tile_y = a.ty0 + band_y;
  const int tile_g = (b * a.tiles_y + tile_y) * a.tiles_x + tile_x;
  const int e0 = a.tile_off[tile_g];
  const int total = a.tile_off[tile_g + 1] - e0;
  // rank r's share [r * per, (r + 1) * per); `active` ranks have one, the
  // others walk nothing but take part in every cluster barrier
  const int per = (total + kTileSplit - 1) / kTileSplit;
  const int active = total > 0 ? (total + per - 1) / per : 1;
  const bool merge = active > 1;
  if (!merge && rank != 0) return;
  const int lo = min(rank * per, total), len = min(total, lo + per) - lo;
  const int is = a.image_size;
  const float isf = (float)is;
  const Scalars& s = a.s;
  const float* rows_b = a.rows + (size_t)b * a.F * a.row;
  cg::cluster_group cluster = cg::this_cluster();

  float xp[PPT], yp[PPT];
  bool live[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int col = tile_x * a.tile_w + lx;
    const int rowp = tile_y * a.tile_h + ly + 4 * k;
    live[k] = lx < a.tile_w && ly + 4 * k < a.tile_h && col < is && rowp < is;
    xp[k] = (2.0f * (float)col + 1.0f - isf) / isf;
    yp[k] = (isf - 1.0f - 2.0f * (float)rowp) / isf;
  }

  // the share's partial state
  float S[PPT], M[PPT], n0[PPT], n1[PPT], n2[PPT];  // softmax
  float dmin[PPT], c0[PPT], c1[PPT], c2[PPT];        // hard rgb
  int win[PPT], cnt[PPT];
  float A[PPT];
  // after the staging buffers (or the state over them): the threshold's own
  const int own_at = max(2 * a.chunk * (a.row + 1), kTileState * kTilePix);
  float* const own = smem + own_at;
  SharedSmallestK<kTilePix> list[THR == kThrList ? PPT : 1];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    S[k] = 0.0f;
    M[k] = kTileNoMax;
    n0[k] = n1[k] = n2[k] = 0.0f;
    dmin[k] = kBigDepth;
    c0[k] = c1[k] = c2[k] = 0.0f;
    win[k] = -1;
    cnt[k] = 0;
    A[k] = a.alpha_func == kAlphaProd ? 1.0f : 0.0f;
    if constexpr (THR == kThrList) list[k] = {own + tid + k * nth, a.K, 0, 0, 0.0f};
  }

  tile_walk(rows_b, a.row, a.entries + e0 + lo, len, a.row, a.chunk, smem,
            [&](const float* r, int fid) {
    const bool side_ok = s.fill_back || r[kFront] > 0.5f;
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (!live[k]) continue;
      PairTerms t;
      // false: outside the inflated bbox or past the distance cut, where
      // the pair changes no accumulator
      if (!pair_terms<DIST>(r, xp[k], yp[k], s, &t)) continue;

      if (a.alpha_func == kAlphaProd) {
        A[k] *= 1.0f - t.sf;
      } else if (a.alpha_func == kAlphaSum) {
        A[k] += t.sf;
      } else if (t.sf > 0.5f) {
        A[k] = 1.0f;
      }
      cnt[k] += t.tk_valid ? 1 : 0;
      if constexpr (THR == kThrList) {
        if (t.tk_valid) list[k](t.zp);
      }

      if (RGB == kRgbSoftmax) {
        if (t.tk_valid && side_ok) {
          const float zpn = (s.far - t.zp) / s.far_minus_near;
          if (zpn > M[k]) {
            // the max rises: rescale what was summed under the old one
            const float sc = expf((M[k] - zpn) / s.gamma);
            S[k] *= sc;
            n0[k] *= sc;
            n1[k] *= sc;
            n2[k] *= sc;
            M[k] = zpn;
          }
          const float e = expf((zpn - M[k]) / s.gamma) * t.sf;
          float c[3];
          pair_color(r, t, s, c);
          S[k] += e;
          n0[k] += e * c[0];
          n1[k] += e * c[1];
          n2[k] += e * c[2];
        }
      } else if (RGB == kRgbHard) {
        if (t.tk_valid && t.inside && side_ok &&
            (t.zp < dmin[k] || (t.zp == dmin[k] && fid < win[k]))) {
          float c[3];
          pair_color(r, t, s, c);
          dmin[k] = t.zp;
          win[k] = fid;
          c0[k] = c[0];
          c1[k] = c[1];
          c2[k] = c[2];
        }
      }
    }
  });

  // the share's state: softmax (n0, n1, n2, S, M) or hard (c0, c1, c2,
  // depth, id), then alpha and the count's bits
  float v[PPT][kTileState];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    v[k][0] = v[k][1] = v[k][2] = v[k][3] = v[k][4] = 0.0f;
    if (RGB == kRgbSoftmax) {
      v[k][0] = n0[k]; v[k][1] = n1[k]; v[k][2] = n2[k]; v[k][3] = S[k]; v[k][4] = M[k];
    } else if (RGB == kRgbHard) {
      v[k][0] = c0[k]; v[k][1] = c1[k]; v[k][2] = c2[k]; v[k][3] = dmin[k];
      v[k][4] = (float)win[k];
    }
    v[k][5] = A[k];
    v[k][6] = __int_as_float(cnt[k]);
  }
  float* const st = smem;  // [kTileState, kTilePix], over the staging buffers
  int* const nlist = reinterpret_cast<int*>(own + a.K * kTilePix);  // kThrList
  if (merge) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int q = tid + k * nth;
#pragma unroll
      for (int c = 0; c < kTileState; ++c) st[c * kTilePix + q] = v[k][c];
      if constexpr (THR == kThrList) nlist[q] = list[k].n;
    }
    cluster.sync();   // every rank's state is written
  }

  const int Hb = a.ty_band * a.tile_h;
  const size_t HW = (size_t)Hb * is;
  // rank r's channel c of pixel k (rank 0 merges its own from registers)
#define STATE(r, k, c) \
  ((r) == 0 ? v[k][c] : cluster.map_shared_rank(st, (r))[(c) * kTilePix + tid + (k) * nth])
  int total_cnt[PPT];
  if (rank == 0) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      float Am = a.alpha_func == kAlphaProd ? 1.0f : 0.0f;
      int cm = 0;
#pragma unroll
      for (int r = 0; r < kTileSplit; ++r) {
        if (r >= active) break;
        const float ar = STATE(r, k, 5);
        if (a.alpha_func == kAlphaProd) {
          Am *= ar;
        } else if (a.alpha_func == kAlphaSum) {
          Am += ar;
        } else {
          Am = fmaxf(Am, ar);
        }
        cm += __float_as_int(STATE(r, k, 6));
      }
      total_cnt[k] = cm;
      float rgb[3], ag0, ag1;
      if (RGB == kRgbSoftmax) {
        float Mm = s.eps;
#pragma unroll
        for (int r = 0; r < kTileSplit; ++r) {
          if (r >= active) break;
          Mm = fmaxf(Mm, STATE(r, k, 4));
        }
        float sS = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int r = 0; r < kTileSplit; ++r) {
          if (r >= active) break;
          const float sc = expf((STATE(r, k, 4) - Mm) / s.gamma);
          s0 += STATE(r, k, 0) * sc;
          s1 += STATE(r, k, 1) * sc;
          s2 += STATE(r, k, 2) * sc;
          sS += STATE(r, k, 3) * sc;
        }
        const float eb = expf((s.eps - Mm) / s.gamma);
        const float Sm = eb + sS;
        rgb[0] = (eb * s.bg[0] + s0) / Sm;
        rgb[1] = (eb * s.bg[1] + s1) / Sm;
        rgb[2] = (eb * s.bg[2] + s2) / Sm;
        ag0 = Sm;
        ag1 = Mm;
      } else if (RGB == kRgbHard) {
        bool hit = false;
        float dm = kBigDepth, wm = -1.0f, w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
#pragma unroll
        for (int r = 0; r < kTileSplit; ++r) {
          if (r >= active) break;
          const float id = STATE(r, k, 4);
          if (id < 0.0f) continue;  // no winner in this share
          const float d = STATE(r, k, 3);
          if (!hit || d < dm || (d == dm && id < wm)) {
            hit = true;
            dm = d;
            wm = id;
            w0 = STATE(r, k, 0);
            w1 = STATE(r, k, 1);
            w2 = STATE(r, k, 2);
          }
        }
        rgb[0] = hit ? w0 : s.bg[0];
        rgb[1] = hit ? w1 : s.bg[1];
        rgb[2] = hit ? w2 : s.bg[2];
        ag0 = hit ? dm : kBigDepth;
        ag1 = hit ? wm : -1.0f;
      } else {
        rgb[0] = s.bg[0];
        rgb[1] = s.bg[1];
        rgb[2] = s.bg[2];
        ag0 = 0.0f;
        ag1 = 0.0f;
      }
      if (!live[k]) continue;
      float alpha;
      if (a.alpha_func == kAlphaProd) {
        alpha = 1.0f - Am;
      } else if (a.alpha_func == kAlphaSum) {
        alpha = Am / (float)a.F;  // divided by the total face count, once
      } else {
        alpha = Am;
      }
      const size_t px = (size_t)(band_y * a.tile_h + ly + 4 * k) * is   // the band's own row
                        + tile_x * a.tile_w + lx;
      float* img = a.image + (size_t)b * 4 * HW + px;
      img[0] = rgb[0];
      img[HW] = rgb[1];
      img[2 * HW] = rgb[2];
      img[3 * HW] = alpha;
      float* ag = a.aggrs + (size_t)b * 2 * HW + px;
      ag[0] = ag0;
      ag[HW] = ag1;
      a.counts[(size_t)b * HW + px] = cm;
    }
  } else if constexpr (THR == kThrBisect) {
    // every rank needs the pixels' whole counts to take the bisection's steps
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      int cm = 0;
#pragma unroll
      for (int r = 0; r < kTileSplit; ++r) {
        if (r >= active) break;
        cm += __float_as_int(r == rank ? v[k][6]
                                       : cluster.map_shared_rank(st, r)[6 * kTilePix + tid + k * nth]);
      }
      total_cnt[k] = cm;
    }
  }
#undef STATE

  float thr[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) thr[k] = s.far;
  if constexpr (THR == kThrList) {
    if (rank == 0) {
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!(live[k] && total_cnt[k] > a.K)) continue;
        const int q = tid + k * nth;
        for (int r = 1; r < active; ++r) {
          const float* dr = cluster.map_shared_rank(own, r) + q;
          const int nr = cluster.map_shared_rank(nlist, r)[q];
          // kTileMergeBatch remote depths in flight at once, then inserted
          for (int i0 = 0; i0 < nr; i0 += kTileMergeBatch) {
            float z[kTileMergeBatch];
#pragma unroll
            for (int i = 0; i < kTileMergeBatch; ++i)
              z[i] = i0 + i < nr ? dr[(i0 + i) * kTilePix] : 0.0f;
#pragma unroll
            for (int i = 0; i < kTileMergeBatch; ++i)
              if (i0 + i < nr) list[k](z[i]);
          }
        }
        thr[k] = list[k].dmax;
      }
    }
  }
  if (merge) cluster.sync();  // rank 0 has read every rank's state and lists
  if (THR != kThrBisect && rank != 0) return;

  if constexpr (THR == kThrBisect) {
    // the smallest key with at least K candidates at or below it: the
    // invariant count(<= lo - 1) < K <= count(<= hi) holds from the start,
    // every candidate lying in [near, far].  Every rank of the cluster
    // holds the same counts, so all take the same branches and barriers.
    int* const cbuf = reinterpret_cast<int*>(own);  // [2, kTilePix]
    bool need = false;
    unsigned klo[PPT], khi[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      need |= live[k] && total_cnt[k] > a.K;
      klo[k] = a.bis_lo;
      khi[k] = a.bis_hi;
    }
    if (__syncthreads_or(need)) {
      for (int it = 0; it < a.bis_iters; ++it) {
        bool open = false;
        unsigned mid[PPT];
        int below[PPT];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          mid[k] = klo[k] + (khi[k] - klo[k]) / 2u;
          below[k] = 0;
          open |= live[k] && total_cnt[k] > a.K && klo[k] < khi[k];
        }
        if (!__syncthreads_or(open)) break;
        tile_walk(rows_b, a.row, a.entries + e0 + lo, len, kGeomRow, a.chunk, smem,
                  [&](const float* r, int) {
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            if (!(live[k] && total_cnt[k] > a.K && klo[k] < khi[k])) continue;
            PairTerms t;
            if (!pair_terms<DIST>(r, xp[k], yp[k], s, &t)) continue;
            below[k] += (t.tk_valid && depth_key(t.zp) <= mid[k]) ? 1 : 0;
          }
        });
        if (merge) {
          int* const buf = cbuf + (it & 1) * kTilePix;
#pragma unroll
          for (int k = 0; k < PPT; ++k) buf[tid + k * nth] = below[k];
          cluster.sync();   // every rank's count of this step is written
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            int sum = 0;
            for (int r = 0; r < active; ++r)
              sum += cluster.map_shared_rank(buf, r)[tid + k * nth];
            below[k] = sum;
          }
        }
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!(total_cnt[k] > a.K && klo[k] < khi[k])) continue;
          if (below[k] >= a.K) {
            khi[k] = mid[k];
          } else {
            klo[k] = mid[k] + 1u;
          }
        }
      }
      if (merge) cluster.sync();  // every rank has read the last step's counts
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (total_cnt[k] > a.K) thr[k] = key_depth(khi[k]);
    }
    if (rank != 0) return;
  }

  if (THR != kThrNone) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      if (!live[k]) continue;
      const size_t px = (size_t)(band_y * a.tile_h + ly + 4 * k) * is + tile_x * a.tile_w + lx;
      a.thr[(size_t)b * HW + px] = thr[k];
    }
  }
}

// static: its `checked` must be this library's own, not one shared with a
// variant build (a static local of a function with external linkage is one
// symbol across every library loaded).  Launch a block per part of a tile
// (tile_part_w x tile_part_h pixels, 2 a thread) and a cluster of
// kTileSplit blocks on each part.
template <int DIST, int RGB, int THR>
static int tile_fwd_launch(const TileFwdArgs& a, cudaStream_t stream) {
  const auto kernel = softras_tile_fwd_kernel<DIST, RGB, THR>;
  const int pw = tile_part_w(a.tile_w), ph = tile_part_h(a.tile_h);
  const int threads = pw * ph / kTilePPT;
  const int parts = ((a.tile_w + pw - 1) / pw) * ((a.tile_h + ph - 1) / ph);
  const size_t smem = tile_fwd_smem(a.chunk, a.row, THR, a.K);
  if (a.ty_band < 1 || a.tile_h % 8 || a.tile_w % 8 || a.chunk < 1 ||
      a.chunk > kTileMaxChunk || a.chunk > 32 * (threads / 32) || smem > kTileSmemMax)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.tiles_x * parts * kTileSplit, a.ty_band, a.B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kTileSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once per (shared-memory size, block size): past 48 KB the kernel must
  // ask for it; can a cluster of kTileSplit such blocks be resident on one
  // GPC?
  static size_t checked = 0;
  static int checked_threads = 0;
  if (checked != smem || checked_threads != threads) {
    cudaError_t err = cudaSuccess;
    if (smem > kTileSmemDefault)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kTileNoCluster;
    checked = smem;
    checked_threads = threads;
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int DIST, int THR>
int tile_fwd_launch_rgb(const TileFwdArgs& a, cudaStream_t stream) {
  switch (a.rgb_func) {
    case kRgbHard: return tile_fwd_launch<DIST, kRgbHard, THR>(a, stream);
    case kRgbSoftmax: return tile_fwd_launch<DIST, kRgbSoftmax, THR>(a, stream);
    default: return tile_fwd_launch<DIST, 2, THR>(a, stream);
  }
}

template <int THR>
int tile_fwd_dispatch(const TileFwdArgs& a, cudaStream_t stream) {
  switch (a.dist_func) {
    case kDistHard: return tile_fwd_launch_rgb<kDistHard, THR>(a, stream);
    case kDistBary: return tile_fwd_launch_rgb<kDistBary, THR>(a, stream);
    default: return tile_fwd_launch_rgb<kDistEuclid, THR>(a, stream);
  }
}

}  // namespace softras
