// SoftRas forward kernel for Hopper (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pxt_impl.py
// _make_fwd_kernel_pxt (:370, launched at :758 by soft_rasterize_fwd_pxt),
// without its top-K threshold (with_thr), which softras_thr.cu computes.
// It computes what that kernel computes, not its TPU layout: there are no
// 128-lane work items, tile blocks, ring slabs or 0/1 matrix products.
//
// What bounds it.  The function's work is the pair math of every (pixel,
// face) pair of a tile's list (chip_smoke.py counts it from its run).  What
// bounded the first design, one block per tile walking the tile's whole
// list, was the uneven load: at 1024^2 on the 39,474-face sphere the
// busiest tile holds 1,158 faces against a mean of 127, and its one block
// took 1.67 of the kernel's 1.82 ms while the other SMs idled.  A block of
// 8 warps also waited on each chunk's rows, gathered by the threads that
// then computed on them, behind three block barriers.
//
// Design.  One thread-block cluster of kSplit blocks per (screen tile,
// batch element); a block of 256 threads, one thread per pixel, each warp
// an 8 x 4 block of pixels (pixels past a ragged image edge only help
// stage data).  A tile's list is one sequence of gcount + run face ids: the
// big faces of the binning's global list (an id whose tile range misses
// this tile is skipped), then the tile's sorted run.  Rank r of the
// cluster walks the contiguous share [r * per, (r + 1) * per) of it, per =
// ceil(total / kSplit), so the busiest tile's list is walked by kSplit SMs
// at once; a rank whose share is empty does not walk.
//  Staging: chunks of a share's faces have their rows (face 9, inv 9,
//    sym 9, obt 3, front 1, tex 3T) copied into shared memory with cp.async,
//    double-buffered: chunk c + 1's copies are in flight while the threads
//    compute on chunk c, with one block barrier per chunk.  Warp w copies
//    the rows of faces w, w + 8, ... of a chunk, its lanes along a row,
//    from ids its lanes loaded one chunk ahead, so no barrier stands
//    between reading an id and copying its row.  Every thread then reads
//    the same row, a broadcast.
//  Partial states: each thread keeps, for its rank's share, what the pxg
//    partials keep (softras_pxg_fwd.cu, pxg_impl.fwd_partials_plain): the
//    online softmax's numerators, S and M without the background (M =
//    -1e30 without a candidate), rescaled when the max rises; for hard rgb
//    the winner's colour, depth and id (the lowest id on a depth tie);
//    alpha as a product, a sum or a max; the candidate count.
//  Merge: the ranks write their states to their own shared memory; after
//    a cluster barrier rank 0 reads them through distributed shared memory,
//    in rank order, and merges them by the pxg combine's rule
//    (softras_pxg_combine_kernel, pxg_impl.combine_plain): M = max(eps,
//    M_r), each share scaled by exp((M_r - M) / gamma), the background term
//    exp((eps - M) / gamma) once; hard rgb the least depth and the lowest
//    id among equal depths, across ranks too; alpha 1 - product, sum / F
//    or max; counts summed.  A second cluster barrier keeps every block
//    resident until rank 0 has read its state.  A tile whose list has at
//    most one face (or none) has one rank at work, which writes its result
//    with no barrier or merge.  Rank 0 writes the final image, aggregates
//    and counts, background and initial values included, so no assembly
//    pass follows.
// The grid is fixed by the image size, so nothing waits on the host.  No
// atomics: the output is deterministic; counts and hard winners equal the
// unsplit walk's, sums move by rounding.  Lists have no cap.
//
// Bands (pixel-band sharding, the band arguments ty0, ty_band, ty_stride
// of soft_rasterize_fwd_pxt, pxt_impl.py:717): the grid's y runs over the
// band's ty_band tile rows, row k being tile row ty0 + k * ty_stride; the
// pixel centres are the image rows', the outputs band-local maps of
// band_h rows (band row k * 16 + i).  A tile's walk does not depend on
// the band, so a band's maps are the whole image's rows, bit for bit; the
// whole image is the band (0, tiles_y, 1) with band_h = H.
//
// Bound.  At 1024^2 on the 39,474-face sphere the tile lists pair 38 M
// (pixel, face) pairs, but only about a quarter lie in the face's
// inflated bbox, and fewer pass the distance cut: the work the function
// needs is some 1.7 GFLOP of fp32 on the CUDA cores against roughly 47 MB
// of face rows, lists and outputs, so operations bound it (chip_smoke.py
// counts both from its run).  A pair outside the bbox costs a bbox test;
// each face row is read once per tile.  What the split costs: kSplit
// blocks per tile each pay a block's fixed cost, and a cluster holds its
// blocks' slots until its slowest rank is done.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "softras_pair.cuh"

// The blocks that share one tile's list, a compile-time constant (PERF.md
// has the times of 2, 4 and 8).
#ifndef SOFTRAS_FWD_SPLIT
#define SOFTRAS_FWD_SPLIT 8
#endif

namespace softras {

namespace cg = cooperative_groups;

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 64;                 // faces of a staged chunk, at most
constexpr int kPerWarp = kMaxChunk / kWarps;  // faces a warp stages per chunk
constexpr int kSplit = SOFTRAS_FWD_SPLIT;
// blocks an SM holds at once: the register cap (64 a thread) that lets 4
// blocks of 48 KB share an SM keeps more warps to hide the staging latency
constexpr int kMinBlocks = 4;
constexpr int kState = 7;                     // channels of a partial state
constexpr float kNoMax = -1e30f;              // M of a share without a candidate
constexpr int kNoCluster = -1;                // the cluster cannot be resident
constexpr size_t kSmemDefault = 48 * 1024;    // dynamic shared memory without asking
static_assert(kSplit >= 1 && kSplit <= 8, "a portable cluster holds 1 to 8 blocks");

struct FwdArgs {
  const float* rows;         // [B, F, row]
  const int* faces_sorted;   // [B, L] face ids sorted by (tile, face)
  const int* starts;         // [B, NT] offset of each tile's run
  const int* run_counts;     // [B, NT] length of each tile's run
  const int* glist;          // [B, F] big-face ids, ascending
  const int* gcount;         // [B] valid glist entries
  const int* ranges;         // [B, F, 4] (ty_min, ty_max, tx_min, tx_max)
  float* image;              // [B, 4, H, W]
  float* aggrs;              // [B, 2, H, W]
  int* counts;               // [B, H, W]
  int B, F, L, row, image_size, tiles_x, tiles_y, chunk;
  int dist_func, rgb_func, alpha_func;
  int ty0, ty_band, ty_stride, band_h;  // the band of tile rows, its maps' rows
  Scalars s;
};

// Where a tile's sequence of face ids lies.
struct TileList {
  const int* glist;   // the batch element's big faces
  const int* ranges;  // their tile ranges
  const int* run;     // the tile's sorted run
  int gcount, tile_x, tile_y;

  // the pos-th id: a big face (-1 where its tile range misses this tile),
  // then the run
  __device__ __forceinline__ int at(int pos) const {
    if (pos >= gcount) return run[pos - gcount];
    const int g = glist[pos];
    const int* rg = ranges + (size_t)g * 4;
    return (tile_y >= rg[0] && tile_y <= rg[1] && tile_x >= rg[2] && tile_x <= rg[3]) ? g : -1;
  }
};

// Lane q < kPerWarp of warp w: the id of face w + kWarps * q of the chunk
// of n faces at `base`, or -1.
__device__ __forceinline__ int chunk_ids(const TileList& tl, int base, int n, int warp,
                                         int lane) {
  const int j = warp + kWarps * lane;
  return (lane < kPerWarp && j < n) ? tl.at(base + j) : -1;
}

// Warp w copies the rows of faces w, w + kWarps, ... of a chunk of n faces
// (ids from chunk_ids) into srow / sid with cp.async, and commits them as
// one group.
__device__ __forceinline__ void stage(const float* rows_b, int row, float* srow, int* sid,
                                      int n, int ids, int warp, int lane) {
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    const int j = warp + kWarps * q;
    const int id = __shfl_sync(0xffffffffu, ids, q);
    if (j < n) {
      if (lane == 0) sid[j] = id;
      if (id >= 0) {
        const float* src = rows_b + (size_t)id * row;
        float* dst = srow + j * row;
        for (int k = lane; k < row; k += 32) __pipeline_memcpy_async(dst + k, src + k, 4);
      }
    }
  }
  __pipeline_commit();
}

template <int DIST, int RGB>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    softras_fwd_kernel(const FwdArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  // each warp takes an 8 x 4 block of the tile's pixels: a small face's
  // inflated bbox meets fewer such warps than 16 x 2 rows, and a warp
  // whose pixels all miss a face's bbox skips that face at once
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int px_t = ty * kTile + tx;                 // the pixel's place in a state row
  const int rank = blockIdx.x % kSplit;             // this_cluster().block_rank()
  const int tile_x = blockIdx.x / kSplit, b = blockIdx.z;
  const int tile_y = a.ty0 + blockIdx.y * a.ty_stride;  // the band's row blockIdx.y
  const int col = tile_x * kTile + tx;
  const int rowp = tile_y * kTile + ty;             // the image row
  const int lrow = blockIdx.y * kTile + ty;         // its row in the band's maps
  const int is = a.image_size;
  const bool live = col < is && rowp < is;
  const float isf = (float)is;
  // the plain version's pixel centres, (2c+1-is)/is and (is-1-2r)/is
  const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
  const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
  const Scalars& s = a.s;
  cg::cluster_group cluster = cg::this_cluster();

  const int NT = a.tiles_x * a.tiles_y;
  const int tile = tile_y * a.tiles_x + tile_x;
  const TileList tl{a.glist + (size_t)b * a.F, a.ranges + (size_t)b * a.F * 4,
                    a.faces_sorted + (size_t)b * a.L + a.starts[b * NT + tile],
                    a.gcount[b], tile_x, tile_y};
  const int total = tl.gcount + a.run_counts[b * NT + tile];
  // rank r's share [r * per, (r + 1) * per); `active` ranks have one
  const int per = (total + kSplit - 1) / kSplit;
  const int active = total > 0 ? (total + per - 1) / per : 1;
  const bool merge = active > 1;
  if (rank >= active) {
    // nothing to walk; rank 0 does not read this block's state, but every
    // block of the cluster takes part in its barriers
    if (merge) {
      cluster.sync();
      cluster.sync();
    }
    return;
  }
  const int lo = rank * per, len = min(total, lo + per) - lo;
  const float* rows_b = a.rows + (size_t)b * a.F * a.row;
  const int chunk = a.chunk, row = a.row;
  // two buffers: rows [2, chunk, row], then ids [2, chunk]
  int* const sid0 = reinterpret_cast<int*>(smem + 2 * chunk * row);

  // the share's partial state
  float S = 0.0f, M = kNoMax, n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;  // softmax
  float dmin = kBigDepth, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;      // hard rgb
  int win = -1;
  float A = a.alpha_func == kAlphaProd ? 1.0f : 0.0f;
  int cnt = 0;

  const int nch = (len + chunk - 1) / chunk;
  if (nch > 0)
    stage(rows_b, row, smem, sid0, min(chunk, len), chunk_ids(tl, lo, min(chunk, len), warp, lane),
          warp, lane);
  int ids_next = nch > 1 ? chunk_ids(tl, lo + chunk, min(chunk, len - chunk), warp, lane) : -1;
  for (int c = 0; c < nch; ++c) {
    const int cur = c & 1;
    const int n = min(chunk, len - c * chunk);
    const float* srow = smem + cur * chunk * row;
    const int* sid = sid0 + cur * chunk;
    __pipeline_wait_prior(0);
    // chunk c's rows and ids are in; every thread is done with chunk c - 1,
    // whose buffers chunk c + 1 takes
    __syncthreads();
    if (c + 1 < nch) {
      stage(rows_b, row, smem + (cur ^ 1) * chunk * row, sid0 + (cur ^ 1) * chunk,
            min(chunk, len - (c + 1) * chunk), ids_next, warp, lane);
      ids_next = c + 2 < nch ? chunk_ids(tl, lo + (c + 2) * chunk,
                                         min(chunk, len - (c + 2) * chunk), warp, lane)
                             : -1;
    }
    if (!live) continue;

    for (int j = 0; j < n; ++j) {
      const int fid = sid[j];
      if (fid < 0) continue;  // a big face outside this tile
      const float* r = srow + j * row;
      PairTerms t;
      // false: outside the inflated bbox or past the distance cut, where
      // the pair changes no accumulator
      if (!pair_terms<DIST>(r, xp, yp, s, &t)) continue;

      if (a.alpha_func == kAlphaProd) {
        A *= 1.0f - t.sf;
      } else if (a.alpha_func == kAlphaSum) {
        A += t.sf;
      } else if (t.sf > 0.5f) {
        A = 1.0f;
      }
      cnt += t.tk_valid ? 1 : 0;
      const bool side_ok = s.fill_back || r[kFront] > 0.5f;

      if (RGB == kRgbSoftmax) {
        if (t.tk_valid && side_ok) {
          const float zpn = (s.far - t.zp) / s.far_minus_near;
          if (zpn > M) {
            // the max rises: rescale what was summed under the old one
            const float sc = expf((M - zpn) / s.gamma);
            S *= sc;
            n0 *= sc;
            n1 *= sc;
            n2 *= sc;
            M = zpn;
          }
          const float e = expf((zpn - M) / s.gamma) * t.sf;
          float c[3];
          pair_color(r, t, s, c);
          S += e;
          n0 += e * c[0];
          n1 += e * c[1];
          n2 += e * c[2];
        }
      } else if (RGB == kRgbHard) {
        if (t.tk_valid && t.inside && side_ok &&
            (t.zp < dmin || (t.zp == dmin && fid < win))) {
          float c[3];
          pair_color(r, t, s, c);
          dmin = t.zp;
          win = fid;
          c0 = c[0];
          c1 = c[1];
          c2 = c[2];
        }
      }
    }
  }

  // the share's state: softmax (n0, n1, n2, S, M) or hard (c0, c1, c2,
  // depth, id), then alpha and the count's bits
  float v[kState] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, A, __int_as_float(cnt)};
  if (RGB == kRgbSoftmax) {
    v[0] = n0; v[1] = n1; v[2] = n2; v[3] = S; v[4] = M;
  } else if (RGB == kRgbHard) {
    v[0] = c0; v[1] = c1; v[2] = c2; v[3] = dmin; v[4] = (float)win;
  }
  float* st = smem;  // [kState, kThreads], over the staging buffers
  if (merge) {
    __syncthreads();  // every thread is done with the staging buffers
#pragma unroll
    for (int k = 0; k < kState; ++k) st[k * kThreads + px_t] = v[k];
    cluster.sync();   // every rank's state is written
    if (rank != 0) {
      cluster.sync(); // rank 0 has read it
      return;
    }
  }

  // rank 0 merges the ranks' states in rank order (its own from registers)
  const float* rs[kSplit];
#pragma unroll
  for (int r = 1; r < kSplit; ++r)
    rs[r] = r < active ? cluster.map_shared_rank(st, r) + px_t : nullptr;
#define STATE(r, k) ((r) == 0 ? v[k] : rs[r][(k) * kThreads])

  float Am = a.alpha_func == kAlphaProd ? 1.0f : 0.0f;
  int cm = 0;
#pragma unroll
  for (int r = 0; r < kSplit; ++r) {
    if (r >= active) break;
    const float ar = STATE(r, 5);
    if (a.alpha_func == kAlphaProd) {
      Am *= ar;
    } else if (a.alpha_func == kAlphaSum) {
      Am += ar;
    } else {
      Am = fmaxf(Am, ar);
    }
    cm += __float_as_int(STATE(r, 6));
  }
  float rgb[3], ag0, ag1;
  if (RGB == kRgbSoftmax) {
    float Mm = s.eps;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      if (r >= active) break;
      Mm = fmaxf(Mm, STATE(r, 4));
    }
    float sS = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      if (r >= active) break;
      const float sc = expf((STATE(r, 4) - Mm) / s.gamma);
      s0 += STATE(r, 0) * sc;
      s1 += STATE(r, 1) * sc;
      s2 += STATE(r, 2) * sc;
      sS += STATE(r, 3) * sc;
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
    for (int r = 0; r < kSplit; ++r) {
      if (r >= active) break;
      const float id = STATE(r, 4);
      if (id < 0.0f) continue;  // no winner in this share
      const float d = STATE(r, 3);
      if (!hit || d < dm || (d == dm && id < wm)) {
        hit = true;
        dm = d;
        wm = id;
        w0 = STATE(r, 0);
        w1 = STATE(r, 1);
        w2 = STATE(r, 2);
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
#undef STATE
  if (merge) cluster.sync();  // the other ranks may exit now
  if (!live) return;

  float alpha;
  if (a.alpha_func == kAlphaProd) {
    alpha = 1.0f - Am;
  } else if (a.alpha_func == kAlphaSum) {
    alpha = Am / (float)a.F;  // divided by the total face count, once
  } else {
    alpha = Am;
  }

  const size_t HW = (size_t)a.band_h * is;
  const size_t px = (size_t)lrow * is + col;
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

// static: its `checked` must be this library's own, not one shared with a
// variant build (a static local of a function with external linkage is one
// symbol across every library loaded)
template <int DIST, int RGB>
static int launch(const FwdArgs& a, cudaStream_t stream) {
  const auto kernel = softras_fwd_kernel<DIST, RGB>;
  const size_t stage_bytes = 2 * (size_t)a.chunk * (a.row + 1) * sizeof(float);
  const size_t state_bytes = (size_t)kState * kThreads * sizeof(float);
  const size_t smem = stage_bytes > state_bytes ? stage_bytes : state_bytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.tiles_x * kSplit, a.ty_band, a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once per shared-memory size: past 48 KB (a face row of many texels)
  // the kernel must ask for it; can a cluster of kSplit such blocks be
  // resident on one GPC?
  static size_t checked = 0;
  if (checked != smem) {
    cudaError_t err = cudaSuccess;
    if (smem > kSmemDefault)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kNoCluster;
    checked = smem;
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int DIST>
int launch_rgb(const FwdArgs& a, cudaStream_t stream) {
  switch (a.rgb_func) {
    case kRgbHard: return launch<DIST, kRgbHard>(a, stream);
    case kRgbSoftmax: return launch<DIST, kRgbSoftmax>(a, stream);
    default: return launch<DIST, 2>(a, stream);
  }
}

}  // namespace softras

extern "C" int softras_fwd(const softras::FwdArgs* args, void* stream) {
  using namespace softras;
  if (args->chunk < 1 || args->chunk > kMaxChunk || !band_ok(*args))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (args->dist_func) {
    case kDistHard: return launch_rgb<kDistHard>(*args, st);
    case kDistBary: return launch_rgb<kDistBary>(*args, st);
    default: return launch_rgb<kDistEuclid>(*args, st);
  }
}

extern "C" int softras_fwd_args_size() { return (int)sizeof(softras::FwdArgs); }

extern "C" int softras_fwd_split() { return softras::kSplit; }
