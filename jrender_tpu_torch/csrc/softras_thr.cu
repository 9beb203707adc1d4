// SoftRas top-K threshold kernel for Hopper (sm_90a), plain C entry point.
//
// Replaces the with_thr part of the TPU forward kernel
// jrender_tpu/ops/softras/pxt_impl.py _make_fwd_kernel_pxt (:584-674): for
// each pixel, the K-th smallest depth zp among its candidate pairs
// (tk_valid), counted with multiplicity, and `far` where the pixel has at
// most K candidates.  The backward sends gradient to the pairs with zp <=
// thr: the reference's top-K truncation (soft_rasterize.py:369-385)
// without a face-id buffer.
//
// Why a kernel of its own, not a flag of the forward.  Only a step that
// asks for a gradient needs the threshold, and only where it binds
// (grad_mode 'topk', K < F); a plain forward must not pay for it.  It
// reads 31 of a row's floats (no texels), needs no colour or softmax
// state, and holds K depths per pixel, which in the forward kernel would
// cost every render its registers.  It reads the forward's candidate count
// map: a tile where no pixel has more than K candidates writes `far` and
// returns without walking its list (the TPU kernel bisects "only overfull
// tiles", :667-674), and a pixel with at most K candidates skips the pair
// math of the walk.
//
// What bounded the first design, one block per tile walking the tile's
// whole list, was the uneven load, as in the forward: at 1024^2 on the
// 39,474-face sphere the busiest tile (1,158 faces against a mean of 127)
// took 1.46 of the kernel's 1.61 ms.  Its per-thread K-smallest list sat in
// local memory (an array indexed at run time).
//
// Design: the forward's cluster split (softras_fwd.cu).  One thread-block
// cluster of kSplit blocks per (screen tile, batch element), a block of 256
// threads, one thread per pixel, each warp an 8 x 4 block of pixels.  Rank
// r walks the contiguous share [r * per, (r + 1) * per), per =
// ceil(total / kSplit), of the tile's sequence (big faces, then the run;
// cuda_impl.rank_shares), its rows' geometry staged in shared memory with
// cp.async, double-buffered.  zp comes from clipped_depth() of
// softras_pair.cuh, so its bits are those the backward compares with.
//  K <= kListMax: each thread keeps the K smallest depths of its share in
//    shared memory, list[i][256] (a warp's lanes on distinct banks), with
//    their count and the place and value of their maximum in registers; a
//    depth below the maximum replaces it, and one scan of K finds the next.
//    The K smallest of a union lie among the K smallest of each part, so
//    after one cluster barrier rank 0 inserts the other ranks' lists, read
//    through distributed shared memory, into its own: the maximum is then
//    the K-th smallest of the tile's whole sequence, to the bit (only the
//    value is kept, so the order of ties does not matter).  A second
//    cluster barrier keeps every block resident until rank 0 has read it.
//  K > kListMax: the depth's bits are bisected, 32 rounds in which every
//    rank counts the candidates of its share at or below the trial value;
//    the counts are integers, summed across the ranks through distributed
//    shared memory after one cluster barrier a round (two count buffers,
//    so a rank may write the next round's count while another reads this
//    one's), so every rank takes the same step and the result is exact.
//  A tile whose sequence has at most one face has one rank at work, which
//    writes its result with no barrier or merge.  Every rank of a cluster
//    reads the same count map, so all take the early exit alike and none
//    leaves while another waits at a cluster barrier.
// Bands: K1's (softras_fwd.cu): the grid runs over the band's tile rows,
// the count map read and the threshold map written are the band's.
// Ties: equal depths are all kept by `zp <= thr`, where the JAX oracle's
// stable sort keeps the lowest face ids only.  No atomics: the map is
// deterministic, and equal for any number of blocks per tile.
//
// Bound.  Bytes: 31 floats per face row, the lists, one count read and
// one float written per pixel.  Operations: the forward's pair math up to
// the depth for every pair of an overfull tile's list.  On the bench
// sphere operations bound it (chip_smoke.py computes both from its run).
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

// The blocks that share one tile's list: K1's split (softras_fwd.cu).
#ifndef SOFTRAS_FWD_SPLIT
#define SOFTRAS_FWD_SPLIT 8
#endif

namespace softras {

namespace cg = cooperative_groups;

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kGeom = kTex;                   // floats of a row that hold geometry
constexpr int kMaxChunk = 64;                 // faces of a staged chunk, at most
constexpr int kPerWarp = kMaxChunk / kWarps;  // faces a warp stages per chunk
constexpr int kSplit = SOFTRAS_FWD_SPLIT;
constexpr int kMinBlocks = 4;                 // 48 KB a block at most: 4 an SM
constexpr int kNoCluster = -1;                // the cluster cannot be resident
constexpr int kMergeBatch = 8;                // remote depths a merge reads at once
static_assert(kSplit >= 1 && kSplit <= 8, "a portable cluster holds 1 to 8 blocks");

struct ThrArgs {
  const float* rows;         // [B, F, row]
  const int* faces_sorted;   // [B, L]
  const int* starts;         // [B, NT]
  const int* run_counts;     // [B, NT]
  const int* glist;          // [B, F]
  const int* gcount;         // [B]
  const int* ranges;         // [B, F, 4]
  const int* counts;         // [B, H, W] candidates per pixel (the forward's)
  float* thr;                // [B, H, W]
  int B, F, L, row, image_size, tiles_x, tiles_y, chunk;
  int dist_func, K;
  int ty0, ty_band, ty_stride, band_h;  // the band of tile rows, its maps' rows
  Scalars s;
};

// Where a tile's sequence of face ids lies (softras_fwd.cu's TileList).
struct TileList {
  const int* glist;
  const int* ranges;
  const int* run;
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

// Warp w copies the geometry of faces w, w + kWarps, ... of a chunk of n
// faces (ids from chunk_ids) into srow [chunk, kGeom] / sid with cp.async,
// and commits them as one group.
__device__ __forceinline__ void stage(const float* rows_b, int row, float* srow, int* sid,
                                      int n, int ids, int warp, int lane) {
#pragma unroll
  for (int q = 0; q < kPerWarp; ++q) {
    const int j = warp + kWarps * q;
    const int id = __shfl_sync(0xffffffffu, ids, q);
    if (j < n) {
      if (lane == 0) sid[j] = id;
      if (id >= 0 && lane < kGeom)
        __pipeline_memcpy_async(srow + j * kGeom + lane, rows_b + (size_t)id * row + lane, 4);
    }
  }
  __pipeline_commit();
}

// Walks the share [lo, lo + len) of the tile's sequence once; visit(zp)
// sees every candidate depth of this thread's pixel where `work`.  Every
// thread of the block must call it.
template <int DIST, class Visit>
__device__ __forceinline__ void walk_share(const ThrArgs& a, const TileList& tl, int lo,
                                           int len, float* stage_buf, bool work, float xp,
                                           float yp, int warp, int lane, Visit& visit) {
  const int chunk = a.chunk;
  const float* rows_b = a.rows + (size_t)blockIdx.z * a.F * a.row;
  int* const sid0 = reinterpret_cast<int*>(stage_buf + 2 * chunk * kGeom);
  const int nch = (len + chunk - 1) / chunk;
  if (nch == 0) return;
  stage(rows_b, a.row, stage_buf, sid0, min(chunk, len),
        chunk_ids(tl, lo, min(chunk, len), warp, lane), warp, lane);
  int ids_next = nch > 1 ? chunk_ids(tl, lo + chunk, min(chunk, len - chunk), warp, lane) : -1;
  for (int c = 0; c < nch; ++c) {
    const int cur = c & 1;
    const int n = min(chunk, len - c * chunk);
    const float* srow = stage_buf + cur * chunk * kGeom;
    const int* sid = sid0 + cur * chunk;
    __pipeline_wait_prior(0);
    // chunk c is in; every thread is done with chunk c - 1, whose buffers
    // chunk c + 1 takes
    __syncthreads();
    if (c + 1 < nch) {
      stage(rows_b, a.row, stage_buf + (cur ^ 1) * chunk * kGeom, sid0 + (cur ^ 1) * chunk,
            min(chunk, len - (c + 1) * chunk), ids_next, warp, lane);
      ids_next = c + 2 < nch ? chunk_ids(tl, lo + (c + 2) * chunk,
                                         min(chunk, len - (c + 2) * chunk), warp, lane)
                             : -1;
    }
    if (!work) continue;
    for (int j = 0; j < n; ++j) {
      if (sid[j] < 0) continue;  // a big face outside this tile
      PairTerms t;
      if (!pair_terms<DIST>(srow + j * kGeom, xp, yp, a.s, &t)) continue;
      if (t.tk_valid) visit(t.zp);
    }
  }
  __syncthreads();  // the staging buffers are free again
}

template <int DIST>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    softras_thr_kernel(const ThrArgs a) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int rank = blockIdx.x % kSplit;             // this_cluster().block_rank()
  const int tile_x = blockIdx.x / kSplit, b = blockIdx.z;
  const int tile_y = a.ty0 + blockIdx.y * a.ty_stride;  // the band's row blockIdx.y
  const int col = tile_x * kTile + tx;
  const int rowp = tile_y * kTile + ty;             // the image row
  const int lrow = blockIdx.y * kTile + ty;         // its row in the band's maps
  const int is = a.image_size;
  const bool live = col < is && rowp < is;
  const float isf = (float)is;
  const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
  const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
  const size_t px = (size_t)b * a.band_h * is + (size_t)lrow * is + col;

  const bool need = live && a.counts[px] > a.K;
  // no pixel of the tile has more than K candidates: thr = far everywhere.
  // Every rank reads the same counts, so the whole cluster leaves here.
  if (!__syncthreads_or(need)) {
    if (rank == 0 && live) a.thr[px] = a.s.far;
    return;
  }
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
  const int lo = min(rank * per, total), len = min(total, lo + per) - lo;
  float* const stage_buf = smem;                    // rows [2, chunk, kGeom], ids [2, chunk]
  float* const own = smem + 2 * a.chunk * (kGeom + 1);

  float thr = a.s.far;
  if (a.K <= kListMax) {
    // own: the list [K, kThreads], then each thread's count [kThreads]
    if (rank >= active) {
      // nothing to walk; rank 0 reads no state of this block, but every
      // block of the cluster takes part in its barriers
      if (merge) {
        cluster.sync();
        cluster.sync();
      }
      return;
    }
    int* const nlist = reinterpret_cast<int*>(own + a.K * kThreads);
    SharedSmallestK<kThreads> list{own + tid, a.K, 0, 0, 0.0f};
    walk_share<DIST>(a, tl, lo, len, stage_buf, need, xp, yp, warp, lane, list);
    if (merge) {
      nlist[tid] = list.n;
      cluster.sync();   // every rank's list is written
      if (rank != 0) {
        cluster.sync(); // rank 0 has read it
        return;
      }
      if (need) {
        for (int r = 1; r < active; ++r) {
          const float* dr = cluster.map_shared_rank(own, r) + tid;
          const int nr = cluster.map_shared_rank(nlist, r)[tid];
          // kMergeBatch remote depths in flight at once, then inserted
          for (int i0 = 0; i0 < nr; i0 += kMergeBatch) {
            float z[kMergeBatch];
#pragma unroll
            for (int i = 0; i < kMergeBatch; ++i)
              z[i] = i0 + i < nr ? dr[(i0 + i) * kThreads] : 0.0f;
#pragma unroll
            for (int i = 0; i < kMergeBatch; ++i)
              if (i0 + i < nr) list(z[i]);
          }
        }
      }
      cluster.sync();   // the other ranks may exit now
    }
    if (need) thr = list.dmax;
  } else {
    // the smallest key with at least K candidates at or below it; own:
    // two count buffers [2, kThreads]
    int* const cnt = reinterpret_cast<int*>(own);
    unsigned klo = 0u, khi = 0xffffffffu;
    for (int it = 0; it < 32; ++it) {
      CountBelow c;
      c.trial = klo + (khi - klo) / 2u;
      c.count = 0;
      walk_share<DIST>(a, tl, lo, len, stage_buf, need, xp, yp, warp, lane, c);
      int sum = c.count;
      if (merge) {
        int* const buf = cnt + (it & 1) * kThreads;
        buf[tid] = c.count;
        cluster.sync();   // every rank's count of this round is written
        sum = 0;
        for (int r = 0; r < active; ++r) sum += cluster.map_shared_rank(buf, r)[tid];
      }
      if (sum >= a.K) {
        khi = c.trial;
      } else {
        klo = c.trial + 1u;
      }
    }
    if (merge) cluster.sync();  // every rank has read the last round's counts
    if (rank != 0) return;
    if (need) thr = key_depth(khi);
  }
  if (live) a.thr[px] = thr;
}

// Dynamic shared memory of a block: the staging buffers, then the lists
// and their counts (K <= kListMax) or two count buffers.
__host__ __device__ inline size_t thr_smem_bytes(int chunk, int K) {
  const size_t stage = 2 * (size_t)chunk * (kGeom + 1) * sizeof(float);
  const size_t own = K <= kListMax ? (size_t)(K + 1) * kThreads * sizeof(float)
                                   : 2 * (size_t)kThreads * sizeof(int);
  return stage + own;
}

// static: its `checked` must be this library's own, not one shared with a
// variant build (a static local of a function with external linkage is one
// symbol across every library loaded)
template <int DIST>
static int launch(const ThrArgs& a, cudaStream_t stream) {
  const auto kernel = softras_thr_kernel<DIST>;
  const size_t smem = thr_smem_bytes(a.chunk, a.K);
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
  // once per shared-memory size: can a cluster of kSplit such blocks be
  // resident on one GPC?
  static size_t checked = 0;
  if (checked != smem) {
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return kNoCluster;
    checked = smem;
  }
  return (int)cudaLaunchKernelEx(&cfg, kernel, a);
}

}  // namespace softras

extern "C" int softras_thr(const softras::ThrArgs* args, void* stream) {
  using namespace softras;
  if (args->chunk < 1 || args->chunk > kMaxChunk || args->K < 1 || !band_ok(*args) ||
      thr_smem_bytes(args->chunk, args->K) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (args->dist_func) {
    case kDistHard: return launch<kDistHard>(*args, st);
    case kDistBary: return launch<kDistBary>(*args, st);
    default: return launch<kDistEuclid>(*args, st);
  }
}

extern "C" int softras_thr_args_size() { return (int)sizeof(softras::ThrArgs); }

extern "C" int softras_thr_split() { return softras::kSplit; }
