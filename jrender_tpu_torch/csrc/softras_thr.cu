// SoftRas top-K threshold kernel for Hopper (sm_90a), plain C entry point.
//
// Replaces the with_thr part of the TPU forward kernel
// jrender_tpu/ops/softras/pxt_impl.py _make_fwd_kernel_pxt (:584-674): for
// each pixel, the K-th smallest depth zp among its candidate pairs
// (tk_valid), and `far` where the pixel has at most K candidates.  The
// backward sends gradient to the pairs with zp <= thr: the reference's
// top-K truncation (soft_rasterize.py:369-385) without a face-id buffer.
//
// Why a kernel of its own, not a flag of the forward.  Only a step that
// asks for a gradient needs the threshold, and only where it binds
// (grad_mode 'topk', K < F); a plain forward must not pay for it.  It
// reads 31 of a row's floats (no texels), needs no colour or softmax
// state, and holds K depths per thread, which in the forward kernel
// would cost every render its registers.  It reads the forward's
// candidate count map, so a tile where no pixel has more than K
// candidates writes `far` and returns without walking its list (the TPU
// kernel bisects "only overfull tiles", :667-674).
//
// Design.  The forward's decomposition: one block of 16 x 16 threads per
// (tile, batch element), one thread per pixel in 8 x 4 warps, walking the
// big-face list and the tile's sorted run with the geometry part of the
// face rows staged in shared memory.  A thread meets its candidates in
// sequence, so it does not bisect as the TPU does: it keeps the K
// smallest depths seen so far in a small unsorted list and the place of
// their maximum; a new depth below the maximum replaces it (then one scan
// of K finds the new maximum).  After the walk the maximum is the K-th
// smallest.  The list has room for kListMax depths; for a larger K the
// kernel bisects on the depth's bits instead, 32 walks that each count
// the candidates at or below a trial value, as the TPU kernel does.
// Ties: equal depths are all kept by `zp <= thr`, where the JAX oracle's
// stable sort keeps the lowest face ids only.  No atomics: the map is
// deterministic.  zp comes from clipped_depth() of softras_pair.cuh, so
// its bits are those the backward kernel compares with.
//
// Bound.  Bytes: 31 floats per face row, the lists, one count read and
// one float written per pixel.  Operations: the forward's pair math up to
// the depth for every pair of an overfull tile's list.  On the bench
// sphere operations bound it (chip_smoke.py computes both from its run).
#include <cuda_runtime.h>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

namespace softras {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kGeom = kTex;   // floats of a row that hold geometry

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
  Scalars s;
};

// Walks the tile's face list once; visit(zp) sees every candidate depth of
// this thread's pixel.  Every thread of the block must call it.
template <int DIST, class Visit>
__device__ __forceinline__ void walk_candidates(const ThrArgs& a, float* srow,
                                                int* sid, int tid, bool live,
                                                float xp, float yp,
                                                Visit& visit) {
  const int tile_x = blockIdx.x, tile_y = blockIdx.y, b = blockIdx.z;
  const int NT = a.tiles_x * a.tiles_y;
  const int tile = tile_y * a.tiles_x + tile_x;
  const int gcount = a.gcount[b];
  const int run = a.run_counts[b * NT + tile];
  const int start = a.starts[b * NT + tile];
  const int total = gcount + run;
  const float* rows_b = a.rows + (size_t)b * a.F * a.row;

  for (int base = 0; base < total; base += a.chunk) {
    const int n = min(a.chunk, total - base);
    __syncthreads();  // the previous chunk has been consumed
    if (tid < n) {
      const int pos = base + tid;
      int id;
      if (pos < gcount) {
        const int g = a.glist[(size_t)b * a.F + pos];
        const int* rg = a.ranges + ((size_t)b * a.F + g) * 4;
        id = (tile_y >= rg[0] && tile_y <= rg[1] && tile_x >= rg[2] &&
              tile_x <= rg[3]) ? g : -1;
      } else {
        id = a.faces_sorted[(size_t)b * a.L + start + (pos - gcount)];
      }
      sid[tid] = id;
    }
    __syncthreads();
    for (int i = tid; i < n * kGeom; i += kThreads) {
      const int j = i / kGeom;
      const int k = i - j * kGeom;
      const int id = sid[j];
      if (id >= 0) srow[i] = rows_b[(size_t)id * a.row + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      if (sid[j] < 0) continue;  // a big face outside this tile
      PairTerms t;
      if (!pair_terms<DIST>(srow + j * kGeom, xp, yp, a.s, &t)) continue;
      if (t.tk_valid) visit(t.zp);
    }
  }
}

template <int DIST>
__global__ void __launch_bounds__(kThreads)
    softras_thr_kernel(const ThrArgs a) {
  extern __shared__ float smem[];
  float* srow = smem;                                          // [chunk, 31]
  int* sid = reinterpret_cast<int*>(smem + a.chunk * kGeom);   // [chunk]

  const int tid = threadIdx.y * kTile + threadIdx.x;
  // the forward's pixel of this thread: 8 x 4 pixels per warp
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int col = blockIdx.x * kTile + tx;
  const int rowp = blockIdx.y * kTile + ty;
  const int is = a.image_size;
  const bool live = col < is && rowp < is;
  const float isf = (float)is;
  const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
  const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
  const size_t px = (size_t)blockIdx.z * is * is + (size_t)rowp * is + col;

  const bool need = live && a.counts[px] > a.K;
  // no pixel of the tile has more than K candidates: thr = far everywhere
  if (!__syncthreads_or(need)) {
    if (live) a.thr[px] = a.s.far;
    return;
  }

  float thr = a.s.far;
  if (a.K <= kListMax) {
    SmallestK list;
    list.K = a.K;
    list.n = 0;
    list.imax = 0;
    walk_candidates<DIST>(a, srow, sid, tid, live, xp, yp, list);
    if (need) thr = list.d[list.imax];
  } else {
    // the smallest key with at least K candidates at or below it
    unsigned lo = 0u, hi = 0xffffffffu;
    for (int it = 0; it < 32; ++it) {
      CountBelow c;
      c.trial = lo + (hi - lo) / 2u;
      c.count = 0;
      walk_candidates<DIST>(a, srow, sid, tid, live, xp, yp, c);
      if (c.count >= a.K) {
        hi = c.trial;
      } else {
        lo = c.trial + 1u;
      }
    }
    if (need) thr = key_depth(hi);
  }
  if (live) a.thr[px] = thr;
}

template <int DIST>
cudaError_t launch(const ThrArgs& a, cudaStream_t stream) {
  const dim3 grid(a.tiles_x, a.tiles_y, a.B);
  const dim3 block(kTile, kTile);
  const size_t smem = (size_t)a.chunk * (kGeom + 1) * sizeof(float);
  softras_thr_kernel<DIST><<<grid, block, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace softras

extern "C" int softras_thr(const softras::ThrArgs* args, void* stream) {
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

extern "C" int softras_thr_args_size() { return (int)sizeof(softras::ThrArgs); }
