// SoftRas top-K threshold on the overfull tiles of the grouped (pxg)
// route, for Hopper (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pxg_impl.py
// _make_thr_kernel_pxg (:545, launched at :656 in _thr_from_depths :616):
// for each pixel of a tile where some pixel has more than K candidates,
// the K-th smallest candidate depth zp; `far` elsewhere (:670), which the
// backward reads as no cut.  The TPU forward stores every pair's depth
// bits for it (360 MB on the 39,474-face sphere, pxg_impl.py:549-552);
// here the forward keeps the K smallest per work item instead.
//
// Design.  One block of 16 x 16 threads per overfull tile (the wrapper
// compacts them from the combine's count map), one thread per pixel in the
// forward's 8 x 4 warps.
//  K <= 32: a thread merges its tile's items' lists of K smallest depths
//    ([W, K, 256], written by softras_pxg_fwd.cu) into softras_topk.cuh's
//    list of the K smallest; the K smallest of a union lie among the K
//    smallest of each part, so the result is exact.  The lists take 4 * K
//    bytes per pixel of every item: at K = 16 twice the partial rows.
//  K > 32: no lists; the block bisects on the depth's bits, 32 walks of the
//    tile's face list (staged geometry rows, as softras_thr.cu walks) that
//    count the candidates at or below a trial value.
// zp comes from clipped_depth() in softras_pair.cuh, in the forward as in
// the backward, so the map equals the binned route's to the bit.  No
// atomics: the map is deterministic.
//
// Bound.  K <= 32: the lists of the overfull tiles' items read once, the
// count map read and the threshold written for their pixels; a merge step
// per list entry.  K > 32: the binned threshold kernel's pair work on the
// overfull tiles, 32 times over.
#include <cuda_runtime.h>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

namespace softras {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kGeom = kTex;   // floats of a row that hold geometry

struct PxgThrArgs {
  const float* rows;      // [B, F, row]
  const int* entries;     // [E] face ids, tile after tile
  const int* tile_off;    // [B * NT + 1] first entry of each tile
  const int* item_off;    // [B * NT + 1] first item of each tile
  const float* depths;    // [W, K, 256] each item's K smallest depths, or null
  const int* tiles;       // [n_tiles] the overfull tiles (global ids)
  const int* counts;      // [B, H, W] candidates per pixel
  float* thr;             // [B, H, W]
  int n_tiles, F, row, image_size, tiles_x, chunk, K, dist_func;
  Scalars s;
};

template <int DIST>
__global__ void __launch_bounds__(kThreads)
    softras_pxg_thr_kernel(const PxgThrArgs a) {
  extern __shared__ float smem[];
  float* srow = smem;                                          // [chunk, 31]
  int* sid = reinterpret_cast<int*>(smem + a.chunk * kGeom);   // [chunk]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tile_g = a.tiles[blockIdx.x];
  const int NT = a.tiles_x * a.tiles_x;
  const int b = tile_g / NT, tile = tile_g - b * NT;
  const int tile_y = tile / a.tiles_x, tile_x = tile - tile_y * a.tiles_x;
  const int col = tile_x * kTile + tx;
  const int rowp = tile_y * kTile + ty;
  const int is = a.image_size;
  const bool live = col < is && rowp < is;
  const float isf = (float)is;
  const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
  const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
  const size_t px = (size_t)b * is * is + (size_t)rowp * is + col;
  const bool need = live && a.counts[px] > a.K;

  float thr = a.s.far;
  if (a.depths != nullptr) {
    SmallestK list;
    list.K = a.K;
    list.n = 0;
    list.imax = 0;
    const float inf = __int_as_float(0x7f800000);
    const float* d = a.depths + ty * kTile + tx;
    for (int i = a.item_off[tile_g]; i < a.item_off[tile_g + 1]; ++i)
      for (int k = 0; k < a.K; ++k) {
        const float z = d[((size_t)i * a.K + k) * kThreads];
        if (z < inf) list(z);
      }
    if (need) thr = list.d[list.imax];
  } else {
    // the smallest key with at least K candidates at or below it
    const int e0 = a.tile_off[tile_g], total = a.tile_off[tile_g + 1] - e0;
    const float* rows_b = a.rows + (size_t)b * a.F * a.row;
    unsigned lo = 0u, hi = 0xffffffffu;
    for (int it = 0; it < 32; ++it) {
      CountBelow c;
      c.trial = lo + (hi - lo) / 2u;
      c.count = 0;
      for (int base = 0; base < total; base += a.chunk) {
        const int n = min(a.chunk, total - base);
        __syncthreads();  // the previous chunk has been consumed
        if (tid < n) sid[tid] = a.entries[e0 + base + tid];
        __syncthreads();
        for (int i = tid; i < n * kGeom; i += kThreads) {
          const int j = i / kGeom;
          srow[i] = rows_b[(size_t)sid[j] * a.row + (i - j * kGeom)];
        }
        __syncthreads();
        if (!live) continue;
        for (int j = 0; j < n; ++j) {
          PairTerms t;
          if (!pair_terms<DIST>(srow + j * kGeom, xp, yp, a.s, &t)) continue;
          if (t.tk_valid) c(t.zp);
        }
      }
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
cudaError_t launch(const PxgThrArgs& a, cudaStream_t stream) {
  const size_t smem = a.depths != nullptr ? 0 : (size_t)a.chunk * (kGeom + 1) * sizeof(float);
  softras_pxg_thr_kernel<DIST><<<a.n_tiles, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace softras

extern "C" int softras_pxg_thr(const softras::PxgThrArgs* args, void* stream) {
  using namespace softras;
  if (args->n_tiles < 1 || args->K < 1 || (args->depths != nullptr && args->K > kListMax))
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

extern "C" int softras_pxg_thr_args_size() { return (int)sizeof(softras::PxgThrArgs); }
