// SoftRas top-K threshold of the grouped (pxg) route, for Hopper (sm_90a),
// with a plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pxg_impl.py
// _make_thr_kernel_pxg (:545, launched at :656 in _thr_from_depths :616):
// for each pixel of a tile where some pixel has more than K candidates,
// the K-th smallest candidate depth zp; `far` elsewhere (:670), which the
// backward reads as no cut.  The TPU forward stores every pair's depth
// bits for it (360 MB on the 39,474-face sphere, pxg_impl.py:549-552);
// here the forward keeps the K smallest per work item instead.
//
// What bounds it.  K <= 32: the lists of the overfull tiles' items read
// once, the count map read and the threshold written; a compare per list
// entry.  What held the first design back: a host read (the wrapper listed
// the overfull tiles with torch.nonzero before every launch), and the
// busiest overfull tile, whose 19 items (304 entries a pixel at K = 16) one
// thread a pixel fed into a list in local memory (0.150 of the kernel's
// 0.195 ms at 1024^2 on the 39,474-face sphere).
//
// Design.  A block per tile, over every tile of the launch: a block whose
// pixels all have at most K candidates writes `far` and ends, so no host
// read picks the tiles and the map is written whole.
//  K <= 32 (softras_pxg_thr_lists_kernel): a thread a pixel, in the
//    forward's 8 x 4 warps, merges its tile's items' lists of K smallest
//    depths ([W, K, 256], written by softras_pxg_fwd.cu) into a list of the K
//    smallest: the K smallest of a union lie among the K smallest of each
//    part, so the result is exact.  At K = 16 the list is sorted in
//    registers (RegSmallest16), at any other K softras_topk.cuh's
//    SharedSmallestK; an item's entries are loaded before their inserts.
//  K > 32 (softras_pxg_thr_bisect_kernel): no lists; kWays threads a pixel
//    bisect on the depth's bits, 32 walks of the tile's face list (staged
//    geometry rows, as softras_thr.cu walks) that count the candidates at or
//    below a trial value, way w taking faces w, w + kWays, ... of each chunk
//    and the ways' counts summed.
// The threshold is a selection of one input value, so any order of the
// inserts, any list and any split of the counts give the same bits.  zp comes
// from clipped_depth() in softras_pair.cuh, in the forward as in the
// backward, so the map equals the binned route's to the bit.  No atomics.
#include <cuda_runtime.h>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

// Compile-time choice (PERF.md has the times of each, and of the builds that
// lost: lists in local memory, several threads a pixel on the lists, warps
// that need nothing skipping the merge, a bound pass before the inserts):
// threads a pixel in the bisection.
#ifndef SOFTRAS_PXG_THR_WAYS
#define SOFTRAS_PXG_THR_WAYS 4
#endif

namespace softras {

constexpr int kTile = 16;
constexpr int kPixels = kTile * kTile;
constexpr int kWays = SOFTRAS_PXG_THR_WAYS;
constexpr int kBisectThreads = kPixels * kWays;
constexpr int kGeom = kTex;   // floats of a row that hold geometry
constexpr size_t kSmemDefault = 48 * 1024;
static_assert(kWays == 1 || kWays == 2 || kWays == 4, "1, 2 or 4 threads a pixel");

struct PxgThrArgs {
  const float* rows;      // [B, F, row]
  const int* entries;     // [E] face ids, tile after tile
  const int* tile_off;    // [B * NT + 1] first entry of each tile
  const int* item_off;    // [B * NT + 1] first item of each tile
  const float* depths;    // [W, K, 256] each item's K smallest depths, or null
  const int* counts;      // [B, H, W] candidates per pixel
  float* thr;             // [B, H, W], written on the launched tiles
  int first_tile, n_tiles, F, row, image_size, tiles_x, chunk, K, dist_func;
  Scalars s;
};

// A block's pixel: where it lies, and whether it has more than K candidates.
struct Pixel {
  int tile_g, b, tx, ty, col, row;
  size_t px;
  bool live, need;
  __device__ __forceinline__ Pixel(const PxgThrArgs& a, int p) {
    const int warp = p / 32, lane = p % 32;
    tx = (warp % 2) * 8 + lane % 8;
    ty = (warp / 2) * 4 + lane / 8;
    tile_g = a.first_tile + blockIdx.x;
    const int NT = a.tiles_x * a.tiles_x;
    b = tile_g / NT;
    const int tile = tile_g - b * NT;
    const int tile_y = tile / a.tiles_x, tile_x = tile - tile_y * a.tiles_x;
    col = tile_x * kTile + tx;
    row = tile_y * kTile + ty;
    const int is = a.image_size;
    live = col < is && row < is;
    px = (size_t)b * is * is + (size_t)row * is + col;
    need = live && a.counts[px] > a.K;
  }
};

// The pixel's entries (d: its place in item 0's list) of items i0 .. i1 - 1,
// each passed to ins(z) where finite; an item's entries are loaded (all 16
// at K = 16, else eight at a time) before their inserts.
template <int KC, class Ins>
__device__ __forceinline__ void each_entry(const float* d, int i0, int i1, int K, Ins&& ins) {
  const float inf = __int_as_float(0x7f800000);
  for (int i = i0; i < i1; ++i) {
    const float* di = d + (size_t)i * K * kPixels;
    if (KC > 0) {
      float v[KC > 0 ? KC : 1];
#pragma unroll
      for (int k = 0; k < KC; ++k) v[k] = di[k * kPixels];
#pragma unroll
      for (int k = 0; k < KC; ++k)
        if (v[k] < inf) ins(v[k]);
    } else {
      for (int k0 = 0; k0 < K; k0 += 8) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = k0 + k < K ? di[(k0 + k) * kPixels] : inf;
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (v[k] < inf) ins(v[k]);
      }
    }
  }
}

__global__ void __launch_bounds__(kPixels) softras_pxg_thr_lists_kernel(const PxgThrArgs a) {
  extern __shared__ float smem[];   // [K, 256] the lists, at K != 16
  const int tid = threadIdx.x;
  const Pixel px(a, tid);
  // a tile where no pixel has more than K candidates: no cut anywhere
  if (!__syncthreads_or(px.need)) {
    if (px.live) a.thr[px.px] = a.s.far;
    return;
  }
  const int K = a.K;
  const int i0 = a.item_off[px.tile_g], i1 = a.item_off[px.tile_g + 1];
  const float* d = a.depths + px.ty * kTile + px.tx;   // the pixel's place in a list row
  float thr;
  if (K == kRegK) {
    RegSmallest16 l;
    l.clear();
    each_entry<kRegK>(d, i0, i1, K, l);
    thr = l.d[kRegK - 1];
  } else {
    SharedSmallestK<kPixels> l{smem + tid, K, 0, 0, 0.0f};
    each_entry<0>(d, i0, i1, K, l);
    thr = l.dmax;
  }
  if (px.live) a.thr[px.px] = px.need ? thr : a.s.far;
}

template <int DIST>
__global__ void __launch_bounds__(kBisectThreads)
    softras_pxg_thr_bisect_kernel(const PxgThrArgs a) {
  extern __shared__ float smem[];
  float* srow = smem;                                          // [chunk, kGeom]
  int* sid = reinterpret_cast<int*>(smem + a.chunk * kGeom);   // [chunk]
  int* scount = sid + a.chunk;                                 // [kBisectThreads]
  const int tid = threadIdx.x;
  const int way = tid / kPixels, p = tid % kPixels;
  const Pixel px(a, p);
  if (!__syncthreads_or(px.need)) {
    if (way == 0 && px.live) a.thr[px.px] = a.s.far;
    return;
  }
  const int is = a.image_size;
  const float isf = (float)is;
  const float xp = (2.0f * (float)px.col + 1.0f - isf) / isf;
  const float yp = (isf - 1.0f - 2.0f * (float)px.row) / isf;
  const int e0 = a.tile_off[px.tile_g], total = a.tile_off[px.tile_g + 1] - e0;
  const float* rows_b = a.rows + (size_t)px.b * a.F * a.row;
  // the smallest key with at least K candidates at or below it
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
      for (int i = tid; i < n * kGeom; i += kBisectThreads) {
        const int j = i / kGeom;
        srow[i] = rows_b[(size_t)sid[j] * a.row + (i - j * kGeom)];
      }
      __syncthreads();
      if (!px.live) continue;
      for (int j = way; j < n; j += kWays) {
        PairTerms t;
        if (!pair_terms<DIST>(srow + j * kGeom, xp, yp, a.s, &t)) continue;
        if (t.tk_valid) c(t.zp);
      }
    }
    if (kWays > 1) {
      scount[tid] = c.count;
      __syncthreads();
      c.count = 0;
#pragma unroll
      for (int w = 0; w < kWays; ++w) c.count += scount[w * kPixels + p];
      __syncthreads();  // every way has read the counts
    }
    if (c.count >= a.K) {
      hi = c.trial;
    } else {
      lo = c.trial + 1u;
    }
  }
  if (way == 0 && px.live) a.thr[px.px] = px.need ? key_depth(hi) : a.s.far;
}

// Launch a kernel for these arguments, or (occupancy != null) report its
// registers, local bytes and blocks an SM instead.  static: its `ready` must
// be this library's own, not one shared with a variant build.
template <class Kernel>
static int run(Kernel kernel, int threads, size_t smem, const PxgThrArgs& a,
               cudaStream_t stream, int* occupancy, size_t* ready) {
  if (*ready < smem) {
    cudaError_t err = cudaSuccess;
    if (smem > kSmemDefault)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    *ready = smem;
  }
  if (occupancy) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
    occupancy[0] = attr.numRegs;
    occupancy[1] = (int)attr.localSizeBytes;
    occupancy[2] = blocks;
    return (int)err;
  }
  kernel<<<a.n_tiles, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DIST>
static int bisect(const PxgThrArgs& a, cudaStream_t stream, int* occupancy) {
  static size_t ready = 0;
  const size_t smem =
      ((size_t)a.chunk * (kGeom + 1) + (kWays > 1 ? kBisectThreads : 0)) * sizeof(float);
  return run(softras_pxg_thr_bisect_kernel<DIST>, kBisectThreads, smem, a, stream, occupancy,
             &ready);
}

static int thr_dispatch(const PxgThrArgs& a, cudaStream_t stream, int* occupancy) {
  if (a.n_tiles < 1 || a.K < 1 || (a.depths != nullptr && a.K > kListMax) ||
      (a.depths == nullptr && (a.chunk < 1 || a.chunk > kBisectThreads)))
    return (int)cudaErrorInvalidValue;
  if (a.depths != nullptr) {
    static size_t ready = 0;
    const size_t smem = a.K == kRegK ? 0 : (size_t)a.K * kPixels * sizeof(float);
    return run(softras_pxg_thr_lists_kernel, kPixels, smem, a, stream, occupancy, &ready);
  }
  switch (a.dist_func) {
    case kDistHard: return bisect<kDistHard>(a, stream, occupancy);
    case kDistBary: return bisect<kDistBary>(a, stream, occupancy);
    default: return bisect<kDistEuclid>(a, stream, occupancy);
  }
}

}  // namespace softras

extern "C" int softras_pxg_thr(const softras::PxgThrArgs* args, void* stream) {
  return softras::thr_dispatch(*args, static_cast<cudaStream_t>(stream), nullptr);
}

extern "C" int softras_pxg_thr_occupancy(const softras::PxgThrArgs* args, int* out) {
  return softras::thr_dispatch(*args, nullptr, out);
}

extern "C" int softras_pxg_thr_args_size() { return (int)sizeof(softras::PxgThrArgs); }
