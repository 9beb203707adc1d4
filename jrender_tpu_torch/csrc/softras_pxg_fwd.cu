// SoftRas forward over grouped work items for Hopper (sm_90a): partial
// aggregates per (tile, chunk of its face list) and their per-tile
// combine, with plain C entry points.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pxg_impl.py
// _make_fwd_kernel_pxg (:314, launched at :716 by soft_rasterize_fwd_pxg)
// and the XLA combine that follows it there (_combine_pxg :449-532, with
// the uncovered tiles' background :738-750).  It computes what they
// compute, not the TPU layout: there are no 8-lane face groups, 16-group
// rows or 0/1 matrix products.
//
// Design.  The prep (ops/softras/pxg_impl.py) cuts every tile's face list
// into work items of at most 64 faces.
//  softras_pxg_fwd_kernel: blocks of 16 x 16 threads, one thread per pixel
//    of an item's tile in 8 x 4 warps, as the binned forward
//    (softras_fwd.cu).  Warp w copies the rows of faces w, w + 8, ... of a
//    staged chunk into shared memory with cp.async, from ids its lanes
//    loaded while the block walked the chunk before, so one block barrier
//    stands between a chunk's copies and its walk (an item of 64 faces is
//    one chunk).  Each thread keeps the binned kernel's accumulators in
//    registers, without the background: the online softmax (S, M and the
//    numerators, M starting at -1e30), alpha as a product, sum or max, the
//    candidate count and the hard winner (depth, original id, lowest id on
//    a tie).  It writes them as one partial row per pixel, [W, 8, 256], at
//    the item's own index.  With the threshold asked for (K <= 32) a thread
//    also keeps the K smallest candidate depths of its item in shared
//    memory ([K][256], a warp's lanes on distinct banks; softras_topk.cuh's
//    SharedSmallestK) and writes them, +inf padded, to [W, K, 256]: the K
//    smallest of a tile's union lie among the K smallest of each item, so
//    the threshold kernel merges lists instead of walking the faces again.
//    A thread walks its item's faces in list order, so no choice below
//    moves a bit of a partial row or a depth list.
//  softras_pxg_combine_kernel: one block per (tile, batch element), a
//    thread per pixel walks the tile's items in order: M = max(M_g, eps),
//    each item's sums scaled by exp((M_g - M) / gamma), the background
//    term exp((eps - M) / gamma) once; hard rgb the least depth and the
//    lowest id among equal depths; alpha by max, sum / F or 1 - product;
//    the counts summed.  A tile without items gets exactly the background
//    and the initial aggregates.  It writes image [B,4,H,W], aggrs
//    [B,2,H,W] and counts [B,H,W], the binned forward's outputs.
// The combine is a kernel, not a scatter: PyTorch's scatter_reduce and
// index_add_ add with float atomics on the card, so their sums change from
// run to run.  No atomics here: every output is deterministic.
//
// Compile-time choice of the partials kernel: SOFTRAS_PXG_FWD_MIN_BLOCKS,
// the blocks an SM is to hold, the register cap of __launch_bounds__ (0:
// no cap; pxg_impl.fwd_defines; tools/time_pxg_fwd.py times the caps,
// PERF.md has the readings).  The default, 5 blocks an SM at 48 registers,
// read 0.496-0.499 ms with the depth lists and 0.449-0.450 without, against
// 0.586-0.588 and 0.509-0.510 for the kernel before (no cap, a chunk
// staged by all threads behind three block barriers, the lists in local
// memory) and 0.509-0.511 / 0.470-0.473 at 4 blocks, in four turns of one
// call (1024 px, 39,474 faces, K = 16, NVIDIA H100 80GB HBM3, 700.00 W).
// Timed alone in another call, the warp-staged rows gained 6.5% and the
// lists in shared memory 8%; the kernel before held 48 registers uncapped,
// so a cap gained only beside them.  A persistent grid (as many blocks as
// the SMs hold, each walking items i, i + grid, ... with the next item's
// rows in flight) lost in every reading (PERF.md §6): its static share of
// items left SMs idle behind the costly ones, where a block per item lets
// the hardware hand the next item to the first free SM.
//
// Bound.  The pair work is the binned forward's (every pair of a tile's
// list tested against its bbox, the bbox pairs through the distance cut,
// the candidates shaded); the bytes are the face rows once per item and
// the partial rows out, 32 bytes per pixel of every item (the combine reads
// them back).  Splitting a long list over blocks takes the busiest tile's
// list off the critical path: at 1024 px on the 39,474-face sphere that
// tile holds 1,158 faces against a mean of 127, and its one block was most
// of the binned forward's time.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

#ifndef SOFTRAS_PXG_FWD_MIN_BLOCKS
#define SOFTRAS_PXG_FWD_MIN_BLOCKS 5
#endif

namespace softras {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kParts = 8;        // channels of a partial row
constexpr float kNoMax = -1e30f; // the softmax maximum of an item without a candidate
constexpr int kMaxChunk = 64;                 // faces of a staged chunk, at most
constexpr int kPerWarp = kMaxChunk / kWarps;  // faces a warp stages per chunk
constexpr size_t kSmemDefault = 48 * 1024;    // dynamic shared memory without asking

struct PxgFwdArgs {
  const float* rows;     // [B, F, row]
  const int* entries;    // [E] face ids of every tile's list, tile after tile
  const int* items;      // [W, 3] (global tile b * NT + t, first entry, end entry)
  float* parts;          // [W, 8, 256] partial rows; pixel (ly, lx) at ly * 16 + lx
  float* depths;         // [W, K, 256] the K smallest candidate depths, or null
  int W, F, row, image_size, tiles_x, chunk, K;
  int dist_func, rgb_func, alpha_func;
  Scalars s;
};

struct PxgCombineArgs {
  const float* parts;    // [W, 8, 256]
  const int* item_off;   // [B * NT + 1] first item of each tile
  float* image;          // [B, 4, H, W]
  float* aggrs;          // [B, 2, H, W]
  int* counts;           // [B, H, W]
  int B, F, image_size, tiles_x;
  int rgb_func, alpha_func;
  Scalars s;
};

// Shared memory of a partials block, in bytes: a chunk of rows and their
// ids, and (with the depth lists) K depths a thread.
__host__ __device__ inline size_t pxg_fwd_smem(const PxgFwdArgs& a) {
  const size_t lists = a.depths != nullptr ? (size_t)a.K * kThreads : 0;
  return ((size_t)a.chunk * (a.row + 1) + lists) * sizeof(float);
}

// Lane q < kPerWarp of warp w: the id of face w + kWarps * q of the chunk
// of n faces at `at` in the entries, or -1.
__device__ __forceinline__ int chunk_ids(const int* entries, int at, int n, int warp,
                                         int lane) {
  const int j = warp + kWarps * lane;
  return (lane < kPerWarp && j < n) ? entries[at + j] : -1;
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
      const float* src = rows_b + (size_t)id * row;
      float* dst = srow + j * row;
      for (int k = lane; k < row; k += 32) __pipeline_memcpy_async(dst + k, src + k, 4);
    }
  }
  __pipeline_commit();
}

#if SOFTRAS_PXG_FWD_MIN_BLOCKS > 0
#define SOFTRAS_PXG_FWD_BOUNDS __launch_bounds__(kThreads, SOFTRAS_PXG_FWD_MIN_BLOCKS)
#else
#define SOFTRAS_PXG_FWD_BOUNDS __launch_bounds__(kThreads)
#endif

template <int DIST, int RGB, bool THR>
__global__ void SOFTRAS_PXG_FWD_BOUNDS softras_pxg_fwd_kernel(const PxgFwdArgs a) {
  extern __shared__ float4 smem4[];
  float* srow = reinterpret_cast<float*>(smem4);                  // [chunk, row]
  int* sid = reinterpret_cast<int*>(srow + (size_t)a.chunk * a.row);  // [chunk]
  float* slist = srow + (size_t)a.chunk * (a.row + 1);            // [K, 256]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int item = blockIdx.x;
  const int tile_g = a.items[3 * item];
  const int first = a.items[3 * item + 1];
  const int total = a.items[3 * item + 2] - first;
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
  const Scalars& s = a.s;
  const float* rows_b = a.rows + (size_t)b * a.F * a.row;

  float S = 0.0f, M = kNoMax, n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;  // softmax
  float dmin = kBigDepth, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;      // hard rgb
  int win = -1;
  float A = a.alpha_func == kAlphaProd ? 1.0f : 0.0f;
  int cnt = 0;
  SharedSmallestK<kThreads> list{slist + tid, a.K, 0, 0, 0.0f};

  // the ids of chunk c + 1 are loaded while the block walks chunk c
  int ids = chunk_ids(a.entries, first, min(a.chunk, total), warp, lane);
  for (int base = 0; base < total; base += a.chunk) {
    const int n = min(a.chunk, total - base);
    if (base > 0) __syncthreads();  // the previous chunk has been consumed
    stage(rows_b, a.row, srow, sid, n, ids, warp, lane);
    const int next = base + a.chunk;
    if (next < total)
      ids = chunk_ids(a.entries, first + next, min(a.chunk, total - next), warp, lane);
    __pipeline_wait_prior(0);
    __syncthreads();  // the chunk is in
    if (!live) continue;

    for (int j = 0; j < n; ++j) {
      const int fid = sid[j];
      const float* r = srow + j * a.row;
      PairTerms t;
      if (!pair_terms<DIST>(r, xp, yp, s, &t)) continue;

      if (a.alpha_func == kAlphaProd) {
        A *= 1.0f - t.sf;
      } else if (a.alpha_func == kAlphaSum) {
        A += t.sf;
      } else if (t.sf > 0.5f) {
        A = 1.0f;
      }
      cnt += t.tk_valid ? 1 : 0;
      if (THR && t.tk_valid) list(t.zp);
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

  // every thread writes its row: a pixel past the image edge writes the
  // initial values, which the combine never reads
  const int px = ty * kTile + tx;
  float* out = a.parts + (size_t)item * kParts * kThreads + px;
  float v[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (RGB == kRgbSoftmax) {
    v[0] = n0;
    v[1] = n1;
    v[2] = n2;
    v[3] = S;
    v[4] = M;
  } else if (RGB == kRgbHard) {
    v[0] = c0;
    v[1] = c1;
    v[2] = c2;
    v[3] = dmin;
    v[4] = (float)win;
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) out[c * kThreads] = v[c];
  out[5 * kThreads] = A;
  out[6 * kThreads] = (float)cnt;
  out[7 * kThreads] = 0.0f;
  if (THR) {
    float* d = a.depths + (size_t)item * a.K * kThreads + px;
    const float inf = __int_as_float(0x7f800000);
    for (int k = 0; k < a.K; ++k) d[k * kThreads] = k < list.n ? slist[k * kThreads + tid] : inf;
  }
}

template <int RGB>
__global__ void __launch_bounds__(kThreads)
    softras_pxg_combine_kernel(const PxgCombineArgs a) {
  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int tile_x = blockIdx.x, tile_y = blockIdx.y, b = blockIdx.z;
  const int col = tile_x * kTile + lx, rowp = tile_y * kTile + ly;
  const int is = a.image_size;
  if (col >= is || rowp >= is) return;
  const Scalars& s = a.s;
  const int tile_g = (b * a.tiles_x + tile_y) * a.tiles_x + tile_x;
  const int i0 = a.item_off[tile_g], i1 = a.item_off[tile_g + 1];
  // channel c of item i at P[(i * 8 + c) * 256]
  const float* P = a.parts + ly * kTile + lx;
#define PART(i, c) P[((size_t)(i) * kParts + (c)) * kThreads]

  float A = a.alpha_func == kAlphaProd ? 1.0f : 0.0f, cnt = 0.0f;
  for (int i = i0; i < i1; ++i) {
    const float ai = PART(i, 5);
    if (a.alpha_func == kAlphaProd) {
      A *= ai;
    } else if (a.alpha_func == kAlphaSum) {
      A += ai;
    } else {
      A = fmaxf(A, ai);
    }
    cnt += PART(i, 6);
  }

  float rgb[3], ag0, ag1;
  if (RGB == kRgbSoftmax) {
    float M = s.eps;
    for (int i = i0; i < i1; ++i) M = fmaxf(M, PART(i, 4));
    float sS = 0.0f, s0 = 0.0f, s1 = 0.0f, s2 = 0.0f;
    for (int i = i0; i < i1; ++i) {
      const float sc = expf((PART(i, 4) - M) / s.gamma);
      s0 += PART(i, 0) * sc;
      s1 += PART(i, 1) * sc;
      s2 += PART(i, 2) * sc;
      sS += PART(i, 3) * sc;
    }
    const float eb = expf((s.eps - M) / s.gamma);
    const float S = eb + sS;
    rgb[0] = (eb * s.bg[0] + s0) / S;
    rgb[1] = (eb * s.bg[1] + s1) / S;
    rgb[2] = (eb * s.bg[2] + s2) / S;
    ag0 = S;
    ag1 = M;
  } else if (RGB == kRgbHard) {
    bool hit = false;
    float dmin = kBigDepth, win = -1.0f;
    int at = 0;
    for (int i = i0; i < i1; ++i) {
      const float id = PART(i, 4);
      if (id < 0.0f) continue;  // the item has no winner here
      const float d = PART(i, 3);
      if (!hit || d < dmin || (d == dmin && id < win)) {
        hit = true;
        dmin = d;
        win = id;
        at = i;
      }
    }
    rgb[0] = hit ? PART(at, 0) : s.bg[0];
    rgb[1] = hit ? PART(at, 1) : s.bg[1];
    rgb[2] = hit ? PART(at, 2) : s.bg[2];
    ag0 = hit ? dmin : kBigDepth;
    ag1 = hit ? win : -1.0f;
  } else {
    rgb[0] = s.bg[0];
    rgb[1] = s.bg[1];
    rgb[2] = s.bg[2];
    ag0 = 0.0f;
    ag1 = 0.0f;
  }
#undef PART
  float alpha;
  if (a.alpha_func == kAlphaProd) {
    alpha = 1.0f - A;
  } else if (a.alpha_func == kAlphaSum) {
    alpha = A / (float)a.F;  // divided by the total face count
  } else {
    alpha = A;
  }

  const size_t HW = (size_t)is * is;
  const size_t px = (size_t)rowp * is + col;
  float* img = a.image + (size_t)b * 4 * HW + px;
  img[0] = rgb[0];
  img[HW] = rgb[1];
  img[2 * HW] = rgb[2];
  img[3 * HW] = alpha;
  float* ag = a.aggrs + (size_t)b * 2 * HW + px;
  ag[0] = ag0;
  ag[HW] = ag1;
  a.counts[(size_t)b * HW + px] = (int)cnt;
}

// Launch the partials kernel for these arguments, or (occupancy != null)
// report its registers, spill bytes and blocks an SM instead.  static: its
// `ready` must be this library's own, not one shared with a variant build
// (a static local of a function with external linkage is one symbol across
// every library loaded).
template <int DIST, int RGB, bool THR>
static int fwd_launch(const PxgFwdArgs& a, cudaStream_t stream, int* occupancy) {
  const auto kernel = softras_pxg_fwd_kernel<DIST, RGB, THR>;
  if (a.chunk < 1 || a.chunk > kMaxChunk || a.row < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = pxg_fwd_smem(a);
  static size_t ready = 0;
  if (ready < smem) {
    cudaError_t err = cudaSuccess;
    if (smem > kSmemDefault)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = smem;
  }
  if (occupancy) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    occupancy[0] = attr.numRegs;
    occupancy[1] = (int)attr.localSizeBytes;
    occupancy[2] = blocks;
    return (int)err;
  }
  if (a.W == 0) return (int)cudaSuccess;
  kernel<<<a.W, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DIST, int RGB>
static int fwd_by_thr(const PxgFwdArgs& a, cudaStream_t stream, int* occupancy) {
  return a.depths != nullptr ? fwd_launch<DIST, RGB, true>(a, stream, occupancy)
                             : fwd_launch<DIST, RGB, false>(a, stream, occupancy);
}

template <int DIST>
static int fwd_by_rgb(const PxgFwdArgs& a, cudaStream_t stream, int* occupancy) {
  switch (a.rgb_func) {
    case kRgbHard: return fwd_by_thr<DIST, kRgbHard>(a, stream, occupancy);
    case kRgbSoftmax: return fwd_by_thr<DIST, kRgbSoftmax>(a, stream, occupancy);
    default: return fwd_by_thr<DIST, 2>(a, stream, occupancy);
  }
}

static int fwd_dispatch(const PxgFwdArgs& a, cudaStream_t stream, int* occupancy) {
  if (a.depths != nullptr && (a.K < 1 || a.K > kListMax)) return (int)cudaErrorInvalidValue;
  switch (a.dist_func) {
    case kDistHard: return fwd_by_rgb<kDistHard>(a, stream, occupancy);
    case kDistBary: return fwd_by_rgb<kDistBary>(a, stream, occupancy);
    default: return fwd_by_rgb<kDistEuclid>(a, stream, occupancy);
  }
}

}  // namespace softras

extern "C" int softras_pxg_fwd(const softras::PxgFwdArgs* args, void* stream) {
  return softras::fwd_dispatch(*args, static_cast<cudaStream_t>(stream), nullptr);
}

// Registers, spill bytes and blocks an SM of the partials kernel these
// arguments launch (out[0..2]).
extern "C" int softras_pxg_fwd_occupancy(const softras::PxgFwdArgs* args, int* out) {
  return softras::fwd_dispatch(*args, nullptr, out);
}

extern "C" int softras_pxg_combine(const softras::PxgCombineArgs* args, void* stream) {
  using namespace softras;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(args->tiles_x, args->tiles_x, args->B);
  switch (args->rgb_func) {
    case kRgbHard: softras_pxg_combine_kernel<kRgbHard><<<grid, kThreads, 0, st>>>(*args); break;
    case kRgbSoftmax:
      softras_pxg_combine_kernel<kRgbSoftmax><<<grid, kThreads, 0, st>>>(*args);
      break;
    default: softras_pxg_combine_kernel<2><<<grid, kThreads, 0, st>>>(*args); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int softras_pxg_fwd_args_size() { return (int)sizeof(softras::PxgFwdArgs); }

extern "C" int softras_pxg_combine_args_size() {
  return (int)sizeof(softras::PxgCombineArgs);
}
