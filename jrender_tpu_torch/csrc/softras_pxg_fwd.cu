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
//  softras_pxg_fwd_kernel: one block of 16 x 16 threads per work item, one
//    thread per pixel of the item's tile in 8 x 4 warps, as the binned
//    forward (softras_fwd.cu).  The block stages its faces' rows in shared
//    memory and each thread keeps the binned kernel's accumulators in
//    registers, without the background: the online softmax (S, M and the
//    numerators, M starting at -1e30), alpha as a product, sum or max, the
//    candidate count and the hard winner (depth, original id, lowest id on
//    a tie).  It writes them as one partial row per pixel, [W, 8, 256].
//    With the threshold asked for (K <= 32) a thread also keeps the K
//    smallest candidate depths of its item (softras_topk.cuh's list) and
//    writes them, +inf padded, to [W, K, 256]: the K smallest of a tile's
//    union lie among the K smallest of each item, so the threshold kernel
//    merges lists instead of walking the faces again.
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
// Bound.  The pair work is the binned forward's (every pair of a tile's
// list tested against its bbox, the bbox pairs through the distance cut,
// the candidates shaded); the bytes are the face rows once per item and
// the partial rows out, 32 bytes per pixel of every item (the combine reads
// them back).  Splitting a long list over blocks takes the busiest tile's
// list off the critical path: at 1024 px on the 39,474-face sphere that
// tile holds 1,158 faces against a mean of 127, and its one block was most
// of the binned forward's time.
#include <cuda_runtime.h>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

namespace softras {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kParts = 8;        // channels of a partial row
constexpr float kNoMax = -1e30f; // the softmax maximum of an item without a candidate

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

template <int DIST, int RGB, bool THR>
__global__ void __launch_bounds__(kThreads)
    softras_pxg_fwd_kernel(const PxgFwdArgs a) {
  extern __shared__ float smem[];
  float* srow = smem;                                         // [chunk, row]
  int* sid = reinterpret_cast<int*>(smem + a.chunk * a.row);  // [chunk]

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
  SmallestK list;
  list.K = a.K;
  list.n = 0;
  list.imax = 0;

  for (int base = 0; base < total; base += a.chunk) {
    const int n = min(a.chunk, total - base);
    __syncthreads();  // the previous chunk has been consumed
    if (tid < n) sid[tid] = a.entries[first + base + tid];
    __syncthreads();
    for (int i = tid; i < n * a.row; i += kThreads) {
      const int j = i / a.row;
      srow[i] = rows_b[(size_t)sid[j] * a.row + (i - j * a.row)];
    }
    __syncthreads();
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
    for (int k = 0; k < a.K; ++k) d[k * kThreads] = k < list.n ? list.d[k] : inf;
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

template <int DIST, int RGB, bool THR>
cudaError_t launch(const PxgFwdArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.chunk * a.row * sizeof(float) +
                      (size_t)a.chunk * sizeof(int);
  softras_pxg_fwd_kernel<DIST, RGB, THR><<<a.W, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DIST, int RGB>
cudaError_t launch_thr(const PxgFwdArgs& a, cudaStream_t stream) {
  return a.depths != nullptr ? launch<DIST, RGB, true>(a, stream)
                             : launch<DIST, RGB, false>(a, stream);
}

template <int DIST>
cudaError_t launch_rgb(const PxgFwdArgs& a, cudaStream_t stream) {
  switch (a.rgb_func) {
    case kRgbHard: return launch_thr<DIST, kRgbHard>(a, stream);
    case kRgbSoftmax: return launch_thr<DIST, kRgbSoftmax>(a, stream);
    default: return launch_thr<DIST, 2>(a, stream);
  }
}

}  // namespace softras

extern "C" int softras_pxg_fwd(const softras::PxgFwdArgs* args, void* stream) {
  using namespace softras;
  if (args->depths != nullptr && (args->K < 1 || args->K > kListMax))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (args->dist_func) {
    case kDistHard: err = launch_rgb<kDistHard>(*args, st); break;
    case kDistBary: err = launch_rgb<kDistBary>(*args, st); break;
    default: err = launch_rgb<kDistEuclid>(*args, st); break;
  }
  return (int)err;
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
