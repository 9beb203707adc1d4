// SoftRas forward over screen tiles of any shape, one block per tile
// walking the tile's whole face list: the kernel of the f_px route
// (softras_fpx_fwd.cu, K3) and of the px_f route (softras_pxf_fwd.cu, K5).
// The TPU kernels carry their per-pixel accumulators in VMEM scratch from
// one (tile, face chunk) grid step to the next, on one core in order
// (pallas_impl.py:313-440 and :894-1158).  Blocks of a CUDA grid run in
// no order, so the sequential chunk dimension becomes a loop inside the
// block and the accumulators live in registers for the whole walk.
//
// Design.  A tile of the band is split over `split` blocks (grid.x =
// tiles_x * split), each of which walks the tile's whole list for its
// share of the tile's pixels: a long list is then walked by several SMs
// at once, which shortens the busiest tile's tail.  A thread holds PPT
// pixels, pixel q = part * blockDim.x * PPT + tid + k * blockDim.x, so a
// warp is a strip of 32 neighbouring pixels of one tile row, and keeps
// for each the binned forward's accumulators (softras_fwd.cu): the online
// softmax (S and M start at the background's term, the numerators are
// rescaled when the max rises), alpha as a product, sum or max, the
// candidate count and the hard winner (depth, face id; the lowest id wins
// a depth tie wherever it stands in the list).  The list is the binning's
// (ops/softras/tiled.py tile_work: the tile's big faces, then its
// sorted run), staged `chunk` rows at a time in shared memory, every
// thread reading the same row, a broadcast.  A tile with an empty list
// writes the background and the initial aggregates, which is the fill of
// the TPU layout's uncovered tiles (pallas_impl.py:1610-1624).  With THR
// the block also finds each pixel's top-K gradient threshold, the K-th
// smallest candidate depth (tied depths all pass zp <= thr): THR == 1 keeps
// softras_topk.cuh's list of the K smallest (K <= 32) during the walk;
// THR == 2 bisects on the depth's order-preserving key between those of
// near and far, one walk of the staged geometry per step, on tiles where
// some pixel has more than K candidates.  `far` at every pixel with at
// most K candidates, as on the binned route.  The band (ty0, ty_band)
// selects tile rows: pixel centres use the global row, the outputs are
// band-local.  No atomics: the output is deterministic.
#pragma once

#include <cuda_runtime.h>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

namespace softras {

constexpr int kTileThreads = 256;  // threads of a block at most
constexpr int kGeomRow = kTex;     // floats of a row that hold geometry
constexpr int kThrNone = 0, kThrList = 1, kThrBisect = 2;

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

template <int DIST, int RGB, int THR, int PPT>
__global__ void __launch_bounds__(kTileThreads)
    softras_tile_fwd_kernel(const TileFwdArgs a) {
  extern __shared__ float smem[];
  float* srow = smem;                                         // [chunk, row]
  int* sid = reinterpret_cast<int*>(smem + a.chunk * a.row);  // [chunk]

  const int tid = threadIdx.x, nth = blockDim.x;
  const int npix = a.tile_h * a.tile_w;
  const int split = gridDim.x / a.tiles_x;
  const int tile_x = blockIdx.x / split, band_y = blockIdx.y, b = blockIdx.z;
  const int q0 = (blockIdx.x - tile_x * split) * nth * PPT;  // the block's first pixel
  const int tile_y = a.ty0 + band_y;
  const int tile_g = (b * a.tiles_y + tile_y) * a.tiles_x + tile_x;
  const int e0 = a.tile_off[tile_g];
  const int total = a.tile_off[tile_g + 1] - e0;
  const int is = a.image_size;
  const float isf = (float)is;
  const Scalars& s = a.s;
  const float* rows_b = a.rows + (size_t)b * a.F * a.row;

  float xp[PPT], yp[PPT];
  bool live[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int q = q0 + tid + k * nth;
    const int col = tile_x * a.tile_w + q % a.tile_w;
    const int rowp = tile_y * a.tile_h + q / a.tile_w;
    live[k] = q < npix && col < is && rowp < is;
    xp[k] = (2.0f * (float)col + 1.0f - isf) / isf;
    yp[k] = (isf - 1.0f - 2.0f * (float)rowp) / isf;
  }

  float S[PPT], M[PPT], n0[PPT], n1[PPT], n2[PPT];  // softmax
  float dmin[PPT], c0[PPT], c1[PPT], c2[PPT];        // hard rgb
  int win[PPT], cnt[PPT];
  float A[PPT];
  SmallestK list[THR == kThrList ? PPT : 1];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    S[k] = 1.0f;
    M[k] = s.eps;
    n0[k] = n1[k] = n2[k] = 0.0f;
    dmin[k] = kBigDepth;
    c0[k] = c1[k] = c2[k] = 0.0f;
    win[k] = -1;
    cnt[k] = 0;
    A[k] = a.alpha_func == kAlphaProd ? 1.0f : 0.0f;
    if constexpr (THR == kThrList) {
      list[k].K = a.K;
      list[k].n = 0;
      list[k].imax = 0;
    }
  }

  for (int base = 0; base < total; base += a.chunk) {
    const int n = min(a.chunk, total - base);
    __syncthreads();  // the previous chunk has been consumed
    for (int i = tid; i < n; i += nth) sid[i] = a.entries[e0 + base + i];
    __syncthreads();
    for (int i = tid; i < n * a.row; i += nth) {
      const int j = i / a.row;
      srow[i] = rows_b[(size_t)sid[j] * a.row + (i - j * a.row)];
    }
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* r = srow + j * a.row;
      const int fid = sid[j];
      const bool side_ok = s.fill_back || r[kFront] > 0.5f;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        if (!live[k]) continue;
        PairTerms t;
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
    }
  }

  float thr[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) thr[k] = s.far;
  if constexpr (THR == kThrList) {
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      if (cnt[k] > a.K) thr[k] = list[k].d[list[k].imax];
  } else if constexpr (THR == kThrBisect) {
    // the smallest key with at least K candidates at or below it: the
    // invariant count(<= lo - 1) < K <= count(<= hi) holds from the start,
    // every candidate lying in [near, far]
    bool need = false;
    unsigned lo[PPT], hi[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      need |= live[k] && cnt[k] > a.K;
      lo[k] = a.bis_lo;
      hi[k] = a.bis_hi;
    }
    if (__syncthreads_or(need)) {
      for (int it = 0; it < a.bis_iters; ++it) {
        bool open = false;
        unsigned mid[PPT];
        int below[PPT];
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          mid[k] = lo[k] + (hi[k] - lo[k]) / 2u;
          below[k] = 0;
          open |= live[k] && cnt[k] > a.K && lo[k] < hi[k];
        }
        if (!__syncthreads_or(open)) break;
        for (int base = 0; base < total; base += a.chunk) {
          const int n = min(a.chunk, total - base);
          __syncthreads();  // the previous chunk has been consumed
          for (int i = tid; i < n; i += nth) sid[i] = a.entries[e0 + base + i];
          __syncthreads();
          for (int i = tid; i < n * kGeomRow; i += nth) {
            const int j = i / kGeomRow;
            srow[i] = rows_b[(size_t)sid[j] * a.row + (i - j * kGeomRow)];
          }
          __syncthreads();
          for (int j = 0; j < n; ++j) {
            const float* r = srow + j * kGeomRow;
#pragma unroll
            for (int k = 0; k < PPT; ++k) {
              if (!(live[k] && cnt[k] > a.K && lo[k] < hi[k])) continue;
              PairTerms t;
              if (!pair_terms<DIST>(r, xp[k], yp[k], s, &t)) continue;
              below[k] += (t.tk_valid && depth_key(t.zp) <= mid[k]) ? 1 : 0;
            }
          }
        }
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          if (!(cnt[k] > a.K && lo[k] < hi[k])) continue;
          if (below[k] >= a.K) {
            hi[k] = mid[k];
          } else {
            lo[k] = mid[k] + 1u;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        if (cnt[k] > a.K) thr[k] = key_depth(hi[k]);
    }
  }

  const int Hb = a.ty_band * a.tile_h;
  const size_t HW = (size_t)Hb * is;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (!live[k]) continue;
    const int q = q0 + tid + k * nth;
    const int col = tile_x * a.tile_w + q % a.tile_w;
    const int rowb = band_y * a.tile_h + q / a.tile_w;   // the band's own row
    float rgb[3], ag0, ag1;
    if (RGB == kRgbSoftmax) {
      const float eb = expf((s.eps - M[k]) / s.gamma);
      rgb[0] = (eb * s.bg[0] + n0[k]) / S[k];
      rgb[1] = (eb * s.bg[1] + n1[k]) / S[k];
      rgb[2] = (eb * s.bg[2] + n2[k]) / S[k];
      ag0 = S[k];
      ag1 = M[k];
    } else if (RGB == kRgbHard) {
      const bool hit = win[k] >= 0;
      rgb[0] = hit ? c0[k] : s.bg[0];
      rgb[1] = hit ? c1[k] : s.bg[1];
      rgb[2] = hit ? c2[k] : s.bg[2];
      ag0 = hit ? dmin[k] : kBigDepth;
      ag1 = hit ? (float)win[k] : -1.0f;
    } else {
      rgb[0] = s.bg[0];
      rgb[1] = s.bg[1];
      rgb[2] = s.bg[2];
      ag0 = 0.0f;
      ag1 = 0.0f;
    }
    float alpha;
    if (a.alpha_func == kAlphaProd) {
      alpha = 1.0f - A[k];
    } else if (a.alpha_func == kAlphaSum) {
      alpha = A[k] / (float)a.F;  // divided by the total face count
    } else {
      alpha = A[k];
    }
    const size_t px = (size_t)rowb * is + col;
    float* img = a.image + (size_t)b * 4 * HW + px;
    img[0] = rgb[0];
    img[HW] = rgb[1];
    img[2 * HW] = rgb[2];
    img[3 * HW] = alpha;
    float* ag = a.aggrs + (size_t)b * 2 * HW + px;
    ag[0] = ag0;
    ag[HW] = ag1;
    a.counts[(size_t)b * HW + px] = cnt[k];
    if (THR != kThrNone) a.thr[(size_t)b * HW + px] = thr[k];
  }
}

// Launch with min(256, ceil(pixels of a tile / PPT)) threads a block and
// as many blocks a tile as its pixels need.
template <int DIST, int RGB, int THR, int PPT>
cudaError_t tile_fwd_launch(const TileFwdArgs& a, cudaStream_t stream) {
  const int npix = a.tile_h * a.tile_w;
  const int threads = min(kTileThreads, (npix + PPT - 1) / PPT);
  const int split = (npix + threads * PPT - 1) / (threads * PPT);
  if (a.ty_band < 1) return cudaErrorInvalidValue;
  const dim3 grid(a.tiles_x * split, a.ty_band, a.B);
  const size_t smem = (size_t)a.chunk * a.row * sizeof(float) +
                      (size_t)a.chunk * sizeof(int);
  softras_tile_fwd_kernel<DIST, RGB, THR, PPT><<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DIST, int THR, int PPT>
cudaError_t tile_fwd_launch_rgb(const TileFwdArgs& a, cudaStream_t stream) {
  switch (a.rgb_func) {
    case kRgbHard: return tile_fwd_launch<DIST, kRgbHard, THR, PPT>(a, stream);
    case kRgbSoftmax: return tile_fwd_launch<DIST, kRgbSoftmax, THR, PPT>(a, stream);
    default: return tile_fwd_launch<DIST, 2, THR, PPT>(a, stream);
  }
}

template <int THR, int PPT>
cudaError_t tile_fwd_dispatch(const TileFwdArgs& a, cudaStream_t stream) {
  switch (a.dist_func) {
    case kDistHard: return tile_fwd_launch_rgb<kDistHard, THR, PPT>(a, stream);
    case kDistBary: return tile_fwd_launch_rgb<kDistBary, THR, PPT>(a, stream);
    default: return tile_fwd_launch_rgb<kDistEuclid, THR, PPT>(a, stream);
  }
}

}  // namespace softras
