// SoftRas per-(pixel, face) gradient terms as CUDA device functions.
//
// The backward part of the pair math, shared by the binned backward
// (softras_bwd.cu, K2), the tile backward (softras_tile_bwd.cuh: K4, K6,
// K9) and the dir backward (softras_dir_bwd.cu, K11):
// the terms of pxt_impl.py:900-1038 and dir_impl.py:521-670 of the JAX
// package, which are the reference's soft_rasterize.py:523-1358.  The
// forward part (pair_terms, clipped_depth) is in softras_pair.cuh, so the
// depth bits that a pair is masked with (zp <= thr) are the forward's.
#pragma once

#include <cuda_runtime.h>

#include "softras_pair.cuh"

namespace softras {

// What the pair gradient reads besides the pair and the pixel.
struct GradCfg {
  Scalars s;
  int F;             // face count: alpha 'sum' divides by it
  int rgb_func, alpha_func;
  bool use_thr;      // mask the pairs with zp <= the pixel's threshold
};

struct PixelIn {
  float o[4];      // the forward's rgba
  float ag0, ag1;  // softmax sum and max, or hard depth and face index
  float g[4];      // incoming gradient
  float thr;
};

struct PairGrad {
  float gv[9];     // d pixel / d (x, y, z) of corner k at [3k ..]
  float tc[3];     // texture coefficient times the rgb gradient
  float wc[3];     // clipped barycentrics (vertex colours)
  int idx;         // texel (surface)
};

// The terms of one (pixel, face) pair, pxt_impl.py:900-1038.  False: the
// pair is no candidate or lies beyond the threshold, and sends nothing.
template <int DIST>
__device__ __forceinline__ bool pair_grad(const float* r, int fid, float xp,
                                          float yp, const PixelIn& px,
                                          const GradCfg& a, PairGrad* o) {
  const Scalars& s = a.s;
  PairTerms t;
  if (!pair_terms<DIST, true>(r, xp, yp, s, &t)) return false;
  if (!t.tk_valid) return false;
  if (a.use_thr && !(t.zp <= px.thr)) return false;

  // dist hard: sf = 1 in the backward, so the xy chain vanishes
  const float sf = DIST == kDistHard ? 1.0f : t.sf;
  float cxy;
  if (a.alpha_func == kAlphaHard) {
    cxy = 0.0f;
  } else if (a.alpha_func == kAlphaSum) {
    cxy = px.g[3] / (float)a.F;
  } else {
    cxy = px.g[3] * (1.0f - px.o[3]) / fmaxf(1.0f - sf, 1e-6f);
  }

  const float* tex = r + kTex;
  const bool surface = s.texture_type == 0;
  o->idx = surface ? surface_tex_idx(t.wc, s.tex_res) : 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) o->wc[k] = t.wc[k];

  float gz[3] = {0.0f, 0.0f, 0.0f};
  float coef = 0.0f;
  if (a.rgb_func == kRgbSoftmax) {
    const float S = fmaxf(px.ag0, 1e-30f);
    const float zpn = (s.far - t.zp) / s.far_minus_near;
    const float zsm = sf * expf((zpn - px.ag1) / s.gamma) / S;
    // colour WITHOUT perspective correction and with no front-side check
    // (reference backward, soft_rasterize.py:1136-1151)
    float d = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float col = surface
          ? tex[3 * o->idx + c]
          : t.wc[0] * tex[c] + t.wc[1] * tex[3 + c] + t.wc[2] * tex[6 + c];
      d += px.g[c] * (col - px.o[c]);
    }
    const float crgb = d * zsm;
    cxy += crgb / fmaxf(sf, 1e-30f);
    const float cz = crgb / s.gamma / (s.near - s.far) * t.zp * t.zp;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float z = r[kFace + 3 * k + 2];
      gz[k] = cz * t.wc[k] / (z * z);
    }
    coef = zsm;
  } else if (a.rgb_func == kRgbHard) {
    // the texture gradient goes to the winning face only
    coef = fid == (int)px.ag1 ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) o->tc[c] = px.g[c] * coef;

  // sigmoid chain to the vertex xy (soft_rasterize.py:1336-1347)
  cxy = cxy * sf * (1.0f - sf) / s.sigma;
  float gx[3] = {0.0f, 0.0f, 0.0f}, gy[3] = {0.0f, 0.0f, 0.0f};
  if (DIST == kDistBary) {
    // reads the unclipped w (soft_rasterize.py:1118-1132)
    const int pmin = t.w[0] > t.w[1] ? (t.w[1] > t.w[2] ? 2 : 1)
                                     : (t.w[0] > t.w[2] ? 2 : 0);
    const float mn = fminf(fminf(t.w[0], t.w[1]), t.w[2]);
    const float C = cxy * 2.0f * sqrtf(mn * mn);
    const float ix = r[kInv + 3 * pmin], iy = r[kInv + 3 * pmin + 1];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gx[k] = -ix * t.w[k] * C;
      gy[k] = -iy * t.w[k] * C;
    }
  } else if (DIST == kDistEuclid) {
    const float C2 = 2.0f * t.sign * cxy;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gx[k] = C2 * t.tau[k] * t.dis_x;
      gy[k] = C2 * t.tau[k] * t.dis_y;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o->gv[3 * k] = gx[k];
    o->gv[3 * k + 1] = gy[k];
    o->gv[3 * k + 2] = gz[k];
  }
  return true;
}

// One step of a warp over 32 pixels of a face: adds the pair's terms to the
// lane's sums (face 9; vertex colours 9) and, for surface texels, to the
// warp's 3T sums in shared memory, lane after lane in ascending order.
// Every lane of the warp must call it; `active` says whether the lane has
// a pixel.
template <int DIST>
__device__ __forceinline__ void add_pair(const float* r, int fid, bool active,
                                         float xp, float yp, const PixelIn& px,
                                         const GradCfg& a, int lane,
                                         float acc[9], float tacc[9],
                                         float* wtex) {
  PairGrad g;
  const bool valid = active && pair_grad<DIST>(r, fid, xp, yp, px, a, &g);
  if (valid) {
#pragma unroll
    for (int c = 0; c < 9; ++c) acc[c] += g.gv[c];
  }
  if (a.s.texture_type != 0) {
    if (valid) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) tacc[3 * k + c] += g.tc[c] * g.wc[k];
    }
    return;
  }
  unsigned mask = __ballot_sync(0xffffffffu, valid);
  while (mask) {
    const int l = __ffs(mask) - 1;
    if (lane == l) {
#pragma unroll
      for (int c = 0; c < 3; ++c) wtex[3 * g.idx + c] += g.tc[c];
    }
    __syncwarp();
    mask &= mask - 1;
  }
}

// add_pair with the texel adds of the step in rounds: the lanes that
// select the same texel form a group (__match_any_sync), and round r adds
// each group's r-th lane, in as many rounds as the largest group has
// lanes.  The 9 face sums and the vertex colours' sums are add_pair's; a
// surface texel receives the values of the lanes that select it in
// ascending lane order, as in add_pair, so its sums have the same bits.
// The tile backward (softras_tile_bwd.cuh) and the dir backward
// (softras_dir_bwd.cu) share it.  Every lane of the warp must call it.
template <int DIST, bool SURFACE>
__device__ __forceinline__ void add_pair_rounds(const float* r, int fid, bool active,
                                                float xp, float yp, const PixelIn& px,
                                                const GradCfg& a, int lane, float acc[9],
                                                float tacc[9], float* wtex) {
  PairGrad g;
  const bool valid = active && pair_grad<DIST>(r, fid, xp, yp, px, a, &g);
  if (valid) {
#pragma unroll
    for (int c = 0; c < 9; ++c) acc[c] += g.gv[c];
  }
  if (!SURFACE) {
    if (valid) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) tacc[3 * k + c] += g.tc[c] * g.wc[k];
    }
    return;
  }
  const unsigned same = __match_any_sync(0xffffffffu, valid ? g.idx : -1);
  const int rounds = (int)__reduce_max_sync(0xffffffffu, valid ? (unsigned)__popc(same) : 0u);
  const int rank = __popc(same & ((1u << lane) - 1u));
  for (int q = 0; q < rounds; ++q) {
    if (valid && rank == q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) wtex[3 * g.idx + c] += g.tc[c];
    }
    __syncwarp();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The pixels whose centres may lie in an inflated bbox q (xmin, xmax,
// ymin, ymax) on an is x is screen, or false: none, or a NaN in q.  The
// dir route's rule (its prep and backward, softras_dir_{prep,bwd}.cu, and
// dir_impl.face_pixel_boxes), rounded operation by operation as the plain
// version: col = (x * is + is - 1) / 2 and row = (is - 1 - y * is) / 2,
// floored at the low end and ceiled at the high end, then clamped.
__device__ __forceinline__ bool bbox_pixels(float4 q, int image_size, int* c0, int* c1,
                                            int* r0, int* r1) {
  if (!(q.x <= q.y && q.z <= q.w)) return false;
  const float isf = (float)image_size;
  const float m1 = isf - 1.0f;
  const float cx0 = __fmul_rn(__fsub_rn(__fadd_rn(__fmul_rn(q.x, isf), isf), 1.0f), 0.5f);
  const float cx1 = __fmul_rn(__fsub_rn(__fadd_rn(__fmul_rn(q.y, isf), isf), 1.0f), 0.5f);
  const float ry0 = __fmul_rn(__fsub_rn(m1, __fmul_rn(q.w, isf)), 0.5f);
  const float ry1 = __fmul_rn(__fsub_rn(m1, __fmul_rn(q.z, isf)), 0.5f);
  *c0 = (int)fminf(fmaxf(floorf(cx0), 0.0f), isf);
  *c1 = (int)fmaxf(fminf(ceilf(cx1), m1), -1.0f);
  *r0 = (int)fminf(fmaxf(floorf(ry0), 0.0f), isf);
  *r1 = (int)fmaxf(fminf(ceilf(ry1), m1), -1.0f);
  return *c0 <= *c1 && *r0 <= *r1;
}

// Pixels whose centres may lie in the face's inflated bbox, clipped to
// [c_lo, c_hi] x [r_lo, r_hi]; rounded outwards (pair_terms tests the
// bbox exactly).  Returns false when the range is empty.
__device__ __forceinline__ bool pixel_range(const float* r, float sq, float isf,
                                            int c_lo, int c_hi, int r_lo,
                                            int r_hi, int* c0, int* c1,
                                            int* r0, int* r1) {
  const float x0 = r[kFace + 0], x1 = r[kFace + 3], x2 = r[kFace + 6];
  const float y0 = r[kFace + 1], y1 = r[kFace + 4], y2 = r[kFace + 7];
  const float xmin = fminf(fminf(x0, x1), x2) - sq;
  const float xmax = fmaxf(fmaxf(x0, x1), x2) + sq;
  const float ymin = fminf(fminf(y0, y1), y2) - sq;
  const float ymax = fmaxf(fmaxf(y0, y1), y2) + sq;
  // xp = (2c + 1 - is) / is and yp = (is - 1 - 2r) / is; clamp before the
  // int cast so that a huge coordinate cannot overflow it
  const float lo_c = (float)c_lo, hi_c = (float)c_hi;
  const float lo_r = (float)r_lo, hi_r = (float)r_hi;
  *c0 = (int)fminf(fmaxf(floorf((xmin * isf + isf - 1.0f) * 0.5f), lo_c), hi_c + 1.0f);
  *c1 = (int)fmaxf(fminf(ceilf((xmax * isf + isf - 1.0f) * 0.5f), hi_c), lo_c - 1.0f);
  *r0 = (int)fminf(fmaxf(floorf((isf - 1.0f - ymax * isf) * 0.5f), lo_r), hi_r + 1.0f);
  *r1 = (int)fmaxf(fminf(ceilf((isf - 1.0f - ymin * isf) * 0.5f), hi_r), lo_r - 1.0f);
  return *c0 <= *c1 && *r0 <= *r1;
}

}  // namespace softras
