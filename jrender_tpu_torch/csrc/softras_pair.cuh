// SoftRas per-(pixel, face) math as CUDA device functions.
//
// Counterpart of the pair math that every SoftRas kernel of the JAX
// package inlines (jrender_tpu/ops/softras/pallas_impl.py):
//   _euclid_kernel :74, _pair_terms_kernel :167, _surface_tex_idx :265,
//   _pair_colors :272
// and of the plain version in ops/softras/geometry.py and torch_impl.py,
// whose arithmetic it follows operation for operation.
//
// Rounding.  nvcc contracts a*b + c into one FMA by default; PyTorch
// rounds every operation.  The barycentrics, the point-to-face distance
// and the texel selector are written with the _rn intrinsics (never
// contracted) in the plain version's order of operations, so they carry
// the same bits: on a sliver face the barycentrics are ill-conditioned
// and one contraction moves the distance, the coverage and the texel.
// The barycentrics are fma(inv0, x, inv1 * y) + inv2 in both versions.
// The remaining terms are continuous and may move by an ulp; expf (never
// __expf) keeps the exponentials as exact as PyTorch's, and the online
// softmax rescales where the plain version exponentiates once.  So a few
// knife-edge pixels can still differ, which the checks allow.
//
// Depth bits.  The backward masks a pair with zp <= thr, and thr is a zp
// that the threshold kernel computed.  clipped_depth() is the one place
// that computes zp, and it is written with _rn intrinsics only (IEEE
// division and addition, nothing that nvcc may contract or reorder), so
// the forward, the threshold and the backward kernels get the same bits
// for the same pair whatever else each of them inlines around it.
//
// Face row layout (floats), staged in shared memory by the kernel:
//   [0, 9)    face  x0 y0 z0 x1 y1 z1 x2 y2 z2 (screen space)
//   [9, 18)   inv   barycentric inverse, row k = (a, b, c) of w_k
//   [18, 27)  sym   p_i . p_j + 1 over the xy corners
//   [27, 30)  obt   first-obtuse-corner flags
//   [30]      front 1 when the face is front facing
//   [31, ...) tex   3T texel rgb (surface) or 3 corner rgb (vertex)
#pragma once

#include <cuda_runtime.h>

namespace softras {

constexpr int kFace = 0;
constexpr int kInv = 9;
constexpr int kSym = 18;
constexpr int kObt = 27;
constexpr int kFront = 30;
constexpr int kTex = 31;

constexpr int kDistHard = 0;
constexpr int kDistBary = 1;
constexpr int kDistEuclid = 2;
constexpr int kRgbHard = 0;
constexpr int kRgbSoftmax = 1;
constexpr int kAlphaHard = 0;
constexpr int kAlphaSum = 1;
constexpr int kAlphaProd = 2;

constexpr float kBigDepth = 10000000.0f;

struct Scalars {
  float near, far, far_minus_near, eps, sigma, gamma;
  float threshold;   // dist_eps * sigma, the squared-distance cut
  float sq;          // sqrt(threshold), the bbox inflation
  float bg[3];
  int fill_back;
  int texture_type;  // 0 surface, 1 vertex
  int tex_res;       // R, with T = R * R texels per face
};

// Quantities of one (pixel, face) pair, for a pair inside the inflated
// bbox and the distance cut (alpha_valid).  The forward reads the first
// five; the backward also reads the rest, which pair_terms fills only
// when its GRAD flag is set (filling them unasked cost the forward
// kernel 4% of its time on the bench sphere).
struct PairTerms {
  float wc[3];       // clipped, renormalised barycentrics
  float sf;          // coverage (sigmoid of the signed distance)
  float zp;          // perspective-correct depth
  bool tk_valid;     // near <= zp <= far
  bool inside;       // 0 <= w <= 1 (closed), the hard-rgb winner test
  float w[3];        // unclipped barycentrics
  float sign;        // euclidean: +1 inside the face, -1 outside
  float dis_x, dis_y;  // euclidean: offset to the closest point of the face
  float tau[3];      // euclidean: barycentrics of that closest point
};

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

__device__ __forceinline__ float safe_div(float a, float b) {
  const float e = 1e-30f;
  if (fabsf(b) < e) b = b < 0.0f ? -e : e;
  return a / b;
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Offsets t - w of the projection of the barycentric point w onto the
// edge (v0, v0+1), geometry._edge_projection; returns dx, dy and, with
// TAU, the projected point's barycentrics.
template <bool TAU>
__device__ __forceinline__ void edge_projection(const float* r,
                                                const float w[3], int v0,
                                                bool clamp, float* dx,
                                                float* dy, float tau[3]) {
  const int v1 = (v0 + 1) % 3;
  const int v2 = (v0 + 2) % 3;
  const float* sym = r + kSym;
  float a0[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) a0[j] = sym[3 * v0 + j] - sym[3 * v1 + j];
  const float num = __fsub_rn(dot3_rn(w[0], w[1], w[2], a0[0], a0[1], a0[2]), a0[v1]);
  const float den = a0[v0] - a0[v1];
  float tv0 = safe_div(num, den);
  float tv1;
  if (clamp) {
    tv0 = clamp01(tv0);
    tv1 = clamp01(1.0f - tv0);
  } else {
    tv1 = 1.0f - tv0;
  }
  float t[3];
  t[v0] = tv0 - w[v0];
  t[v1] = tv1 - w[v1];
  t[v2] = 0.0f - w[v2];
  if (TAU) {
    tau[v0] = tv0;  // the projected point itself, t + w of the plain version
    tau[v1] = tv1;
    tau[v2] = 0.0f;
  }
  *dx = dot3_rn(t[0], t[1], t[2], r[kFace + 0], r[kFace + 3], r[kFace + 6]);
  *dy = dot3_rn(t[0], t[1], t[2], r[kFace + 1], r[kFace + 4], r[kFace + 7]);
}

// (p - p_base) . (p_other - p_base) > 0: the obtuse-corner redirection.
__device__ __forceinline__ bool corner_shift(const float* r, int base,
                                             int other, float xp, float yp) {
  const float bx = r[kFace + 3 * base], by = r[kFace + 3 * base + 1];
  const float ox = r[kFace + 3 * other], oy = r[kFace + 3 * other + 1];
  return __fadd_rn(__fmul_rn(xp - bx, ox - bx),
                   __fmul_rn(yp - by, oy - by)) > 0.0f;
}

// geometry.euclidean_p2f_distance (reference soft_rasterize.py:57-147):
// sets sign (+1 inside, -1 outside), the offset (dx, dy) to the closest
// point, the squared distance and, with TAU, that point's barycentrics.
template <bool TAU>
__device__ __forceinline__ void euclidean_distance(const float* r,
                                                   const float w[3],
                                                   float xp, float yp,
                                                   float* sign, float* dis,
                                                   float* dxo, float* dyo,
                                                   float tau[3]) {
  const bool inside = w[0] > 0.0f && w[0] < 1.0f && w[1] > 0.0f &&
                      w[1] < 1.0f && w[2] > 0.0f && w[2] < 1.0f;
  float dx, dy;
  if (inside) {
    // closest of the three unclamped edge projections; first min wins
    float best = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float ex, ey, et[3];
      edge_projection<TAU>(r, w, k, false, &ex, &ey, et);
      const float d = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
      if (k == 0 || d < best) {
        best = d;
        dx = ex;
        dy = ey;
        if (TAU) {
          tau[0] = et[0];
          tau[1] = et[1];
          tau[2] = et[2];
        }
      }
    }
    *sign = 1.0f;
  } else {
    // corner-region casework (soft_rasterize.py:109-121)
    const bool w0n = w[0] <= 0.0f, w1n = w[1] <= 0.0f, w2n = w[2] <= 0.0f;
    const float* obt = r + kObt;
    int v0;
    if (w1n && w2n) {
      v0 = (obt[0] == 1.0f && corner_shift(r, 0, 2, xp, yp)) ? 2 : 0;
    } else if (w2n && w0n) {
      v0 = (obt[1] == 1.0f && corner_shift(r, 1, 0, xp, yp)) ? 0 : 1;
    } else if (w0n && w1n) {
      v0 = (obt[2] == 1.0f && corner_shift(r, 2, 1, xp, yp)) ? 1 : 2;
    } else if (w0n) {
      v0 = 1;
    } else if (w1n) {
      v0 = 2;
    } else {
      v0 = 0;  // w2 <= 0, or some w >= 1 with all w > 0
    }
    edge_projection<TAU>(r, w, v0, true, &dx, &dy, tau);
    *sign = -1.0f;
  }
  *dxo = dx;
  *dyo = dy;
  *dis = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// geometry.barycentric_clip and perspective_depth: the clipped,
// renormalised barycentrics wc and zp = 1 / sum(wc_k / z_k).  Intrinsics
// only, so that every kernel computes the same bits (see "Depth bits").
__device__ __forceinline__ float clipped_depth(const float* r, const float w[3],
                                               float wc[3]) {
  const float c0 = clamp01(w[0]), c1 = clamp01(w[1]), c2 = clamp01(w[2]);
  const float wsum = fmaxf(__fadd_rn(__fadd_rn(c0, c1), c2), 1e-5f);
  wc[0] = __fdiv_rn(c0, wsum);
  wc[1] = __fdiv_rn(c1, wsum);
  wc[2] = __fdiv_rn(c2, wsum);
  return __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(__fdiv_rn(wc[0], r[kFace + 2]),
                                             __fdiv_rn(wc[1], r[kFace + 5])),
                                   __fdiv_rn(wc[2], r[kFace + 8])));
}

// _pairwise_terms of the plain version for one pair.  Returns alpha_valid
// and fills *t only when it is true: a pair outside the inflated bbox or
// past the distance cut reaches no accumulator (alpha, count and rgb all
// read alpha_valid first), so the rest of its math is skipped.  Most
// pairs of a tile list lie outside the face's bbox, so the cheap bbox
// test comes first.
template <int DIST, bool GRAD = false>
__device__ __forceinline__ bool pair_terms(const float* r, float xp, float yp,
                                           const Scalars& s, PairTerms* t) {
  const float x0 = r[kFace + 0], x1 = r[kFace + 3], x2 = r[kFace + 6];
  const float y0 = r[kFace + 1], y1 = r[kFace + 4], y2 = r[kFace + 7];
  const float xmax = fmaxf(fmaxf(x0, x1), x2), xmin = fminf(fminf(x0, x1), x2);
  const float ymax = fmaxf(fmaxf(y0, y1), y2), ymin = fminf(fminf(y0, y1), y2);
  if (xp > xmax + s.sq || xp < xmin - s.sq || yp > ymax + s.sq ||
      yp < ymin - s.sq)
    return false;

  const float* inv = r + kInv;
  // fma(inv0, x, inv1 * y) + inv2, as the plain version rounds it
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    w[k] = __fadd_rn(__fmaf_rn(inv[3 * k], xp, __fmul_rn(inv[3 * k + 1], yp)),
                     inv[3 * k + 2]);

  const bool inside = w[0] >= 0.0f && w[0] <= 1.0f && w[1] >= 0.0f &&
                      w[1] <= 1.0f && w[2] >= 0.0f && w[2] <= 1.0f;
  if (DIST == kDistHard) {
    if (!inside) return false;
    t->sf = 1.0f;
  } else if (DIST == kDistBary) {
    const float mn = fminf(fminf(w[0], w[1]), w[2]);
    const float dis = mn > 0.0f ? mn * mn : -(mn * mn);
    if (-dis >= s.threshold) return false;
    t->sf = sigmoid(dis / s.sigma);
  } else {
    float sign, dis, dx, dy, tau[3];
    euclidean_distance<GRAD>(r, w, xp, yp, &sign, &dis, &dx, &dy, tau);
    if (sign < 0.0f && dis >= s.threshold) return false;
    t->sf = sigmoid(sign * dis / s.sigma);
    if (GRAD) {
      t->sign = sign;
      t->dis_x = dx;
      t->dis_y = dy;
#pragma unroll
      for (int k = 0; k < 3; ++k) t->tau[k] = tau[k];
    }
  }
  t->inside = inside;
  if (GRAD) {
#pragma unroll
    for (int k = 0; k < 3; ++k) t->w[k] = w[k];
  }

  t->zp = clipped_depth(r, w, t->wc);
  t->tk_valid = t->zp >= s.near && t->zp <= s.far;
  return true;
}

// geometry.sample_texture_surface_idx (forward_sample_texture :156-166)
__device__ __forceinline__ int surface_tex_idx(const float wc[3], int R) {
  const float Rf = (float)R;
  const int w_x = (int)fminf(__fmul_rn(wc[0], Rf), (float)(R - 1));
  const int w_y = (int)fminf(__fmul_rn(wc[1], Rf), (float)(R - 1));
  const float lowv = __fsub_rn(
      __fsub_rn(__fmul_rn(__fadd_rn(wc[0], wc[1]), Rf), (float)w_x),
      (float)w_y);
  return lowv <= 1.0f ? w_y * R + w_x : (R - 1 - w_y) * R + (R - 1 - w_x);
}

// _sample_colors of the plain version: perspective-correct colour.
__device__ __forceinline__ void pair_color(const float* r, const PairTerms& t,
                                           const Scalars& s, float c[3]) {
  const float* tex = r + kTex;
  if (s.texture_type == 0) {
    const int idx = surface_tex_idx(t.wc, s.tex_res);
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = tex[3 * idx + k];
  } else {
    const float wz0 = t.wc[0] / r[kFace + 2];
    const float wz1 = t.wc[1] / r[kFace + 5];
    const float wz2 = t.wc[2] / r[kFace + 8];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      c[k] = (wz0 * tex[k] + wz1 * tex[3 + k] + wz2 * tex[6 + k]) * t.zp;
  }
}

// Bands of 16-px tile rows (the binned kernels' ty0, ty_band, ty_stride,
// band_h): band row k is tile row ty0 + k * ty_stride, and the band's maps
// hold its image rows, band row k * 16 + i being image row
// (ty0 + k * ty_stride) * 16 + i.  band_ok: a band the kernels can take
// (its last row inside the image's tile rows, its maps no taller than
// its rows).
template <class Args>
inline bool band_ok(const Args& a) {
  return a.ty0 >= 0 && a.ty_band >= 1 && a.ty_stride >= 1 &&
         a.ty0 + (a.ty_band - 1) * a.ty_stride < a.tiles_y && a.band_h >= 1 &&
         a.band_h <= a.ty_band * 16;
}

}  // namespace softras
