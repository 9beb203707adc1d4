// N3MR edge-gradient kernel for Hopper (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/n3mr/banded_bwd.py
// _make_banded_kernel (:347, launched at :614 by _axis_pass_pallas, entry
// backward_pixel_map_banded :636) and the segment sum after it (:623-632).
// It computes the NMR finite-difference gradient of the rgb and alpha images
// with respect to each face's vertex x and y (reference rasterize.py:342-660):
// for each (face, edge, axis) it walks d0 along the edge and scans d1 away
// from it, outwards to the screen border where the crossing pixel is the
// face's own (OUT) and inwards to the opposite edge over the face's own pixels
// (IN), and adds -diff / dist for the edge's two endpoints wherever the image
// difference times the incoming gradient is positive.  The predicates follow
// _axis_pass (banded_bwd.py:194-298) line for line.  The TPU's 8-row bands,
// band lists, item chunks, their caps (8,192 items per band, 512 long items)
// and the overflow reports have no counterpart: every edge is processed.
//
// Design.  One block of 6 warps per (batch element, face), one warp per
// (edge, axis) item; a back face's block leaves at once.  The warp loops over
// the edge's d0 range; for each d0 the crossing is computed once (all lanes
// alike), and the 32 lanes stride over the d1 scan.  The wrapper hands the
// kernel every map twice, as is and transposed (banded_bwd.py:176-189 does the
// same with a view), so on both axes the scan runs along contiguous memory and
// the lanes read neighbouring addresses.  Each lane adds its cells in
// ascending d1 order, a shuffle butterfly adds the lanes, and the block's 6
// (c1, c2) pairs are combined into the face's 9 gradient entries by 9 threads:
// no atomics, every sum in a fixed order, two runs give the same bits.
//
// Bound.  Operations: about 25 per scanned cell with a positive difference
// test, on top of 8 loads; an OUT scan runs to the screen border, so the cell
// count is of the order faces x edge pixels x image size (chip_smoke.py counts
// it from its run).  The loads hit L2: the function's bytes (the maps once,
// [B, F, 9] out) are small beside that.  Load is uneven by nature: a long
// silhouette edge of a small mesh is one warp's work.
#include <cuda_runtime.h>

#include "n3mr_common.cuh"

namespace n3mr {

constexpr int kItems = 6;             // 3 edges x 2 axes
constexpr int kThreads = kItems * 32;

struct EdgeBwdArgs {
  const float* pp;      // [B, F, 7] pixel-space x0 y0 x1 y1 x2 y2, front
  const int* fi2;       // [2, B, is, is] face_index transposed, and as is
  const float* planes;  // [2, B, nch, is, is] the maps, transposed and as is:
                        // alpha, grad_alpha (if return_alpha), then rgb 3,
                        // grad_rgb 3 (if return_rgb)
  float* grad_face;     // [B, F, 9]
  int B, F, image_size, nch, return_rgb, return_alpha;
  float eps;
};

// The maps of one cell row M[d0, :] and the values at the crossing pixel.
struct Scan {
  const int* fi;        // face_index row
  const float* pl;      // channel 0 of the row; channel c at pl + c * HW
  size_t HW;
  int ch_a, ch_r;       // first alpha / rgb channel, -1 if off
};

// sum over channels of (map[d1] - map at the crossing pixel dx) * grad[d1]
__device__ __forceinline__ float diff_at(const Scan& s, int d1, const float vx[4]) {
  float diff = 0.0f;
  if (s.ch_a >= 0) {
    const float* p = s.pl + s.ch_a * s.HW;
    diff = diff + (p[d1] - vx[3]) * p[s.HW + d1];
  }
  if (s.ch_r >= 0) {
    const float* p = s.pl + s.ch_r * s.HW;
    const float t0 = (p[d1] - vx[0]) * p[3 * s.HW + d1];
    const float t1 = (p[s.HW + d1] - vx[1]) * p[4 * s.HW + d1];
    const float t2 = (p[2 * s.HW + d1] - vx[2]) * p[5 * s.HW + d1];
    diff = diff + ((t0 + t1) + t2);
  }
  return diff;
}

__device__ __forceinline__ void value_at(const Scan& s, int d1, float vx[4]) {
  vx[0] = vx[1] = vx[2] = vx[3] = 0.0f;
  if (s.ch_a >= 0) vx[3] = s.pl[s.ch_a * s.HW + d1];
  if (s.ch_r >= 0) {
    const float* p = s.pl + s.ch_r * s.HW;
    vx[0] = p[d1];
    vx[1] = p[s.HW + d1];
    vx[2] = p[2 * s.HW + d1];
  }
}

// -diff / dist of one cell for the two endpoints (banded_bwd.py:272-293):
// dist = base / den, moved away from 0 by eps.
__device__ __forceinline__ void add_cell(float diff, float base, float den1,
                                         float den2, float eps, float* c1, float* c2) {
  if (!(diff > 0.0f)) return;
  if (fabsf(den1) > 0.0f) {
    float dist = __fdiv_rn(base, den1);
    dist = dist > 0.0f ? __fadd_rn(dist, eps) : __fsub_rn(dist, eps);
    *c1 += __fdiv_rn(diff, dist);
  }
  if (fabsf(den2) > 0.0f) {
    float dist = __fdiv_rn(base, den2);
    dist = dist > 0.0f ? __fadd_rn(dist, eps) : __fsub_rn(dist, eps);
    *c2 += __fdiv_rn(diff, dist);
  }
}

__global__ void __launch_bounds__(kThreads) n3mr_edgebwd_kernel(const EdgeBwdArgs a) {
  __shared__ float sc[kItems][2];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long bf = blockIdx.x;                    // b * F + f
  const int b = (int)(bf / a.F);
  const int f = (int)(bf - (long long)b * a.F);
  const float* pp = a.pp + bf * 7;
  float* out = a.grad_face + bf * 9;
  if (!(pp[6] > 0.5f)) {                              // a back face
    if (tid < 9) out[tid] = 0.0f;
    return;
  }
  const int is = a.image_size;
  const float isf = (float)is, hi = isf - 1.0f;
  const int e = warp / 2, axis = warp % 2;
  const int i0 = e, i1 = (e + 1) % 3, i2 = (e + 2) % 3;
  const float p00 = pp[2 * i0 + axis], p01 = pp[2 * i0 + 1 - axis];
  const float p10 = pp[2 * i1 + axis], p11 = pp[2 * i1 + 1 - axis];
  const float p20 = pp[2 * i2 + axis], p21 = pp[2 * i2 + 1 - axis];
  const float dir = (p00 < p10 ? -1.0f : 1.0f) * (axis == 0 ? 1.0f : -1.0f);
  const bool up = dir > 0.0f;

  const size_t HW = (size_t)is * is;
  Scan s;
  s.HW = HW;
  s.ch_a = a.return_alpha ? 0 : -1;
  s.ch_r = a.return_rgb ? (a.return_alpha ? 2 : 0) : -1;
  const int* fi_v = a.fi2 + ((size_t)axis * a.B + b) * HW;
  const float* pl_v = a.planes + ((size_t)axis * a.B + b) * a.nch * HW;

  float c1 = 0.0f, c2 = 0.0f;
  const float d0_from = fmaxf(ceilf(fminf(p00, p10)), 0.0f);
  const float d0_to = fminf(fmaxf(p00, p10), hi);
  // a NaN bound fails the test: no cell
  if (d0_from <= d0_to) {
    const float slope = __fdiv_rn(__fsub_rn(p11, p01), __fsub_rn(p10, p00));
    const float slope_a = __fdiv_rn(__fsub_rn(p21, p01), __fsub_rn(p20, p00));
    const float slope_b = __fdiv_rn(__fsub_rn(p11, p21), __fsub_rn(p10, p20));
    const float dp = __fsub_rn(p10, p00);
    const int d0_last = (int)floorf(d0_to);
    for (int d0 = (int)d0_from; d0 <= d0_last; ++d0) {
      const float d0f = (float)d0;
      const float d1_cross = __fadd_rn(__fmul_rn(slope, __fsub_rn(d0f, p00)), p01);
      const float d1_in_f = up ? floorf(d1_cross) : ceilf(d1_cross);
      const float d1_out_f = d1_in_f + dir;
      // float compares before the int cast: NaN and inf fail them
      if (!(d1_in_f >= 0.0f && d1_in_f <= hi && d1_out_f >= 0.0f && d1_out_f <= hi))
        continue;
      const int d1_in = (int)d1_in_f, d1_out = (int)d1_out_f;
      s.fi = fi_v + (size_t)d0 * is;
      s.pl = pl_v + (size_t)d0 * is;
      const float den1 = __fsub_rn(p10, d0f), den2 = __fsub_rn(d0f, p00);
      float vx[4];

      // OUT: from the crossing to the screen border, where the crossing
      // pixel is the face's own
      if (s.fi[d1_in] == f) {
        value_at(s, d1_in, vx);
        const int lim = up ? is - 1 : 0;
        const int lo = max(min(d1_out, lim), 0), hi_o = min(max(d1_out, lim), is - 1);
        for (int d1 = lo + lane; d1 <= hi_o; d1 += 32) {
          const float base = __fdiv_rn(__fmul_rn(__fmul_rn(dp, __fsub_rn((float)d1, d1_cross)),
                                                 2.0f), isf);
          add_cell(diff_at(s, d1, vx), base, den1, den2, a.eps, &c1, &c2);
        }
      }

      // IN: from the crossing to the opposite edge's crossing, over the
      // face's own pixels
      const bool between = __fmul_rn(__fsub_rn(d0f, p00), __fsub_rn(d0f, p20)) < 0.0f;
      const float cross2 = between
          ? __fadd_rn(__fmul_rn(slope_a, __fsub_rn(d0f, p00)), p01)
          : __fadd_rn(__fmul_rn(slope_b, __fsub_rn(d0f, p20)), p21);
      const float lim_f = up ? ceilf(cross2) : floorf(cross2);
      if (isfinite(lim_f)) {
        const int lim = (int)fminf(fmaxf(lim_f, -1.0f), isf);
        const int lo = max(min(d1_in, lim), 0), hi_i = min(max(d1_in, lim), is - 1);
        value_at(s, d1_out, vx);
        for (int d1 = lo + lane; d1 <= hi_i; d1 += 32) {
          if (s.fi[d1] != f) continue;
          const float base = __fdiv_rn(__fmul_rn(__fmul_rn(dp, __fsub_rn((float)d1, d1_cross)),
                                                 2.0f), isf);
          add_cell(diff_at(s, d1, vx), base, den1, den2, a.eps, &c1, &c2);
        }
      }
    }
  }
  c1 = warp_sum(c1);
  c2 = warp_sum(c2);
  if (lane == 0) {
    sc[warp][0] = c1;
    sc[warp][1] = c2;
  }
  __syncthreads();
  if (tid < 9) {
    // vertex v, column col: -c1 of the edge that starts at v and -c2 of the
    // edge that ends at v, both of the axis 1 - col; z gets nothing
    const int v = tid / 3, col = tid % 3;
    float g = 0.0f;
    if (col < 2) {
      const int ax = 1 - col;
      g = -sc[v * 2 + ax][0] - sc[((v + 2) % 3) * 2 + ax][1];
    }
    out[tid] = g;
  }
}

}  // namespace n3mr

extern "C" int n3mr_edgebwd(const n3mr::EdgeBwdArgs* args, void* stream) {
  using namespace n3mr;
  const EdgeBwdArgs& a = *args;
  const long long faces = (long long)a.B * a.F;
  if (faces == 0) return 0;
  n3mr_edgebwd_kernel<<<(unsigned)faces, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int n3mr_edgebwd_args_size() { return (int)sizeof(n3mr::EdgeBwdArgs); }
