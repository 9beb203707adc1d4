// N3MR texture-gradient kernel for Hopper (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/n3mr/pallas_impl.py
// _make_texbwd_kernel (:347, launched at :448 by backward_textures_pallas
// :390) and the segment sum after it (:457-462); for the texture sizes that
// kernel does not serve the JAX package sums per-pixel rows with
// impl.backward_textures_single (:302), the same function.  It computes, per
// face, the sum over the pixels the face won of the tent-weight outer product
// (3 x ts weights, from the pixel's barycentric weights, depth and the
// winner's corner depths) times the pixel's rgb gradient: [B, F, ts, ts, ts, 3].
// The TPU's winner one-hot matmul per (tile, face chunk) and its slot rows
// have no counterpart.
//
// Design.  One warp per (batch element, face); back faces and faces with a
// non-finite corner, which win no pixel, write zeros at once.  The warp walks
// the pixels of the face's pixel-space bounding box (one pixel wider on each
// side than the corners, so rounding cannot hide a won pixel), 32 at a time.
// A lane whose pixel's face_index is the warp's face stages its three texture
// coordinates and its rgb gradient in shared memory (6 floats, whatever the
// texture size); then the lanes change roles: lane t owns output element t
// (t, t + 32, ... of the 3 ts^3), makes the three tent weights of its element
// from the staged coordinates and adds the staged pixels' products to it in
// ascending lane order.  So every sum has a fixed order, there is no atomic,
// and two runs give the same bits.  The per-warp sums live in shared memory,
// kCap of them at a time: a texture of up to 6^3 texels is summed in one walk
// of the bounding box, a larger one in ceil(3 ts^3 / kCap) walks, each for its
// own part of the output.  Any texture size is served.
//
// Bound.  Bytes: face_index of every pixel, and of the pixels a face won the
// weight 3, depth 1, zcorn 3 and gradient 3 values, each read once, and the
// gradient written once; the operations (3 ts^3 products per won pixel) are
// fewer by an order of magnitude.  A face that covers much of the screen is
// walked by its one warp alone: right, and slow.
#include <cuda_runtime.h>

#include "n3mr_common.cuh"

namespace n3mr {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCap = 768;     // per-warp sums held at once (3 * 6^3 = 648 fit)
constexpr int kStage = 6;     // staged floats per pixel: 3 coordinates, 3 gradients

struct TexBwdArgs {
  const float* rows;        // [B, F, 19]
  const int* face_index;    // [B, H, W]
  const float* weight;      // [B, H, W, 3]
  const float* depth;       // [B, H, W]
  const float* zcorn;       // [B, H, W, 3]
  const float* grad_rgb;    // [B, H, W, 3]
  float* grad_tex;          // [B, F, ts^3 * 3]
  int B, F, image_size, ts;
  float eps;
};

__global__ void __launch_bounds__(kThreads) n3mr_texbwd_kernel(const TexBwdArgs a) {
  __shared__ float s_sum[kWarps][kCap];
  __shared__ float s_px[kWarps][32 * kStage];
  const int ts = a.ts;
  const int T3 = ts * ts * ts * 3;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wsum = s_sum[warp];
  float* spx = s_px[warp];

  const long long gw = (long long)blockIdx.x * kWarps + warp;   // b * F + f
  if (gw >= (long long)a.B * a.F) return;
  const int b = (int)(gw / a.F);
  const int f = (int)(gw - (long long)b * a.F);
  const int is = a.image_size;
  const float isf = (float)is;
  const float* r = a.rows + gw * kRow;
  float* out = a.grad_tex + gw * T3;

  // pixel-space bounding box, p = 0.5 * (v * is + is - 1), one pixel wider
  const float x0 = r[0], y0 = r[1], x1 = r[3], y1 = r[4], x2 = r[6], y2 = r[7];
  const bool finite = isfinite(x0) && isfinite(y0) && isfinite(x1) && isfinite(y1) &&
                      isfinite(x2) && isfinite(y2);
  int c0 = 0, c1 = -1, r0 = 0, r1 = -1;
  if (finite && r[kFront] > 0.5f) {
    const float hi = isf - 1.0f;
    const float pxl = 0.5f * (fminf(fminf(x0, x1), x2) * isf + isf - 1.0f);
    const float pxh = 0.5f * (fmaxf(fmaxf(x0, x1), x2) * isf + isf - 1.0f);
    const float pyl = 0.5f * (fminf(fminf(y0, y1), y2) * isf + isf - 1.0f);
    const float pyh = 0.5f * (fmaxf(fmaxf(y0, y1), y2) * isf + isf - 1.0f);
    // clamp before the int cast, so that a huge coordinate cannot overflow it
    c0 = (int)fminf(fmaxf(floorf(pxl) - 1.0f, 0.0f), isf);
    c1 = (int)fmaxf(fminf(ceilf(pxh) + 1.0f, hi), -1.0f);
    r0 = (int)fminf(fmaxf(floorf(pyl) - 1.0f, 0.0f), isf);
    r1 = (int)fmaxf(fminf(ceilf(pyh) + 1.0f, hi), -1.0f);
  }
  const bool walk = c0 <= c1 && r0 <= r1;
  const int w = c1 - c0 + 1;
  const int np = walk ? w * (r1 - r0 + 1) : 0;

  // one walk of the bounding box per kCap output elements
  for (int t0 = 0; t0 < T3; t0 += kCap) {
    const int nt = min(kCap, T3 - t0);
    for (int t = lane; t < nt; t += 32) wsum[t] = 0.0f;
    __syncwarp();
    for (int k0 = 0; k0 < np; k0 += 32) {
      const int k = k0 + lane;
      bool own = false;
      if (k < np) {
        const size_t px = ((size_t)b * is + (r0 + k / w)) * is + (c0 + k % w);
        own = a.face_index[px] == f;
        if (own) {
          float* s = spx + lane * kStage;
          const float d = a.depth[px];
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            // one texel: its tent weight is 1 at coordinate 0
            s[ax] = ts == 1 ? 0.0f
                            : sampling_tif(a.weight[px * 3 + ax], d, a.zcorn[px * 3 + ax],
                                           ts, a.eps);
            s[3 + ax] = a.grad_rgb[px * 3 + ax];
          }
        }
      }
      const unsigned mask = __ballot_sync(0xffffffffu, own);
      if (mask == 0) continue;
      __syncwarp();
      // lane t owns output element t0 + t = ((i * ts + j) * ts + k) * 3 + c
      for (int t = lane; t < nt; t += 32) {
        const int e = t0 + t;
        const int c = e % 3;
        const int kk = (e / 3) % ts;
        const int j = (e / (3 * ts)) % ts;
        const int i = e / (3 * ts * ts);
        float acc = wsum[t];
        unsigned m = mask;
        while (m) {
          const int l = __ffs(m) - 1;
          m &= m - 1;
          const float* s = spx + l * kStage;
          acc += tent(s[0], i) * tent(s[1], j) * tent(s[2], kk) * s[3 + c];
        }
        wsum[t] = acc;
      }
      __syncwarp();
    }
    for (int t = lane; t < nt; t += 32) out[t0 + t] = wsum[t];
    __syncwarp();
  }
}

}  // namespace n3mr

extern "C" int n3mr_texbwd(const n3mr::TexBwdArgs* args, void* stream) {
  using namespace n3mr;
  const TexBwdArgs& a = *args;
  const long long faces = (long long)a.B * a.F;
  if (faces == 0) return 0;
  const unsigned blocks = (unsigned)((faces + kWarps - 1) / kWarps);
  n3mr_texbwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int n3mr_texbwd_args_size() { return (int)sizeof(n3mr::TexBwdArgs); }
