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
// non-finite corner, which win no pixel, write zeros.  The warp walks the
// pixels of the face's pixel-space bounding box (one pixel wider on each side
// than the corners, so rounding cannot hide a won pixel), 32 at a time.  A
// lane whose pixel's face_index is the warp's face stages its three texture
// coordinates and its rgb gradient in shared memory (6 floats, whatever the
// texture size); then the lanes change roles: lane t owns output elements t,
// t + 32, ... of the 3 ts^3 and adds the staged pixels' products to them in
// ascending lane order.  So every sum runs over the face's won pixels in
// ascending row-major order from 0.0f, there is no atomic, and two runs give
// the same bits.
//
// What bounds it.  Bytes: face_index of every pixel, and of the pixels a face
// won the weight 3, depth 1, zcorn 3 and gradient 3 values, each read once,
// and the gradient written once (5.5 us at 1024^2 on the 39,474-face sphere);
// the operations (3 ts^3 products per won pixel) are fewer by an order of
// magnitude.  What holds it back is latency: a chunk's face_index load, then
// its won pixels' loads, then the sums, at a few blocks an SM.  The first
// design kept every warp's sums in shared memory (30 KB a block, sized for
// ts <= 6: 5 blocks an SM) and waited for each chunk's face_index.  So:
//  - at ts <= 4 (3 ts^3 <= 192: the bench's ts = 2, demo 4's ts = 4) a lane
//    keeps its sums in registers, ceil(3 ts^3 / 32) of them, in a template
//    instance a size; the block needs only the 6 KB of staged pixels.  Larger
//    textures keep the per-warp sums in shared memory, kCap at a time, one
//    walk of the bounding box per kCap elements: any size is served;
//  - the next chunk's face_index is loaded before the current chunk is staged
//    and summed, so a chunk waits on one trip to memory, its values'.
// PERF.md has the readings of the elements that lost: the next chunk's
// values loaded ahead too (registers: 3 blocks an SM at ts = 4), a block's
// faces taken from a counter by its warps, and register caps.
// A face that covers much of the screen is walked by its one warp alone:
// right, and slow.
#include <cuda_runtime.h>

#include "n3mr_common.cuh"

namespace n3mr {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCap = 768;     // per-warp shared sums held at once (3 * 6^3 = 648 fit)
constexpr int kStage = 6;     // staged floats per pixel: 3 coordinates, 3 gradients
constexpr int kRegTs = 4;     // texture sizes whose sums a lane keeps in registers

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

// The walk of one face: its pixel-space bounding box, one pixel wider on each
// side, as np pixels of rows r0.. and columns c0 .. c0 + w - 1; np = 0 for a
// back face or a non-finite corner.
struct Walk {
  size_t base;   // (b * is + r0) * is + c0
  int f, w, np;
};

__device__ __forceinline__ Walk face_walk(const TexBwdArgs& a, long long gw) {
  const int b = (int)(gw / a.F);
  const int f = (int)(gw - (long long)b * a.F);
  const int is = a.image_size;
  const float isf = (float)is;
  const float* r = a.rows + gw * kRow;
  // p = 0.5 * (v * is + is - 1)
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
  Walk wk;
  wk.f = f;
  wk.w = c1 - c0 + 1;
  wk.np = c0 <= c1 && r0 <= r1 ? wk.w * (r1 - r0 + 1) : 0;
  wk.base = ((size_t)b * is + r0) * is + c0;
  return wk;
}

__device__ __forceinline__ size_t walk_pixel(const TexBwdArgs& a, const Walk& wk, int k) {
  return wk.base + (size_t)(k / wk.w) * a.image_size + k % wk.w;
}

// face_index of pixel k of the walk, -1 past its end
__device__ __forceinline__ int walk_face(const TexBwdArgs& a, const Walk& wk, int k) {
  return k < wk.np ? a.face_index[walk_pixel(a, wk, k)] : -1;
}

// What a won pixel contributes: its maps' values, loaded ahead of the staging
struct PixelVals {
  float w[3], z[3], g[3], d;
};

__device__ __forceinline__ void load_vals(const TexBwdArgs& a, size_t px, PixelVals& v) {
  v.d = a.depth[px];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    v.w[ax] = a.weight[px * 3 + ax];
    v.z[ax] = a.zcorn[px * 3 + ax];
    v.g[ax] = a.grad_rgb[px * 3 + ax];
  }
}

__device__ __forceinline__ void stage(const PixelVals& v, int ts, float eps, float* s) {
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    // one texel: its tent weight is 1 at coordinate 0
    s[ax] = ts == 1 ? 0.0f : sampling_tif(v.w[ax], v.d, v.z[ax], ts, eps);
    s[3 + ax] = v.g[ax];
  }
}

// Output element e = ((i * ts + j) * ts + k) * 3 + c: one staged pixel's term
__device__ __forceinline__ float term(const float* s, int e, int ts) {
  const int c = e % 3;
  const int kk = (e / 3) % ts;
  const int j = (e / (3 * ts)) % ts;
  const int i = e / (3 * ts * ts);
  return tent(s[0], i) * tent(s[1], j) * tent(s[2], kk) * s[3 + c];
}

// A lane's sums of one walk, zeroed when made: TS > 0, in registers
// (elements lane, lane + 32, ... of the 3 TS^3); TS = 0, the warp's sums of
// elements t0 .. t0 + nt - 1 in shared memory (wsum), lane t adding to t,
// t + 32, ...  add() adds the staged pixels of `mask` in ascending lane order.
template <int TS>
struct Sums {
  static constexpr int kT3 = 3 * TS * TS * TS;
  static constexpr int kN = (kT3 + 31) / 32;
  const int lane;
  float v[kN];
  __device__ __forceinline__ Sums(int lane, int, int, float*, int) : lane(lane) {
#pragma unroll
    for (int q = 0; q < kN; ++q) v[q] = 0.0f;
  }
  __device__ __forceinline__ void add(const float* spx, unsigned mask) {
    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      const float* s = spx + l * kStage;
#pragma unroll
      for (int q = 0; q < kN; ++q) {
        const int e = lane + 32 * q;
        if (e < kT3) v[q] += term(s, e, TS);
      }
    }
  }
  __device__ __forceinline__ void store(float* out) {
#pragma unroll
    for (int q = 0; q < kN; ++q) {
      const int e = lane + 32 * q;
      if (e < kT3) out[e] = v[q];
    }
  }
};

template <>
struct Sums<0> {
  const int lane, t0, nt, ts;
  float* const wsum;
  __device__ __forceinline__ Sums(int lane, int t0, int nt, float* wsum, int ts)
      : lane(lane), t0(t0), nt(nt), ts(ts), wsum(wsum) {
    for (int t = lane; t < nt; t += 32) wsum[t] = 0.0f;
    __syncwarp();
  }
  __device__ __forceinline__ void add(const float* spx, unsigned mask) {
    for (int t = lane; t < nt; t += 32) {
      float acc = wsum[t];
      unsigned m = mask;
      while (m) {
        const int l = __ffs(m) - 1;
        m &= m - 1;
        acc += term(spx + l * kStage, t0 + t, ts);
      }
      wsum[t] = acc;
    }
  }
  __device__ __forceinline__ void store(float* out) {
    for (int t = lane; t < nt; t += 32) out[t0 + t] = wsum[t];
    __syncwarp();
  }
};

// One face's gradient: every walk of its bounding box (one at ts <= 4)
template <int TS>
__device__ __forceinline__ void face_grad(const TexBwdArgs& a, long long gw, int lane,
                                          float* spx, float* wsum) {
  const int ts = TS > 0 ? TS : a.ts;
  const int T3 = ts * ts * ts * 3;
  const Walk wk = face_walk(a, gw);
  float* out = a.grad_tex + gw * T3;
  for (int t0 = 0; t0 < T3; t0 += kCap) {
    Sums<TS> sums(lane, t0, min(kCap, T3 - t0), wsum, ts);
    // the next chunk's face_index in flight while one chunk is staged and summed
    int fi = walk_face(a, wk, lane);
    for (int k0 = 0; k0 < wk.np; k0 += 32) {
      const bool own = fi == wk.f;
      PixelVals v;
      if (own) load_vals(a, walk_pixel(a, wk, k0 + lane), v);
      fi = walk_face(a, wk, k0 + 32 + lane);
      if (own) stage(v, ts, a.eps, spx + lane * kStage);
      const unsigned mask = __ballot_sync(0xffffffffu, own);
      if (mask == 0) continue;
      __syncwarp();
      sums.add(spx, mask);
      __syncwarp();
    }
    sums.store(out);
  }
}

template <int TS>
__global__ void __launch_bounds__(kThreads) n3mr_texbwd_kernel(const TexBwdArgs a) {
  __shared__ float s_px[kWarps][32 * kStage];
  __shared__ float s_sum[TS > 0 ? 1 : kWarps][TS > 0 ? 1 : kCap];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long gw = (long long)blockIdx.x * kWarps + warp;   // b * F + f
  if (gw >= (long long)a.B * a.F) return;
  face_grad<TS>(a, gw, lane, s_px[warp], s_sum[TS > 0 ? 0 : warp]);
}

template <int TS>
cudaError_t launch(const TexBwdArgs& a, cudaStream_t stream) {
  const long long faces = (long long)a.B * a.F;
  const unsigned blocks = (unsigned)((faces + kWarps - 1) / kWarps);
  n3mr_texbwd_kernel<TS><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int TS>
cudaError_t occupancy(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, n3mr_texbwd_kernel<TS>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, n3mr_texbwd_kernel<TS>,
                                                        kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return err;
}

// the instance that serves texture size ts: its register sums up to kRegTs
__host__ int instance(int ts) { return ts >= 1 && ts <= kRegTs ? ts : 0; }

}  // namespace n3mr

extern "C" int n3mr_texbwd(const n3mr::TexBwdArgs* args, void* stream) {
  using namespace n3mr;
  const TexBwdArgs& a = *args;
  if ((long long)a.B * a.F == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (instance(a.ts)) {
    case 1: return (int)launch<1>(a, st);
    case 2: return (int)launch<2>(a, st);
    case 3: return (int)launch<3>(a, st);
    case 4: return (int)launch<4>(a, st);
    default: return (int)launch<0>(a, st);
  }
}

// Registers, local (spill) bytes and blocks an SM of the instance that
// serves texture size ts, from the CUDA runtime.
extern "C" int n3mr_texbwd_occupancy(int ts, int* out) {
  using namespace n3mr;
  switch (instance(ts)) {
    case 1: return (int)occupancy<1>(out);
    case 2: return (int)occupancy<2>(out);
    case 3: return (int)occupancy<3>(out);
    case 4: return (int)occupancy<4>(out);
    default: return (int)occupancy<0>(out);
  }
}

extern "C" int n3mr_texbwd_args_size() { return (int)sizeof(n3mr::TexBwdArgs); }
