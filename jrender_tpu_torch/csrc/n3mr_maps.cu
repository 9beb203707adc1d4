// N3MR z-buffer kernel for Hopper (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/n3mr/pallas_impl.py
// _make_maps_kernel (:34, launched at :299 by forward_sel_pallas :240) and the
// elementwise pass after it (:308-331).  It computes what they compute: per
// pixel the nearest front face that passes the strict inside test with
// near < depth < far, the lowest face id on exact depth ties, and the winner's
// barycentric weights, pixel-space inverse, corner depths and, with textures,
// its trilinear texture sample.  The TPU's (tile, 128-face chunk) work items,
// revisited VMEM blocks and the one-hot selection matmul (there because a TPU
// cannot gather) have no counterpart, and neither have its caps: a tile's list
// may be any length.
//
// Design.  One block of 16 x 16 threads per (screen tile, batch element), one
// thread per pixel, each warp an 8 x 4 block of pixels.  The block walks its
// tile's face list from the binning (the big faces whose tile range holds the
// tile, then the tile's sorted run), staging chunks of per-face rows (face 9,
// inverse 9, front 1) in shared memory, where every thread reads the same row,
// a broadcast.  A thread tests its pixel against each face and keeps the best
// (depth, face id) and that face's weights in registers; (depth, id) pairs are
// compared, so the order of the walk does not matter.  At the end it writes
// its pixel's maps itself, reading the winner's row and texture volume by id.
// No atomics: the output is deterministic.
//
// Bound.  Bytes: the rows and lists read once, 17 floats and an int (20 with
// rgb) written per pixel: at 1024^2 some 75 MB, 0.02 ms, against about 0.2
// GFLOP of edge tests.  The kernel's time is instead the busiest tile's list,
// walked by one block, as in the SoftRas forward (chip_smoke.py counts both
// from its run).
#include <cuda_runtime.h>

#include "n3mr_common.cuh"

namespace n3mr {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;

struct MapsArgs {
  const float* rows;         // [B, F, 19]
  const float* tex;          // [B, F, ts^3 * 3], or null: no rgb
  const int* faces_sorted;   // [B, L] face ids sorted by (tile, face)
  const int* starts;         // [B, NT] offset of each tile's run
  const int* run_counts;     // [B, NT] length of each tile's run
  const int* glist;          // [B, F] big-face ids, ascending
  const int* gcount;         // [B] valid glist entries
  const int* ranges;         // [B, F, 4] (ty_min, ty_max, tx_min, tx_max)
  int* face_index;           // [B, H, W], -1 where empty
  float* depth;              // [B, H, W], far where empty
  float* weight;             // [B, H, W, 3]
  float* face_inv;           // [B, H, W, 9]
  float* zcorn;              // [B, H, W, 3], 1 where empty
  float* rgb;                // [B, H, W, 3], or null
  int B, F, L, image_size, tiles_x, tiles_y, chunk, ts;
  float near, far, eps;
};

// Trilinear fetch from the winner's [ts, ts, ts, 3] volume, in the plain
// version's nesting: t1 = sum_i w0_i tex[i], t2 = sum_j w1_j t1[j],
// rgb = sum_k w2_k t2[k]; taps of weight 0 are skipped (they add exactly 0).
__device__ __forceinline__ void sample_texture(const float* vol, int ts, float eps,
                                               const float w[3], float depth,
                                               const float z[3], float out[3]) {
  if (ts == 1) {
    out[0] = vol[0];
    out[1] = vol[1];
    out[2] = vol[2];
    return;
  }
  float tif[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) tif[a] = sampling_tif(w[a], depth, z[a], ts, eps);
  out[0] = out[1] = out[2] = 0.0f;
  for (int k = 0; k < ts; ++k) {
    const float wk = tent(tif[2], k);
    if (wk == 0.0f) continue;
    float t2[3] = {0.0f, 0.0f, 0.0f};
    for (int j = 0; j < ts; ++j) {
      const float wj = tent(tif[1], j);
      if (wj == 0.0f) continue;
      float t1[3] = {0.0f, 0.0f, 0.0f};
      for (int i = 0; i < ts; ++i) {
        const float wi = tent(tif[0], i);
        if (wi == 0.0f) continue;
        const float* t = vol + ((i * ts + j) * ts + k) * 3;
        t1[0] += wi * t[0];
        t1[1] += wi * t[1];
        t1[2] += wi * t[2];
      }
      t2[0] += wj * t1[0];
      t2[1] += wj * t1[1];
      t2[2] += wj * t1[2];
    }
    out[0] += wk * t2[0];
    out[1] += wk * t2[1];
    out[2] += wk * t2[2];
  }
}

__global__ void __launch_bounds__(kThreads) n3mr_maps_kernel(const MapsArgs a) {
  extern __shared__ float smem[];
  float* srow = smem;                                          // [chunk, 19]
  int* sid = reinterpret_cast<int*>(smem + a.chunk * kRow);    // [chunk]

  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int tile_x = blockIdx.x, tile_y = blockIdx.y, b = blockIdx.z;
  const int col = tile_x * kTile + tx;
  const int rowp = tile_y * kTile + ty;
  const int is = a.image_size;
  const bool live = col < is && rowp < is;
  const float isf = (float)is;
  // integer pixel coordinates, and the NDC pixel centres (2c + 1 - is) / is;
  // y grows with the row (torch_impl._pixel_coords)
  const float XI = (float)col, YI = (float)rowp;
  const float xp = __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, XI), 1.0f), isf), isf);
  const float yp = __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, YI), 1.0f), isf), isf);

  const int NT = a.tiles_x * a.tiles_y;
  const int tile = tile_y * a.tiles_x + tile_x;
  const int gcount = a.gcount[b];
  const int run = a.run_counts[b * NT + tile];
  const int start = a.starts[b * NT + tile];
  const int total = gcount + run;
  const float* rows_b = a.rows + (size_t)b * a.F * kRow;

  float best_z = 0.0f, bw0 = 0.0f, bw1 = 0.0f, bw2 = 0.0f;
  int best_f = -1;

  for (int base = 0; base < total; base += a.chunk) {
    const int n = min(a.chunk, total - base);
    __syncthreads();  // the previous chunk has been consumed
    if (tid < n) {
      const int pos = base + tid;
      int id;
      if (pos < gcount) {
        const int g = a.glist[(size_t)b * a.F + pos];
        const int* rg = a.ranges + ((size_t)b * a.F + g) * 4;
        id = (tile_y >= rg[0] && tile_y <= rg[1] && tile_x >= rg[2] &&
              tile_x <= rg[3]) ? g : -1;
      } else {
        id = a.faces_sorted[(size_t)b * a.L + start + (pos - gcount)];
      }
      sid[tid] = id;
    }
    __syncthreads();
    for (int i = tid; i < n * kRow; i += kThreads) {
      const int j = i / kRow;
      const int id = sid[j];
      if (id >= 0) srow[i] = rows_b[(size_t)id * kRow + (i - j * kRow)];
    }
    __syncthreads();
    if (!live) continue;

    for (int j = 0; j < n; ++j) {
      const int fid = sid[j];
      if (fid < 0) continue;  // a big face outside this tile
      const float* r = srow + j * kRow;
      if (!(r[kFront] > 0.5f)) continue;
      const float x0 = r[0], y0 = r[1], x1 = r[3], y1 = r[4], x2 = r[6], y2 = r[7];
      // strict inside test in NDC (rasterize.py:113-116)
      const bool e0 = __fmul_rn(__fsub_rn(yp, y0), __fsub_rn(x1, x0)) <
                      __fmul_rn(__fsub_rn(xp, x0), __fsub_rn(y1, y0));
      const bool e1 = __fmul_rn(__fsub_rn(yp, y1), __fsub_rn(x2, x1)) <
                      __fmul_rn(__fsub_rn(xp, x1), __fsub_rn(y2, y1));
      const bool e2 = __fmul_rn(__fsub_rn(yp, y2), __fsub_rn(x0, x2)) <
                      __fmul_rn(__fsub_rn(xp, x2), __fsub_rn(y0, y2));
      if (e0 || e1 || e2) continue;
      // barycentrics at integer pixel coordinates, clipped, normalised
      float w[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* iv = r + kInv + 3 * k;
        w[k] = clamp_nan(__fadd_rn(__fadd_rn(__fmul_rn(iv[0], XI), __fmul_rn(iv[1], YI)),
                                   iv[2]), 0.0f, 1.0f);
      }
      const float wsum = __fadd_rn(__fadd_rn(w[0], w[1]), w[2]);
#pragma unroll
      for (int k = 0; k < 3; ++k) w[k] = __fdiv_rn(w[k], wsum);
      const float zp = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(__fdiv_rn(w[0], r[2]),
                                                           __fdiv_rn(w[1], r[5])),
                                                 __fdiv_rn(w[2], r[8])));
      // NaN fails both tests: a degenerate face never wins
      if (!(zp > a.near && zp < a.far)) continue;
      if (best_f < 0 || zp < best_z || (zp == best_z && fid < best_f)) {
        best_z = zp;
        best_f = fid;
        bw0 = w[0];
        bw1 = w[1];
        bw2 = w[2];
      }
    }
  }
  if (!live) return;

  const size_t px = ((size_t)b * is + rowp) * is + col;
  const bool has = best_f >= 0;
  a.face_index[px] = best_f;
  a.depth[px] = has ? best_z : a.far;
  const float wgt[3] = {bw0, bw1, bw2};
  float z[3] = {1.0f, 1.0f, 1.0f};
  const float* r = rows_b + (size_t)(has ? best_f : 0) * kRow;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.weight[px * 3 + k] = wgt[k];
    if (has) z[k] = r[3 * k + 2];
    a.zcorn[px * 3 + k] = z[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) a.face_inv[px * 9 + k] = has ? r[kInv + k] : 0.0f;
  if (a.tex != nullptr) {
    float c[3] = {0.0f, 0.0f, 0.0f};
    if (has) {
      const int T3 = a.ts * a.ts * a.ts * 3;
      sample_texture(a.tex + ((size_t)b * a.F + best_f) * T3, a.ts, a.eps, wgt,
                     best_z, z, c);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) a.rgb[px * 3 + k] = c[k];
  }
}

}  // namespace n3mr

extern "C" int n3mr_maps(const n3mr::MapsArgs* args, void* stream) {
  using namespace n3mr;
  const MapsArgs& a = *args;
  const dim3 grid(a.tiles_x, a.tiles_y, a.B);
  const dim3 block(kTile, kTile);
  const size_t smem = (size_t)a.chunk * (kRow * sizeof(float) + sizeof(int));
  n3mr_maps_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int n3mr_maps_args_size() { return (int)sizeof(n3mr::MapsArgs); }
