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
// What bounds it.  Bytes: the rows and lists read once, 17 floats and an int
// (20 with rgb) written per pixel: at 1024^2 some 75 MB, 0.027 ms, against
// about 0.2 GFLOP of edge tests.  What held the first design back (one block
// of 16 x 16 threads walking its tile's whole list, every thread testing every
// staged face; 0.253 ms at 1024^2 on the 39,474-face sphere) was threefold:
// the writes (a thread's 20 values at strides of 12 and 36 bytes: 0.14 ms
// with every list empty), a walk in which every thread of a tile tested every
// face of its list though most faces meet few of a tile's 8 warps, and the
// longest lists (the busiest, 544 faces, where the sphere's pole is seen
// edge-on), each walked by one block.
//
// Design.  A block of 256 threads per screen tile, one thread per pixel, each
// warp an 8 x 4 block of pixels.  A tile's list is one sequence of gcount +
// run face ids: the big faces whose tile range holds the tile, then the
// tile's sorted run.
//  Pooled split: a cluster of kSplit blocks takes kSplit tiles of a column
//    (tile rows ty0 .. ty0 + kSplit - 1); their lists, one after the other,
//    are cut into kSplit equal shares, and block r walks share r, so a long
//    list is shared with its neighbours' short ones and no block is added.
//    Each block keeps, for every tile its share touches, its pixels' best
//    state in shared memory; block r then reads tile r's states from the
//    ranks whose shares touched it through distributed shared memory, in
//    rank order, and keeps the least (depth, id).  (A first design split
//    each tile's own list over kSplit blocks; its idle blocks on the many
//    short lists cost more than the long lists' walk, PERF.md.)
//  Staging: chunks of 128 positions of the share, 16 a warp; a warp's lanes
//    load the ids (and their tiles) one chunk ahead, keep those that name a
//    face by a ballot (a big face outside the tile is -1), and copy their rows
//    into shared memory with cp.async, double-buffered, one block barrier a
//    chunk.
//  Walk: a warp's lanes test 32 staged faces at once with the warp's corner
//    test (warp_misses: an edge whose test rejects the warp's corner pixels
//    rejects all of them; back faces are skipped there too), and the warp
//    walks only the faces a ballot keeps, in position order, so the tile
//    changes at most kSplit - 1 times.  A thread keeps its pixel's best
//    (depth, id) and that face's weights; pairs are compared by (depth, id),
//    so the order of the walk and the shares' bounds do not matter.
//  Epilogue: block r forms its tile's pixels' maps, reading the winner's row
//    and texture volume by id, stages them in shared memory and writes each
//    map a tile row at a time, so a warp's stores fill whole sectors.
// No atomics: the output is deterministic, and the same at every build.
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "n3mr_common.cuh"

// The compile-time choice (PERF.md has the times of each): the tiles (and
// blocks) a cluster pools.
#ifndef N3MR_MAPS_SPLIT
#define N3MR_MAPS_SPLIT 4
#endif

namespace n3mr {

namespace cg = cooperative_groups;

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 128;                  // positions a chunk
constexpr int kPerWarp = kChunk / kWarps;    // positions a warp stages a chunk
constexpr int kSplit = N3MR_MAPS_SPLIT;
constexpr int kState = 5;                    // depth, id, three weights
constexpr int kMaps = 20;                    // values of a pixel's maps
constexpr int kNoCluster = -1;               // the cluster cannot be resident
constexpr size_t kSmemDefault = 48 * 1024;
static_assert(kSplit == 1 || kSplit == 2 || kSplit == 4 || kSplit == 8,
              "a portable cluster of 1, 2, 4 or 8 blocks");
static_assert(kPerWarp <= 32 && kChunk % 32 == 0, "a warp's lanes hold its positions");

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
  // the tiles launched: the clusters that hold tile columns first_col ..
  // first_col + n_cols - 1 and tile rows first_row .. first_row + n_rows - 1
  // (all tiles_x x tiles_y for a frame); the maps of the others are not written
  int first_col, first_row, n_cols, n_rows;
  float near, far, eps;
};

// The NDC centre of pixel column (or row) c: (2c + 1 - is) / is
// (torch_impl._pixel_coords).
__device__ __forceinline__ float centre(float c, float isf) {
  return __fdiv_rn(__fsub_rn(__fadd_rn(__fmul_rn(2.0f, c), 1.0f), isf), isf);
}

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

// A pixel's best face so far.
struct Best {
  float z, w0, w1, w2;
  int f;
};

// The pixel's test of one face (rasterize.py:113-133), in the plain version's
// operations and order (torch_impl._pair_terms): the strict inside test in
// NDC, the clipped and normalised barycentrics at integer pixel coordinates,
// the depth; a pair with near < depth < far replaces the best where its
// (depth, id) is less.  NaN fails both depth tests: a degenerate face never
// wins.
__device__ __forceinline__ void test_face(const float* r, int fid, float xp, float yp,
                                          float XI, float YI, float near, float far,
                                          Best& b) {
  const float x0 = r[0], y0 = r[1], x1 = r[3], y1 = r[4], x2 = r[6], y2 = r[7];
  const bool e0 = __fmul_rn(__fsub_rn(yp, y0), __fsub_rn(x1, x0)) <
                  __fmul_rn(__fsub_rn(xp, x0), __fsub_rn(y1, y0));
  const bool e1 = __fmul_rn(__fsub_rn(yp, y1), __fsub_rn(x2, x1)) <
                  __fmul_rn(__fsub_rn(xp, x1), __fsub_rn(y2, y1));
  const bool e2 = __fmul_rn(__fsub_rn(yp, y2), __fsub_rn(x0, x2)) <
                  __fmul_rn(__fsub_rn(xp, x2), __fsub_rn(y0, y2));
  if (e0 || e1 || e2) return;
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float* iv = r + kInv + 3 * k;
    w[k] = clamp_nan(__fadd_rn(__fadd_rn(__fmul_rn(iv[0], XI), __fmul_rn(iv[1], YI)), iv[2]),
                     0.0f, 1.0f);
  }
  const float wsum = __fadd_rn(__fadd_rn(w[0], w[1]), w[2]);
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = __fdiv_rn(w[k], wsum);
  const float zp = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(__fdiv_rn(w[0], r[2]),
                                                       __fdiv_rn(w[1], r[5])),
                                             __fdiv_rn(w[2], r[8])));
  if (!(zp > near && zp < far)) return;
  if (b.f < 0 || zp < b.z || (zp == b.z && fid < b.f)) {
    b.z = zp;
    b.f = fid;
    b.w0 = w[0];
    b.w1 = w[1];
    b.w2 = w[2];
  }
}

// The pixel centres of a warp's first and last column and row.
struct WarpBox {
  float x_lo, x_hi, y_lo, y_hi;
};

// Whether the inside test's edge (a -> b) rejects every pixel of the warp:
// its test is L(yp) < R(xp), L = (yp - ya) * (xb - xa), R = (xp - xa) * (yb -
// ya), each operation rounded to nearest.  With finite edge vectors each side
// is a monotone function of one coordinate (a rounded subtraction and a
// rounded product by a constant are monotone, and never NaN here), so its
// extremes over the warp's pixels lie at the warp's first or last row
// (column): where the largest L is below the least R, L < R at every pixel.
__device__ __forceinline__ bool edge_rejects_warp(float xa, float ya, float xb, float yb,
                                                  const WarpBox& w) {
  const float A = __fsub_rn(xb, xa), Bv = __fsub_rn(yb, ya);
  if (!(fabsf(A) <= 3.4028234e38f && fabsf(Bv) <= 3.4028234e38f)) return false;
  const float l0 = __fmul_rn(__fsub_rn(w.y_lo, ya), A);
  const float l1 = __fmul_rn(__fsub_rn(w.y_hi, ya), A);
  const float r0 = __fmul_rn(__fsub_rn(w.x_lo, xa), Bv);
  const float r1 = __fmul_rn(__fsub_rn(w.x_hi, xa), Bv);
  return (l0 > l1 ? l0 : l1) < (r0 < r1 ? r0 : r1);
}

// The warp's corner test: true where no pixel of the warp can pass the strict
// inside test of the face (one of its edges rejects them all), so the warp
// may skip it.  A face with a non-finite corner is never skipped.
__device__ __forceinline__ bool warp_misses(const float* r, const WarpBox& w) {
  return edge_rejects_warp(r[0], r[1], r[3], r[4], w) ||
         edge_rejects_warp(r[3], r[4], r[6], r[7], w) ||
         edge_rejects_warp(r[6], r[7], r[0], r[1], w);
}

// Write a tile's staged map of C channels (s: [256 pixels, ty * 16 + tx, C])
// to out [B, H, W, C], a tile row of 16 * C contiguous values at a time, so
// a warp's stores fill whole sectors; values past a ragged edge stay unwritten.
template <int C, typename T>
__device__ __forceinline__ void store_tile(const T* s, T* out, int tile_x, int tile_y, int b,
                                           int is, int tid) {
  constexpr int kRowLen = kTile * C;
  const int valid = min(kTile, is - tile_x * kTile) * C;
  for (int e = tid; e < kTile * kRowLen; e += kThreads) {
    const int ry = e / kRowLen, k = e - ry * kRowLen;
    const int rowp = tile_y * kTile + ry;
    if (rowp < is && k < valid)
      out[(((size_t)b * is + rowp) * is + tile_x * kTile) * C + k] = s[e];
  }
}

// The cluster's pooled list: tile k (row ty0 + k) holds positions
// [off[k], off[k + 1]); position q of it names face at(k, q - off[k]).
struct Pool {
  int off[kSplit + 1];
  int start[kSplit];   // each tile's run in faces_sorted
  int gcount;
};

// The tile of pooled position q.
__device__ __forceinline__ int tile_of(const Pool& pl, int q) {
  int k = 0;
#pragma unroll
  for (int j = 1; j < kSplit; ++j) k += q >= pl.off[j] ? 1 : 0;
  return k;
}

// Lane q < kPerWarp of warp w: the id and the tile of pooled position pos0 +
// w * kPerWarp + q (below end), or -1: a big face first (-1 where its tile
// range misses the tile), then the tile's run.
__device__ __forceinline__ int chunk_id(const Pool& pl, const int* faces_b,
                                        const int* glist_b, const int* ranges_b, int tile_x,
                                        int ty0, int pos0, int end, int warp, int lane,
                                        int* tile) {
  const int q = pos0 + warp * kPerWarp + lane;
  *tile = 0;
  if (lane >= kPerWarp || q >= end) return -1;
  const int k = tile_of(pl, q);
  *tile = k;
  const int pos = q - pl.off[k];
  if (pos >= pl.gcount) return faces_b[pl.start[k] + pos - pl.gcount];
  const int g = glist_b[pos];
  const int* rg = ranges_b + (size_t)g * 4;
  const int tile_y = ty0 + k;
  return (tile_y >= rg[0] && tile_y <= rg[1] && tile_x >= rg[2] && tile_x <= rg[3]) ? g : -1;
}

// Warp w keeps the ids of its lanes that name a face, in lane order, at slots
// w * kPerWarp + 0, 1, ... of the chunk (their tiles beside them), writes
// their count to scnt[w], and copies their rows into srow with cp.async,
// committed as one group.
__device__ __forceinline__ void stage_warp(const float* rows_b, float* srow, int* sid,
                                           int* stile, int* scnt, int id, int tile, int warp,
                                           int lane) {
  const bool keep = id >= 0;
  const unsigned m = __ballot_sync(0xffffffffu, keep);
  const int slot0 = warp * kPerWarp;
  if (keep) {
    const int s = slot0 + __popc(m & ((1u << lane) - 1u));
    sid[s] = id;
    stile[s] = tile;
  }
  const int cnt = __popc(m);
  if (lane == 0) scnt[warp] = cnt;
  __syncwarp();
  for (int i = lane; i < cnt * kRow; i += 32) {
    const int j = i / kRow;
    const int k = i - j * kRow;
    __pipeline_memcpy_async(srow + (slot0 + j) * kRow + k,
                            rows_b + (size_t)sid[slot0 + j] * kRow + k, 4);
  }
  __pipeline_commit();
}

// Shared memory: the staging buffers (two chunks of rows [kChunk, 19], ids,
// tiles and warp counts), over which the epilogue stages the maps; then
// (kSplit > 1) the shares' states, [kSplit tiles][kState][256].
constexpr size_t kStageFloats = 2 * ((size_t)kChunk * (kRow + 2) + kWarps);
constexpr size_t kStoreFloats = (size_t)kMaps * kThreads;
constexpr size_t kBufFloats = kStageFloats > kStoreFloats ? kStageFloats : kStoreFloats;
constexpr size_t kStateFloats = kSplit > 1 ? (size_t)kSplit * kState * kThreads : 0;
constexpr size_t kSmem = (kBufFloats + kStateFloats) * sizeof(float);

__global__ void __launch_bounds__(256) n3mr_maps_kernel(const MapsArgs a) {
  extern __shared__ float smem[];
  __shared__ Pool pool;
  __shared__ float sybox[kSplit][4][2];   // each tile's warp rows' first and last centre
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int rank = blockIdx.y % kSplit;   // this_cluster().block_rank()
  // the cluster's first tile row
  const int ty0 = a.first_row / kSplit * kSplit + blockIdx.y - rank;
  const int tile_x = a.first_col + blockIdx.x, b = blockIdx.z;
  const int tile_y = ty0 + rank;          // the tile this block writes (none past the image)
  const int is = a.image_size;
  const float isf = (float)is;
  const int NT = a.tiles_x * a.tiles_y;
  const float* rows_b = a.rows + (size_t)b * a.F * kRow;
  cg::cluster_group cluster = cg::this_cluster();

  if (tid == 0) {
    pool.gcount = a.gcount[b];
    pool.off[0] = 0;
    for (int k = 0; k < kSplit; ++k) {
      const int t = (ty0 + k) * a.tiles_x + tile_x;
      const bool in = ty0 + k < a.tiles_y;
      pool.start[k] = in ? a.starts[b * NT + t] : 0;
      pool.off[k + 1] = pool.off[k] + (in ? pool.gcount + a.run_counts[b * NT + t] : 0);
    }
  }
  if (tid < kSplit * 4) {
    const float r0 = (float)((ty0 + tid / 4) * kTile + (tid % 4) * 4);
    sybox[tid / 4][tid % 4][0] = centre(r0, isf);
    sybox[tid / 4][tid % 4][1] = centre(r0 + 3.0f, isf);
  }
  __syncthreads();
  const Pool& pl = pool;
  const int total = pl.off[kSplit];
  const int per = max(1, (total + kSplit - 1) / kSplit);
  const int lo = min(total, rank * per), len = min(total, lo + per) - lo;

  // the pixel: its column (the same in every tile of the cluster), and its
  // row in the tile being walked
  const float XI = (float)(tile_x * kTile + tx);
  const float xp = centre(XI, isf);
  WarpBox box;
  box.x_lo = centre((float)(tile_x * kTile + (warp % 2) * 8), isf);
  box.x_hi = centre((float)(tile_x * kTile + (warp % 2) * 8 + 7), isf);
  float* const sst = smem + kBufFloats;   // [kSplit][kState][256]
  auto flush = [&](int k, const Best& s) {
    float* o = sst + (size_t)k * kState * kThreads + tid;
    o[0] = s.z;
    o[1 * kThreads] = __int_as_float(s.f);
    o[2 * kThreads] = s.w0;
    o[3 * kThreads] = s.w1;
    o[4 * kThreads] = s.w2;
  };
  const Best empty{0.0f, 0.0f, 0.0f, 0.0f, -1};
  Best best = empty;
  int cur = len > 0 ? tile_of(pl, lo) : rank;
  float YI = (float)((ty0 + cur) * kTile + ty);
  float yp = centre(YI, isf);

  int* const sid0 = reinterpret_cast<int*>(smem + 2 * kChunk * kRow);
  int* const stile0 = sid0 + 2 * kChunk;
  int* const scnt0 = stile0 + 2 * kChunk;
  const int* faces_b = a.faces_sorted + (size_t)b * a.L;
  const int* glist_b = a.glist + (size_t)b * a.F;
  const int* ranges_b = a.ranges + (size_t)b * a.F * 4;
  const int nch = (len + kChunk - 1) / kChunk;
  const int end = lo + len;
  int tile_n = 0;
  if (nch > 0) {
    const int id = chunk_id(pl, faces_b, glist_b, ranges_b, tile_x, ty0, lo, end, warp, lane,
                            &tile_n);
    stage_warp(rows_b, smem, sid0, stile0, scnt0, id, tile_n, warp, lane);
  }
  int id_next = nch > 1 ? chunk_id(pl, faces_b, glist_b, ranges_b, tile_x, ty0, lo + kChunk,
                                   end, warp, lane, &tile_n)
                        : -1;
  for (int c = 0; c < nch; ++c) {
    const int cur_buf = c & 1;
    __pipeline_wait_prior(0);
    // chunk c's rows, ids, tiles and counts are in; every thread is done
    // with chunk c - 1, whose buffers chunk c + 1 takes
    __syncthreads();
    if (c + 1 < nch) {
      const int nb = cur_buf ^ 1;
      stage_warp(rows_b, smem + nb * kChunk * kRow, sid0 + nb * kChunk, stile0 + nb * kChunk,
                 scnt0 + nb * kWarps, id_next, tile_n, warp, lane);
      id_next = c + 2 < nch ? chunk_id(pl, faces_b, glist_b, ranges_b, tile_x, ty0,
                                       lo + (c + 2) * kChunk, end, warp, lane, &tile_n)
                            : -1;
    }
    const float* srow = smem + cur_buf * kChunk * kRow;
    const int* sid = sid0 + cur_buf * kChunk;
    const int* stile = stile0 + cur_buf * kChunk;
    const int* scnt = scnt0 + cur_buf * kWarps;
    // the lanes test 32 slots at once; the warp walks those a ballot keeps,
    // in slot order (position order: the tile never falls)
    for (int base = 0; base < kChunk; base += 32) {
      const int s = base + lane;
      bool hit = false;
      if (s % kPerWarp < scnt[s / kPerWarp]) {
        const float* r = srow + s * kRow;
        WarpBox bx = box;
        bx.y_lo = sybox[stile[s]][warp / 2][0];
        bx.y_hi = sybox[stile[s]][warp / 2][1];
        hit = r[kFront] > 0.5f && !warp_misses(r, bx);
      }
      unsigned m = __ballot_sync(0xffffffffu, hit);
      while (m != 0u) {
        const int s2 = base + __ffs(m) - 1;
        m &= m - 1u;
        const int k = stile[s2];
        if (k != cur) {
          // the walk moves on to tile k: tile cur's state is done, and so is
          // that of any tile between them (no face of theirs met this warp)
          if (kSplit > 1) {
            flush(cur, best);
            for (int j = cur + 1; j < k; ++j) flush(j, empty);
          }
          best = empty;
          cur = k;
          YI = (float)((ty0 + cur) * kTile + ty);
          yp = centre(YI, isf);
        }
        test_face(srow + s2 * kRow, sid[s2], xp, yp, XI, YI, a.near, a.far, best);
      }
    }
  }

  if (kSplit > 1 && total > 0) {
    // (a cluster whose lists are all empty has nothing to merge: `total` is
    // the same in every block of it)
    // the share's states: every tile it touched, from `cur` on to its last
    if (len > 0) {
      const int last = tile_of(pl, lo + len - 1);
      flush(cur, best);
      for (int j = cur + 1; j <= last; ++j) flush(j, empty);
    }
    cluster.sync();   // every rank's states are written
    // tile `rank`: the states of the ranks whose shares touched it, in rank order
    best = empty;
    const int t0 = pl.off[rank], t1 = pl.off[rank + 1];
    if (t1 > t0) {
      for (int r = t0 / per; r <= (t1 - 1) / per; ++r) {
        const float* o = cluster.map_shared_rank(sst, r) + (size_t)rank * kState * kThreads + tid;
        const int f = __float_as_int(o[1 * kThreads]);
        const float z = o[0];
        if (f >= 0 && (best.f < 0 || z < best.z || (z == best.z && f < best.f))) {
          best.z = z;
          best.f = f;
          best.w0 = o[2 * kThreads];
          best.w1 = o[3 * kThreads];
          best.w2 = o[4 * kThreads];
        }
      }
    }
    cluster.sync();   // no rank exits while another reads its states
  }
  if (tile_y >= a.tiles_y) return;

  // the pixel's maps: the winner's weights, depth, corner depths, inverse
  // and texture sample (rasterize.py:252-298), staged by pixel, then written
  // a tile row at a time
  const bool has = best.f >= 0;
  const float wgt[3] = {best.w0, best.w1, best.w2};
  const float* r = rows_b + (size_t)(has ? best.f : 0) * kRow;
  float z[3] = {1.0f, 1.0f, 1.0f}, c[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (has) z[k] = r[3 * k + 2];
  if (a.tex != nullptr && has) {
    const int T3 = a.ts * a.ts * a.ts * 3;
    sample_texture(a.tex + ((size_t)b * a.F + best.f) * T3, a.ts, a.eps, wgt, best.z, z, c);
  }
  __syncthreads();  // every thread is done with the staging buffers
  const int p = ty * kTile + tx;
  int* s_fi = reinterpret_cast<int*>(smem);
  float* s_dep = smem + kThreads;
  float* s_w = s_dep + kThreads;
  float* s_z = s_w + 3 * kThreads;
  float* s_inv = s_z + 3 * kThreads;
  float* s_rgb = s_inv + 9 * kThreads;
  s_fi[p] = best.f;
  s_dep[p] = has ? best.z : a.far;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s_w[3 * p + k] = wgt[k];
    s_z[3 * p + k] = z[k];
    s_rgb[3 * p + k] = c[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) s_inv[9 * p + k] = has ? r[kInv + k] : 0.0f;
  __syncthreads();
  store_tile<1>(s_fi, a.face_index, tile_x, tile_y, b, is, tid);
  store_tile<1>(s_dep, a.depth, tile_x, tile_y, b, is, tid);
  store_tile<3>(s_w, a.weight, tile_x, tile_y, b, is, tid);
  store_tile<3>(s_z, a.zcorn, tile_x, tile_y, b, is, tid);
  store_tile<9>(s_inv, a.face_inv, tile_x, tile_y, b, is, tid);
  if (a.rgb != nullptr) store_tile<3>(s_rgb, a.rgb, tile_x, tile_y, b, is, tid);
}

// The launch configuration: a cluster of kSplit blocks along y (the tile
// rows launched, from the first one's cluster, padded to a whole cluster).
struct Launch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  Launch(const MapsArgs& a, cudaStream_t stream) : cfg{}, attr{} {
    const int rows = a.first_row % kSplit + a.n_rows;
    cfg.gridDim = dim3(a.n_cols, (rows + kSplit - 1) / kSplit * kSplit, a.B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = kSplit;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Once per library: the shared memory past 48 KB, and whether a cluster
// can be resident on one GPC.  (static: this library's own, not one shared
// with a variant build.)
static int prepare(const Launch& l) {
  static bool ready = false;
  if (ready) return 0;
  cudaError_t err = cudaSuccess;
  if (kSmem > kSmemDefault)
    err = cudaFuncSetAttribute(n3mr_maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, n3mr_maps_kernel, &l.cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return kNoCluster;
  ready = true;
  return 0;
}

}  // namespace n3mr

extern "C" int n3mr_maps(const n3mr::MapsArgs* args, void* stream) {
  using namespace n3mr;
  const MapsArgs& a = *args;
  if (a.chunk != kChunk || a.first_col < 0 || a.n_cols < 1 ||
      a.first_col + a.n_cols > a.tiles_x || a.first_row < 0 || a.n_rows < 1 ||
      a.first_row + a.n_rows > a.tiles_y)
    return (int)cudaErrorInvalidValue;
  Launch l(a, static_cast<cudaStream_t>(stream));
  const int err = prepare(l);
  if (err != 0) return err;
  return (int)cudaLaunchKernelEx(&l.cfg, n3mr_maps_kernel, a);
}

// Registers, local bytes (spill slots and stack) and blocks an SM of the
// kernel, from the CUDA runtime.
extern "C" int n3mr_maps_occupancy(int* out) {
  using namespace n3mr;
  if (kSmem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        n3mr_maps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, n3mr_maps_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, n3mr_maps_kernel, kThreads,
                                                        kSmem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  return (int)err;
}

extern "C" int n3mr_maps_args_size() { return (int)sizeof(n3mr::MapsArgs); }

extern "C" int n3mr_maps_split() { return n3mr::kSplit; }
