// N3MR edge-gradient kernels for Hopper (sm_90a), with plain C entry points.
//
// Replace the TPU kernel jrender_tpu/ops/n3mr/banded_bwd.py
// _make_banded_kernel (:347, launched at :614 by _axis_pass_pallas, entry
// backward_pixel_map_banded :636), its band lists (build_band_lists :56) and
// the segment sum after it (:623-632).  They compute the NMR
// finite-difference gradient of the rgb and alpha images with respect to each
// face's vertex x and y (reference rasterize.py:342-660): for each (face,
// edge, axis) item the edge is walked along d0 and each of its rows scanned
// along d1, outwards to the screen border where the crossing pixel is the
// face's own (OUT) and inwards to the opposite edge over the face's own
// pixels (IN), adding -diff / dist for the edge's two endpoints wherever the
// image difference times the incoming gradient is positive.  The predicates
// follow _axis_pass (banded_bwd.py:194-298) line for line, with __f*_rn
// intrinsics in the plain version's order (n3mr_common.cuh).
//
// The first design (a block per face, a warp per item, the maps read from
// L2) read each image row again for every item that crosses it, some 280
// items per (axis, row) at 1024^2 on the 39,474-face sphere: about 5 GB of
// L2 reads a call.
//
// Design: the TPU kernel's d0 bands, without their caps.
//  n3mr_edge_bands (one thread per item) lists every front item by the bands
//    of kBand rows its edge spans: a sort key per (item, band), ordered by
//    (axis, batch element, band, the item's first row in the band, face,
//    edge), for at most kSpan bands; an item that spans more (a long
//    silhouette edge of a small mesh) gets one key in a global list
//    instead, as the SoftRas binning's big faces do.  The lists have a
//    fixed size (kSpan keys an item), so nothing waits on the host; the
//    wrapper sorts the keys (torch.sort) and hands them back.
//  n3mr_edgebwd launches three kernels.  The band kernel runs one block per
//    (column segment, band, axis and batch element): it finds the band's
//    list in the sorted keys by binary search, copies the band's rows of
//    the face-index map and of the nch channel maps (the axis's view:
//    transposed for axis 0, so rows are contiguous) into shared memory with
//    cp.async, and its warps take the list's items in turn (a warp done
//    with one takes the next), each walking the item's rows of the band and
//    scanning them from shared memory, the 32 lanes striding along d1.  A
//    segment is the whole row unless kBand rows of all channels pass 112 KB
//    (two blocks an SM; the wrapper's EDGE_SMEM_BYTES): alpha and rgb
//    together at 1024^2, or anti-aliasing's 2,048-px rows.  Then blocks
//    take column segments of the band, the scans are cut at the segment's
//    edges, and a crossing pixel outside the segment is read from device
//    memory.  The global kernel gives each global item one warp that walks
//    all its rows reading the maps from device memory, as the first design
//    did.  Each (item, band, segment) writes its (c1, c2) to a slot of its
//    own, whichever warp computed it; the assembly kernel (one thread per
//    face) sums each item's slots in ascending band and segment order and
//    forms the face's 9 entries.  No float atomics, every sum in a fixed
//    order: two runs give the same bits.
//
// Bound.  Operations: about 25 per scanned cell with a positive difference
// test; an OUT scan runs to the screen border, so the cell count is of the
// order faces x edge pixels x image size (chip_smoke.py counts it from its
// run).  Bytes: the maps read once per band (the lists are small beside
// them).  What is left is the cells' arithmetic as the plain version
// rounds it: on the bench sphere half the 219 M scanned cells are positive
// and pay four IEEE divisions each (a branch every warp takes).  Staging
// the rows took the first design's 2.16 ms to 1.79, sort included, on an
// H100; the rest is that arithmetic (PERF.md §6).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "n3mr_common.cuh"

// d0 rows of a band, a compile-time constant (PERF.md has the times of the
// alternatives)
#ifndef N3MR_EDGE_BAND
#define N3MR_EDGE_BAND 4
#endif

namespace n3mr {

constexpr int kBand = N3MR_EDGE_BAND;
constexpr int kSpan = 8;              // bands an item is listed in, at most
constexpr int kBandWarps = 16;        // warps of a band block
constexpr int kGlobalWarps = 8;       // warps of a global block
constexpr int kGlobalBlocks = 264;    // global blocks: two an SM
constexpr int kPrepThreads = 256;
constexpr size_t kSmemMax = 227 * 1024;

struct EdgeBandArgs {
  const float* pp;      // [B, F, 7] pixel-space x0 y0 x1 y1 x2 y2, front
  void* keys;           // [N * kSpan] the sort keys of every (item, band), int32
                        // where they fit (key_bytes 4), else int64
  int* items;           // [N, 3] first row, last row, bands listed (-1 global, 0 none)
  int B, F, image_size, key_bytes;
};

struct EdgeBwdArgs {
  const float* pp;      // [B, F, 7]
  const int* fi2;       // [2, B, is, is] face_index transposed, and as is
  const float* planes;  // [2, B, nch, is, is] the maps, transposed and as is:
                        // alpha, grad_alpha (if return_alpha), then rgb 3,
                        // grad_rgb 3 (if return_rgb)
  const void* keys;        // [N * kSpan] sorted, int32 or int64 (key_bytes)
  const long long* order;  // [N * kSpan] the (item, band) of each sorted key:
                           // item * kSpan + band - the item's first band
  const int* items;     // [N, 3] from n3mr_edge_bands
  float* slots;         // [N * kSpan, n_seg, 2] (c1, c2) of each (item, band, segment)
  float* grad_face;     // [B, F, 9]
  int B, F, image_size, nch, return_rgb, return_alpha, seg_w, n_seg, key_bytes;
  float eps;
};

// Internal linkage: a variant build (another N3MR_EDGE_BAND) loaded beside
// the default one must keep its own `raised` (a static local of a function
// with external linkage is one symbol across every library loaded), or it
// launches past 48 KB without having asked for it.
namespace {

// Items: item = ((axis * B + b) * F + f) * 3 + e, N = 6 B F.  Keys: the
// listed (item, band) pairs below gbase(), ordered by (axis, b, band, row,
// f, e); the global items at gbase() + item; the rest, unused, after.
__host__ __device__ inline long long band_count(int is) { return (is + kBand - 1) / kBand; }
__host__ __device__ inline long long group_keys(int F) { return (long long)kBand * 3 * F; }
__host__ __device__ inline long long gbase(int B, int F, int is) {
  return 2LL * B * band_count(is) * group_keys(F);
}

// The first key at or above `key` in the sorted keys.
template <class Key>
__device__ __forceinline__ long long first_at_or_above(const Key* keys, long long n,
                                                       long long key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if ((long long)keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <class Key>
__global__ void __launch_bounds__(kPrepThreads) n3mr_edge_bands_kernel(const EdgeBandArgs a) {
  const long long N = 6LL * a.B * a.F;
  const long long it = (long long)blockIdx.x * kPrepThreads + threadIdx.x;
  if (it >= N) return;
  const int e = (int)(it % 3);
  const long long fb = it / 3;
  const int f = (int)(fb % a.F);
  const int ab = (int)(fb / a.F);           // axis * B + b
  const int axis = ab / a.B, b = ab % a.B;
  const float* pp = a.pp + ((size_t)b * a.F + f) * 7;
  const float p00 = pp[2 * e + axis], p10 = pp[2 * ((e + 1) % 3) + axis];
  const int is = a.image_size;
  // torch_impl._edge_rows' d0 range; a NaN corner lists nothing, as there
  int first = 0, last = -1;
  if (pp[6] > 0.5f && !isnan(p00) && !isnan(p10)) {
    const float d0_from = fmaxf(ceilf(fminf(p00, p10)), 0.0f);
    const float d0_to = fminf(fmaxf(p00, p10), (float)is - 1.0f);
    if (d0_from <= d0_to) {
      first = (int)d0_from;
      last = (int)floorf(d0_to);
    }
  }
  const int bfrom = first / kBand, nb = last >= first ? last / kBand - bfrom + 1 : 0;
  const bool in_global = nb > kSpan;
  int* row = a.items + it * 3;
  row[0] = first;
  row[1] = last;
  row[2] = in_global ? -1 : nb;
  const long long gb = gbase(a.B, a.F, is), unused = gb + N;
  Key* keys = static_cast<Key*>(a.keys) + it * kSpan;
  for (int j = 0; j < kSpan; ++j) {
    long long key = unused + it * kSpan + j;
    if (in_global) {
      if (j == 0) key = gb + it;
    } else if (j < nb) {
      const int band = bfrom + j;
      const int row0 = max(first - band * kBand, 0);
      key = ((long long)ab * band_count(is) + band) * group_keys(a.F)
            + (long long)row0 * 3 * a.F + (long long)f * 3 + e;
    }
    keys[j] = (Key)key;
  }
}

// The cells of one d0 row: the face index and channel c at column d1.
struct Cells {
  const int* fi;        // the row's face index, at column `off`
  const float* pl;      // channel 0 of the row, at column `off`
  size_t cs;            // channel stride
  int off;
  __device__ __forceinline__ int id(int d1) const { return fi[d1 - off]; }
  __device__ __forceinline__ float at(int c, int d1) const { return pl[c * cs + d1 - off]; }
};

// sum over channels of (map[d1] - map at the crossing pixel) * grad[d1]
__device__ __forceinline__ float diff_at(const Cells& s, int ch_a, int ch_r, int d1,
                                         const float vx[4]) {
  float diff = 0.0f;
  if (ch_a >= 0) diff = diff + (s.at(ch_a, d1) - vx[3]) * s.at(ch_a + 1, d1);
  if (ch_r >= 0) {
    const float t0 = (s.at(ch_r, d1) - vx[0]) * s.at(ch_r + 3, d1);
    const float t1 = (s.at(ch_r + 1, d1) - vx[1]) * s.at(ch_r + 4, d1);
    const float t2 = (s.at(ch_r + 2, d1) - vx[2]) * s.at(ch_r + 5, d1);
    diff = diff + ((t0 + t1) + t2);
  }
  return diff;
}

__device__ __forceinline__ void value_at(const Cells& s, int ch_a, int ch_r, int d1,
                                         float vx[4]) {
  vx[0] = vx[1] = vx[2] = vx[3] = 0.0f;
  if (ch_a >= 0) vx[3] = s.at(ch_a, d1);
  if (ch_r >= 0) {
    vx[0] = s.at(ch_r, d1);
    vx[1] = s.at(ch_r + 1, d1);
    vx[2] = s.at(ch_r + 2, d1);
  }
}

// -diff / dist of one cell for the two endpoints (banded_bwd.py:272-293):
// dist = base / den, moved away from 0 by eps; a cell whose difference is
// not positive adds nothing (its base is not computed).
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

// One (face, edge, axis) item's geometry.
struct Item {
  int f, first, last;
  float p00, p01, p10, p20, p21, dir, slope, slope_a, slope_b, dp;
  bool up;
};

// base = dp * (d1 - d1_cross) * 2 / is of a cell (banded_bwd.py:272); the
// division by a power-of-two size is the multiplication by its inverse,
// exactly.
__device__ __forceinline__ float cell_base(const Item& g, int d1, float d1_cross, float isf,
                                           bool pow2) {
  const float t = __fmul_rn(__fmul_rn(g.dp, __fsub_rn((float)d1, d1_cross)), 2.0f);
  return pow2 ? __fmul_rn(t, __frcp_rn(isf)) : __fdiv_rn(t, isf);
}

__device__ __forceinline__ Item load_item(const EdgeBwdArgs& a, long long it) {
  Item g;
  const int e = (int)(it % 3);
  const long long fb = it / 3;
  g.f = (int)(fb % a.F);
  const int ab = (int)(fb / a.F);
  const int axis = ab / a.B, b = ab % a.B;
  const float* pp = a.pp + ((size_t)b * a.F + g.f) * 7;
  const int i0 = e, i1 = (e + 1) % 3, i2 = (e + 2) % 3;
  g.p00 = pp[2 * i0 + axis];
  g.p01 = pp[2 * i0 + 1 - axis];
  g.p10 = pp[2 * i1 + axis];
  const float p11 = pp[2 * i1 + 1 - axis];
  g.p20 = pp[2 * i2 + axis];
  g.p21 = pp[2 * i2 + 1 - axis];
  g.dir = (g.p00 < g.p10 ? -1.0f : 1.0f) * (axis == 0 ? 1.0f : -1.0f);
  g.up = g.dir > 0.0f;
  g.slope = __fdiv_rn(__fsub_rn(p11, g.p01), __fsub_rn(g.p10, g.p00));
  g.slope_a = __fdiv_rn(__fsub_rn(g.p21, g.p01), __fsub_rn(g.p20, g.p00));
  g.slope_b = __fdiv_rn(__fsub_rn(p11, g.p21), __fsub_rn(g.p10, g.p20));
  g.dp = __fsub_rn(g.p10, g.p00);
  const int* row = a.items + it * 3;
  g.first = row[0];
  g.last = row[1];
  return g;
}

// The OUT and IN scans of row d0 of item g, cut to the columns [c_lo,
// c_hi) that `cells` holds; `cross` reads a crossing pixel outside them
// (it holds the whole row).  Each lane adds its cells in ascending d1.
__device__ __forceinline__ void scan_row(const EdgeBwdArgs& a, const Item& g, int d0,
                                         const Cells& cross, const Cells& cells, int c_lo,
                                         int c_hi, int lane, float* c1, float* c2) {
  const int is = a.image_size;
  const float isf = (float)is, hi = isf - 1.0f;
  const int ch_a = a.return_alpha ? 0 : -1;
  const int ch_r = a.return_rgb ? (a.return_alpha ? 2 : 0) : -1;
  const bool pow2 = (is & (is - 1)) == 0;
  const float d0f = (float)d0;
  const float d1_cross = __fadd_rn(__fmul_rn(g.slope, __fsub_rn(d0f, g.p00)), g.p01);
  const float d1_in_f = g.up ? floorf(d1_cross) : ceilf(d1_cross);
  const float d1_out_f = d1_in_f + g.dir;
  // float compares before the int cast: NaN and inf fail them
  if (!(d1_in_f >= 0.0f && d1_in_f <= hi && d1_out_f >= 0.0f && d1_out_f <= hi)) return;
  const int d1_in = (int)d1_in_f, d1_out = (int)d1_out_f;
  const float den1 = __fsub_rn(g.p10, d0f), den2 = __fsub_rn(d0f, g.p00);
  float vx[4];

  // OUT: from the crossing to the screen border, where the crossing pixel
  // is the face's own
  // the crossing pixels from the staged cells where they lie in them
  const Cells& at_in = d1_in >= c_lo && d1_in < c_hi ? cells : cross;
  const Cells& at_out = d1_out >= c_lo && d1_out < c_hi ? cells : cross;
  if (at_in.id(d1_in) == g.f) {
    value_at(at_in, ch_a, ch_r, d1_in, vx);
    const int lim = g.up ? is - 1 : 0;
    const int lo = max(max(min(d1_out, lim), 0), c_lo);
    const int hi_o = min(min(max(d1_out, lim), is - 1), c_hi - 1);
    for (int d1 = lo + lane; d1 <= hi_o; d1 += 32) {
      const float diff = diff_at(cells, ch_a, ch_r, d1, vx);
      if (diff > 0.0f)
        add_cell(diff, cell_base(g, d1, d1_cross, isf, pow2), den1, den2, a.eps, c1, c2);
    }
  }

  // IN: from the crossing to the opposite edge's crossing, over the face's
  // own pixels
  const bool between = __fmul_rn(__fsub_rn(d0f, g.p00), __fsub_rn(d0f, g.p20)) < 0.0f;
  const float cross2 = between ? __fadd_rn(__fmul_rn(g.slope_a, __fsub_rn(d0f, g.p00)), g.p01)
                               : __fadd_rn(__fmul_rn(g.slope_b, __fsub_rn(d0f, g.p20)), g.p21);
  const float lim_f = g.up ? ceilf(cross2) : floorf(cross2);
  if (isfinite(lim_f)) {
    const int lim = (int)fminf(fmaxf(lim_f, -1.0f), isf);
    const int lo = max(max(min(d1_in, lim), 0), c_lo);
    const int hi_i = min(min(max(d1_in, lim), is - 1), c_hi - 1);
    value_at(at_out, ch_a, ch_r, d1_out, vx);
    for (int d1 = lo + lane; d1 <= hi_i; d1 += 32) {
      if (cells.id(d1) != g.f) continue;
      const float diff = diff_at(cells, ch_a, ch_r, d1, vx);
      if (diff > 0.0f)
        add_cell(diff, cell_base(g, d1, d1_cross, isf, pow2), den1, den2, a.eps, c1, c2);
    }
  }
}

// Row d0 of the view (axis, b) in device memory.
__device__ __forceinline__ Cells device_row(const EdgeBwdArgs& a, int ab, int d0) {
  const size_t HW = (size_t)a.image_size * a.image_size;
  Cells c;
  c.fi = a.fi2 + (size_t)ab * HW + (size_t)d0 * a.image_size;
  c.pl = a.planes + (size_t)ab * a.nch * HW + (size_t)d0 * a.image_size;
  c.cs = HW;
  c.off = 0;
  return c;
}

template <class Key>
__global__ void __launch_bounds__(kBandWarps * 32)
    n3mr_edgebwd_band_kernel(const EdgeBwdArgs a) {
  extern __shared__ __align__(16) float sm[];   // [1 + nch][kBand][seg_w]: face index, channels
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int seg = blockIdx.x, band = blockIdx.y, ab = blockIdx.z;
  const int is = a.image_size, sw_max = a.seg_w;
  const int s0 = seg * sw_max, sw = min(is, s0 + sw_max) - s0;
  const int r0 = band * kBand, nrows = min(kBand, is - r0);
  const size_t HW = (size_t)is * is;
  const Key* keys = static_cast<const Key*>(a.keys);
  __shared__ long long range[2];
  __shared__ int next;   // the next list entry a warp takes
  if (tid == 0) {
    const long long n = 6LL * a.B * a.F * kSpan;
    const long long g = (long long)ab * band_count(is) + band;
    range[0] = first_at_or_above(keys, n, g * group_keys(a.F));
    range[1] = first_at_or_above(keys, n, (g + 1) * group_keys(a.F));
    next = kBandWarps;
  }
  __syncthreads();
  if (range[0] >= range[1]) return;   // no item crosses this band

  // stage the band's rows: plane 0 the face index, planes 1.. the channels
  const int planes = 1 + a.nch;
  // 16-byte copies where rows and segments start on 4 floats
  const bool vec = is % 4 == 0 && sw_max % 4 == 0 && (reinterpret_cast<size_t>(a.fi2) & 15) == 0 &&
                   (reinterpret_cast<size_t>(a.planes) & 15) == 0;
  const int per_row = vec ? sw / 4 : sw;
  const int total = planes * nrows * per_row;
  for (int i = tid; i < total; i += kBandWarps * 32) {
    const int p = i / (nrows * per_row);
    const int rest = i - p * nrows * per_row;
    const int r = rest / per_row, v = rest - r * per_row;
    const int x = vec ? 4 * v : v;
    const float* src = p == 0
        ? reinterpret_cast<const float*>(a.fi2 + (size_t)ab * HW)
        : a.planes + ((size_t)ab * a.nch + (p - 1)) * HW;
    src += (size_t)(r0 + r) * is + s0 + x;
    float* dst = sm + ((size_t)p * kBand + r) * sw_max + x;
    if (vec) {
      __pipeline_memcpy_async(dst, src, 16);
    } else {
      __pipeline_memcpy_async(dst, src, 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // each warp takes the list's next entry when it is done with one: a
  // slot's sum depends on its item and band only, not on the warp
  for (long long k = range[0] + warp; k < range[1];) {
    const long long pair = a.order[k];
    const Item g = load_item(a, pair / kSpan);
    const int d0a = max(g.first, r0), d0b = min(g.last, r0 + nrows - 1);
    float c1 = 0.0f, c2 = 0.0f;
    for (int d0 = d0a; d0 <= d0b; ++d0) {
      Cells cells;
      cells.fi = reinterpret_cast<const int*>(sm + (size_t)(d0 - r0) * sw_max);
      cells.pl = sm + ((size_t)kBand + (d0 - r0)) * sw_max;
      cells.cs = (size_t)kBand * sw_max;
      cells.off = s0;
      scan_row(a, g, d0, device_row(a, ab, d0), cells, s0, s0 + sw, lane, &c1, &c2);
    }
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    if (lane == 0) {
      float* out = a.slots + ((size_t)pair * a.n_seg + seg) * 2;
      out[0] = c1;
      out[1] = c2;
    }
    int t = 0;
    if (lane == 0) t = atomicAdd(&next, 1);
    k = range[0] + __shfl_sync(0xffffffffu, t, 0);
  }
}

template <class Key>
__global__ void __launch_bounds__(kGlobalWarps * 32)
    n3mr_edgebwd_global_kernel(const EdgeBwdArgs a) {
  const int lane = threadIdx.x % 32;
  const int is = a.image_size;
  __shared__ long long range[2];
  if (threadIdx.x == 0) {
    const long long N = 6LL * a.B * a.F;
    const long long gb = gbase(a.B, a.F, is);
    const Key* keys = static_cast<const Key*>(a.keys);
    range[0] = first_at_or_above(keys, N * kSpan, gb);
    range[1] = first_at_or_above(keys, N * kSpan, gb + N);
  }
  __syncthreads();
  const long long step = (long long)gridDim.x * kGlobalWarps;
  for (long long k = range[0] + blockIdx.x * kGlobalWarps + threadIdx.x / 32; k < range[1];
       k += step) {
    const long long pair = a.order[k];
    const long long it = pair / kSpan;
    const Item g = load_item(a, it);
    const int ab = (int)(it / 3 / a.F);
    float c1 = 0.0f, c2 = 0.0f;
    for (int d0 = g.first; d0 <= g.last; ++d0) {
      const Cells row = device_row(a, ab, d0);
      scan_row(a, g, d0, row, row, 0, is, lane, &c1, &c2);
    }
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    if (lane == 0) {
      float* out = a.slots + (size_t)pair * a.n_seg * 2;
      out[0] = c1;
      out[1] = c2;
    }
  }
}

__global__ void __launch_bounds__(256) n3mr_edgebwd_sum_kernel(const EdgeBwdArgs a) {
  const long long bf = (long long)blockIdx.x * 256 + threadIdx.x;
  if (bf >= (long long)a.B * a.F) return;
  const int b = (int)(bf / a.F), f = (int)(bf % a.F);
  float sc[3][2][2];   // [edge][axis] (c1, c2)
  for (int e = 0; e < 3; ++e) {
    for (int axis = 0; axis < 2; ++axis) {
      const long long it = (((long long)axis * a.B + b) * a.F + f) * 3 + e;
      const int nb = a.items[it * 3 + 2];
      const float* s = a.slots + (size_t)it * kSpan * a.n_seg * 2;
      float c1 = 0.0f, c2 = 0.0f;
      if (nb < 0) {   // a global item: one slot
        c1 = s[0];
        c2 = s[1];
      } else {
        for (int j = 0; j < nb * a.n_seg; ++j) {   // ascending band, then segment
          c1 += s[2 * j];
          c2 += s[2 * j + 1];
        }
      }
      sc[e][axis][0] = c1;
      sc[e][axis][1] = c2;
    }
  }
  // vertex v, column col: -c1 of the edge that starts at v and -c2 of the
  // edge that ends at v, both of the axis 1 - col; z gets nothing
  float* out = a.grad_face + bf * 9;
  for (int v = 0; v < 3; ++v) {
    out[v * 3 + 0] = -sc[v][1][0] - sc[(v + 2) % 3][1][1];
    out[v * 3 + 1] = -sc[v][0][0] - sc[(v + 2) % 3][0][1];
    out[v * 3 + 2] = 0.0f;
  }
}

inline size_t band_smem(const EdgeBwdArgs& a) {
  return (size_t)(1 + a.nch) * kBand * a.seg_w * sizeof(float);
}

template <class Key>
int launch(const EdgeBwdArgs& a, cudaStream_t st) {
  const long long faces = (long long)a.B * a.F;
  const size_t smem = band_smem(a);
  static size_t raised = 48 * 1024;
  if (smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        n3mr_edgebwd_band_kernel<Key>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    raised = smem;
  }
  const dim3 grid((unsigned)a.n_seg, (unsigned)band_count(a.image_size), 2u * a.B);
  n3mr_edgebwd_band_kernel<Key><<<grid, kBandWarps * 32, smem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  n3mr_edgebwd_global_kernel<Key><<<kGlobalBlocks, kGlobalWarps * 32, 0, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  n3mr_edgebwd_sum_kernel<<<(unsigned)((faces + 255) / 256), 256, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace n3mr

extern "C" int n3mr_edge_bands(const n3mr::EdgeBandArgs* args, void* stream) {
  using namespace n3mr;
  const long long N = 6LL * args->B * args->F;
  if (N == 0) return 0;
  if (args->key_bytes != 4 && args->key_bytes != 8) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + kPrepThreads - 1) / kPrepThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (args->key_bytes == 4) {
    n3mr_edge_bands_kernel<int><<<blocks, kPrepThreads, 0, st>>>(*args);
  } else {
    n3mr_edge_bands_kernel<long long><<<blocks, kPrepThreads, 0, st>>>(*args);
  }
  return (int)cudaGetLastError();
}

extern "C" int n3mr_edgebwd(const n3mr::EdgeBwdArgs* args, void* stream) {
  using namespace n3mr;
  const EdgeBwdArgs& a = *args;
  const long long faces = (long long)a.B * a.F;
  if (faces == 0) return 0;
  const int is = a.image_size;
  if (a.seg_w < 1 || a.n_seg != (is + a.seg_w - 1) / a.seg_w) return (int)cudaErrorInvalidValue;
  if (band_smem(a) > kSmemMax || (a.key_bytes != 4 && a.key_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return a.key_bytes == 4 ? launch<int>(a, st) : launch<long long>(a, st);
}

extern "C" int n3mr_edgebwd_args_size() { return (int)sizeof(n3mr::EdgeBwdArgs); }

extern "C" int n3mr_edge_bands_args_size() { return (int)sizeof(n3mr::EdgeBandArgs); }

extern "C" int n3mr_edgebwd_band() { return n3mr::kBand; }

extern "C" int n3mr_edgebwd_span() { return n3mr::kSpan; }

// The first global key (gbase) for B images of F faces at image size `is`:
// the wrapper checks its own key layout against it.
extern "C" long long n3mr_edge_gbase(int B, int F, int is) { return n3mr::gbase(B, F, is); }
