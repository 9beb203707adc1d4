// SoftRas backward of the dir route for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/dir_impl.py
// _make_bwd_kernel_dir (:480, launched at :720 by soft_rasterize_bwd_dir)
// and the un-permutation after it (:729-734).  It computes the reference's
// top-K truncated backward (soft_rasterize.py:523-1358): for every
// candidate pair with zp <= the pixel's threshold (every tied face kept),
// the gradient of the pixel with respect to the face's 9 coordinates and
// its texture values, summed over the pixels per face, in the faces'
// original order.  The per-pair terms are K2's (softras_grad.cuh); the
// hard-rgb winner is matched on the original id, as dir_impl.py:596-599.
//
// What a face's row is.  The face's pixel bbox (its inflated bbox, clipped
// to the screen) is read row-major in chunks of 32 pixels, one per lane,
// and split j of the face takes chunks j, j + splits, ...  The wrapper sets
// splits from the image's area (1 up to 128 px, 64 from 1024 px).  Each
// (face, split) that has a chunk is one work item; a warp sums its item's
// pixels into a partial row (each lane its pixels in order, then a
// butterfly; surface texels into the warp's 3T sums in shared memory,
// lane after lane), and the face's row is the sum of its items' partial
// rows in ascending split order.  So every sum has a fixed order, there
// are no float atomics, and two runs give the same bits.
//
// What held the first design back (PERF.md §6): a warp for every
// (face, split), B * F * splits warps, where a split past the face's last
// chunk returned at once (2.5 M warps for 0.42 M items on the 39,474-face
// sphere at 1024 px, and a partial row for each: 849 MB), surface texels
// added lane after lane, and a second launch for the face sums.
//
// Design.  The prep lists the live items (softras_dir_prep.cu: each face's
// item count min(splits, chunks), their offsets within units of 256
// places and the units' offsets), and the kernel launches a warp for each
// of them, eight to a block, each warp on its own (no block barrier).  A
// warp finds its unit, then its face, among the offsets with a 32-way
// search (each step the lanes probe 32 places at once), recomputes the
// face's pixel bbox with the prep's rounding (bbox_pixels), stages the
// face's row with cp.async while it loads its first chunk's pixel maps,
// and walks its chunks; a step's surface texel adds go in rounds
// (add_pair_rounds, the same bits as lane after lane).  The face sum is
// in the same kernel: a face of one item writes its original row at once;
// otherwise each item writes its partial row, counts itself in an integer
// counter of the face after a __threadfence, and the item that counts
// last sums the face's partial rows in ascending split order (read from
// L2, eight rows' loads in flight), writes the original row and zeroes
// the counter again; blocks past the items write the zero rows of the
// faces with no item.  The kernel is capped at 4 blocks an SM
// (__launch_bounds__).  PERF.md has the readings of these choices and of
// those that lost: plain row loads, texel adds lane after lane, a second
// kernel for the face sums, caps 2, 3, 5 and none.
//
// Bound.  Operations: the pair math of every pair in a face's bbox up to
// the depth, and some 120 more for a pair within the threshold.  Bytes:
// the face rows, 11 floats per pixel, one gradient row per face out; the
// partial rows are this design's cost on top of that.  chip_smoke.py
// counts both from its run.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "softras_grad.cuh"

namespace softras {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;   // blocks an SM: the register cap

struct DirBwdArgs {
  const float* rows;         // [B, F, row] face rows, Morton order
  const float* bbox;         // [B, F, 4] xmin, xmax, ymin, ymax (inflated)
  const int* ids;            // [B, F] original id of each face
  const int* uoff;           // [B * U + 1] each unit's first item; the last is the count
  const int* loff;           // [B * F] each face's first item within its unit
  const float* image;        // [B, 4, H, W] the forward's output
  const float* aggrs;        // [B, 2, H, W]
  const float* grad;         // [B, 4, H, W] incoming gradient
  const float* thr;          // [B, H, W], or null: no truncation
  float* part;               // [items, GC] a partial row per item
  int* done;                 // [B * F] items finished per face, zero on entry and exit
  float* grad_face;          // [B, F, 9], original order
  float* grad_tex;           // [B, F, GC - 9], original order
  int B, F, U, row, image_size, splits, GC, items;
  int dist_func, rgb_func, alpha_func;
  Scalars s;
};

constexpr int kUnit = 256;   // places of a unit of the prep's offsets

// The last i in [0, n) with off[i] <= it, given off[0] <= it (and, were it
// read, off[n] > it).  Each step the warp's lanes probe 32 places of the
// range at once and a ballot keeps the part that holds it.
__device__ __forceinline__ int find_last(const int* off, int n_off, int it, int lane) {
  int lo = 0, hi = n_off;   // off[lo] <= it < off[hi]
  while (hi - lo > 1) {
    const int n = hi - lo - 1;   // candidates lo + 1 .. hi - 1
    const int p = n <= 32 ? lo + 1 + min(lane, n - 1)
                          : lo + 1 + (int)(((long long)lane * n) / 32);
    const unsigned m = __ballot_sync(0xffffffffu, off[p] <= it);
    const int c = __popc(m);     // the probes are ascending: m is a run of low bits
    const int plo = __shfl_sync(0xffffffffu, p, max(c - 1, 0));
    const int phi = __shfl_sync(0xffffffffu, p, min(c, 31));
    if (c > 0) lo = plo;
    if (c < 32) hi = phi;   // c = 32: lo is the last probe (hi - 1 where n <= 32)
  }
  return lo;
}

// The items of the face at place f (b * F + place): its first, and how many.
__device__ __forceinline__ void face_item_range(const DirBwdArgs& a, long long f, int* first,
                                                int* n) {
  const int b = (int)(f / a.F), p = (int)(f - (long long)b * a.F);
  const int k = b * a.U + p / kUnit;
  *first = a.uoff[k] + a.loff[f];
  const int next = (p + 1 < a.F && (p + 1) % kUnit != 0) ? a.uoff[k] + a.loff[f + 1]
                                                           : a.uoff[k + 1];
  *n = next - *first;
}

// The warp's pixel maps at pixel p of batch element b.
__device__ __forceinline__ void load_pixel(const DirBwdArgs& a, int b, size_t HW, size_t p,
                                           PixelIn* px) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    px->o[c] = __ldg(a.image + ((size_t)b * 4 + c) * HW + p);
    px->g[c] = __ldg(a.grad + ((size_t)b * 4 + c) * HW + p);
  }
  px->ag0 = __ldg(a.aggrs + ((size_t)b * 2) * HW + p);
  px->ag1 = __ldg(a.aggrs + ((size_t)b * 2 + 1) * HW + p);
  px->thr = a.thr != nullptr ? __ldg(a.thr + (size_t)b * HW + p) : 0.0f;
}

// The face's sums, from registers (lanes 0..8 hold the 9 face values and,
// for vertex colours, the 9 texture values) and the warp's texel sums, into
// `out` (a partial row of GC values) or, with `orig`, into the face's
// original rows of grad_face and grad_tex, as 0 + v, the first step of the
// face sum.
template <bool SURFACE>
__device__ __forceinline__ void write_row(const DirBwdArgs& a, float* out, size_t orig,
                                          bool to_orig, float mine, float mine_t,
                                          const float* wtex, int lane) {
  const int T3 = a.GC - 9;
  if (to_orig) {
    if (lane < 9) a.grad_face[orig * 9 + lane] = 0.0f + mine;
    if (!SURFACE) {
      if (lane < 9) a.grad_tex[orig * T3 + lane] = 0.0f + mine_t;
    } else {
      for (int i = lane; i < T3; i += 32) a.grad_tex[orig * T3 + i] = 0.0f + wtex[i];
    }
    return;
  }
  if (lane < 9) out[lane] = mine;
  if (!SURFACE) {
    if (lane < 9) out[9 + lane] = mine_t;
  } else {
    for (int i = lane; i < T3; i += 32) out[9 + i] = wtex[i];
  }
}

template <int DIST, bool SURFACE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    softras_dir_bwd_kernel(const __grid_constant__ DirBwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int faces = a.B * a.F;
  const int item_blocks = (a.items + kWarps - 1) / kWarps;
  const int T3 = a.GC - 9;
  if ((int)blockIdx.x >= item_blocks) {
    // the zero rows of the faces with no item
    const long long f = (long long)(blockIdx.x - item_blocks) * kThreads + threadIdx.x;
    if (f >= faces) return;
    int first, n;
    face_item_range(a, f, &first, &n);
    if (n != 0) return;
    const size_t orig = (size_t)(f / a.F) * a.F + a.ids[f];
    for (int c = 0; c < 9; ++c) a.grad_face[orig * 9 + c] = 0.0f;
    for (int c = 0; c < T3; ++c) a.grad_tex[orig * T3 + c] = 0.0f;
    return;
  }
  const int it = blockIdx.x * kWarps + warp;
  if (it >= a.items) return;
  // the item's unit, then its face within the unit
  const int k = find_last(a.uoff, a.B * a.U, it, lane);
  const int b = k / a.U, u = k - b * a.U;
  const int unit0 = b * a.F + u * kUnit;
  const int fi = unit0 + find_last(a.loff + unit0, min(kUnit, a.F - u * kUnit), it - a.uoff[k],
                                   lane);
  const size_t f = (size_t)fi;
  int first, n_items;
  face_item_range(a, fi, &first, &n_items);
  const int split = it - first;
  int c0, c1, r0, r1;
  if (!bbox_pixels(reinterpret_cast<const float4*>(a.bbox)[f], a.image_size, &c0, &c1, &r0,
                   &r1)) {   // never: the prep gave the face this item
    c0 = c1 = r0 = 0;
    r1 = -1;
  }

  const int T3s = SURFACE ? T3 : 0;
  float* srow = smem + warp * (a.row + T3s);  // [row] the face's row
  float* wtex = srow + a.row;                 // [T3] the warp's texel sums
  const float* src = a.rows + f * a.row;
  for (int i = lane; i < a.row; i += 32) __pipeline_memcpy_async(srow + i, src + i, 4);
  __pipeline_commit();
  if (SURFACE)
    for (int i = lane; i < T3; i += 32) wtex[i] = 0.0f;

  const int fid = a.ids[f];
  const int is = a.image_size;
  const float isf = (float)is;
  const size_t HW = (size_t)is * is;
  const GradCfg cfg{a.s, a.F, a.rgb_func, a.alpha_func, a.thr != nullptr};
  const int w = c1 - c0 + 1;
  const int np = w * (r1 - r0 + 1);
  const int stride = 32 * a.splits;
  // pixel k of the bbox is (k / w, k % w); lane k0 + lane steps by `stride`
  const int k_first = 32 * split + lane;
  int dr = k_first / w, dc = k_first - dr * w;
  const int sr = stride / w, sc = stride - sr * w;
  float acc[9], tacc[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) acc[c] = tacc[c] = 0.0f;
  PixelIn px;
  bool active = k_first < np;
  int col = c0 + (active ? dc : 0), rowp = r0 + (active ? dr : 0);
  load_pixel(a, b, HW, (size_t)rowp * is + col, &px);
  __pipeline_wait_prior(0);
  __syncwarp();   // the row is in, the texel sums are zero
  for (int k0 = 32 * split; k0 < np; k0 += stride) {
    const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
    const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
    add_pair_rounds<DIST, SURFACE>(srow, fid, active, xp, yp, px, cfg, lane, acc, tacc, wtex);
    if (k0 + stride < np) {
      dc += sc;
      dr += sr;
      if (dc >= w) {
        dc -= w;
        ++dr;
      }
      active = k0 + stride + lane < np;
      col = c0 + (active ? dc : 0);
      rowp = r0 + (active ? dr : 0);
      load_pixel(a, b, HW, (size_t)rowp * is + col, &px);
    }
  }
  // the lanes by butterfly
  float mine = 0.0f, mine_t = 0.0f;
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const float v = warp_sum(acc[c]);
    if (lane == c) mine = v;
  }
  if (!SURFACE) {
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      const float v = warp_sum(tacc[c]);
      if (lane == c) mine_t = v;
    }
  }
  __syncwarp();   // every lane's texel adds are in
  const size_t orig = (size_t)b * a.F + fid;   // the face's original row
  if (n_items == 1) {
    write_row<SURFACE>(a, nullptr, orig, true, mine, mine_t, wtex, lane);
    return;
  }
  write_row<SURFACE>(a, a.part + (size_t)it * a.GC, orig, false, mine, mine_t, wtex, lane);
  // the face's last item to finish sums its partial rows in ascending
  // split order; the counter is an integer, so the order of the adds does
  // not depend on which item that is
  __threadfence();
  __syncwarp();
  int prev = 0;
  if (lane == 0) prev = atomicAdd(a.done + f, 1);
  prev = __shfl_sync(0xffffffffu, prev, 0);
  if (prev != n_items - 1) return;
  __threadfence();
  if (lane == 0) a.done[f] = 0;   // zero again for the next launch
  const float* rows_f = a.part + (size_t)first * a.GC;
  for (int c = lane; c < a.GC; c += 32) {
    // eight rows' loads in flight at once, added in split order
    float v = 0.0f;
    int j = 0;
    for (; j + 8 <= n_items; j += 8) {
      float r[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) r[q] = __ldcg(rows_f + (size_t)(j + q) * a.GC + c);
#pragma unroll
      for (int q = 0; q < 8; ++q) v += r[q];
    }
    for (; j < n_items; ++j) v += __ldcg(rows_f + (size_t)j * a.GC + c);
    if (c < 9) {
      a.grad_face[orig * 9 + c] = v;
    } else {
      a.grad_tex[orig * T3 + (c - 9)] = v;
    }
  }
}

static size_t bwd_smem(const DirBwdArgs& a) {
  const int T3s = a.s.texture_type == 0 ? a.GC - 9 : 0;
  return (size_t)kWarps * (a.row + T3s) * sizeof(float);
}

// Launch the kernel for these arguments, or (occupancy != null) report its
// registers, local (spill) bytes and blocks an SM.
template <int DIST, bool SURFACE>
static int launch(const DirBwdArgs& a, cudaStream_t stream, int* occupancy) {
  const auto kernel = softras_dir_bwd_kernel<DIST, SURFACE>;
  const size_t smem = bwd_smem(a);
  if (occupancy) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
    occupancy[0] = attr.numRegs;
    occupancy[1] = (int)attr.localSizeBytes;
    occupancy[2] = blocks;
    return (int)err;
  }
  const long long faces = (long long)a.B * a.F;
  const long long item_blocks = ((long long)a.items + kWarps - 1) / kWarps;
  const long long blocks = item_blocks + (faces + kThreads - 1) / kThreads;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DIST>
static int by_texture(const DirBwdArgs& a, cudaStream_t stream, int* occupancy) {
  return a.s.texture_type == 0 ? launch<DIST, true>(a, stream, occupancy)
                               : launch<DIST, false>(a, stream, occupancy);
}

static int dispatch(const DirBwdArgs& a, cudaStream_t stream, int* occupancy) {
  if (a.items < 0 || a.splits < 1 || a.GC < 9 || (a.items > 0 && a.done == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (a.dist_func) {
    case kDistHard: return by_texture<kDistHard>(a, stream, occupancy);
    case kDistBary: return by_texture<kDistBary>(a, stream, occupancy);
    default: return by_texture<kDistEuclid>(a, stream, occupancy);
  }
}

}  // namespace softras

extern "C" int softras_dir_bwd(const softras::DirBwdArgs* args, void* stream) {
  return softras::dispatch(*args, static_cast<cudaStream_t>(stream), nullptr);
}

extern "C" int softras_dir_bwd_occupancy(const softras::DirBwdArgs* args, int* out) {
  return softras::dispatch(*args, nullptr, out);
}

extern "C" int softras_dir_bwd_args_size() { return (int)sizeof(softras::DirBwdArgs); }
