// SoftRas forward of the dir route for Hopper (sm_90a), plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/dir_impl.py
// _make_fwd_kernel_dir (:202, launched at :434 by soft_rasterize_fwd_dir),
// with_thr included: the image, the aggregates and the candidate counts of
// the binned forward (softras_fwd.cu, K1) and, when asked, the top-K depth
// threshold of softras_thr.cu, found in the same walk.  There is no
// binning: every screen tile walks the whole face table.
//
// Design.  One block of 16 x 16 threads per (screen tile, batch element),
// one thread per pixel, each warp an 8 x 4 block of pixels, as K1.  The
// face table is in Morton order of the faces' bbox centres (prep_dir), so
// the faces that meet a tile lie close together in it.  The block walks
// the table 256 faces at a time: each thread tests one face's inflated
// bbox against the tile's pixel centres (a NaN face fails the test), and
// a warp ballot and a prefix over the eight warps list the faces that meet
// the tile, in table order.  A window with none costs that one test.  The
// listed faces' rows are staged in shared memory in chunks and every
// thread runs the pair math of softras_pair.cuh on each (the depth bits
// are K1's and the threshold kernel's).  Each thread keeps its
// accumulators in registers, K1's online softmax, alpha, count and hard
// winner; the hard winner compares (depth, original id), so the walk's
// order does not change it.  With a threshold asked for and K <= 32, the
// thread also keeps its K smallest candidate depths (softras_topk.cuh);
// for a larger K, a block where some pixel has more than K candidates
// bisects on the depth's bits with 32 more walks of the geometry alone.
// No atomics: the output is deterministic.
//
// Bound.  Bytes: the face table and bboxes once, 7 or 8 floats written per
// pixel.  Operations: a bbox test per (tile, face), then the pair math of
// the pairs in a listed face's tile: on the bench's 288-face sphere at
// 1024^2 the pairs in a bbox are few, and the bbox tests of 4,096 tiles
// against the whole table are the kernel's own overhead on top of them.
// chip_smoke.py counts both from its run.
#include <cuda_runtime.h>

#include <type_traits>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

namespace softras {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kGeom = kTex;   // floats of a row that hold geometry

struct DirFwdArgs {
  const float* rows;         // [B, F, row] face rows, Morton order
  const float* bbox;         // [B, F, 4] xmin, xmax, ymin, ymax (inflated)
  const int* ids;            // [B, F] original id of each face
  float* image;              // [B, 4, H, W]
  float* aggrs;              // [B, 2, H, W]
  int* counts;               // [B, H, W]
  float* thr;                // [B, H, W], or null when K = 0
  int B, F, row, image_size, tiles, chunk;
  int K;                     // 0: no threshold
  int dist_func, rgb_func, alpha_func;
  Scalars s;
};

struct Shared {
  float* srow;   // [chunk, stage]
  int* slist;    // [kThreads] places of the faces that meet the tile
  int* soid;     // [chunk] their original ids
  int* swc;      // [kWarps] listed faces per warp
};

// Walks the face table once: visit(row, terms, original id) sees every pair
// of this thread's pixel that passes the bbox test and the distance cut.
// `stage` floats of each listed row are staged.  Every thread of the block
// must call it.
template <int DIST, class Visit>
__device__ __forceinline__ void walk(const DirFwdArgs& a, const Shared& sh, int stage,
                                     int tid, bool live, float xp, float yp,
                                     float x0, float x1, float y0, float y1,
                                     Visit& visit) {
  const int b = blockIdx.z;
  const int warp = tid / 32, lane = tid % 32;
  const float4* bb = reinterpret_cast<const float4*>(a.bbox) + (size_t)b * a.F;
  const float* rows_b = a.rows + (size_t)b * a.F * a.row;
  const int* ids_b = a.ids + (size_t)b * a.F;
  for (int w0 = 0; w0 < a.F; w0 += kThreads) {
    const int pos = w0 + tid;
    bool meets = false;
    if (pos < a.F) {
      const float4 q = bb[pos];
      meets = q.x <= x1 && q.y >= x0 && q.z <= y1 && q.w >= y0;
    }
    const unsigned m = __ballot_sync(0xffffffffu, meets);
    __syncthreads();  // the previous window has been consumed
    if (lane == 0) sh.swc[warp] = __popc(m);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? sh.swc[w] : 0;
      n += sh.swc[w];
    }
    if (meets) sh.slist[off + __popc(m & ((1u << lane) - 1u))] = pos;
    __syncthreads();
    for (int base = 0; base < n; base += a.chunk) {
      const int c = min(a.chunk, n - base);
      if (base > 0) __syncthreads();  // the previous chunk has been consumed
      for (int i = tid; i < c * stage; i += kThreads) {
        const int j = i / stage;
        sh.srow[i] = rows_b[(size_t)sh.slist[base + j] * a.row + (i - j * stage)];
      }
      if (tid < c) sh.soid[tid] = ids_b[sh.slist[base + tid]];
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < c; ++j) {
        const float* r = sh.srow + j * stage;
        PairTerms t;
        // false: outside the inflated bbox or past the distance cut
        if (pair_terms<DIST>(r, xp, yp, a.s, &t)) visit(r, t, sh.soid[j]);
      }
    }
  }
}

struct NoList {};

// K1's accumulators, and the K smallest candidate depths when LIST.  `a`
// points at the kernel's __grid_constant__ parameter: no copy is made.
template <int RGB, bool LIST>
struct Accumulate {
  const DirFwdArgs* a;
  float S, M, n0, n1, n2;          // softmax
  float dmin, c0, c1, c2;          // hard rgb
  int win;
  float A;
  int cnt;
  std::conditional_t<LIST, SmallestK, NoList> list;

  __device__ __forceinline__ void operator()(const float* r, const PairTerms& t, int oid) {
    const Scalars& s = a->s;
    if (a->alpha_func == kAlphaProd) {
      A *= 1.0f - t.sf;
    } else if (a->alpha_func == kAlphaSum) {
      A += t.sf;
    } else if (t.sf > 0.5f) {
      A = 1.0f;
    }
    cnt += t.tk_valid ? 1 : 0;
    if constexpr (LIST) {
      if (t.tk_valid) list(t.zp);
    }
    const bool side_ok = s.fill_back || r[kFront] > 0.5f;
    if (RGB == kRgbSoftmax) {
      if (t.tk_valid && side_ok) {
        const float zpn = (s.far - t.zp) / s.far_minus_near;
        if (zpn > M) {
          // the max rises: rescale what was summed under the old one
          const float sc = expf((M - zpn) / s.gamma);
          S *= sc;
          n0 *= sc;
          n1 *= sc;
          n2 *= sc;
          M = zpn;
        }
        const float e = expf((zpn - M) / s.gamma) * t.sf;
        float c[3];
        pair_color(r, t, s, c);
        S += e;
        n0 += e * c[0];
        n1 += e * c[1];
        n2 += e * c[2];
      }
    } else if (RGB == kRgbHard) {
      if (t.tk_valid && t.inside && side_ok &&
          (t.zp < dmin || (t.zp == dmin && (win < 0 || oid < win)))) {
        float c[3];
        pair_color(r, t, s, c);
        dmin = t.zp;
        win = oid;
        c0 = c[0];
        c1 = c[1];
        c2 = c[2];
      }
    }
  }
};

struct CountPairs {
  CountBelow c;
  __device__ __forceinline__ void operator()(const float*, const PairTerms& t, int) {
    if (t.tk_valid) c(t.zp);
  }
};

template <int DIST, int RGB, bool LIST>
__global__ void __launch_bounds__(kThreads)
    softras_dir_fwd_kernel(const __grid_constant__ DirFwdArgs a) {
  extern __shared__ float smem[];
  Shared sh;
  sh.srow = smem;
  sh.slist = reinterpret_cast<int*>(smem + a.chunk * a.row);
  sh.soid = sh.slist + kThreads;
  sh.swc = sh.soid + a.chunk;

  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tx = (warp % 2) * 8 + lane % 8;
  const int ty = (warp / 2) * 4 + lane / 8;
  const int is = a.image_size;
  const float isf = (float)is;
  const int cl = blockIdx.x * kTile, rl = blockIdx.y * kTile;
  const int col = cl + tx, rowp = rl + ty;
  const bool live = col < is && rowp < is;
  // the plain version's pixel centres, (2c+1-is)/is and (is-1-2r)/is, and
  // the tile's extreme centres by the same formulas
  const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
  const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
  const int ch = min(cl + kTile - 1, is - 1), rh = min(rl + kTile - 1, is - 1);
  const float x0 = (2.0f * (float)cl + 1.0f - isf) / isf;
  const float x1 = (2.0f * (float)ch + 1.0f - isf) / isf;
  const float y1 = (isf - 1.0f - 2.0f * (float)rl) / isf;
  const float y0 = (isf - 1.0f - 2.0f * (float)rh) / isf;
  const Scalars& s = a.s;

  Accumulate<RGB, LIST> acc;
  acc.a = &a;
  acc.S = 1.0f;
  acc.M = s.eps;
  acc.n0 = acc.n1 = acc.n2 = 0.0f;
  acc.dmin = kBigDepth;
  acc.c0 = acc.c1 = acc.c2 = 0.0f;
  acc.win = -1;
  acc.A = a.alpha_func == kAlphaProd ? 1.0f : 0.0f;
  acc.cnt = 0;
  if constexpr (LIST) {
    acc.list.K = a.K;
    acc.list.n = 0;
    acc.list.imax = 0;
  }
  walk<DIST>(a, sh, a.row, tid, live, xp, yp, x0, x1, y0, y1, acc);

  // the threshold: the K-th smallest candidate depth where the pixel has
  // more than K candidates, far elsewhere
  const bool need = live && a.K > 0 && acc.cnt > a.K;
  float thr = s.far;
  if constexpr (LIST) {
    if (need) thr = acc.list.d[acc.list.imax];
  } else {
    if (a.K > kListMax && __syncthreads_or(need)) {
      // the smallest key with at least K candidates at or below it
      unsigned lo = 0u, hi = 0xffffffffu;
      for (int it = 0; it < 32; ++it) {
        CountPairs v;
        v.c.trial = lo + (hi - lo) / 2u;
        v.c.count = 0;
        walk<DIST>(a, sh, kGeom, tid, live, xp, yp, x0, x1, y0, y1, v);
        if (v.c.count >= a.K) {
          hi = v.c.trial;
        } else {
          lo = v.c.trial + 1u;
        }
      }
      if (need) thr = key_depth(hi);
    }
  }
  if (!live) return;

  float rgb[3], ag0, ag1;
  if (RGB == kRgbSoftmax) {
    const float eb = expf((s.eps - acc.M) / s.gamma);
    rgb[0] = (eb * s.bg[0] + acc.n0) / acc.S;
    rgb[1] = (eb * s.bg[1] + acc.n1) / acc.S;
    rgb[2] = (eb * s.bg[2] + acc.n2) / acc.S;
    ag0 = acc.S;
    ag1 = acc.M;
  } else if (RGB == kRgbHard) {
    const bool hit = acc.win >= 0;
    rgb[0] = hit ? acc.c0 : s.bg[0];
    rgb[1] = hit ? acc.c1 : s.bg[1];
    rgb[2] = hit ? acc.c2 : s.bg[2];
    ag0 = hit ? acc.dmin : kBigDepth;
    ag1 = hit ? (float)acc.win : -1.0f;
  } else {
    rgb[0] = s.bg[0];
    rgb[1] = s.bg[1];
    rgb[2] = s.bg[2];
    ag0 = 0.0f;
    ag1 = 0.0f;
  }
  float alpha;
  if (a.alpha_func == kAlphaProd) {
    alpha = 1.0f - acc.A;
  } else if (a.alpha_func == kAlphaSum) {
    alpha = acc.A / (float)a.F;  // divided by the true face count
  } else {
    alpha = acc.A;
  }

  const size_t HW = (size_t)is * is;
  const size_t b = blockIdx.z;
  const size_t px = (size_t)rowp * is + col;
  float* img = a.image + b * 4 * HW + px;
  img[0] = rgb[0];
  img[HW] = rgb[1];
  img[2 * HW] = rgb[2];
  img[3 * HW] = alpha;
  float* ag = a.aggrs + b * 2 * HW + px;
  ag[0] = ag0;
  ag[HW] = ag1;
  a.counts[b * HW + px] = acc.cnt;
  if (a.thr != nullptr) a.thr[b * HW + px] = thr;
}

template <int DIST, int RGB>
cudaError_t launch(const DirFwdArgs& a, cudaStream_t stream) {
  const dim3 grid(a.tiles, a.tiles, a.B);
  const dim3 block(kTile, kTile);
  const size_t smem = (size_t)a.chunk * a.row * sizeof(float) +
                      (kThreads + (size_t)a.chunk + kWarps) * sizeof(int);
  if (a.K > 0 && a.K <= kListMax) {
    softras_dir_fwd_kernel<DIST, RGB, true><<<grid, block, smem, stream>>>(a);
  } else {
    softras_dir_fwd_kernel<DIST, RGB, false><<<grid, block, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int DIST>
cudaError_t launch_rgb(const DirFwdArgs& a, cudaStream_t stream) {
  switch (a.rgb_func) {
    case kRgbHard: return launch<DIST, kRgbHard>(a, stream);
    case kRgbSoftmax: return launch<DIST, kRgbSoftmax>(a, stream);
    default: return launch<DIST, 2>(a, stream);
  }
}

}  // namespace softras

extern "C" int softras_dir_fwd(const softras::DirFwdArgs* args, void* stream) {
  using namespace softras;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (args->dist_func) {
    case kDistHard: err = launch_rgb<kDistHard>(*args, st); break;
    case kDistBary: err = launch_rgb<kDistBary>(*args, st); break;
    default: err = launch_rgb<kDistEuclid>(*args, st); break;
  }
  return (int)err;
}

extern "C" int softras_dir_fwd_args_size() { return (int)sizeof(softras::DirFwdArgs); }
