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
// the table a window at a time: each thread tests faces' inflated bboxes
// against the tile's pixel centres (a NaN face fails the test), and warp
// ballots and a prefix over the warps list the faces that meet the tile,
// in table order.  Every thread runs the pair math of softras_pair.cuh on
// each listed face (the depth bits are K1's and the threshold kernel's),
// visiting its faces in table order.  Each thread keeps its accumulators in
// registers, K1's online softmax, alpha, count and hard winner; the hard
// winner compares (depth, original id), so the walk's order does not
// change it.  With a threshold asked for and K <= 32, the thread also
// keeps its K smallest candidate depths (softras_topk.cuh); for a larger
// K, a block where some pixel has more than K candidates bisects on the
// depth's bits with 32 more walks of the geometry alone.  No atomics: the
// output is deterministic, and no choice below changes a bit of it.
//
// What held the first design back (PERF.md §6): every window cost a
// bbox load a thread, a ballot and three block barriers, so a block walked
// the whole table at 256 faces a barrier round (155 rounds at 39,474
// faces); the listed rows were staged behind a block barrier a chunk; the
// K smallest depths lived in local memory.  Now the prep's union bbox of
// every 256 places (softras_dir_prep.cu) is tested first, and a window
// whose unions all miss the tile is skipped by the whole block, with no
// load a thread and no barrier; at K = 16 the K smallest depths are a
// sorted list in registers (RegSmallest16, as the pxg threshold keeps
// them), SmallestK at other K up to 32.  A window is 4 x 256 faces, four a
// thread, under one round of barriers.  The kernels are capped at 4 blocks
// an SM (__launch_bounds__), those of the bisection at 3: its walks spill
// under the cap of 4 and lose occupancy without a cap.  PERF.md has the
// readings of these choices and of those that lost (1 or 2 faces a thread,
// cap 3 without the bisection, the bisection at 4 or without a cap).
//
// One choice at run time, by the mesh's density (the wrapper's
// `warp_rows`, dir_impl.fwd_warp_rows): where faces are small beside a
// tile (fewer image pixels a face than dir_impl.WARP_ROWS_PIXELS), each
// warp keeps only the listed faces whose inflated bbox meets its 8 x 4
// pixel centres (the warp cull: the bbox against the warp's extreme
// centres, by the same formulas as the pair test, so it rejects only faces
// that pair_terms rejects at every pixel of the warp) and stages their rows
// into a buffer of its own with cp.async, behind warp barriers only;
// elsewhere the block stages chunks of the listed rows behind a block
// barrier a chunk, and every warp walks them all.
//
// Bound.  Bytes: the face table and bboxes once, 7 or 8 floats written per
// pixel.  Operations: a bbox test per (tile, face), then the pair math of
// the pairs in a listed face's tile.  chip_smoke.py counts both from its
// run.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "softras_pair.cuh"
#include "softras_topk.cuh"

namespace softras {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kGeom = kTex;   // floats of a row that hold geometry
constexpr int kWide = 4;        // faces a thread tests in a window
constexpr int kMinBlocks = 4;        // blocks an SM: the register cap
constexpr int kBisectMinBlocks = 3;  // the same for the kernels with the bisection

struct DirFwdArgs {
  const float* rows;         // [B, F, row] face rows, Morton order
  const float* bbox;         // [B, F, 4] xmin, xmax, ymin, ymax (inflated)
  const float* wbox;         // [B, ceil(F / 256), 4] the union of each 256 faces' bboxes
  const int* ids;            // [B, F] original id of each face
  float* image;              // [B, 4, H, W]
  float* aggrs;              // [B, 2, H, W]
  int* counts;               // [B, H, W]
  float* thr;                // [B, H, W], or null when K = 0
  int B, F, row, image_size, tiles;
  int chunk;                 // rows a block stages at once (block rows)
  int wchunk;                // rows a warp stages at once (warp rows)
  int warp_rows;             // 1: warps cull the list and stage their own rows
  int K;                     // 0: no threshold
  int dist_func, rgb_func, alpha_func;
  Scalars s;
};

// Shared memory of a block, in 4-byte words: the face rows (a block's
// chunk, or each warp's), the listed places, and the warps' counts; the
// listed faces' ids (block rows) or each warp's kept places and ids (warp
// rows).
__host__ __device__ inline size_t fwd_smem_words(const DirFwdArgs& a) {
  const size_t w = (size_t)kThreads * kWide + (size_t)kWide * kWarps;
  if (a.warp_rows) return w + (size_t)kWarps * a.wchunk * a.row + (size_t)kWarps * 64;
  return w + (size_t)a.chunk * a.row + a.chunk;
}

struct Shared {
  float* srow;   // [chunk, row] (block rows) or [kWarps, wchunk, row] (warp rows)
  int* slist;    // [kThreads * kWide] places of the faces that meet the tile
  int* soid;     // [chunk] their original ids (block rows)
  int* swc;      // [kWide, kWarps] listed faces per window part and warp
  int* wl;       // [kWarps, 32] places a warp keeps, then [kWarps, 32] their ids (warp rows)
};

// Extreme pixel centres of a block of pixels: x0 <= x1, y0 <= y1.
struct Extent {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ bool meets(const float4& q, const Extent& e) {
  return q.x <= e.x1 && q.y >= e.x0 && q.z <= e.y1 && q.w >= e.y0;
}

// The pixel centres of columns c0..c1 and rows r0..r1: (2c+1-is)/is and
// (is-1-2r)/is, the plain version's formulas, which are monotone in c and r.
__device__ __forceinline__ Extent extent(int c0, int c1, int r0, int r1, float isf) {
  Extent e;
  e.x0 = (2.0f * (float)c0 + 1.0f - isf) / isf;
  e.x1 = (2.0f * (float)c1 + 1.0f - isf) / isf;
  e.y1 = (isf - 1.0f - 2.0f * (float)r0) / isf;
  e.y0 = (isf - 1.0f - 2.0f * (float)r1) / isf;
  return e;
}

// Walks the face table once: visit(row, terms, original id) sees every pair
// of this thread's pixel that passes the bbox test and the distance cut,
// face after face in table order.  `stage` floats of each listed row are
// staged.  Every thread of the block must call it.
template <int DIST, bool WARP, class Visit>
__device__ __forceinline__ void walk(const DirFwdArgs& a, const Shared& sh, int stage,
                                     int tid, bool live, float xp, float yp,
                                     const Extent& tile, const Extent& wx, bool warp_live,
                                     Visit& visit) {
  const int b = blockIdx.z;
  const int warp = tid / 32, lane = tid % 32;
  const unsigned below = (1u << lane) - 1u;
  const float4* bb = reinterpret_cast<const float4*>(a.bbox) + (size_t)b * a.F;
  const int units = (a.F + kThreads - 1) / kThreads;
  const float4* wb = reinterpret_cast<const float4*>(a.wbox) + (size_t)b * units;
  const float* rows_b = a.rows + (size_t)b * a.F * a.row;
  const int* ids_b = a.ids + (size_t)b * a.F;
  for (int w0 = 0; w0 < a.F; w0 += kThreads * kWide) {
    bool unit_meets[kWide];
    bool any = false;
#pragma unroll
    for (int s = 0; s < kWide; ++s) {
      const int u = w0 / kThreads + s;
      unit_meets[s] = u < units && meets(wb[u], tile);
      any = any || unit_meets[s];
    }
    if (!any) continue;   // the same for the whole block: no face of the window meets the tile
    unsigned m[kWide];
#pragma unroll
    for (int s = 0; s < kWide; ++s) {
      const int pos = w0 + s * kThreads + tid;
      m[s] = __ballot_sync(0xffffffffu, unit_meets[s] && pos < a.F && meets(bb[pos], tile));
    }
    __syncthreads();  // the previous window has been consumed
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < kWide; ++s) sh.swc[s * kWarps + warp] = __popc(m[s]);
    }
    __syncthreads();
    int n = 0;
#pragma unroll
    for (int s = 0; s < kWide; ++s) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp && ((m[s] >> lane) & 1u))
          sh.slist[n + __popc(m[s] & below)] = w0 + s * kThreads + tid;
        n += sh.swc[s * kWarps + w];
      }
    }
    __syncthreads();
    if (WARP) {
      // each warp keeps the listed faces it needs and stages their rows
      if (!warp_live) continue;
      float* wrow = sh.srow + (size_t)warp * a.wchunk * a.row;
      int* wl = sh.wl + warp * 32;
      int* wid = sh.wl + kWarps * 32 + warp * 32;
      for (int base = 0; base < n; base += 32) {
        const int j = base + lane;
        bool keep = false;
        int place = 0;
        if (j < n) {
          place = sh.slist[j];
          keep = meets(bb[place], wx);
        }
        const unsigned km = __ballot_sync(0xffffffffu, keep);
        if (keep) {
          wl[__popc(km & below)] = place;
          wid[__popc(km & below)] = ids_b[place];
        }
        __syncwarp();
        const int k = __popc(km);
        for (int q0 = 0; q0 < k; q0 += a.wchunk) {
          const int g = min(a.wchunk, k - q0);
          for (int i = lane; i < g * stage; i += 32) {
            const int q = i / stage;
            __pipeline_memcpy_async(wrow + i, rows_b + (size_t)wl[q0 + q] * a.row + (i - q * stage),
                                    4);
          }
          __pipeline_commit();
          __pipeline_wait_prior(0);
          __syncwarp();
          if (live) {
            for (int q = 0; q < g; ++q) {
              const float* r = wrow + q * stage;
              PairTerms t;
              // false: outside the inflated bbox or past the distance cut
              if (pair_terms<DIST>(r, xp, yp, a.s, &t)) visit(r, t, wid[q0 + q]);
            }
          }
          __syncwarp();   // the buffer and the kept places are free
        }
      }
      continue;
    }
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
        if (pair_terms<DIST>(r, xp, yp, a.s, &t)) visit(r, t, sh.soid[j]);
      }
    }
  }
}

// What a thread keeps for the threshold: nothing (no threshold), its K
// smallest depths in local memory or, at K = 16, in registers, or nothing
// and the bisection (K > 32).
constexpr int kNoList = 0, kLocalList = 1, kRegisterList = 2, kBisect = 3;

struct NoList {};

// K1's accumulators, and the K smallest candidate depths with a list.  `a`
// points at the kernel's __grid_constant__ parameter: no copy is made.
template <int RGB, int LIST>
struct Accumulate {
  const DirFwdArgs* a;
  float S, M, n0, n1, n2;          // softmax
  float dmin, c0, c1, c2;          // hard rgb
  int win;
  float A;
  int cnt;
  std::conditional_t<LIST == kLocalList, SmallestK,
                     std::conditional_t<LIST == kRegisterList, RegSmallest16, NoList>> list;

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
    if constexpr (LIST == kLocalList || LIST == kRegisterList) {
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

template <int DIST, int RGB, int LIST, bool WARP>
__global__ void __launch_bounds__(kThreads, LIST == kBisect ? kBisectMinBlocks : kMinBlocks)
    softras_dir_fwd_kernel(const __grid_constant__ DirFwdArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  Shared sh;
  if (WARP) {
    sh.srow = smem;
    sh.slist = reinterpret_cast<int*>(smem + (size_t)kWarps * a.wchunk * a.row);
    sh.soid = nullptr;
    sh.swc = sh.slist + kThreads * kWide;
    sh.wl = sh.swc + kWide * kWarps;
  } else {
    sh.srow = smem;
    sh.slist = reinterpret_cast<int*>(sh.srow + (size_t)a.chunk * a.row);
    sh.soid = sh.slist + kThreads * kWide;
    sh.swc = sh.soid + a.chunk;
    sh.wl = nullptr;
  }

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
  // the tile's and the warp's extreme centres by the same formulas
  const float xp = (2.0f * (float)col + 1.0f - isf) / isf;
  const float yp = (isf - 1.0f - 2.0f * (float)rowp) / isf;
  const Extent tile = extent(cl, min(cl + kTile - 1, is - 1), rl, min(rl + kTile - 1, is - 1), isf);
  const int wc0 = cl + (warp % 2) * 8, wr0 = rl + (warp / 2) * 4;
  const Extent wx = extent(wc0, min(wc0 + 7, is - 1), wr0, min(wr0 + 3, is - 1), isf);
  const bool warp_live = __any_sync(0xffffffffu, live);
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
  if constexpr (LIST == kLocalList) {
    acc.list.K = a.K;
    acc.list.n = 0;
    acc.list.imax = 0;
  } else if constexpr (LIST == kRegisterList) {
    acc.list.clear();
  }
  walk<DIST, WARP>(a, sh, a.row, tid, live, xp, yp, tile, wx, warp_live, acc);

  // the threshold: the K-th smallest candidate depth where the pixel has
  // more than K candidates, far elsewhere
  const bool need = live && a.K > 0 && acc.cnt > a.K;
  float thr = s.far;
  if constexpr (LIST == kLocalList) {
    if (need) thr = acc.list.d[acc.list.imax];
  } else if constexpr (LIST == kRegisterList) {
    if (need) thr = acc.list.d[kRegK - 1];
  } else if constexpr (LIST == kBisect) {
    if (__syncthreads_or(need)) {
      // the smallest key with at least K candidates at or below it
      unsigned lo = 0u, hi = 0xffffffffu;
      for (int it = 0; it < 32; ++it) {
        CountPairs v;
        v.c.trial = lo + (hi - lo) / 2u;
        v.c.count = 0;
        walk<DIST, WARP>(a, sh, kGeom, tid, live, xp, yp, tile, wx, warp_live, v);
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

// static: its `ready` must be this library's own (a static local of a
// function with external linkage is one symbol across every library
// loaded).
template <int DIST, int RGB, int LIST, bool WARP>
static int launch_rows(const DirFwdArgs& a, cudaStream_t stream, int* occupancy) {
  const auto kernel = softras_dir_fwd_kernel<DIST, RGB, LIST, WARP>;
  const size_t smem = 4 * fwd_smem_words(a);
  static size_t ready = 0;
  if (ready < smem) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = smem;
  }
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
  kernel<<<dim3(a.tiles, a.tiles, a.B), dim3(kTile, kTile), smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int DIST, int RGB, int LIST>
static int launch_list(const DirFwdArgs& a, cudaStream_t stream, int* occupancy) {
  return a.warp_rows ? launch_rows<DIST, RGB, LIST, true>(a, stream, occupancy)
                     : launch_rows<DIST, RGB, LIST, false>(a, stream, occupancy);
}

template <int DIST, int RGB>
static int launch(const DirFwdArgs& a, cudaStream_t stream, int* occupancy) {
  if (a.K <= 0) return launch_list<DIST, RGB, kNoList>(a, stream, occupancy);
  if (a.K == kRegK) return launch_list<DIST, RGB, kRegisterList>(a, stream, occupancy);
  if (a.K <= kListMax) return launch_list<DIST, RGB, kLocalList>(a, stream, occupancy);
  return launch_list<DIST, RGB, kBisect>(a, stream, occupancy);
}

template <int DIST>
static int launch_rgb(const DirFwdArgs& a, cudaStream_t stream, int* occupancy) {
  switch (a.rgb_func) {
    case kRgbHard: return launch<DIST, kRgbHard>(a, stream, occupancy);
    case kRgbSoftmax: return launch<DIST, kRgbSoftmax>(a, stream, occupancy);
    default: return launch<DIST, 2>(a, stream, occupancy);
  }
}

static int dispatch(const DirFwdArgs& a, cudaStream_t stream, int* occupancy) {
  if (a.row < kGeom || (a.warp_rows ? a.wchunk < 1 : (a.chunk < 1 || a.chunk > kThreads)))
    return (int)cudaErrorInvalidValue;
  switch (a.dist_func) {
    case kDistHard: return launch_rgb<kDistHard>(a, stream, occupancy);
    case kDistBary: return launch_rgb<kDistBary>(a, stream, occupancy);
    default: return launch_rgb<kDistEuclid>(a, stream, occupancy);
  }
}

}  // namespace softras

extern "C" int softras_dir_fwd(const softras::DirFwdArgs* args, void* stream) {
  return softras::dispatch(*args, static_cast<cudaStream_t>(stream), nullptr);
}

extern "C" int softras_dir_fwd_occupancy(const softras::DirFwdArgs* args, int* out) {
  return softras::dispatch(*args, nullptr, out);
}

extern "C" int softras_dir_fwd_args_size() { return (int)sizeof(softras::DirFwdArgs); }
