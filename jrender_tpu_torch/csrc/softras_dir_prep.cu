// The dir route's table prep for Hopper (sm_90a), plain C entry point.
//
// Replaces no TPU kernel: it is the part of the JAX package's prep_dir
// (jrender_tpu/ops/softras/dir_impl.py:99, XLA) that both dir kernels of
// the port read after the Morton sort, in one launch where plain torch
// took some fifty: the faces' inflated bboxes in place order (a gather by
// the sort), the union of every 256 places' bboxes, which the forward
// (softras_dir_fwd.cu) tests before the places themselves, and, for a step
// that will take a gradient, the backward's work items (softras_dir_bwd.cu):
// each face's item count min(splits, its chunks of 32 pixels), their
// offsets and their total, and the backward's zeroed face counters.  Its
// plain version is dir_impl.prep_plain; every output is exact (a gather,
// minima and maxima, integer sums), so the two agree to the bit.
//
// Design.  A block per 256 places of a batch element (a unit), a thread a
// place: the thread gathers its face's bbox, the block reduces the unit's
// union and scans the items into offsets within the unit, and writes the
// unit's total.  With the items the grid is cooperative (a block an SM,
// each taking units in turn): after a grid barrier, block 0 scans the
// units' totals into their offsets in place, total last.  The barrier is
// the launch's own, so preps on several streams share no state.  An
// item's offset is its unit's offset plus its offset within the unit (the
// backward searches both levels), and no host read is needed: the wrapper
// copies the total to pinned memory behind an event.
//
// Bound.  Bytes: the bboxes and ids read once, the sorted bboxes, unions,
// offsets and counters written once.  chip_smoke.py counts them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "softras_grad.cuh"

namespace softras {

constexpr int kUnit = 256;   // places a block takes: the forward block's window
constexpr int kWarps = kUnit / 32;

struct DirPrepArgs {
  const float* bbox;   // [B, F, 4] xmin, xmax, ymin, ymax (inflated), the faces' own order
  const int* ids;      // [B, F] original id of the face at each place
  float* sbox;         // [B, F, 4] the bboxes in place order
  float* wbox;         // [B, U, 4] each unit's union
  int* loff;           // [B * F] each face's first item within its unit, or null: no items
  int* uoff;           // [B * U + 1] each unit's first item; the last is the total
  int* done;           // [B * F] the backward's face counters, zeroed
  int B, F, U, image_size, splits;
};

// The face's item count: min(splits, chunks of 32 pixels in its pixel bbox),
// 0 for no pixel or a NaN face.
__device__ __forceinline__ int face_items(float4 q, int image_size, int splits) {
  int c0, c1, r0, r1;
  if (!bbox_pixels(q, image_size, &c0, &c1, &r0, &r1)) return 0;
  return min(splits, ((c1 - c0 + 1) * (r1 - r0 + 1) + 31) / 32);
}

// Exclusive scan of v over the block's 256 threads; *total gets the sum.
__device__ __forceinline__ int block_scan(int v, int* swarp, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) swarp[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? swarp[w] : 0;
    all += swarp[w];
  }
  __syncthreads();   // swarp is free again
  *total = all;
  return before + x - v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Unit k = b * U + u: its places' bboxes gathered, its union and, with the
// items, each face's count scanned into offsets within the unit and the
// unit's total in uoff[k + 1].  Every thread of the block calls it.
__device__ __forceinline__ void prep_unit(const DirPrepArgs& a, int k, float (*sred)[4],
                                          int* swarp) {
  const int b = k / a.U, u = k - b * a.U;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int f = u * kUnit + t;
  const bool in = f < a.F;
  const size_t place = (size_t)b * a.F + f;
  const float inf = __int_as_float(0x7f800000);
  float4 q = make_float4(inf, -inf, inf, -inf);
  if (in) {
    q = reinterpret_cast<const float4*>(a.bbox)[(size_t)b * a.F + a.ids[place]];
    reinterpret_cast<float4*>(a.sbox)[place] = q;
  }
  // a face with a NaN meets no tile: it counts in no union
  const bool finite = !(isnan(q.x) || isnan(q.y) || isnan(q.z) || isnan(q.w));
  float r[4] = {finite ? q.x : inf, finite ? q.y : -inf, finite ? q.z : inf, finite ? q.w : -inf};
  r[0] = warp_min(r[0]);
  r[1] = warp_max(r[1]);
  r[2] = warp_min(r[2]);
  r[3] = warp_max(r[3]);
  __syncthreads();   // the previous unit's union has been read
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) sred[warp][c] = r[c];
  }
  __syncthreads();
  if (t == 0) {
    float4 w = make_float4(inf, -inf, inf, -inf);
    for (int i = 0; i < kWarps; ++i) {
      w.x = fminf(w.x, sred[i][0]);
      w.y = fmaxf(w.y, sred[i][1]);
      w.z = fminf(w.z, sred[i][2]);
      w.w = fmaxf(w.w, sred[i][3]);
    }
    reinterpret_cast<float4*>(a.wbox)[k] = w;
  }
  if (a.loff == nullptr) return;
  const int n = in ? face_items(q, a.image_size, a.splits) : 0;
  int unit_total;
  const int excl = block_scan(n, swarp, &unit_total);
  if (in) {
    a.loff[place] = excl;
    a.done[place] = 0;
  }
  if (t == 0) a.uoff[k + 1] = unit_total;
}

__global__ void __launch_bounds__(kUnit) softras_dir_prep_kernel(const DirPrepArgs a) {
  __shared__ float sred[kWarps][4];
  __shared__ int swarp[kWarps];
  const int units = a.B * a.U;
  for (int k = blockIdx.x; k < units; k += gridDim.x) prep_unit(a, k, sred, swarp);
  if (a.loff == nullptr) return;   // the same for every block: no grid barrier
  // every unit's total is written (the barrier orders the grid's writes)
  cooperative_groups::this_grid().sync();
  if (blockIdx.x != 0) return;
  const int t = threadIdx.x;
  int carry = 0;
  for (int base = 0; base < units; base += kUnit) {
    const int i = base + t;
    const int v = i < units ? __ldcg(a.uoff + 1 + i) : 0;
    int total;
    const int e = block_scan(v, swarp, &total);
    if (i < units) a.uoff[1 + i] = carry + e + v;
    carry += total;
  }
  if (t == 0) a.uoff[0] = 0;
}

// The blocks of a cooperative launch on the current card: one an SM (a
// unit is little work), found at the card's first launch; 0 on an error.
static int grid_blocks() {
  static int known[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (known[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, softras_dir_prep_kernel, kUnit,
                                                      0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        per_sm < 1)
      return 0;
    known[dev] = sms;
  }
  return known[dev];
}

}  // namespace softras

extern "C" int softras_dir_prep(const softras::DirPrepArgs* args, void* stream) {
  using namespace softras;
  const DirPrepArgs& a = *args;
  if (a.B < 1 || a.F < 1 || a.U != (a.F + kUnit - 1) / kUnit || a.splits < 1 ||
      (a.loff != nullptr && (a.uoff == nullptr || a.done == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int units = a.B * a.U;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.loff == nullptr) {
    softras_dir_prep_kernel<<<units, kUnit, 0, s>>>(a);
    return (int)cudaGetLastError();
  }
  const int most = grid_blocks();
  if (most < 1) return (int)cudaErrorInvalidConfiguration;
  void* params[] = {const_cast<DirPrepArgs*>(&a)};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(softras_dir_prep_kernel),
                                          dim3(units < most ? units : most), dim3(kUnit), params,
                                          0, s);
}

extern "C" int softras_dir_prep_args_size() { return (int)sizeof(softras::DirPrepArgs); }
