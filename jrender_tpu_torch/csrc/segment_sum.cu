// Sums of rows by segment in a fixed order, for Hopper (sm_90a), with a
// plain C entry point.
//
// Replaces the segment sums by face id that follow the TPU backward
// kernels (jrender_tpu/ops/softras/pxg_impl.py:998-1011, and
// pallas_impl.py:670-678 and :1713-1724 for the f_px and px_f layouts),
// and the port's index_add_ sums per vertex and per face outside the
// rasterizers (ops/segment_sum.py).  Segment s adds the rows
// rows[order[e]] for e in [off[s], off[s + 1]), in that order, and writes
// out[s] = their sum (zero for an empty segment).
//
// Design.  One thread per output value (segment, column): a warp covers
// consecutive columns of one or more segments, so a row is read by
// adjacent lanes, whatever its width (3 for vertex normals, 9 + 3T for a
// SoftRas gradient row).  Each thread adds its segment's rows one after
// the other: no atomics, the same order on every run, the same bits.
//
// Bound.  Bytes: the rows read once, the index (off, order), the sums
// written once; one add per row value.
#include <cuda_runtime.h>

namespace segsum {

constexpr int kThreads = 256;

struct SegmentSumArgs {
  const float* rows;   // [N, C]
  const int* off;      // [n_seg + 1] first place of each segment in order
  const int* order;    // [N] row ids, each segment's ascending
  float* out;          // [n_seg, C]
  long long n_seg;
  int C;
};

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(const SegmentSumArgs a) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n_seg * a.C) return;
  const long long s = i / a.C;
  const int c = (int)(i - s * a.C);
  const int e0 = a.off[s], e1 = a.off[s + 1];
  float v = 0.0f;
  for (int e = e0; e < e1; ++e) v += a.rows[(size_t)a.order[e] * a.C + c];
  a.out[i] = v;
}

}  // namespace segsum

extern "C" int segment_sum(const segsum::SegmentSumArgs* args, void* stream) {
  using namespace segsum;
  const long long n = args->n_seg * args->C;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  segment_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*args);
  return (int)cudaGetLastError();
}

extern "C" int segment_sum_args_size() { return (int)sizeof(segsum::SegmentSumArgs); }
