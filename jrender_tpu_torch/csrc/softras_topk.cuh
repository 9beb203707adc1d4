// The top-K depth threshold's pieces as CUDA device code, shared by the
// binned threshold kernel (softras_thr.cu), the px_f forward
// (softras_tile_fwd.cuh), the dir forward (softras_dir_fwd.cu), which
// find the threshold in their own walks, and the pxg threshold
// (softras_pxg_thr.cu), which merges the pxg partials' lists.
//
// The threshold of a pixel is the K-th smallest depth among its candidate
// pairs, counted with multiplicity.  A thread meets its candidates one
// after the other and keeps the K smallest seen so far (SmallestK), for K
// up to kListMax; a larger K is bisected on the depth's bits, one walk
// per step counting the candidates at or below a trial (CountBelow), as
// the TPU kernels bisect (pxt_impl.py:584-674, dir_impl.py:343-399).
#pragma once

#include <cuda_runtime.h>

namespace softras {

constexpr int kListMax = 32;  // depths a thread's list holds
constexpr int kRegK = 16;     // the register list's K

// order-preserving map of a float onto unsigned integers
__device__ __forceinline__ unsigned depth_key(float z) {
  const unsigned u = __float_as_uint(z);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_depth(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the K smallest depths seen so far, unsorted, and the place of their max
struct SmallestK {
  float d[kListMax];
  int K, n, imax;
  __device__ __forceinline__ void operator()(float z) {
    if (n < K) {
      d[n] = z;
      if (n == 0 || z > d[imax]) imax = n;
      ++n;
    } else if (z < d[imax]) {
      d[imax] = z;
      int m = 0;
      for (int i = 1; i < K; ++i)
        if (d[i] > d[m]) m = i;
      imax = m;
    }
  }
};

// The K = 16 smallest depths seen so far, sorted, in registers: a depth
// below the largest moves the larger ones up one place.  d[kRegK - 1] is
// the K-th smallest once K depths were seen (+inf before).
struct RegSmallest16 {
  float d[kRegK];
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kRegK; ++i) d[i] = __int_as_float(0x7f800000);
  }
  __device__ __forceinline__ void operator()(float z) {
    if (!(z < d[kRegK - 1])) return;
#pragma unroll
    for (int i = kRegK - 1; i > 0; --i) d[i] = z < d[i - 1] ? d[i - 1] : (z < d[i] ? z : d[i]);
    d[0] = z < d[0] ? z : d[0];
  }
};

// The K smallest depths seen so far, in shared memory: d[i * STRIDE] is
// the thread's i-th, unsorted (STRIDE pixels apart, so a warp's lanes sit
// on distinct banks); the count and the place and value of the maximum
// live in registers.  A depth below the maximum replaces it, and one scan
// of K finds the next.
template <int STRIDE>
struct SharedSmallestK {
  float* d;
  int K, n, imax;
  float dmax;
  __device__ __forceinline__ void operator()(float z) {
    if (n < K) {
      d[n * STRIDE] = z;
      if (n == 0 || z > dmax) {
        imax = n;
        dmax = z;
      }
      ++n;
    } else if (z < dmax) {
      d[imax * STRIDE] = z;
      int m = 0;
      float mv = d[0];
#pragma unroll 8
      for (int i = 1; i < K; ++i) {
        const float v = d[i * STRIDE];
        if (v > mv) {
          mv = v;
          m = i;
        }
      }
      imax = m;
      dmax = mv;
    }
  }
};

struct CountBelow {
  unsigned trial;
  int count;
  __device__ __forceinline__ void operator()(float z) {
    count += depth_key(z) <= trial ? 1 : 0;
  }
};

}  // namespace softras
