// SoftRas backward of the f_px route for Hopper (sm_90a), with a plain C
// entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pallas_impl.py
// _make_bwd_kernel / _bwd_body (:442 / :470, launched at :660 by
// soft_rasterize_bwd_pallas): the untruncated backward, the reference's
// naive one (pallas_impl.py:12-16).  Every candidate pair sends gradient;
// the kernel reads no threshold, and the route gives it only calls where
// the top-K truncation does not bind (grad_mode='full', or K >= F).  The
// TPU kernel writes slots [W, 32, 9] and [W, 32, 3T] per (work item, face)
// and XLA segment-sums them (:670-678); here a work item is a run of at
// most 32 faces of a 16 x min(128, is) tile's list and the slots are the
// entries' rows [E, GC], which the segment sum (segment_sum.cu) adds per
// face in ascending tile order.
//
// Design: softras_tile_bwd.cuh (a warp per entry walks the face's bbox
// inside the tile, sums in a fixed order, no atomics: bit-equal twice and
// at every build).
//
// Choices of this source (tools/time_tile_bwd.py, PERF.md §6; 1024 px,
// 39,474 faces, NVIDIA H100 80GB HBM3, 700.00 W): 3 blocks an SM (80
// registers), rows staged a chunk a block, texel adds in rounds, items of
// 32 faces: 0.80 ms against 1.20 for build 000 (no cap, texel adds lane
// after lane) in one call; warps taking faces from a counter (px_f's
// choice) 2.1-2.5% slower in each of 8 turns, 4 blocks an SM 0.81; the
// tile's maps staged in shared memory (96 KB a block, one block an SM; a
// build since removed) 2.2.
//
// Bound.  Operations: the forward's pair math for every pair in a bbox
// plus the gradient terms of every candidate.  Bytes of the function the
// backward and the face sum compute together: the face rows, the lists,
// the 10 maps of the pixels with a candidate, one gradient row per face
// out; the entry rows between the two kernels count only in the sum's.
#ifndef SOFTRAS_TILE_BWD_MIN_BLOCKS
#define SOFTRAS_TILE_BWD_MIN_BLOCKS 3
#endif
#ifndef SOFTRAS_TILE_BWD_ROWS
#define SOFTRAS_TILE_BWD_ROWS 0
#endif
#ifndef SOFTRAS_TILE_BWD_TEXEL
#define SOFTRAS_TILE_BWD_TEXEL 1
#endif
#include "softras_tile_bwd.cuh"

extern "C" int softras_fpx_bwd(const softras::TileBwdArgs* args, void* stream) {
  using namespace softras;
  if (args->thr != nullptr) return (int)cudaErrorInvalidValue;  // untruncated
  return tile_bwd_dispatch(*args, static_cast<cudaStream_t>(stream), nullptr);
}

// Registers, spill bytes and blocks an SM of the kernel these arguments
// launch (out[0..2]).
extern "C" int softras_fpx_bwd_occupancy(const softras::TileBwdArgs* args, int* out) {
  return softras::tile_bwd_dispatch(*args, nullptr, out);
}

extern "C" int softras_fpx_bwd_args_size() { return (int)sizeof(softras::TileBwdArgs); }
