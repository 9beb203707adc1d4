// SoftRas backward of the pxg route (grouped work items) for Hopper
// (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pxg_impl.py
// _make_bwd_kernel_pxg (:758, launched at :989 by soft_rasterize_bwd_pxg).
// With the segment sum by face id that follows it there (:998-1011, here
// csrc/segment_sum.cu) it computes the reference's top-K truncated
// backward (soft_rasterize.py:523-1358): for every candidate pair with
// zp <= thr (:803-804), the gradient of the pixel with respect to the
// face's 9 coordinates and its texture values, summed over the pixels per
// face.  The TPU's 11-channel per-group pixel gather (:963-969) is a
// lane-layout device and has no counterpart.
//
// Design: softras_tile_bwd.cuh, on 16 x 16 tiles, no band (the maps are
// the whole image's), over the forward's work items (pxg_impl.GROUP = 64
// faces of a tile's list).  A warp per entry walks the face's bbox inside
// the tile in a fixed order, so every row is bit-equal at every build and
// item size, and to the kernel this one replaced.
//
// Choices of this source (tools/time_tile_bwd.py --routes pxg, PERF.md §6;
// 1024 px, 39,474 faces, K = 16, NVIDIA H100 80GB HBM3, 700.00 W): 3 blocks
// an SM (80 registers), warps taking faces from a counter with their own
// rows staged by cp.async, texel adds in rounds (build 311).  At items of
// 64 (3,001 items) it read 0.7529-0.7573 ms against 0.7836-0.7871 for 411
// (4 blocks an SM, 64 registers) in eight readings each, in turns, of one
// call; at items of 48, 0.7498-0.7550 against 0.7690-0.7722 (a cut of its
// own at 48 gained 0.25%, which did not pay for a second cut in every
// prep).  In another call build 000 (no cap, rows a chunk a block, lanes
// one by one; items of 32) read 1.157, where the kernel this one replaced
// read 1.173 and build 000 at its items of 64 1.137, so staging the tile's
// 11 maps in shared memory (that kernel's one difference) did not pay.
//
// Bound.  Operations: the forward's pair math for every pair in a bbox
// plus the gradient terms of the pairs within the threshold.  Bytes of
// the function this kernel and the face sum compute together: the face
// rows, the lists, the 11 maps of the pixels with a candidate, one
// gradient row per face out; the entry rows count only in the sum's.
#ifndef SOFTRAS_TILE_BWD_MIN_BLOCKS
#define SOFTRAS_TILE_BWD_MIN_BLOCKS 3
#endif
#ifndef SOFTRAS_TILE_BWD_ROWS
#define SOFTRAS_TILE_BWD_ROWS 1
#endif
#ifndef SOFTRAS_TILE_BWD_TEXEL
#define SOFTRAS_TILE_BWD_TEXEL 1
#endif
#include "softras_tile_bwd.cuh"

extern "C" int softras_pxg_bwd(const softras::TileBwdArgs* args, void* stream) {
  using namespace softras;
  if (args->tile_h != 16 || args->tile_w != 16 || args->ty0 != 0 ||
      args->band_h != args->image_size)
    return (int)cudaErrorInvalidValue;  // the pxg route's 16 x 16 tiles, the whole image
  return tile_bwd_dispatch(*args, static_cast<cudaStream_t>(stream), nullptr);
}

// Registers, spill bytes and blocks an SM of the kernel these arguments
// launch (out[0..2]).
extern "C" int softras_pxg_bwd_occupancy(const softras::TileBwdArgs* args, int* out) {
  return softras::tile_bwd_dispatch(*args, nullptr, out);
}

extern "C" int softras_pxg_bwd_args_size() { return (int)sizeof(softras::TileBwdArgs); }
