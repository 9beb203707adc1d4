// SoftRas backward of the px_f route for Hopper (sm_90a), with a plain C
// entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pallas_impl.py
// _make_bwd_kernel_pf (:1161, launched at :1705 by
// soft_rasterize_bwd_pallas_pf): the reference's top-K truncated backward
// (a pair sends gradient when zp <= thr, the forward's threshold, where
// the truncation binds; every candidate otherwise) over work items of at
// most 128 faces of a t x t tile's list, for the tiles of one band of tile
// rows; the maps are the band's, and the gradient is that of the band's
// pixels only (the caller sums over bands).  The TPU kernel contracts
// pixels on the MXU into slots [W, 9, 128] and [W, 3T, 128], zeroes the
// inactive items' slots and segment-sums them (:1713-1724); here the
// slots are the entries' rows [E, GC] and the segment sum (segment_sum.cu)
// adds them per face in ascending tile order.
//
// Design: softras_tile_bwd.cuh (a warp per entry walks the face's bbox
// inside the tile, sums in a fixed order, no atomics: bit-equal twice and
// at every build).
//
// Choices of this source (tools/time_tile_bwd.py, PERF.md §6; 1024 px,
// 39,474 faces, NVIDIA H100 80GB HBM3, 700.00 W): 3 blocks an SM (80
// registers), warps taking faces from a counter with their own rows
// staged by cp.async, texel adds in rounds, items of 32 faces
// (pxf_impl.GROUP): 0.74 ms against 1.10 for build 000 (no cap, rows a
// chunk a block, texel adds lane after lane; items of 128: 1.27) in one
// call; rows a chunk a block (f_px's choice) 4.0-4.7% slower in each of 8
// turns; the tile's maps staged in shared memory (a build since removed)
// 0.90.
//
// Bound.  Operations: the forward's pair math for every pair in a bbox
// plus the gradient terms of the pairs within the threshold.  Bytes: the
// face rows, the lists, the 11 maps of the pixels with a candidate, one
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

extern "C" int softras_pxf_bwd(const softras::TileBwdArgs* args, void* stream) {
  return softras::tile_bwd_dispatch(*args, static_cast<cudaStream_t>(stream), nullptr);
}

// Registers, spill bytes and blocks an SM of the kernel these arguments
// launch (out[0..2]).
extern "C" int softras_pxf_bwd_occupancy(const softras::TileBwdArgs* args, int* out) {
  return softras::tile_bwd_dispatch(*args, nullptr, out);
}

extern "C" int softras_pxf_bwd_args_size() { return (int)sizeof(softras::TileBwdArgs); }
