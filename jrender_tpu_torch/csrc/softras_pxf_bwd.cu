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
// Design: softras_tile_bwd.cuh (a warp per staged face walks the face's
// bbox inside the tile, sums in a fixed order, no atomics: bit-equal
// twice).
//
// Bound.  Operations: the forward's pair math for every pair in a bbox
// plus the gradient terms of the pairs within the threshold.  Bytes: the
// face rows, the lists, the 11 maps of the pixels with a candidate, one
// gradient row per face out; the entry rows count only in the sum's.
#include "softras_tile_bwd.cuh"

extern "C" int softras_pxf_bwd(const softras::TileBwdArgs* args, void* stream) {
  return (int)softras::tile_bwd_dispatch(*args, static_cast<cudaStream_t>(stream));
}

extern "C" int softras_pxf_bwd_args_size() { return (int)sizeof(softras::TileBwdArgs); }
