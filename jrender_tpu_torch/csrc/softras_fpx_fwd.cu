// SoftRas forward of the f_px route for Hopper (sm_90a), with a plain C
// entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pallas_impl.py
// _make_fwd_kernel (:313, launched at :813 by soft_rasterize_fwd_pallas):
// the image [B,4,H,W] and aggregates [B,2,H,W] over 16 x min(128, is)
// pixel tiles, accumulated across each tile's face list.  Like the TPU
// kernel it computes no top-K threshold; the route gives it only calls
// where the truncation does not bind.  It adds the per-pixel candidate
// count, which the port's forward returns on every route.
//
// Design: softras_tile_fwd.cuh.  A 16 x 128 tile (2,048 pixels) is cut
// into 4 parts of 256 threads x 2 pixels, and each part's walk of the
// tile's list is split over a thread-block cluster of kTileSplit blocks,
// each walking a contiguous share and merged by rank 0 through distributed
// shared memory: a wide tile's list is long (2,490 faces in the busiest
// tile at 1024 px on the 39,474-face sphere), and one block walking it
// was the whole kernel's time (PERF.md).  The TPU
// kernel's hard-rgb winner is the first minimum of a 32-face chunk, then
// a strict < across chunks, the lowest id because its lists ascend; here
// a depth tie goes to the lowest id wherever it stands, which gives the
// same winner.  Alpha 'prod' multiplies in list order, where the TPU
// kernel multiplies each chunk as a tree: the bits may differ in the last
// place.
//
// Bound.  The pair work of the binned forward on wider tiles (every pair
// of a tile's list tested against its bbox, the bbox pairs through the
// distance cut, the candidates shaded) and the face rows once per tile,
// the lists, and the outputs written once (chip_smoke.py counts both from
// its run).  A wide tile holds more faces than a 16 x 16 one: each pair of
// its list pays a bbox test, and the split's kTileSplit blocks a part each
// pay a block's fixed cost and the merge.
//
// Occupancy: 64 registers a thread, 4 blocks of 48 KB an SM: 1.63 ms at 1024 px on
// the 39,474-face sphere against 1.95 at 3 blocks (74 registers) and 2.61
// at 2 (85) (tools/time_tile_fwd.py, PERF.md).
#ifndef SOFTRAS_TILE_MIN_BLOCKS
#define SOFTRAS_TILE_MIN_BLOCKS 4
#endif
#include "softras_tile_fwd.cuh"

extern "C" int softras_fpx_fwd(const softras::TileFwdArgs* args, void* stream) {
  using namespace softras;
  if (args->thr != nullptr) return (int)cudaErrorInvalidValue;  // no threshold here
  return tile_fwd_dispatch<kThrNone>(*args, static_cast<cudaStream_t>(stream));
}

extern "C" int softras_fpx_fwd_args_size() { return (int)sizeof(softras::TileFwdArgs); }

extern "C" int softras_fpx_fwd_split() { return softras::kTileSplit; }
