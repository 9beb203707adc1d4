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
// Design: softras_tile_fwd.cuh, each tile's whole list walked by 4 blocks
// of 256 threads, 2 pixels a thread (a 16 x 128 tile is 2,048 pixels):
// a wide tile's list is long (2,490 faces in the busiest tile at 1024 px
// on the 39,474-face sphere), and one block walking it would be the
// whole kernel's time (PERF.md).  The TPU
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
// the lists, and the outputs written once: at 1024 px on the 39,474-face
// sphere, operations and bytes bound it about alike (chip_smoke.py counts
// both from its run).  A wide tile holds more faces than a 16 x 16 one,
// and its whole list is one block's: the busiest tile is the tail.
#include "softras_tile_fwd.cuh"

extern "C" int softras_fpx_fwd(const softras::TileFwdArgs* args, void* stream) {
  using namespace softras;
  if (args->thr != nullptr) return (int)cudaErrorInvalidValue;  // no threshold here
  return (int)tile_fwd_dispatch<kThrNone, 2>(*args, static_cast<cudaStream_t>(stream));
}

extern "C" int softras_fpx_fwd_args_size() { return (int)sizeof(softras::TileFwdArgs); }
