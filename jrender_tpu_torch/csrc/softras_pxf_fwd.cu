// SoftRas forward of the px_f route, with its top-K gradient threshold,
// for Hopper (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel jrender_tpu/ops/softras/pallas_impl.py
// _make_fwd_kernel_pf (:894, launched at :1597 by
// soft_rasterize_fwd_pallas_pf) and the fill of its uncovered tiles
// (:1610-1624): over t x t pixel tiles (t = 32, 16 or 8) of a band of
// tile rows, the image, the aggregates, the candidate count and, when
// asked, the top-K threshold, the K-th smallest candidate depth (tied
// depths all pass).  The TPU kernel stores every chunk's candidate depth
// bits in a VMEM slab and bisects them with MXU-counted ranks; here a
// thread keeps the K smallest depths of each of its pixels for K <= 32 and
// the block bisects over the tile's list above that (softras_topk.cuh),
// as the dir forward does.  A pixel with at most K candidates gets `far`,
// as on the binned route (the TPU kernel's bisection ends at its largest
// candidate there; both pass every candidate).
//
// Design: softras_tile_fwd.cuh, each tile's whole list walked by 2 blocks
// of 256 threads, 2 pixels a thread (a 32 x 32 tile is 1,024 pixels).  A
// tile without faces writes the background and the initial aggregates,
// count 0 and the threshold `far`.
//
// Bound.  The binned forward's pair work plus the threshold's (a list
// compare per candidate; K > 32: a walk of the overfull tiles' pairs per
// bisection step); the face rows once per tile, the lists, and the five
// output maps written once (chip_smoke.py counts both from its run).
#include "softras_tile_fwd.cuh"

extern "C" int softras_pxf_fwd(const softras::TileFwdArgs* args, void* stream) {
  using namespace softras;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (args->thr == nullptr) return (int)tile_fwd_dispatch<kThrNone, 2>(*args, st);
  if (args->K < 1) return (int)cudaErrorInvalidValue;
  if (args->K <= kListMax) return (int)tile_fwd_dispatch<kThrList, 2>(*args, st);
  return (int)tile_fwd_dispatch<kThrBisect, 2>(*args, st);
}

extern "C" int softras_pxf_fwd_args_size() { return (int)sizeof(softras::TileFwdArgs); }
