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
// bits in a VMEM slab and bisects them with MXU-counted ranks; here each
// rank of a cluster keeps its share's K smallest depths of each pixel in
// shared memory for K <= 32, merged by rank 0, and above that the ranks
// bisect on the depth's bits, summing their counts at every step
// (softras_tile_fwd.cuh).  A pixel with at most K candidates gets `far`,
// as on the binned route (the TPU kernel's bisection ends at its largest
// candidate there; both pass every candidate).
//
// Design: softras_tile_fwd.cuh.  A 32 x 32 tile (1,024 pixels) is cut
// into 2 parts of 256 threads x 2 pixels, and each part's walk of the
// tile's list is split over a thread-block cluster of kTileSplit blocks
// (the busiest 32 x 32 tile holds 1,755 faces at 1024 px on the
// 39,474-face sphere).  A tile without faces writes the background and
// the initial aggregates, count 0 and the threshold `far`.
//
// Bound.  The binned forward's pair work plus the threshold's (a list
// compare per candidate; K > 32: a walk of the overfull tiles' pairs per
// bisection step); the face rows once per tile, the lists, and the five
// output maps written once (chip_smoke.py counts both from its run).
//
// Occupancy: 80 registers a thread, 3 blocks an SM (a block holds 59 KB at K = 16):
// 2.00 ms at 1024 px on the 39,474-face sphere against 2.10 at 4 blocks
// (64 registers, 68 bytes of spills) and 2.59 at 2 (94)
// (tools/time_tile_fwd.py, PERF.md).
#ifndef SOFTRAS_TILE_MIN_BLOCKS
#define SOFTRAS_TILE_MIN_BLOCKS 3
#endif
#include "softras_tile_fwd.cuh"

extern "C" int softras_pxf_fwd(const softras::TileFwdArgs* args, void* stream) {
  using namespace softras;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (args->thr == nullptr) return tile_fwd_dispatch<kThrNone>(*args, st);
  if (args->K < 1) return (int)cudaErrorInvalidValue;
  if (args->K <= kListMax) return tile_fwd_dispatch<kThrList>(*args, st);
  return tile_fwd_dispatch<kThrBisect>(*args, st);
}

extern "C" int softras_pxf_fwd_args_size() { return (int)sizeof(softras::TileFwdArgs); }

extern "C" int softras_pxf_fwd_split() { return softras::kTileSplit; }
