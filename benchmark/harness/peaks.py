"""Published peaks of the card and the least time of a piece of work.

NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power limit:
float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s.  The renderer
computes in float32 on the CUDA cores, so a share of a roofline is taken
against these two; the run records the card's power limit beside it.
"""
from __future__ import annotations

PEAKS = {
    'NVIDIA H100 80GB HBM3': {'fp32_flops': 67e12, 'bytes_per_s': 3.35e12},
}


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind``; any H100 is taken at the SXM
    part's rates."""
    if kind in PEAKS:
        return PEAKS[kind]
    if 'H100' in kind:
        return PEAKS['NVIDIA H100 80GB HBM3']
    raise KeyError(f'no published peaks for {kind!r} in benchmark/harness/peaks.py')


def least_seconds(ops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take: operations at its float32 peak
    or bytes at its memory rate, whichever takes longer."""
    p = peaks(kind)
    return max(ops / p['fp32_flops'], nbytes / p['bytes_per_s'])
