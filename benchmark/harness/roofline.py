"""Peaks of the card and the least time of a kernel's work.

``HBM_BYTES_PER_S``, ``FP32_FLOP_PER_S`` and :func:`bound_of` are copies of
``chip_smoke.py``'s (commit b69f200): NVIDIA's data sheet for the H100 SXM
at its full 700 W, device memory and FP32 outside the tensor cores; a
kernel's bytes count each input read once and each output written once.

The IMDCT's least time counts the work of the transform whatever computes
it, from the block size n of each decoded packet and channel:

- bytes: the n/2 f32 coefficients read once and the n f32 samples written
  once, 6 n bytes;
- operations: those of the fast algorithm (an n/4-point complex FFT between
  a complex pre- and post-twiddle of n/4 points each, 6 flops a complex
  multiply): 5 (n/4) log2(n/4) + 2 * 6 (n/4) = 1.25 n log2(n/4) + 3 n.
  A dense product would count n^2 / 2 multiply-adds; no implementation is
  credited with work that a fast transform does not need.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "bound_of", "imdct_work",
           "least_s", "kernel_share", "IMDCT_KERNELS"]

HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12

#: substrings (lower case) of the names of the kernels that compute the
#: IMDCT on the program's path as the profiler records them: cuBLAS's f32
#: GEMM kernels and the split-K reduction that may go with them (the dense
#: products of ``ops.imdct``, the only GEMMs of the floor-kernel route that
#: the batch and serving cells take), torch's ``where`` kernel (the long /
#: short select of ``ops.imdct.imdct_batch``, the route's only ``where``),
#: and a kernel of the program's own named for the transform
IMDCT_KERNELS = ("gemm", "gemv", "splitkreduce", "where_kernel", "imdct",
                 "dct4", "fft")


def bound_of(ops: float, moved_bytes: float) -> tuple[float, str]:
    """(least seconds, what bounds them): the larger of the bytes over the
    memory rate and the operations over the FP32 peak."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = ops / FP32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def imdct_work(blocksizes: np.ndarray, channels: int) -> tuple[float, float]:
    """(operations, bytes) of the IMDCT of packets of these block sizes,
    every channel."""
    n = np.asarray(blocksizes, np.float64)
    ops = float((1.25 * n * np.log2(n / 4) + 3 * n).sum()) * channels
    return ops, float((6 * n).sum()) * channels


def least_s(work: tuple[float, float]) -> float:
    return bound_of(*work)[0]


def kernel_share(trace, names, least: float) -> float | None:
    """100 x the least time over the device time of the kernels whose
    names hold one of ``names`` in the traced slice; None without a
    trace, without those kernels or without work."""
    if trace is None or not least:
        return None
    t = sum(s for k, s in trace.kernel_s.items()
            if any(p in k.lower() for p in names))
    return 100.0 * least / t if t > 0 else None
