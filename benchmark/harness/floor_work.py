"""The least time of the floor kernel's work (K1: ``floor_spectra_kernel``,
or ``floor_cd_kernel`` on the split route), from each decoded packet's
block size n and the setup's geometry, counted whatever computes it.

Per decoded packet and channel, with w = min(w_eff, n/2), the spectral
width the kernel fills (``w_eff``: the widest residue extent of any
mode and submap, rounded up to 128, as the port's ``compile_setup`` sets
it) and P the floor-1 posts of the widest floor:

- bytes: each input read once and the output written once: the residue
  at the transport's width (2 w: the cells' codebooks are integer-valued,
  so their residue travels and reaches the kernel as i16 rows), the posts
  (an i32 value and a one-byte flag each, 5 P) and the f32 spectrum
  (4 w): 6 w + 5 P;
- operations: the curve (a step along its line and the inverse-dB gather,
  2 w), the product (w), and, per packet, each coupling step's add or
  subtract on both channels of its pair (2 w a step): 3 w C + 2 w steps.

Bytes bound it: 6 B against 3 to 5 operations a sample, at a peak ratio
of 67e12 / 3.35e12 = 20 operations a byte.
"""

from __future__ import annotations

import numpy as np

__all__ = ["FLOOR_KERNELS", "setup_geometry", "floor_work"]

#: substrings (lower case) of the names of the floor kernel's forms as the
#: profiler records them
FLOOR_KERNELS = ("floor_spectra_kernel", "floor_cd_kernel")


def setup_geometry(ident, setup) -> tuple[int, int, int]:
    """(w_eff, P, coupling steps) of a parsed setup
    (``benchmark.reference.header``): the widest residue extent per
    channel over every mode and submap (a type-2 end is over the
    interleaved vector of the submap's channels), rounded up to 128 and
    at least 128, at most n1/2; the most floor-1 posts; the most coupling
    steps of a mapping."""
    half = ident.bs1 // 2
    w = 0
    for mode in setup.modes:
        mp = setup.mappings[mode.mapping]
        n2 = (ident.bs1 if mode.blockflag else ident.bs0) // 2
        for sm, ri in enumerate(mp.submap_residue):
            r = setup.residues[ri]
            ch = max(1, sum(1 for m in mp.mux if m == sm))
            w = max(w, -(-min(r.end, n2 * ch) // ch) if r.residue_type == 2
                    else min(r.end, n2))
    w_eff = min(half, max(128, -(-w // 128) * 128))
    posts = max((len(f.x_list) for f in setup.floors if f.floor_type == 1),
                default=0)
    steps = max((len(m.coupling_magnitude) for m in setup.mappings),
                default=0)
    return w_eff, posts, steps


def floor_work(blocksizes, channels: int, w_eff: int, posts: int,
               steps: int) -> tuple[float, float]:
    """(operations, bytes) of the floor kernel over packets of these block
    sizes, every channel."""
    w = np.minimum(np.asarray(blocksizes, np.float64) // 2, w_eff)
    ops = float((3 * w * channels + 2 * w * steps).sum())
    moved = float((6 * w + 5 * posts).sum()) * channels
    return ops, moved
