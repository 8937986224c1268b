"""The floor kernel's (K1) share of its roofline in the traced batch: the
least time of the floor work the batch decoded (``floor_work``: bytes and
operations from each packet's block size and the setup's geometry) over
the device time of the kernels that ``floor_work.FLOOR_KERNELS`` names.

The traced slice is one whole batch, and a batch is the mix's multiset of
tilings, each a whole cycle of the source: its packets are that many
cycles of the source's block sizes."""

import numpy as np

from benchmark.harness.floor_work import (FLOOR_KERNELS, floor_work,
                                          setup_geometry)
from benchmark.harness.roofline import kernel_share, least_s
from benchmark.harness.traffic import tiling_multiset


def read(run):
    if run.trace is None:
        return None
    tr, src = run.traffic, run.source
    cycles = int(tiling_multiset(tr["files"], tr["tilings"]).sum())
    work = floor_work(np.tile(src.blocksize, cycles), src.channels,
                      *setup_geometry(src.ident, src.setup))
    return kernel_share(run.trace, FLOOR_KERNELS, least_s(work))
