"""The IMDCT's share of its roofline in the traced slice: the least time
of the transforms the slice decoded (``roofline.imdct_work``: bytes and
fast-transform operations from each packet's block size) over the device
time of the kernels that ``roofline.IMDCT_KERNELS`` names as the IMDCT's."""

from benchmark.harness.roofline import IMDCT_KERNELS, kernel_share, least_s


def read(run):
    if run.trace is None or "imdct" not in run.trace.work:
        return None
    return kernel_share(run.trace, IMDCT_KERNELS,
                        least_s(run.trace.work["imdct"]))
