"""Share of the native entropy front-end's worker time in the traced batch
spent in the per-channel residue (formats 0 and 1: each channel's vector
coded on its own, as in an uncoupled 7.1 setup): the program's
``frontend.residue01_ns`` over ``frontend.busy_ns``. None where the program
does not count it."""

from benchmark.harness.tracer import count_ratio, slice_records


def read(run):
    got = slice_records(run)
    if got is None or "frontend.residue01_ns" not in got[1]:
        return None
    return count_ratio(run, "frontend.residue01_ns", "frontend.busy_ns")
