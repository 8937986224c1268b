"""Share of the native entropy front-end's worker time in the traced batch
spent clearing and deinterleaving the type-2 residue scratch of submaps
that do not take the stereo direct write (a 5.1 setup's five-channel
submap): the program's ``frontend.deinterleave_ns`` over
``frontend.busy_ns``. None where the program does not count it."""

from benchmark.harness.tracer import count_ratio, slice_records


def read(run):
    got = slice_records(run)
    if got is None or "frontend.deinterleave_ns" not in got[1]:
        return None
    return count_ratio(run, "frontend.deinterleave_ns", "frontend.busy_ns")
