"""Share of the traced slice in which no operation ran on the device: one
less the union of the profiler's device intervals over the slice
(``trace.busy_s``, a copy of ``chip_smoke.busy_us``)."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
