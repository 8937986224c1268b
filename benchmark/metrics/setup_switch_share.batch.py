"""Share of the traced slice spent switching setups inside the program's
mixed-setup batch calls: the whole duration of its ``batch.setup_switch``
spans (``parallel.batch._decode_groups``: from the last dispatch of one
setup to the first front-end call of the next, with the waits inside
them) over the slice. The spans' children are counted, not subtracted as
a self time would: a wait the switch cannot hide is its cost. None where
the program records no such span."""

from benchmark.harness.tracer import slice_records


def read(run):
    got = slice_records(run)
    if got is None:
        return None
    switch = [t1 - t0 for name, t0, t1, _ in got[0]
              if name == "batch.setup_switch"]
    if not switch:
        return None
    return 100.0 * sum(switch) / run.trace.window_s
