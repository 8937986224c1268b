"""Share of the batch window spent in the native Ogg demux of the batch's
files (``native.demux_spans``): the harness's spans."""


def read(run):
    if not run.window_s or "demux" not in run.spans.total:
        return None
    return 100.0 * run.spans.total["demux"] / run.window_s
