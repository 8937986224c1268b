"""Share of the serve window spent registering requests: the harness's
spans around ``StreamingScheduler.add_stream(sid, bytes)`` (the Python Ogg
page reader with its CRC, the header packets, group entry)."""


def read(run):
    if not run.window_s or "register" not in run.spans.total:
        return None
    return 100.0 * run.spans.total["register"] / run.window_s
