"""Share of the serve window spent in ``StreamingScheduler.step()`` (the
native entropy front-end, transport, dispatch of the chunk program and
collection of the PCM of the step before): the harness's spans."""


def read(run):
    if not run.window_s or "step" not in run.spans.total:
        return None
    return 100.0 * run.spans.total["step"] / run.window_s
