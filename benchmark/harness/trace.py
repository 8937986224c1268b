"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a steady
part of the window, reduced in memory to the device's busy time, kernel
time by name and the host's spans over the device's idle gaps. Nothing is
written to disk.

:func:`busy_s` is ``chip_smoke.busy_us`` (commit b69f200) in seconds: the
union of the device activities (kernels, copies, fills) inside the slice.
The profiler has dropped a replay's device records on this card before,
and once kept 0.34 s of a 3-s slice. A slice
in which it recorded no device activity, or whose recorded range is
shorter than nine tenths of the host's clock over it, is no reading: the
caller takes the next slice, up to ``TRIES`` slices, and then reports no
device metric rather than an idle device.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

__all__ = ["TraceSlice", "Profiler", "busy_s", "TRIES", "SPAN_PREFIX"]

TRIES = 3
SPAN_PREFIX = "bench:"
_SLICE = SPAN_PREFIX + "slice"


@dataclass
class TraceSlice:
    window_s: float
    busy_s: float
    kernel_s: dict  # device op name -> summed seconds
    idle_by_span: dict  # host span over the device's idle gaps -> seconds
    work: dict = field(default_factory=dict)  # what the slice decoded

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def busy_s(span, dev) -> float:
    """Seconds of the union of the device intervals ``dev`` ((start, end)
    us, sorted by start) inside ``span``."""
    busy, end = 0.0, span[0]
    for a, b in dev:
        a, b = max(a, span[0]), min(b, span[1])
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e6


def _gaps(span, dev):
    """The idle intervals (us) of the slice between the device intervals."""
    out, end = [], span[0]
    for a, b in dev:
        if a > end:
            out.append((end, min(a, span[1])))
        end = max(end, b)
    if end < span[1]:
        out.append((end, span[1]))
    return [(a, b) for a, b in out if b > a]


def _idle_by_span(gaps, spans) -> dict:
    """Each idle gap's seconds given to the host span over each part of it
    (the harness's spans do not nest), the rest to ``harness`` (the
    harness's own loop between spans)."""
    spans = sorted(spans)
    starts = [s for s, _, _ in spans]
    out: dict[str, float] = {}
    for g0, g1 in gaps:
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, g0) - 1)
        while i < len(spans) and spans[i][0] < g1:
            s, e, name = spans[i]
            over = min(e, g1) - max(s, g0)
            if over > 0:
                out[name] = out.get(name, 0.0) + over / 1e6
                covered += over
            i += 1
        if g1 - g0 > covered:
            out["harness"] = out.get("harness", 0.0) + (g1 - g0 - covered) / 1e6
    return out


class Profiler:
    """One slice at a time: ``start()``, the work, ``stop()`` -> a
    :class:`TraceSlice`, or None when the profiler recorded no device
    activity."""

    def __init__(self):
        self._prof = None
        self._range = None
        self.t0 = 0.0

    @staticmethod
    def warm(device) -> None:
        """Start the profiler once on a little device work, so that its
        first start (CUPTI's set-up) falls in the set-up, not the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1 << 20, device=device).add_(1)
            torch.cuda.synchronize(device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._range = record_function(_SLICE)
        self._range.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> TraceSlice | None:
        import torch

        wall = time.perf_counter() - self.t0
        self._range.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        events = self._prof.events()
        self._prof = self._range = None
        cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
        whole = next((e for e in events if e.name == _SLICE
                      and e.device_type == cpu), None)
        if whole is None:
            return None
        span = (whole.time_range.start, whole.time_range.end)
        if span[1] - span[0] < 0.9e6 * wall:
            return None  # the profiler lost part of the slice's records
        dev, per_op = [], {}
        for e in events:
            if (e.device_type != cuda or e.name.startswith(SPAN_PREFIX)
                    or e.is_user_annotation
                    or e.name.startswith("ProfilerStep")):
                continue
            a = max(e.time_range.start, span[0])
            b = min(e.time_range.end, span[1])
            if b <= a:
                continue
            dev.append((a, b))
            per_op[e.name] = per_op.get(e.name, 0.0) + (b - a) / 1e6
        if not dev:
            return None
        dev.sort()
        spans = [(e.time_range.start, e.time_range.end,
                  e.name[len(SPAN_PREFIX):]) for e in events
                 if e.device_type == cpu and e.name.startswith(SPAN_PREFIX)
                 and e.name != _SLICE]
        window = (span[1] - span[0]) / 1e6 or wall
        return TraceSlice(window, busy_s(span, dev), per_op,
                          _idle_by_span(_gaps(span, dev), spans))
