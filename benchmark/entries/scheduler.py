"""Closed loop through ``lewton_tpu_torch``'s ``StreamingScheduler``: a
decode endpoint that always has requests waiting.

The queue never runs dry: each request is a whole file of the mix's pool,
taken round after round with one file of each length a round
(``traffic.rounds``), so any stretch of requests holds the same lengths
whatever the seed. One thread serves them: it registers the next request
with ``add_stream(sid, bytes)`` whenever fewer than the scheduler's
``capacity`` are active (a full scheduler would start a second group, whose
programs compile at their first use), runs ``step()``, polls every active
stream and retires the finished ones with ``remove_stream``.

``served_x_realtime`` is the audio of the PCM that ``poll`` returned during
the window over the window's length: the rate the endpoint serves, bounded
by nothing but the program. At the close registration stops and the active
requests drain; one that has not finished ``drain_s`` later is missing.
Each request's first PCM and turnaround, from its registration, go on the
context line.

Set-up warms every program the window can run: one stream of each length
from 1 to ``chunk`` packets, each twice in a row (the group's two transfer
slots), so every output-length bucket of a chunk is captured in both.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness.roofline import imdct_work
from benchmark.harness.trace import TRIES
from benchmark.harness.traffic import check_sample, make_files, rounds

#: seconds of each traced slice, taken from a quarter into the window
SLICE_S = 3.0


def _pct(a, p) -> float:
    return float(np.percentile(np.asarray(a, np.float64), p)) if len(a) else 0.0


def run(run) -> dict:
    import torch
    from lewton_tpu_torch.serve import StreamingScheduler

    src, tr = run.source, run.traffic
    opts = tr["scheduler"]
    pool = make_files(src, tr["files"], tr["tilings"], run.seed)
    queue = rounds(pool, run.seed)
    # every answer to a sampled file of the pool is compared
    kept: dict[int, list] = {i: [] for i in
                             check_sample(pool, tr["check_files"], run.seed)}
    sched = StreamingScheduler(capacity=opts["capacity"], chunk=opts["chunk"],
                               scan=opts["scan"], device=run.device)

    def sync():
        if run.on_card:
            torch.cuda.synchronize(run.device)

    t0 = time.perf_counter()
    for m in range(1, opts["chunk"] + 1):
        warm = src.make_file(0, 1, m, packets=m).data
        for rep in range(2):
            sched.add_stream(("warm", m, rep), warm)
            while sched.step():
                pass
            sched.poll(("warm", m, rep))
            sched.remove_stream(("warm", m, rep))
    sched.transfer_stats(reset=True)
    run.log(f"{run.name}: pool of {len(pool)} files, "
            f"{sum(f.samples for f in pool) / src.rate:.3f} audio s, "
            f"{sum(len(f.data) for f in pool)} bytes; capacity "
            f"{opts['capacity']}, chunk {opts['chunk']}, scan {opts['scan']}; "
            f"warm-up {time.perf_counter() - t0:.3f} s")

    file_of: list[int] = []  # request id -> pool index
    reg: list[float] = []  # request id -> registration (s into the window)
    first: dict[int, float] = {}
    done: dict[int, float] = {}
    active: dict[int, list] = {}  # request id -> its PCM, if kept
    served = 0  # samples polled in the window
    at_close = None  # the spans as the window closed
    fed0: dict[int, int] = {}  # traced slice: packets fed at its start
    fed: dict[int, int] = {}  # packets fed in the slice, by stream
    slice_at, tries, tracing = run.seconds / 4, 0, False
    sync()
    run.window_started()
    start = run.t_window

    def fed_now(sid):
        return sched.streams[sid][1].fed

    while True:
        now = time.perf_counter() - start
        if at_close is None and now >= run.seconds:
            run.window_s = now
            at_close = dict(run.spans.total)
            if tracing:  # the window closed inside a slice: no reading
                run.spans.profiling = tracing = False
                run.profiler.stop()
        if (at_close is None and run.profiler is not None
                and run.trace is None and tries < TRIES):
            if not tracing and now >= slice_at:
                sync()
                fed0 = {sid: fed_now(sid) for sid in active}
                fed.clear()
                run.spans.profiling = tracing = True
                run.profiler.start()
            elif tracing and now >= slice_at + SLICE_S:
                sync()
                run.spans.profiling = tracing = False
                run.trace = run.profiler.stop()
                tries += 1
                for sid in active:
                    fed[sid] = fed_now(sid) - fed0.get(sid, 0)
                if run.trace is not None:
                    bs = np.concatenate(
                        [pool[file_of[s]].blocksizes[
                            fed0.get(s, 0):fed0.get(s, 0) + k]
                         for s, k in fed.items()] + [np.zeros(0, np.int32)])
                    run.trace.work["imdct"] = imdct_work(bs, src.channels)
                slice_at = now
        while at_close is None and len(active) < opts["capacity"]:
            sid = len(file_of)
            file_of.append(next(queue))
            reg.append(time.perf_counter() - start)
            with run.spans("register"):
                sched.add_stream(sid, pool[file_of[sid]].data)
            active[sid] = []
        if not active or (at_close is not None
                          and now > run.window_s + tr["drain_s"]):
            break
        with run.spans("step"):
            sched.step()
        with run.spans("poll"):
            t = time.perf_counter() - start
            for sid in list(active):
                pcm = sched.poll(sid)
                if pcm.size:
                    if at_close is None:
                        served += len(pcm)
                    first.setdefault(sid, t - reg[sid])
                    if file_of[sid] in kept:
                        active[sid].append(pcm)
                if sched.is_done(sid):
                    done[sid] = t - reg[sid]
                    if tracing:
                        fed[sid] = fed_now(sid) - fed0.get(sid, 0)
                    sched.remove_stream(sid)
                    parts = active.pop(sid)
                    if file_of[sid] in kept:
                        kept[file_of[sid]].append(
                            np.concatenate(parts) if parts
                            else np.zeros((0, src.channels), np.int16))
    drain = time.perf_counter() - start - run.window_s
    run.spans.total.clear()
    run.spans.total.update(at_close)
    for sid in active:  # never finished: missing
        if file_of[sid] in kept:
            kept[file_of[sid]].append(None)
    n = len(file_of)
    run.counters.update(requests=n, finished=len(done), drain_s=drain,
                        served_audio_s=served / src.rate)
    stats = sched.transfer_stats()
    fp = np.array(list(first.values())) * 1e3
    ta = np.array(list(done.values())) * 1e3
    run.log(f"{run.name}: window {run.window_s:.4f} s, {n} requests "
            f"registered, {len(done)} finished ({len(active)} not after a "
            f"{drain:.3f}-s drain); first PCM p50 {_pct(fp, 50):.3f} p95 "
            f"{_pct(fp, 95):.3f} ms, turnaround p50 {_pct(ta, 50):.3f} p95 "
            f"{_pct(ta, 95):.3f} ms from registration; h2d "
            f"{stats['h2d_bytes']} B, d2h {stats['d2h_bytes']} B")
    if run.profiler is not None and run.trace is None:
        run.log(f"{run.name}: the profiler recorded no device activity in "
                f"{tries} slices: no device metric")
    return {"e2e": {"served_x_realtime": served / src.rate / run.window_s},
            "attempted": n, "failed": n - len(done),
            "answers": [(pool[i].data, outs) for i, outs in sorted(kept.items())
                        if outs]}
