"""Closed loop through ``lewton_tpu_torch``'s ``BatchDecoder``: file to PCM.

One worker decodes batches back to back. A batch is the mix's ``files``
files, whole Ogg files in host memory: the native demux
(``native.demux_spans``) of each file, then one
``BatchDecoder.decode_streams_i16`` call over all of them, into interleaved
i16 PCM per file on the host. Every batch holds the same files (a data
loader's epochs over one shard) in a new seeded order, so each batch pads
to the same longest file and the warm-up batch has run every shape the
window runs.

The window runs from the first batch's start to the end of the first batch
that ends after ``--seconds``: only whole batches count. ``x_realtime`` is
the audio seconds of every file decoded over the window.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness.roofline import imdct_work
from benchmark.harness.trace import TRIES
from benchmark.harness.traffic import check_sample, make_files, rng_of


def run(run) -> dict:
    import torch
    from lewton_tpu_torch import native
    from lewton_tpu_torch.header import read_header_ident, read_header_setup
    from lewton_tpu_torch.parallel.batch import BatchDecoder

    src, tr = run.source, run.traffic
    files = make_files(src, tr["files"], tr["tilings"], run.seed)
    sample = check_sample(files, tr["check_files"], run.seed)
    kept = {i: [] for i in sample}
    ident = read_header_ident(src.headers[0])
    setup = read_header_setup(src.headers[2], ident)
    opts = tr["decoder"]
    dec = BatchDecoder(ident, setup, chunk=opts["chunk"], scan=opts["scan"],
                       raw_headers=(src.headers[0], src.headers[2]),
                       device=run.device)
    audio_s = sum(f.samples for f in files) / src.rate

    def sync():
        if run.on_card:
            torch.cuda.synchronize(run.device)

    def batch(b: int, keep: bool) -> dict:
        order = (np.arange(len(files)) if b < 0
                 else rng_of(run.seed, 100 + b).permutation(len(files)))
        t0 = time.perf_counter()
        with run.spans("demux"):
            streams = [native.demux_spans(files[i].data)[0][3:]
                       for i in order]
        with run.spans("decode"):
            outs = dec.decode_streams_i16(streams, compact=opts["compact"],
                                          transport=opts["transport"])
        wall = time.perf_counter() - t0
        with run.spans("keep"):
            for j, i in enumerate(order):
                if keep and i in kept:
                    kept[i].append(outs[j])
            del outs, streams
        st = dec.last_stats
        return {"wall_s": wall, "audio_s": audio_s,
                "h2d_bytes": st["h2d_bytes"], "d2h_bytes": st["d2h_bytes"],
                "transport": st["transport"], "stages": st.get("stages", {})}

    warm = batch(-1, keep=False)  # captures every program the window runs
    run.log(f"{run.name}: {len(files)} files, {audio_s:.3f} audio s a batch, "
            f"{sum(f.packets for f in files)} packets, "
            f"{sum(len(f.data) for f in files)} bytes; cycle "
            f"{len(src.cycle)} packets from source packet {src.cycle_start}; "
            f"warm-up batch {warm['wall_s']:.3f} s, transport "
            f"{warm['transport']}")
    if run.trace_on:
        dec.stage_sync = True  # stages split the wall (traced run only)
    sync()
    run.window_started()
    tries = 0
    while True:
        b = len(run.batches)
        profile = (run.profiler is not None and run.trace is None
                   and tries < TRIES and b >= 1)
        if profile:
            sync()
            run.spans.profiling = True
            run.profiler.start()
        rec = batch(b, keep=True)
        if profile:
            sync()
            run.spans.profiling = False
            tries += 1
            run.trace = run.profiler.stop()
            if run.trace is not None:
                bs = np.concatenate([f.blocksizes for f in files])
                run.trace.work["imdct"] = imdct_work(bs, src.channels)
        run.batches.append(rec)
        now = time.perf_counter()
        if now - run.t_window >= run.seconds and not (
                run.profiler is not None and run.trace is None
                and tries < TRIES):
            break
    run.window_s = now - run.t_window
    decoded = sum(r["audio_s"] for r in run.batches)
    transports = sorted({r["transport"] for r in run.batches})
    run.log(f"{run.name}: window {run.window_s:.4f} s, {len(run.batches)} "
            f"batches, {decoded:.3f} audio s, batch walls "
            f"{[round(r['wall_s'], 4) for r in run.batches]}, transport "
            f"{transports}, h2d {sum(r['h2d_bytes'] for r in run.batches)} B, "
            f"d2h {sum(r['d2h_bytes'] for r in run.batches)} B")
    if run.profiler is not None and run.trace is None:
        run.log(f"{run.name}: the profiler recorded no device activity in "
                f"{tries} traced batches: no device metric")
    return {"e2e": {"x_realtime": decoded / run.window_s},
            "attempted": len(files) * len(run.batches), "failed": 0,
            "answers": [(files[i].data, kept[i]) for i in sample]}
