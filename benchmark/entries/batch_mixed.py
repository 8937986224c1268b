"""Closed loop through ``lewton_tpu_torch``'s ``MixedBatchDecoder``: file to
PCM over a corpus encoded at several setups.

One worker decodes batches back to back. A batch is the mix's ``files``
files, an equal share of each of the configuration's ``streams`` (its
setups): for setup k, ``make_files`` of that setup's source with the mix's
``tilings``, from a seed of its own. Every batch holds the same files in a
new seeded order that interleaves the setups (a loader's shuffled epochs
over one shard). Each file is demuxed natively (``native.demux_spans``)
and its header pair taken from its own first and third packets; then one
``MixedBatchDecoder.decode_streams_i16`` call decodes the batch. Each
setup's part of a batch holds the same files in every batch, so its
shapes repeat, and the warm-up batch runs every shape the window runs.

The window and ``x_realtime`` are ``batch_decoder``'s: whole batches only,
the audio seconds of every file decoded over the window. The check
compares ``check_files`` answers, an equal share from each setup
(``check_sample`` over that setup's files: its longest among them).
"""

from __future__ import annotations

import resource
import time

import numpy as np

from benchmark.harness.roofline import imdct_work
from benchmark.harness.source import load_source
from benchmark.harness.trace import TRIES
from benchmark.harness.tracer import slice_records
from benchmark.harness.traffic import check_sample, make_files, rng_of


def sources(root, config) -> list:
    """The ``Source`` of each setup of the configuration, in its order."""
    return [load_source(root, s) for s in config["streams"]]


def corpus(srcs: list, traffic: dict, seed: int) -> tuple[list, list]:
    """(the batch's files as (setup index, File), grouped by setup; the
    indices of the files the check compares). Setup k's files are
    ``make_files`` of its source from seed ``len(srcs) * seed + k``:
    each setup has the mix's multiset of lengths whatever the seed."""
    per, check = (traffic["files"] // len(srcs),
                  traffic["check_files"] // len(srcs))
    files, sample = [], []
    for k, src in enumerate(srcs):
        seed_k = len(srcs) * int(seed) + k
        made = make_files(src, per, traffic["tilings"], seed_k)
        sample += [len(files) + i for i in check_sample(made, check, seed_k)]
        files += [(k, f) for f in made]
    return files, sample


def run(run) -> dict:
    import torch
    from lewton_tpu_torch import native
    from lewton_tpu_torch.parallel.batch import MixedBatchDecoder

    tr = run.traffic
    opts = tr["decoder"]
    srcs = sources(run.root, run.config)
    files, sample = corpus(srcs, tr, run.seed)
    kept = {i: [] for i in sample}
    dec = MixedBatchDecoder(chunk=opts["chunk"], scan=opts["scan"],
                            device=run.device)
    audio_s = sum(f.samples / srcs[k].rate for k, f in files)

    def sync():
        if run.on_card:
            torch.cuda.synchronize(run.device)

    def batch(b: int, keep: bool) -> dict:
        order = (np.arange(len(files)) if b < 0
                 else rng_of(run.seed, 100 + b).permutation(len(files)))
        t0 = time.perf_counter()
        with run.spans("demux"):
            pks = [native.demux_spans(files[i][1].data)[0] for i in order]
            streams = [p[3:] for p in pks]
            headers = [(p[0], p[2]) for p in pks]
        demux_s = time.perf_counter() - t0
        with run.spans("decode"):
            outs = dec.decode_streams_i16(streams, headers,
                                          compact=opts["compact"],
                                          transport=opts["transport"])
        wall = time.perf_counter() - t0
        with run.spans("keep"):
            for j, i in enumerate(order):
                if keep and i in kept:
                    kept[i].append(outs[j])
            del outs, streams, pks
        st = dec.last_stats
        return {"wall_s": wall, "demux_s": demux_s, "audio_s": audio_s,
                "h2d_bytes": st["h2d_bytes"], "d2h_bytes": st["d2h_bytes"],
                "transport": st["transport"], "stages": st.get("stages", {})}

    for k, src in enumerate(srcs):
        mine = [f for s, f in files if s == k]
        run.log(f"{run.name}: setup {run.config['streams'][k]['name']}: "
                f"{len(mine)} files, {src.channels} ch, {src.rate} Hz, "
                f"cycle {len(src.cycle)} packets from source packet "
                f"{src.cycle_start}, "
                f"{sum(f.samples for f in mine) / src.rate:.3f} audio s, "
                f"{sum(f.packets for f in mine)} packets, "
                f"{sum(len(f.data) for f in mine)} bytes")
    warm = batch(-1, keep=False)  # captures every program the window runs
    made = len(dec.decoders)
    run.log(f"{run.name}: {len(files)} files, {audio_s:.3f} audio s a batch; "
            f"warm-up batch {warm['wall_s']:.3f} s, {made} decoders, "
            f"transport {warm['transport']}")
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
                work = [imdct_work(np.concatenate(
                    [f.blocksizes for s, f in files if s == k]), src.channels)
                    for k, src in enumerate(srcs)]
                run.trace.work["imdct"] = (sum(w[0] for w in work),
                                           sum(w[1] for w in work))
        run.batches.append(rec)
        now = time.perf_counter()
        if now - run.t_window >= run.seconds and not (
                run.profiler is not None and run.trace is None
                and tries < TRIES):
            break
    run.window_s = now - run.t_window
    decoded = sum(r["audio_s"] for r in run.batches)
    transports = sorted({str(r["transport"]) for r in run.batches})
    run.log(f"{run.name}: window {run.window_s:.4f} s, {len(run.batches)} "
            f"batches, {decoded:.3f} audio s, batch walls "
            f"{[round(r['wall_s'], 4) for r in run.batches]}, transport "
            f"{transports}, h2d {sum(r['h2d_bytes'] for r in run.batches)} B, "
            f"d2h {sum(r['d2h_bytes'] for r in run.batches)} B")
    split = [[round(r["demux_s"], 3)]
             + [round(r["stages"].get(k, 0.0), 3)
                for k in ("frontend", "d2h", "compact", "other")]
             for r in run.batches]
    run.log(f"{run.name}: each batch's seconds (demux, then the decode "
            f"call's front-end, d2h, compact and other): {split}")
    got = slice_records(run)
    traced = ("" if got is None else
              f", traced slice: batch.setups {got[1].get('batch.setups', 0)}"
              f", batch.setup_compiles "
              f"{got[1].get('batch.setup_compiles', 0)}")
    run.log(f"{run.name}: decoders made in the window "
            f"{len(dec.decoders) - made}{traced}; peak host RSS "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.3f}"
            f" GiB")
    if run.profiler is not None and run.trace is None:
        run.log(f"{run.name}: the profiler recorded no device activity in "
                f"{tries} traced batches: no device metric")
    return {"e2e": {"x_realtime": decoded / run.window_s},
            "attempted": len(files) * len(run.batches), "failed": 0,
            "answers": [(files[i][1].data, kept[i]) for i in sample]}
