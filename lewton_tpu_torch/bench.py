"""Benchmark surfaces of lewton_tpu_torch: the port's counterpart of the
repository's ``bench.py``, on the port's own API.

    python -m lewton_tpu_torch.bench [--check | --e2e | --serve | --frontend]
                                     [--cpu] [--streams S] [--chunk T] ...

Each surface prints ONE JSON line last, under the reference's metric name,
unit and detail keys (``vs_baseline`` is value / 10,000, the north star of
10,000x aggregate realtime per chip); ``detail`` also names the device
(``torch.cuda.get_device_name()``, or "cpu") and the platform ("cuda" or
"cpu"):

- (no surface flag) ``aggregate_realtime_synthesis_44k1_stereo``: the
  device half (frames in, i16 PCM and the window carry out) on the flagship
  setup, ``synthetic_headers(2, 8, 11)`` with frames from seed 3, S streams
  of T packets; ``--scan N`` chunks per call through
  :func:`decode_chunks_scan` (0: one chunk through
  :func:`decode_chunk_batch`), each as one program (``parallel.graphs``:
  a CUDA graph replayed per call, as the reference's bench calls its
  jitted function). One warm-up call (which captures it), then
  ``--iters`` calls timed to a device synchronize.
- ``--check`` -> ``conformance_max_lsb_diff``: every committed stream of
  ``tests/data/torch_gate/`` through ``OggStreamReader.read_all_i16()``
  against its libvorbis golden, then the reference's production
  permutations of ``BatchDecoder.decode_streams_i16`` and of the serving
  scheduler on PERM_CASES, and the ``plain`` permutation: the same reads
  with every kernel wrapper replaced by its plain torch version (the
  reference's ``xla_fallback``, which forced its Pallas gates off).
- ``--e2e`` -> ``e2e_realtime_decode_44k1_stereo``: file to PCM
  (native demux, native entropy decode, transfer, device, compaction) on
  S copies of stereo_44k_q3's audio packets tiled to about 30 s.
- ``--serve`` -> ``serve_realtime_mixed_setups``: S streams over three
  setups through one ``StreamingScheduler``, registration to removal.
- ``--frontend`` -> ``entropy_frontend_packets_per_s``: the native
  entropy front-end alone on the host (no device, no transfers), at 1, 2,
  cores/2 and cores threads, and the 12-bit emit.

Runs on the card (cuda:0); ``--cpu`` runs on the CPU, where every kernel
wrapper takes its plain torch version. Without ``--cpu`` and without a card
it raises: nothing falls back. The streams are the committed files of
``tests/data/torch_gate/`` (``manifest.json``), held to their sha256.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from . import native
from .inside_ogg import OggStreamReader, read_headers
from .models.decoder import StreamDecoder, compile_setup
from .ogg import PacketReader
from .ops import imdct
from .ops.windowing import init_window_carry
from .parallel import graphs, launch
from .parallel.batch import (BatchDecoder, decode_chunk_batch,
                             decode_chunks_scan)
from .parallel.pack12 import pack12_supported
from .serve import StreamingScheduler
from .testing import synthetic_frames, synthetic_headers

__all__ = ["main", "probe_link", "gate_streams", "lsb_diff", "gate_pass",
           "permutation_pass", "serve_gate"]

GATE_DIR = Path(__file__).resolve().parent.parent / "tests" / "data" / \
    "torch_gate"
GATE_LSB = 2  # the conformance contract: within +/-2 i16 LSB of libvorbis
#: the reference's production permutations of decode_streams_i16:
#: (label, scan, transport, compact), each on 2 copies of every case
PERMUTATIONS = (("scan8_p12_device", 8, "p12", "device"),
                ("scan16_p12_device", 16, "p12", "device"),
                ("scan16_i16_host", 16, "i16", "host"))
#: the reference's permutation cases (bench.py's perm_cases); the plain
#: permutation reads the first two, as its xla_fallback did
PERM_CASES = ("stereo_44k_q3", "ch6_44k_q3", "f1_bs8192")
#: the reference's serve_scan8 permutation
SERVE_GATE = {"capacity": 4, "chunk": 64, "scan": 8}
#: --serve's streams, one setup each; --e2e's and --frontend's stream
SERVE_FILES = ("stereo_44k_q3", "stereo_48k_q5", "mono_16k_q3")
E2E_STREAM = "stereo_44k_q3"
E2E_SECONDS = 30  # --e2e tiles the stream's audio packets to about this


# ---------------------------------------------------------------------------
# device, link
# ---------------------------------------------------------------------------

def resolve_device(cpu: bool) -> torch.device:
    """The CPU with ``cpu``, else card 0; raises without a card."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("lewton_tpu_torch.bench: no CUDA device "
                           "(torch.cuda.is_available() is False); pass --cpu "
                           "to run on the CPU")
    return torch.device("cuda", 0)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def probe_link(dev, mb: int = 32, reps: int = 3) -> tuple[float, float]:
    """Measured host<->device link rates (h2d_mb_s, d2h_mb_s): the median
    of ``reps`` one-way copies of a pageable ``mb``-MiB buffer in each
    direction, each timed to a device synchronize, after one warm copy
    each way. Transfer-bound surfaces record the rate seen at measurement
    time, so a reader can tell a pipeline regression from a slower link."""
    host = torch.zeros((mb << 20) // 4, dtype=torch.float32)
    back = torch.empty_like(host)
    d = torch.empty(host.shape, dtype=host.dtype, device=dev)
    d.copy_(host)
    back.copy_(d)
    sync(dev)
    h2d, d2h = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        d.copy_(host)
        sync(dev)
        h2d.append(host.nbytes / max(time.perf_counter() - t0, 1e-9))
        t0 = time.perf_counter()
        back.copy_(d)
        sync(dev)
        d2h.append(host.nbytes / max(time.perf_counter() - t0, 1e-9))
    return float(np.median(h2d)) / 1e6, float(np.median(d2h)) / 1e6


def _link_detail(h2d_bytes: int, d2h_bytes: int, audio_s: float,
                 wall_s: float, probe: tuple[float, float]) -> dict:
    """Self-normalizing transfer fields of the e2e and serve lines: byte
    counts, achieved aggregate MB/s, and the link-implied ceiling at the
    probed rates."""
    h2d_mb_s, d2h_mb_s = probe
    link_s = (h2d_bytes / (h2d_mb_s * 1e6) if h2d_mb_s else 0.0) + (
        d2h_bytes / (d2h_mb_s * 1e6) if d2h_mb_s else 0.0)
    return {
        "h2d_bytes": int(h2d_bytes),
        "d2h_bytes": int(d2h_bytes),
        "achieved_link_mb_s": round((h2d_bytes + d2h_bytes) / wall_s / 1e6,
                                    1),
        "probe_h2d_mb_s": round(h2d_mb_s, 1),
        "probe_d2h_mb_s": round(d2h_mb_s, 1),
        "link_implied_ceiling_x": round(audio_s / link_s, 1) if link_s
        else None,
    }


def _line(metric: str, value: float, unit: str, detail: dict,
          dev: torch.device) -> dict:
    return {"metric": metric, "value": value, "unit": unit,
            "vs_baseline": round(value / 10000.0, 3),
            "detail": detail | {"platform": dev.type,
                                "device": device_name(dev)}}


# ---------------------------------------------------------------------------
# the committed streams
# ---------------------------------------------------------------------------

def gate_manifest() -> dict:
    with open(GATE_DIR / "manifest.json") as f:
        return json.load(f)


def gate_streams(names=None) -> dict:
    """name -> (ogg bytes, golden i16 [samples, C], kind) of the committed
    gate streams (``names``, or all of them), each file held to its sha256
    in the manifest."""
    manifest = gate_manifest()["streams"]
    out = {}
    for name in (manifest if names is None else names):
        e = manifest[name]
        blobs = []
        for key in ("ogg", "golden"):
            blob = (GATE_DIR / e[key]).read_bytes()
            if hashlib.sha256(blob).hexdigest() != e[key + "_sha256"]:
                raise AssertionError(f"gate {name}: {e[key]} sha256 differs "
                                     "from the manifest")
            blobs.append(blob)
        with np.load(GATE_DIR / e["golden"]) as z:
            golden = z["pcm"]
        out[name] = (blobs[0], golden, e["kind"])
    return out


def lsb_diff(out: np.ndarray, golden: np.ndarray) -> tuple[int, int, int]:
    """(max |out - golden| in i16 LSB, samples over GATE_LSB, samples that
    differ at all)."""
    if not golden.size:
        return 0, 0, 0
    d = np.abs(out.astype(np.int32) - golden.astype(np.int32))
    return int(d.max()), int((d > GATE_LSB).sum()), int((d > 0).sum())


def stream_packets(data: bytes):
    """(headers, audio packets) of a single-link stream; the headers carry
    the raw header packets (``raw_ident``, ``raw_setup``)."""
    rdr = PacketReader(data)
    headers, serial = read_headers(rdr)
    pcks = []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial == serial:
            pcks.append(p.data)
    return headers, pcks


def audio_spans(data: bytes, tile: int = 1):
    """(headers, the stream's audio packets as ``native.PacketSpans`` into
    one demux blob, ``tile`` copies in a row) of a single-link stream."""
    headers, _ = read_headers(PacketReader(data))
    spans = native.demux_spans(data)[0]
    return headers, native.PacketSpans(spans.data,
                                       np.tile(spans.offs[3:], tile),
                                       np.tile(spans.lens[3:], tile))


def first_link_samples(data: bytes) -> int | None:
    """The granule of the first link's end: what the scheduler keeps of a
    chained stream (it follows the first link's serial only); None for a
    single-link stream."""
    rdr = PacketReader(data)
    serial = rdr.read_packet().stream_serial
    end, links = None, 1
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial != serial:
            links += p.first_in_stream
        elif p.last_in_stream:
            end = p.absgp_page
    return end if links > 1 else None


# ---------------------------------------------------------------------------
# the conformance passes (chip_smoke.py runs them too)
# ---------------------------------------------------------------------------

def gate_pass(streams: dict, dev, label: str) -> dict:
    """Every stream through OggStreamReader.read_all_i16() on ``dev``:
    exact length, per-stream max diff and samples over the contract."""
    res = {}
    for name, (data, golden, kind) in streams.items():
        out = OggStreamReader(data, device=dev).read_all_i16()
        if out.shape != golden.shape:
            raise AssertionError(f"gate {label} {name}: shape {out.shape}, "
                                 f"golden {golden.shape}")
        res[name] = lsb_diff(out, golden)
        print(f"gate {label} {name} ({kind}): {out.shape[0]} samples x "
              f"{out.shape[1]} ch, maxdiff {res[name][0]} LSB, "
              f"{res[name][1]} over +/-{GATE_LSB}, {res[name][2]} differ")
    return res


def permutation_pass(streams: dict, dev, names) -> dict:
    """The production permutations of decode_streams_i16 on 2 copies of
    each of ``names``, on the native front-end. The batch decode applies
    no granule truncation, so its output holds the golden as a prefix and
    at most one long block more. Returns "label/name" -> lsb_diff."""
    res = {}
    for label, scan, transport, compact in PERMUTATIONS:
        for name in names:
            data, golden, _ = streams[name]
            headers, pcks = stream_packets(data)
            dec = BatchDecoder(headers.ident, headers.setup, chunk=64,
                               scan=scan, device=dev,
                               raw_headers=(headers.raw_ident,
                                            headers.raw_setup))
            if dec._sd._native is None:
                raise AssertionError("the batch decoder is not on the "
                                     "native front-end")
            outs = dec.decode_streams_i16([pcks, pcks], compact=compact,
                                          transport=transport)
            if name == "stereo_44k_q3" and transport == "p12" and not (
                    pack12_supported(dec.cs)
                    and dec.last_stats["transport"] == "p12"
                    and dec._sd._native.residue_dtype == np.uint32):
                raise AssertionError("the flagship did not take p12 from "
                                     "the native emit")
            if not np.array_equal(outs[0], outs[1]):
                raise AssertionError(f"perm {label} {name}: the two copies "
                                     "differ")
            extra = outs[0].shape[0] - golden.shape[0]
            if not 0 <= extra <= dec.cs.n1:
                raise AssertionError(f"perm {label} {name}: {outs[0].shape} "
                                     f"against golden {golden.shape}")
            r = lsb_diff(outs[0][: golden.shape[0]], golden)
            res[f"{label}/{name}"] = r
            print(f"perm {label} {name}: transport "
                  f"{dec.last_stats['transport']}, residue emit "
                  f"{np.dtype(dec._sd._native.residue_dtype).name}, maxdiff "
                  f"{r[0]} LSB, {r[1]} over +/-{GATE_LSB}, {r[2]} differ")
    return res


def serve_gate(streams: dict, names, dev, label: str,
               show: bool = True) -> tuple:
    """``names`` through one StreamingScheduler(**SERVE_GATE) on ``dev``:
    exact length, samples over the contract against the libvorbis golden
    (a chained stream against the golden's first link), no stream errors.
    Returns (name -> lsb_diff, the outputs in ``names``' order, the
    scheduler); prints a line per stream with ``show``."""
    sched = StreamingScheduler(**SERVE_GATE, device=dev)
    for name in names:
        sched.add_stream(name, streams[name][0])
    while sched.step():
        pass
    res, outs = {}, []
    for name in names:
        data, golden, kind = streams[name]
        out = sched.poll(name)
        outs.append(out)
        end = first_link_samples(data)
        note = ""
        if end is not None:
            golden = golden[:end]
            note = f", held to its first link ({end} samples)"
        if out.shape != golden.shape or not sched.is_done(name) \
                or sched.stream_errors(name):
            raise AssertionError(f"serve gate{label} {name}: shape "
                                 f"{out.shape}, golden {golden.shape}, "
                                 f"errors {sched.stream_errors(name)}")
        res[name] = lsb_diff(out, golden)
        if show:
            print(f"serve gate{label} {name} ({kind}{note}): {out.shape[0]} "
                  f"samples x {out.shape[1]} ch, maxdiff {res[name][0]} LSB, "
                  f"{res[name][1]} over +/-{GATE_LSB}, {res[name][2]} differ")
    return res, outs, sched


def _summary(res: dict) -> dict:
    return {"maxdiff": max((r[0] for r in res.values()), default=0),
            "samples_over_2lsb": sum(r[1] for r in res.values())}


def bench_check(args, dev, names=None) -> dict:
    """Conformance on ``dev``: the committed streams (``names``, or all of
    them) through read_all_i16, the production permutations and the
    serve_scan8 pass on PERM_CASES, and the plain permutation on the first
    two cases."""
    streams = gate_streams(names)
    cases = gate_streams(PERM_CASES)
    direct = gate_pass(streams, dev, "read_all_i16")
    perms = permutation_pass(cases, dev, PERM_CASES)
    results = {label: _summary({k: v for k, v in perms.items()
                                if k.startswith(label + "/")})
               for label, _, _, _ in PERMUTATIONS}
    before = launch._counters()
    with launch.plain_kernels():
        plain = gate_pass({n: cases[n] for n in PERM_CASES[:2]}, dev,
                          "read_all_i16 plain")
    if launch._counters() != before:
        raise AssertionError("the plain permutation launched a kernel: "
                             f"{before} -> {launch._counters()}")
    results["plain"] = _summary(plain)
    served, _, _ = serve_gate(cases, PERM_CASES, dev, " serve_scan8")
    results["serve_scan8"] = _summary(served)
    worst = max(_summary(direct)["maxdiff"],
                *(r["maxdiff"] for r in results.values()))
    bad = _summary(direct)["samples_over_2lsb"] + sum(
        r["samples_over_2lsb"] for r in results.values())
    return _line("conformance_max_lsb_diff", worst, "i16_lsb", {
        "samples_over_2lsb": bad, "production_permutations": results,
        "streams": len(streams),
        "left_out": gate_manifest()["left_out"],
        # the programs read_all_i16 ran through: made, captured, replays,
        # capture seconds and the pool's MB
        "stream_programs": graphs.stream_programs(dev).stats()}, dev) | {
        "vs_baseline": 1.0 if bad == 0 and worst <= GATE_LSB else 0.0}


# ---------------------------------------------------------------------------
# the timed surfaces
# ---------------------------------------------------------------------------

def bench_synthesis(args, dev, programs=None) -> dict:
    """The device half on the flagship setup: --iters calls after one
    warm-up, timed to a device synchronize. ``programs``: the
    ``graphs.Programs`` the calls' program is made in (default: a new
    one)."""
    S, T = args.streams, args.chunk
    ident, setup = synthetic_headers(channels=2, bs0_exp=8, bs1_exp=11)
    cs = compile_setup(ident, setup, device=dev)
    fr = {k: torch.from_numpy(v).to(dev)
          for k, v in synthetic_frames(cs, T=T, S=S, seed=3).items()}
    carry = init_window_carry(cs.channels, cs.n1 // 2, S, dev)
    # the call's program: the carry it returns is its owner's static one, so
    # passing it back chains the calls with no copy
    programs = graphs.Programs() if programs is None else programs
    if args.scan:
        # N chunks per call: the same frames stacked (steady-state
        # synthesis; production stacks N distinct chunks the same way)
        frs = {k: v.expand(args.scan, *v.shape) for k, v in fr.items()}

        def call(c):
            (outs, lens), c = decode_chunks_scan(cs, frs, c, with_i16=True,
                                                 programs=programs)
            return outs, lens, c
    else:
        def call(c):
            (outs, lens), c = decode_chunk_batch(cs, fr, c, with_i16=True,
                                                 programs=programs)
            return outs, lens, c
    _, lens, _ = call(carry)  # warm-up
    samples_per_call = int(lens.sum())  # per-channel samples
    sync(dev)
    t0 = time.perf_counter()
    c = carry
    for _ in range(args.iters):
        _, _, c = call(c)
    sync(dev)
    dt = time.perf_counter() - t0
    audio_s = samples_per_call * args.iters / ident.sample_rate
    packets = S * T * max(1, args.scan) * args.iters
    if args.scan:
        detail = {"streams": S, "chunk": T, "scan": args.scan,
                  "iters": args.iters, "wall_s": round(dt, 4),
                  "audio_s": round(audio_s, 2),
                  "packets_per_s": round(packets / dt, 1)}
    else:
        detail = {"streams": S, "chunk_packets": T, "iters": args.iters,
                  "wall_s": round(dt, 4), "audio_s": round(audio_s, 2),
                  "packets_per_s": round(packets / dt, 1)}
    return _line("aggregate_realtime_synthesis_44k1_stereo",
                 round(audio_s / dt, 1), "x_realtime_per_chip", detail, dev)


def bench_e2e(args, dev) -> dict:
    """File to PCM: S copies of stereo_44k_q3's audio packets tiled to
    about E2E_SECONDS, one warm-up call, the link probe, one timed call."""
    data, _, _ = gate_streams([E2E_STREAM])[E2E_STREAM]
    # zero-copy packet views into the demux blob; packets are
    # self-contained (only the window carry crosses them), so tiling the
    # spans re-reads the same bytes
    headers, pcks = audio_spans(data, max(1, E2E_SECONDS // 3))
    S = args.streams
    dec = BatchDecoder(headers.ident, headers.setup,
                       chunk=min(args.chunk, 64),
                       raw_headers=(headers.raw_ident, headers.raw_setup),
                       scan=max(1, args.scan), device=dev)
    dec.decode_streams_i16([pcks] * S, compact=args.compact,
                           transport=args.transport)  # warm-up
    probe = probe_link(dev)
    sync(dev)
    t0 = time.perf_counter()
    outs = dec.decode_streams_i16([pcks] * S, compact=args.compact,
                                  transport=args.transport)
    dt = time.perf_counter() - t0
    audio_s = sum(o.shape[0] for o in outs) / headers.ident.sample_rate
    detail = {"streams": S, "wall_s": round(dt, 3),
              "audio_s": round(audio_s, 2)}
    detail.update(_link_detail(dec.last_stats["h2d_bytes"],
                               dec.last_stats["d2h_bytes"], audio_s, dt,
                               probe))
    return _line("e2e_realtime_decode_44k1_stereo", round(audio_s / dt, 1),
                 "x_realtime_per_chip", detail, dev)


def bench_serve(args, dev, timed=contextlib.nullcontext):
    """S streams over SERVE_FILES through one scheduler, after one warm-up
    stream per setup, registration to removal, the timed part inside
    ``timed(sched)`` (``sched``: the scheduler). Returns the JSON line, the
    PCM of each timed stream and the scheduler."""
    streams = gate_streams(SERVE_FILES)
    datas = [streams[n][0] for n in SERVE_FILES]
    S = args.streams
    sched = StreamingScheduler(capacity=max(8, S // len(datas) + 1),
                               chunk=64, scan=max(1, args.scan), device=dev)
    # warm-up: one stream per setup makes each group and its buffers
    for i, d in enumerate(datas):
        sched.add_stream(("warm", i), d)
    while sched.step():
        pass
    probe = probe_link(dev)
    sched.transfer_stats(reset=True)
    audio_s = 0.0
    outs = []
    sync(dev)
    with timed(sched):
        t0 = time.perf_counter()
        for i in range(S):
            sched.add_stream(i, datas[i % len(datas)])
        while sched.step():
            pass
        for i in range(S):
            outs.append(sched.poll(i))
            audio_s += outs[-1].shape[0] / sched.streams[i][0].cs.sample_rate
            sched.remove_stream(i)
        dt = time.perf_counter() - t0
    stats = sched.transfer_stats()
    detail = {"streams": S, "setups": len(datas), "wall_s": round(dt, 3),
              "audio_s": round(audio_s, 1),
              # p50/p95/p99/max registration -> first PCM and turnaround
              "latency": sched.latency_stats()}
    detail.update(_link_detail(stats["h2d_bytes"], stats["d2h_bytes"],
                               audio_s, dt, probe))
    return _line("serve_realtime_mixed_setups", round(audio_s / dt, 1),
                 "x_realtime_per_chip", detail, dev), outs, sched


def bench_frontend(args, dev, seconds: float = 3.0) -> dict:
    """The native entropy front-end alone, on the host: 32 streams of
    stereo_44k_q3's first 64 audio packets per call, ``seconds`` at each
    thread point, then the 12-bit emit on one thread."""
    data, _, _ = gate_streams([E2E_STREAM])[E2E_STREAM]
    headers, audio = audio_spans(data)
    # host only: the decoder's setup tables stay on the CPU
    sd = StreamDecoder(headers.ident, headers.setup, chunk=64,
                       raw_headers=(headers.raw_ident, headers.raw_setup),
                       device="cpu")
    S = 32
    streams = [audio[:64]] * S
    out = sd.entropy_chunk_batch(streams)  # warm-up, allocate
    cores = os.cpu_count() or 1

    def rate(threads: int, buf: dict) -> float:
        n = 0
        t0 = time.perf_counter()
        while (dt := time.perf_counter() - t0) < seconds:
            sd.entropy_chunk_batch(streams, threads=threads, out=buf)
            n += S * 64
        return n / dt

    rates = {t: rate(t, out)
             for t in sorted({1, 2, max(1, cores // 2), cores})}
    best = max(rates.values())
    p12_rate = None
    if pack12_supported(sd.cs):
        sd.set_residue_transport("p12")
        p12_rate = rate(1, sd.entropy_chunk_batch(streams))
        sd.set_residue_transport("default")
    # packets/s -> x realtime: ~1024 samples a packet at 44.1 kHz (q3 is
    # long-block dominated)
    x_rt = best * 1024 / 44100.0
    detail = {"per_thread_rates": {str(k): round(v, 1)
                                   for k, v in rates.items()},
              "p12_emit_packets_per_s": (round(p12_rate, 1) if p12_rate
                                         else None),
              "cores": cores, "one_core_host": cores == 1,
              "x_realtime_equiv": round(x_rt, 1),
              "scaling_note": ("projection from a 1-vCPU host" if cores == 1
                               else f"measured on {cores} cores")}
    return _line("entropy_frontend_packets_per_s", round(best, 1),
                 "packets_per_s", detail, dev) | {
        "vs_baseline": round(x_rt / 10000.0, 3)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lewton_tpu_torch.bench",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    surface = ap.add_mutually_exclusive_group()
    surface.add_argument("--check", action="store_true",
                         help="conformance of the committed streams on the "
                         "device, through every production permutation")
    surface.add_argument("--e2e", action="store_true",
                         help="file to PCM: native demux and entropy decode, "
                         "device synthesis, --streams copies of a stream")
    surface.add_argument("--serve", action="store_true",
                         help="StreamingScheduler: --streams streams over "
                         "three setups, x_realtime registration to removal")
    surface.add_argument("--frontend", action="store_true",
                         help="the native entropy front-end alone on the "
                         "host: packets/s (no device, no transfers)")
    ap.add_argument("--scan", type=int, default=None, metavar="N",
                    help="chunks per dispatch (default: 16 for synthesis, "
                    "8 for e2e, 1 for serve; 0 = one chunk)")
    ap.add_argument("--dct4-split", action="store_true",
                    help="the Wang split for the long IMDCT "
                    "(ops.imdct.USE_DCT4_SPLIT)")
    ap.add_argument("--transport", default="auto",
                    choices=["auto", "i16", "p12"],
                    help="--e2e residue host-to-device encoding (auto: p12 "
                    "on a slow measured link, i16 otherwise)")
    ap.add_argument("--compact", default="device", choices=["device", "host"],
                    help="--e2e output compaction: on the device, or host "
                    "slicing of the padded i16 output")
    args = ap.parse_args(argv)
    if args.scan is None:
        args.scan = 1 if args.serve else (8 if args.e2e else 16)
    return args


def main(argv=None, frontend_seconds: float = 3.0, check_names=None,
         programs=None) -> dict:
    """Run the surface ``argv`` selects, print its JSON line last and
    return it. ``frontend_seconds``: --frontend's seconds at each thread
    point; ``check_names``: --check's gate streams (default all);
    ``programs``: the headline's ``graphs.Programs`` (default: a new
    one)."""
    args = parse_args(argv)
    dev = resolve_device(args.cpu)
    split = imdct.USE_DCT4_SPLIT
    imdct.USE_DCT4_SPLIT = split or args.dct4_split
    try:
        if args.frontend:
            result = bench_frontend(args, dev, frontend_seconds)
        elif args.check:
            result = bench_check(args, dev, check_names)
        elif args.e2e:
            result = bench_e2e(args, dev)
        elif args.serve:
            result = bench_serve(args, dev)[0]
        else:
            result = bench_synthesis(args, dev, programs)
    finally:
        imdct.USE_DCT4_SPLIT = split
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
