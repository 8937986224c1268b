"""Start the ranks of a (dp, tp) mesh and run a job on each, one process per
rank (the port's counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m lewton_tpu_torch.parallel.launch --dp 2 --tp 2 \\
        --backend gloo --device cpu --init-file /tmp/lt_init \\
        --out /tmp/lt_run --job dryrun

Run as above, the command is the parent: it starts ``dp * tp`` processes of
itself with ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set (each rank's
output in ``OUT/rank{r}.log``), waits for them until ``--timeout`` seconds
have passed, kills the others as soon as one fails or time is up, and then
exits non-zero. With ``RANK`` in its environment (set by the parent, or by
``torchrun``) the command is one rank: it joins the process group through a
``FileStore`` on ``--init-file`` (``env://`` without one, as under
torchrun) with ``--collective-timeout`` on every collective, builds the
mesh (:func:`make_mesh`), runs the job and exits non-zero on any
exception, without touching the group again.

A ``FileStore`` needs no TCP port, so runs that start at once (parallel
test workers) cannot pick the same one. Ranks that share one card take the
"gloo" backend; "nccl" needs one rank per card. The parent should build
the kernels and the host library first (``_build.load_library``,
``_build.load_host_library``): ranks that start on a cold tree would each
compile them.

Jobs:

- ``dryrun``: the reference's multichip dry run, ``synthetic_headers(2, 6,
  7)``, S = 2 dp streams of T = 4 packets through
  :func:`decode_chunk_sharded`; shape, finiteness and ``out_len`` checks;
  rank 0 prints one ``ok`` line.
- ``cases``: the decodes listed in ``--spec`` (a JSON file, :func:`run_case`
  says what each does). Every rank writes ``OUT/rank{r}.json`` (per case:
  sha256 digests of its own block's outputs and of the gathered ones,
  launches of each kernel form, ms per chunk, ``last_stats``, and with
  ``held`` the kernels held against their plain versions); rank 0 also
  writes the gathered arrays to ``OUT/rank0.npz``.
- ``FILE.py:FUNCTION``: ``FUNCTION(mesh, args)`` of that file.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import functools
import hashlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
#: launch counters of every kernel form: name -> (module, attribute)
COUNTERS = {"floor": ("floor_kernel", "LAUNCHES"),
            "floor_flat": ("floor_kernel", "LAUNCHES_FLAT"),
            "floor_cd": ("floor_kernel", "LAUNCHES_CD"),
            "overlap": ("overlap_kernel", "LAUNCHES"),
            "overlap_split": ("overlap_kernel", "LAUNCHES_SPLIT"),
            "overlap_audio": ("overlap_kernel", "LAUNCHES_AUDIO"),
            "synth": ("synth_kernel", "LAUNCHES")}
#: the kernel wrappers as the decoder looks them up: (module, wrapper, its
#: plain version); K1's plain version takes no ``xs`` (the 4th argument)
HELD = (("models.decoder", "floor_spectra", "floor_spectra_ref"),
        ("models.decoder", "fused_floor_couple", "fused_floor_couple_ref"),
        ("ops.windowing", "overlap_i16", "overlap_i16_ref"),
        ("ops.windowing", "overlap_i16_split", "overlap_i16_split_ref"),
        ("ops.windowing", "overlap_i16_audio", "overlap_i16_audio_ref"))


#: each wrapper of :data:`HELD` with the module the decoder looks it up in,
#: as the package defines it (taken at import, before any swap)
_DEFINED = tuple((importlib.import_module(f"lewton_tpu_torch.{mod}"), name,
                  getattr(importlib.import_module(f"lewton_tpu_torch.{mod}"),
                          name)) for mod, name, _ in HELD)
#: launches of each kernel form (:data:`COUNTERS`' names) made by replayed
#: CUDA graphs (``parallel.graphs``): a replay does not pass through the
#: wrappers, whose counters count only the launches they make
REPLAYED = dict.fromkeys(COUNTERS, 0)


def kernels_in_use() -> bool:
    """Whether every kernel wrapper the decoder calls (:data:`HELD`) is the
    package's own: false inside :func:`plain_kernels` and
    :func:`held_kernels` and wherever a caller has put a stand-in there."""
    return all(getattr(m, name) is fn for m, name, fn in _DEFINED)


class RankFailed(RuntimeError):
    """A rank exited non-zero or the run outlived its deadline."""


def _module(name: str):
    return importlib.import_module(f"lewton_tpu_torch.ops.{name}")


def _counters() -> dict:
    return {k: getattr(_module(m), a) for k, (m, a) in COUNTERS.items()}


def _replayed() -> dict:
    """The package module's :data:`REPLAYED`, the one ``graphs`` adds to:
    a rank runs this file as ``__main__``, a module of its own."""
    return importlib.import_module(
        "lewton_tpu_torch.parallel.launch").REPLAYED


def _zero_counters() -> None:
    """The wrappers' counters and :data:`REPLAYED` set to 0."""
    for m, a in COUNTERS.values():
        setattr(_module(m), a, 0)
    rep = _replayed()
    rep.update(dict.fromkeys(rep, 0))


def _set_counters(counts: dict) -> None:
    for k, n in counts.items():
        setattr(_module(COUNTERS[k][0]), COUNTERS[k][1], n)


def _add_replayed(delta: dict) -> None:
    """Add a replayed graph's launches (name -> launches) to
    :data:`REPLAYED`."""
    for k, n in delta.items():
        REPLAYED[k] += n


def spawn(dp: int, tp: int, job: str, out, backend: str = "gloo",
          device: str = "cuda", spec=None, init_file=None,
          timeout: float = 120.0, collective_timeout: float = 60.0) -> Path:
    """Run ``job`` on dp * tp rank processes and wait for all of them; raise
    :class:`RankFailed` (with the tail of the failed rank's log) when one
    exits non-zero or ``timeout`` seconds pass, after killing the others.
    Each collective of a rank fails after ``collective_timeout`` seconds.
    The ranks decode on ``device`` (the card unless the caller names
    another). Returns the output directory."""
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    init_file = Path(init_file) if init_file else out / "init"
    if init_file.exists():
        init_file.unlink()  # a FileStore file is for one run
    world = dp * tp
    cmd = [sys.executable, "-m", "lewton_tpu_torch.parallel.launch",
           "--dp", str(dp), "--tp", str(tp), "--backend", backend,
           "--device", device, "--init-file", str(init_file),
           "--out", str(out), "--job", job,
           "--collective-timeout", str(collective_timeout)]
    if spec is not None:
        cmd += ["--spec", str(spec)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    procs = []
    deadline = time.monotonic() + timeout
    try:
        for r in range(world):
            log = open(out / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(
                cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                env=dict(env, RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(r))),
                log))
        while True:
            codes = [p.poll() for p, _ in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.monotonic() > deadline
            if bad or late:
                show = bad or [r for r, c in enumerate(codes) if c is None]
                what = (", ".join(f"rank {r} exited {codes[r]}" for r in bad)
                        if bad else f"ranks {show} still running after "
                        f"{timeout} s")
                logs = ""
                for r in show[:2]:
                    procs[r][1].flush()
                    tail = (out / f"rank{r}.log").read_text()[-3000:]
                    logs += f"\n--- rank {r}'s log:\n{tail}"
                raise RankFailed(f"{job} at dp={dp} tp={tp} ({backend}, "
                                 f"{device}): {what}{logs}")
            if all(c == 0 for c in codes):
                return out
            time.sleep(0.05)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()


# ---------------------------------------------------------------------------
# the rank's side
# ---------------------------------------------------------------------------

def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _host(x) -> np.ndarray:
    return x.to("cpu", copy=True).numpy()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def job_dryrun(mesh, args) -> None:
    """The reference's ``dryrun_multichip`` on this rank."""
    from ..models.decoder import compile_setup, frames_to_device
    from ..ops.windowing import init_window_carry
    from ..testing import synthetic_frames, synthetic_headers
    from .batch import decode_chunk_sharded, mesh_device

    dev = mesh_device(mesh)
    n_dp, n_tp = mesh["dp"].size(), mesh["tp"].size()
    cs = compile_setup(*synthetic_headers(2, 6, 7), device=dev)
    S, T = 2 * n_dp, 4
    fr = frames_to_device(synthetic_frames(cs, T=T, S=S), dev)
    carry = init_window_carry(cs.channels, cs.n1 // 2, S, dev)
    (out, out_len), _ = decode_chunk_sharded(mesh, cs, fr, carry)
    out, out_len = _host(out), _host(out_len)
    assert out.shape == (S, T, cs.channels, 3 * cs.n1 // 4), out.shape
    assert np.isfinite(out).all()
    # the first packet of each stream primes the window: 0 samples
    assert (out_len[:, 0] == 0).all()
    assert (out_len[:, 1:] > 0).all()
    if dist.get_rank() == 0:
        print(f"dryrun_multichip ok: mesh dp={n_dp} tp={n_tp}, out "
              f"{out.shape}, total samples {int(out_len.sum())}", flush=True)


def _packets(path: str):
    """(headers, audio packets) of a single-link stream file."""
    from ..inside_ogg import read_headers
    from ..ogg import PacketReader

    with open(path, "rb") as f:
        rdr = PacketReader(f.read())
    headers, serial = read_headers(rdr)
    pcks = []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial == serial:
            pcks.append(p.data)
    return headers, pcks


def run_case(mesh, case: dict) -> tuple[dict, dict]:
    """One case of a ``cases`` spec on this rank; returns (record, arrays
    gathered over the mesh). Kinds:

    - ``chunk``: N chunks of ``synthetic_frames`` (setup
      ``synthetic_headers(*setup)``, S streams of T packets, chunk i from
      seed + i, the carry chained) through :func:`decode_chunk_sharded`
      (``with_i16``, ``compact_cap``); ``warmup`` runs the chunks once
      untimed first. With ``programs`` the chunks go through the
      programs of one ``graphs.Programs`` (captured on a card; at tp > 1
      two segments a chunk around the all-reduce), and the record gets
      its ``programs`` stats and ``eager``: the digests, ``eager_maxdiff``
      and ``ms_per_chunk`` of a run again with ``programs=None``, after
      the timed run. Arrays: each chunk's outputs, the final carry.
    - ``streams``: the stream in ``file``, once per entry of ``lengths``
      (its first that many audio packets; null for all), through
      ``BatchDecoder(mesh=)`` (``chunk``; the native front-end, on the
      raw header packets), ``decode_streams`` or, with ``i16``,
      ``decode_streams_i16(compact=)``; the record gets its transfer
      slots' ``programs`` stats and, with ``eager``, ``eager`` as above
      from a run again under ``graphs.eager()``. Arrays: one per stream.

    Both kinds record ``graphed``: whether the run's programs were all
    captured (on a card; never on the CPU, where programs run eagerly).

    The launch counts are set to 0 just before the timed run and read just
    after it: each kernel form's launches through its wrapper and in
    replayed programs (``REPLAYED``) together. With ``held`` the case runs a second time on the same inputs
    under :func:`held_kernels`, and its record gets that run's ``held``
    calls and ``launches``, the digests of its outputs and
    ``plain_maxdiff``, the largest difference of any output from the timed
    run's."""
    from ..models.decoder import compile_setup, frames_to_device
    from ..ops.windowing import init_window_carry
    from ..testing import synthetic_frames, synthetic_headers
    from . import graphs
    from .batch import (BatchDecoder, _dp_block, decode_chunk_sharded,
                        mesh_device)

    dev = mesh_device(mesh)
    kind = case["kind"]
    progs = None
    if kind == "chunk":
        cs = compile_setup(*synthetic_headers(*case["setup"]), device=dev)
        S, T, chunks = case["S"], case["T"], case.get("N", 1)
        frs = [frames_to_device(synthetic_frames(
            cs, T=T, S=S, seed=case.get("seed", 0) + i), dev)
            for i in range(chunks)]
        kw = {"with_i16": case.get("with_i16", False),
              "compact_cap": case.get("compact_cap")}
        progs = graphs.Programs() if case.get("programs") else None

        def run(programs=progs):
            carry = init_window_carry(cs.channels, cs.n1 // 2, S, dev)
            arrays = {}
            for i, fr in enumerate(frs):
                out, carry = decode_chunk_sharded(mesh, cs, fr, carry,
                                                  programs=programs, **kw)
                # cloned: at dp = 1 a program's outputs are its own
                # buffers, rewritten by the next chunk
                arrays |= {f"out{i}_{j}": x.clone() for j, x in
                           enumerate(out)}
            return arrays | {f"carry_{j}": c for j, c in enumerate(carry)}
    elif kind == "streams":
        headers, pcks = _packets(case["file"])
        dec = BatchDecoder(headers.ident, headers.setup,
                           chunk=case.get("chunk", 64), mesh=mesh,
                           raw_headers=(headers.raw_ident, headers.raw_setup))
        streams = [pcks[:n] for n in case["lengths"]]
        S = len(streams)
        chunks = -(-max(map(len, streams)) // dec.chunk)

        def run():
            outs = (dec.decode_streams_i16(
                streams, compact=case.get("compact", "device"))
                if case.get("i16", False) else dec.decode_streams(streams))
            return {f"stream{i}": o for i, o in enumerate(outs)}
    else:
        raise ValueError(f"case kind {kind!r}")
    for _ in range(case.get("warmup", 0)):
        run()
    _sync(dev)
    _zero_counters()
    t0 = time.perf_counter()
    arrays = run()
    _sync(dev)
    secs = time.perf_counter() - t0
    rec = {"launches": _ran(), "ms_per_chunk": 1e3 * secs / chunks}
    arrays = _on_host(arrays)
    lo, hi = _dp_block(mesh, S)
    rec |= _digests(arrays, kind, lo, hi)
    rerun = None
    if kind == "streams":
        rec["last_stats"] = {k: v for k, v in dec.last_stats.items()
                             if k != "stages"}
        progs = dec._slots.programs
        if case.get("eager", False):
            def rerun():
                with graphs.eager():
                    return run()
    elif progs is not None:
        rerun = functools.partial(run, None)
    if progs is not None:
        st = rec["programs"] = progs.stats()
        rec["graphed"] = 0 < st["captured"] == st["programs"]
    if rerun is not None:
        _sync(dev)
        t0 = time.perf_counter()
        eager = rerun()
        _sync(dev)
        secs = time.perf_counter() - t0
        eager = _on_host(eager)
        rec["eager"] = _digests(eager, kind, lo, hi) | {
            "eager_maxdiff": _maxdiff(arrays, eager),
            "ms_per_chunk": 1e3 * secs / chunks}
    if case.get("held", False):
        held: dict = {}
        _zero_counters()
        with held_kernels(held):
            again = _on_host(run())
        rec["held"] = {"calls": held, "launches": _ran(),
                       "plain_maxdiff": _maxdiff(arrays, again)}
        rec["held"] |= _digests(again, kind, lo, hi)
    return rec, arrays


def _maxdiff(arrays: dict, again: dict) -> float:
    """The largest difference of any array of ``again`` from ``arrays``'."""
    return max((float(np.abs(a.astype(np.float64) - again[k]).max())
                for k, a in arrays.items() if a.size), default=0.0)


def _ran() -> dict:
    """Launches of each kernel form: through its wrapper and in replayed
    programs together."""
    rep = _replayed()
    return {k: n + rep[k] for k, n in _counters().items()}


def _on_host(arrays: dict) -> dict:
    return {k: _host(v) if isinstance(v, torch.Tensor) else v
            for k, v in arrays.items()}


def _digests(arrays: dict, kind: str, lo: int, hi: int) -> dict:
    """sha256 of this rank's own block (of every array's streams for a
    chunk case, of the list of streams for a streams case) and of all."""
    block = ([a[lo:hi] for a in arrays.values()] if kind == "chunk"
             else list(arrays.values())[lo:hi])
    return {"digest_block": _digest(block),
            "digest_gathered": _digest(arrays.values())}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a = a.contiguous().view(torch.int32)
        b = b.contiguous().view(torch.int32)
    return torch.equal(a, b)


@contextlib.contextmanager
def _swapped(make):
    """Each kernel wrapper of :data:`HELD` replaced for the block by
    ``make(wrapper, its plain version, drop_xs)`` (``drop_xs``: the plain
    version takes no ``xs``), the wrappers restored in a ``finally``."""
    saved = []
    try:
        for (m, name, _), (_, _, ref_name) in zip(_DEFINED, HELD):
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, make(getattr(m, name), getattr(m, ref_name),
                                  name == "floor_spectra"))
        yield
    finally:
        for m, name, fn in reversed(saved):
            setattr(m, name, fn)


@contextlib.contextmanager
def held_kernels(calls: dict):
    """Every kernel wrapper the decoder calls (:data:`HELD`) launches its
    kernel as on the path, then holds each output against the kernel's
    plain version on the same inputs, bit for bit (AssertionError
    otherwise), and hands on the plain version's values in the kernel
    output's tensors (their strides: a stride moves the GEMM that follows
    to another kernel), so the run goes on on the plain versions. ``calls``
    gets, per kernel form that launched (:data:`COUNTERS`' names), the
    calls, their output shapes and the largest difference."""
    def hold(kern, ref, drop_xs):
        def held(*a, **kw):
            before = _counters()
            got = kern(*a, **kw)
            form = [k for k, v in _counters().items() if v != before[k]]
            # the plain version writes into no caller's buffer
            want = ref(*(a[:3] + a[4:] if drop_xs else a),
                       **{k: v for k, v in kw.items() if k != "out"})
            pairs = (list(zip(got, want, strict=True))
                     if isinstance(got, tuple) else [(got, want)])
            err = max((float((g.double() - w.double()).abs().max())
                       for g, w in pairs if g.numel()), default=0.0)
            if not all(_same_bits(g, w) for g, w in pairs):
                raise AssertionError(
                    f"{kern.__name__} at {[tuple(g.shape) for g, _ in pairs]}"
                    f" differs from its plain version by {err}")
            for g, w in pairs:
                g.copy_(w)
            for f in form:
                c = calls.setdefault(f, {"calls": 0, "shapes": [],
                                         "max_abs_err": 0.0})
                c["calls"] += 1
                c["max_abs_err"] = max(c["max_abs_err"], err)
                shape = [list(g.shape) for g, _ in pairs]
                if shape not in c["shapes"]:
                    c["shapes"].append(shape)
            return got
        return held

    with _swapped(hold):
        yield calls


def _plain(ref, drop_xs: bool):
    """A kernel wrapper's stand-in: its plain version, each fresh output
    copied into a tensor of the kernel's (contiguous) strides. A plain
    output's stride on a size-1 axis would send the GEMM after it to
    another kernel, whose sum order moves a sample by 1 LSB."""
    def plain(*a, **kw):
        got = ref(*(a[:3] + a[4:] if drop_xs else a), **kw)

        def fresh(t):
            if t is kw.get("out"):
                return t
            return torch.empty(t.shape, dtype=t.dtype,
                               device=t.device).copy_(t)
        return tuple(map(fresh, got)) if isinstance(got, tuple) \
            else fresh(got)
    return plain


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper the decoder calls (:data:`HELD`) replaced by
    its plain torch version for the block (outputs in the kernels'
    strides), restored in a ``finally``: the decode launches no kernel."""
    with _swapped(lambda kern, ref, drop_xs: _plain(ref, drop_xs)):
        yield


def job_cases(mesh, args, run=run_case) -> None:
    """Every case of ``args.spec`` through ``run(mesh, case)`` (another
    job may pass its own, which returns (record, arrays) as
    :func:`run_case` does)."""
    with open(args.spec) as f:
        cases = json.load(f)["cases"]
    rank = dist.get_rank()
    out = Path(args.out)
    recs, saved = {}, {}
    for case in cases:
        rec, arrays = run(mesh, case)
        recs[case["name"]] = rec
        if rank == 0:
            saved |= {f"{case['name']}__{k}": v for k, v in arrays.items()}
    rec = {"rank": rank, "dp_rank": mesh.get_local_rank("dp"),
           "tp_rank": mesh.get_local_rank("tp"), "cases": recs}
    with open(out / f"rank{rank}.json", "w") as f:
        json.dump(rec, f)
    if rank == 0:
        np.savez(out / "rank0.npz", **saved)


JOBS = {"dryrun": job_dryrun, "cases": job_cases}


def _job(name: str):
    """A job of :data:`JOBS`, or ``FILE.py:FUNCTION``."""
    if name in JOBS:
        return JOBS[name]
    path, _, fn = name.rpartition(":")
    if not path.endswith(".py") or not fn:
        raise ValueError(f"job {name!r}: not one of {sorted(JOBS)} and not "
                         "FILE.py:FUNCTION")
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, fn)


def rank_main(args) -> None:
    """One rank: join the group, build the mesh, run the job. Any exception
    ends the process with exit code 1 at once, leaving the group as it
    is (a rank never goes on after a failed collective)."""
    from .batch import make_mesh

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    try:
        dist.init_process_group(
            args.backend, init_method=(f"file://{args.init_file}"
                                       if args.init_file else "env://"),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=args.collective_timeout))
        mesh = make_mesh(args.dp, args.tp, args.device)
        _job(args.job)(mesh, args)
    except BaseException:  # noqa: BLE001 -- the exit code carries it
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dp", type=int, required=True)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--init-file", help="FileStore file (one per run)")
    ap.add_argument("--out", required=True, help="directory of the results")
    ap.add_argument("--job", required=True,
                    help=f"one of {', '.join(JOBS)}, or FILE.py:FUNCTION")
    ap.add_argument("--spec", help="JSON list of cases (--job cases)")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds for the whole run (the parent)")
    ap.add_argument("--collective-timeout", type=float, default=60.0,
                    help="seconds for each collective (a rank)")
    args = ap.parse_args(argv)
    if "RANK" in os.environ:
        rank_main(args)
        return
    try:
        spawn(args.dp, args.tp, args.job, args.out, args.backend, args.device,
              args.spec, args.init_file, args.timeout,
              args.collective_timeout)
    except RankFailed as e:
        print(e, file=sys.stderr)
        sys.exit(1)
    print((Path(args.out) / "rank0.log").read_text(), end="")


if __name__ == "__main__":
    main()
