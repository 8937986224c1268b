"""Run one cell of ``BENCHMARK.json`` once and build its result line.

Everything is found by name: the cell's entry in ``BENCHMARK.json`` names
its configuration (``configs[].file``) and its traffic mix
(``benchmark/traffic/<traffic>.json``); the mix names the program's entry
the window drives (``benchmark/entries/<entry>.py``); each per-layer
metric is read by ``benchmark/metrics/<metric>.py``. A cell, a mix, an
entry or a metric is added by adding files and entries, without an edit.

An entry module has ``run(run: Run) -> dict``: it makes its inputs from the
seed, sets the program up and warms it, marks the window's start
(``run.window_started()``), drives the window, and returns its end-to-end
values, the answers the check compares and the request counts. Spans are
taken with ``run.spans(name)``; in a ``--trace 1`` run the entry takes the
traced slice with ``run.profiler`` and keeps it in ``run.trace``.

A metric module has ``read(run: Run) -> float | None``; None (nothing to
read in this run) leaves the metric out of the line.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

from . import check
from .roofline import FP32_FLOP_PER_S, HBM_BYTES_PER_S
from .source import load_json, load_source
from .trace import SPAN_PREFIX, Profiler

__all__ = ["Run", "Spans", "load_cell", "run_cell", "ROOT"]

ROOT = Path(__file__).resolve().parent.parent.parent
BENCH_DIR = "benchmark"


class Spans:
    """Seconds spent in each named span of the harness; inside a traced
    slice each span is also a ``record_function`` range."""

    def __init__(self):
        self.total: dict[str, float] = defaultdict(float)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = None
        if self.profiling:
            from torch.profiler import record_function
            rng = record_function(SPAN_PREFIX + name)
            rng.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.total[name] += time.perf_counter() - t0
            if rng is not None:
                rng.__exit__(None, None, None)

    def reset(self) -> None:
        self.total.clear()


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(root: Path, name: str) -> dict:
    """The cell ``name`` of ``root/BENCHMARK.json`` with everything it
    names: workload, configuration entry and file, traffic mix, entry
    module path, and its end-to-end and per-layer metric entries."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    traffic = load_json(root / BENCH_DIR / "traffic" / f"{cell['traffic']}.json")

    def mine(m):
        return name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if mine(m) is not False]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if mine(m) or (mine(m) is None and m["moves"] in moved)]
    return {"cell": cell, "config_entry": conf,
            "config": load_json(root / conf["file"]), "traffic": traffic,
            "entry": root / BENCH_DIR / "entries" / f"{traffic['entry']}.py",
            "end_to_end": e2e, "per_layer": per_layer,
            "metric_files": {m["name"]: root / BENCH_DIR / "metrics"
                             / f"{m['name']}.py" for m in per_layer}}


class Run:
    """What one run knows: the cell, its inputs, the window's spans and
    counters, the traced slice; the entry and the metric readers share it."""

    def __init__(self, root, spec, seed, seconds, trace, device, t_start,
                 out=sys.stdout):
        self.root = Path(root)
        self.name = spec["cell"]["name"]
        self.config = spec["config"]
        self.traffic = spec["traffic"]
        self.seed, self.seconds, self.trace_on = int(seed), seconds, trace
        self.device = device
        self.on_card = getattr(device, "type", str(device)) == "cuda"
        self.t_start = t_start
        self.t_window = None
        self.window_s = 0.0
        self.spans = Spans()
        self.counters: dict = {}
        self.batches: list[dict] = []
        self.trace = None  # the traced slice (trace.TraceSlice)
        self.profiler = Profiler() if (trace and self.on_card) else None
        self.source = load_source(self.root, self.config)
        self._out = out

    def log(self, msg: str) -> None:
        print(msg, file=self._out, flush=True)

    def window_started(self) -> None:
        self.t_window = time.perf_counter()
        self.spans.reset()


def _card_line(device) -> str:
    import torch

    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi not read"
    return (f"card: {name} | {smi} | peaks {HBM_BYTES_PER_S:.3g} B/s, "
            f"{FP32_FLOP_PER_S:.3g} FP32 FLOP/s (H100 SXM data sheet, 700 W)")


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, traffic_overrides: dict | None = None,
             out=sys.stdout, err=sys.stderr) -> dict:
    """One run of cell ``name``; returns the result line's object
    (``traffic_overrides``: mix parameters replaced, for a rehearsal at a
    tiny size)."""
    import torch

    spec = load_cell(Path(root), name)
    if traffic_overrides:
        spec["traffic"] = spec["traffic"] | traffic_overrides
    run = Run(root, spec, seed, seconds, trace, device, t_start, out)
    if run.on_card:
        run.log(_card_line(device))
        if run.profiler is not None:
            Profiler.warm(device)
    entry = load_module(spec["entry"], f"bench_entry_{spec['traffic']['entry']}")
    res = entry.run(run)
    device_info = {"platform": "gpu" if run.on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if run.on_card
                            else "cpu"),
                   "count": 1 if run.on_card else 0,
                   "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(
                       device)) if run.on_card else 0)}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    # the program's state is freed before the reference runs
    answers = res.pop("answers")
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()
    from ..reference.decode import Reference

    numbers = check.compare(answers, Reference())
    limits = run.config["limits"]
    correct = all(numbers[k] <= limits[k] for k in check.NUMBERS)

    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            mod = load_module(spec["metric_files"][m["name"]],
                              "bench_metric_" + m["name"].replace(".", "_"))
            v = mod.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(res["e2e"], setup_s=run.t_window - run.t_start)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(res["attempted"]),
              "failed": int(res["failed"]), "metrics": metrics,
              "device": device_info}
    if trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in check.NUMBERS}
    for k in check.NUMBERS:
        print(f"check {k} {numbers[k]} limit {limits[k]}", file=err,
              flush=True)
    return result
