"""Each cell rehearsed on the CPU at a tiny size through the harness's own
code: a result line of the contract's shape, ``correct`` true, and no
device metric (no trace off the card); then the no-JAX check of a run's
whole import graph, and the refusal without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness.core import ROOT, load_cell
from benchmark.tests._cpu import rehearse
from benchmark.tests.test_bench_files import CELLS

DEVICE_METRICS = ("device_idle", "imdct_roofline")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(cell, trace):
    res, out, err = rehearse(cell, bool(trace))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert res["device"]["platform"] == "cpu" and "busy_s" not in res["device"]
    assert "breakdown" not in res
    spec = load_cell(ROOT, cell)
    if trace:
        assert not any(k.startswith(DEVICE_METRICS) for k in res["metrics"])
        want = {m["name"] for m in spec["per_layer"]
                if not m["name"].startswith(DEVICE_METRICS)}
        assert set(res["metrics"]) == want
    else:
        assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    assert err.strip().splitlines()[-len(res["check"]):] == [
        f"check {k} {v['value']} limit {v['limit']}"
        for k, v in res["check"].items()]
    json.dumps(res)


_GRAPH = """
import sys, torch
sys.path.insert(0, sys.argv[1])
import benchmark.run as run
from benchmark.tests._cpu import rehearse
for cell in sys.argv[2:]:
    assert rehearse(cell)[0]["correct"]
print(run.forbidden_modules(), "lewton_tpu_torch" in sys.modules)
"""


def test_no_jax_in_a_runs_import_graph():
    """A batch and a serve cell run in one process import no module whose
    top-level name, compared whole, is jax, jaxlib, flax or lewton_tpu
    (lewton_tpu_torch is the program)."""
    out = subprocess.run(
        [sys.executable, "-c", _GRAPH, str(ROOT), "batch_music_q3",
         "serve_speech_16k"], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compared_whole(monkeypatch):
    import benchmark.run as run

    monkeypatch.setitem(sys.modules, "lewton_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxy.sub", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "batch_music_q3",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_one_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "batch_music_q3",
         "--seed", str(2 ** 33 + 1), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
