"""The 5.1 configuration (``surround51_q3_44k``) and what the benchmark adds
for it: its frozen stream and golden, the reference against the golden,
the floor kernel's least work (``harness/floor_work.py``), the readers of
``floor_roofline.batch`` and ``deinterleave_share.batch`` on a stub run, and
a rehearsal of ``batch_surround51_q3`` on the CPU at a tiny size."""

from __future__ import annotations

import hashlib
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark.harness.core import ROOT, load_cell, load_module
from benchmark.harness.floor_work import floor_work, setup_geometry
from benchmark.harness.roofline import least_s
from benchmark.harness.source import load_json, load_source
from benchmark.harness.traffic import tiling_multiset
from benchmark.reference.decode import Reference
from benchmark.tests._cpu import rehearse

CELL = "batch_surround51_q3"
CONFIG = load_json(ROOT / "benchmark/configs/surround51_q3_44k.json")


def _reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                       "t_surround_" + name.replace(".", "_"))


def test_stream_and_golden_are_the_frozen_copies():
    for key in ("stream", "golden"):
        blob = (ROOT / CONFIG[key]).read_bytes()
        assert hashlib.sha256(blob).hexdigest() == CONFIG[key + "_sha256"]
        gate = ROOT / "tests/data/torch_gate" / (ROOT / CONFIG[key]).name
        assert gate.read_bytes() == blob
    assert CONFIG["reduced"] == []


def test_reference_within_1_lsb_of_libvorbis():
    data = (ROOT / CONFIG["stream"]).read_bytes()
    with np.load(ROOT / CONFIG["golden"]) as z:
        golden = z["pcm"]
    out = Reference().decode(data)
    assert out.shape == golden.shape == (44100, 6)
    assert np.abs(out.astype(np.int32) - golden).max() <= 1


def test_source_is_the_51_mode():
    src = load_source(ROOT, CONFIG)
    assert src.channels == 6 and src.rate == 44100
    assert len(src.cycle) == 58 and src.cycle_start == 3
    assert sorted(np.bincount(src.blocksize)[[256, 2048]]) == [17, 41]
    assert setup_geometry(src.ident, src.setup) == (896, 29, 4)
    mp = src.setup.mappings[0]
    assert mp.mux == [0, 0, 0, 0, 0, 1]
    assert list(zip(mp.coupling_magnitude, mp.coupling_angle)) == [
        (0, 2), (3, 4), (0, 1), (0, 3)]


def test_floor_work_by_hand():
    # w = 128 and 896; ops 3 w C + 2 w steps = 8 w; bytes 6 w + 5 P a
    # channel
    ops, moved = floor_work(np.array([256, 2048]), channels=2, w_eff=896,
                            posts=10, steps=1)
    assert ops == 8 * (128 + 896)
    assert moved == 2 * (6 * 128 + 50 + 6 * 896 + 50)
    # a narrower w_eff clips the long block
    ops, moved = floor_work(np.array([2048]), 1, 512, 2, 0)
    assert (ops, moved) == (3 * 512, 6 * 512 + 10)


def _run(kernel_s, trace=True):
    src = load_source(ROOT, CONFIG)
    return SimpleNamespace(
        trace=SimpleNamespace(kernel_s=kernel_s, window_s=5.0)
        if trace else None,
        traffic={"files": 1024, "tilings": [1, 10]}, source=src,
        profiler=SimpleNamespace(t0=100.0))


def test_floor_roofline_reader():
    read = _reader("floor_roofline.batch").read
    src = load_source(ROOT, CONFIG)
    cycles = int(tiling_multiset(1024, [1, 10]).sum())
    assert cycles == 5620
    least = least_s(floor_work(np.tile(src.blocksize, cycles), 6, 896, 29,
                               4))
    kernels = {"void floor_spectra_kernel<6, short>(float const*)": 0.004,
               "void floor_cd_kernel<6, short>(float const*)": 0.001,
               "ampere_sgemm_128x64_nn": 1.0}
    assert read(_run(kernels)) == pytest.approx(100.0 * least / 0.005)
    assert read(_run(kernels, trace=False)) is None
    assert read(_run({"ampere_sgemm_128x64_nn": 1.0})) is None


def test_deinterleave_reader(monkeypatch):
    from lewton_tpu_torch import profiling
    from lewton_tpu_torch.profiling import Count

    read = _reader("deinterleave_share.batch").read
    run = _run({})
    recs = [Count("frontend.busy_ns", 101.0, 400),
            Count("frontend.deinterleave_ns", 101.0, 30),
            Count("frontend.deinterleave_ns", 99.0, 999)]  # before the slice
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert read(run) == pytest.approx(100.0 * 30 / 400)
    assert read(_run({}, trace=False)) is None
    # a program without the counter (the parent of this metric): no reading
    monkeypatch.setattr(profiling, "records", lambda: recs[:1])
    assert read(run) is None


def test_cell_entries():
    spec = load_cell(ROOT, CELL)
    assert spec["cell"]["chips"] == 1
    assert spec["config"]["name"] == "surround51_q3_44k"
    assert [m["name"] for m in spec["end_to_end"]] == ["x_realtime",
                                                        "setup_s"]
    names = {m["name"] for m in spec["per_layer"]}
    assert {"deinterleave_share.batch", "floor_roofline.batch",
            "native_demux_share.batch", "imdct_roofline.batch",
            "device_idle.batch"} <= names
    assert len(names) == 11
    floor = next(m for m in spec["per_layer"]
                 if m["name"] == "floor_roofline.batch")
    assert floor["workloads"] == [CELL, "batch_music_q3"]


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(trace):
    res, out, err = rehearse(CELL, bool(trace))
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert res["check"]["max_lsb_diff"]["value"] <= 1
    assert res["check"]["length_mismatches"]["value"] == 0
    assert "58 packets from source packet 3" in out
    if trace:
        # no device and no tracer slice off the card
        assert not {"floor_roofline.batch", "deinterleave_share.batch",
                    "device_idle.batch"} & set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"x_realtime", "setup_s"}
