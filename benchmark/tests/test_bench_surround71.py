"""The 7.1 configuration (``surround71_q4_44k``) and what the benchmark adds
for it: its frozen stream and golden, the reference against the golden,
the source's uncoupled mode, the floor kernel's least work at no coupling
step, the reader of ``residue01_share.batch`` on a stub run, the cell's
entries, and a rehearsal of ``batch_surround71_q4`` on the CPU at a tiny
size."""

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

CELL = "batch_surround71_q4"
CONFIG = load_json(ROOT / "benchmark/configs/surround71_q4_44k.json")


def _reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                       "t_surround71_" + name.replace(".", "_"))


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
    assert out.shape == golden.shape == (35280, 8)
    assert np.abs(out.astype(np.int32) - golden).max() <= 1


def test_source_is_the_uncoupled_71_mode():
    src = load_source(ROOT, CONFIG)
    assert src.channels == 8 and src.rate == 44100
    assert len(src.cycle) == 49 and src.cycle_start == 3
    assert list(np.bincount(src.blocksize)[[256, 2048]]) == [17, 32]
    assert int(src.decoded.sum()) == 34944
    assert setup_geometry(src.ident, src.setup) == (896, 29, 0)
    for mp in src.setup.mappings:
        assert mp.mux == [0] * 8 and len(mp.submap_residue) == 1
        assert mp.coupling_magnitude == [] == mp.coupling_angle
    assert [(r.residue_type, r.end, r.partition_size, r.classifications)
            for r in src.setup.residues] == [(1, 112, 16, 8), (1, 896, 32, 8)]


def test_floor_work_by_hand_at_no_step():
    # w = 128 and 896; ops 3 w C; bytes 6 w + 5 P a channel
    ops, moved = floor_work(np.array([256, 2048]), channels=8, w_eff=896,
                            posts=29, steps=0)
    assert ops == 3 * 8 * (128 + 896)
    assert moved == 8 * (6 * 128 + 5 * 29 + 6 * 896 + 5 * 29)


def _run(kernel_s, trace=True):
    src = load_source(ROOT, CONFIG)
    return SimpleNamespace(
        trace=SimpleNamespace(kernel_s=kernel_s, window_s=5.0)
        if trace else None,
        traffic={"files": 1024, "tilings": [1, 10]}, source=src,
        profiler=SimpleNamespace(t0=100.0))


def test_floor_roofline_reader_at_8_channels():
    read = _reader("floor_roofline.batch").read
    src = load_source(ROOT, CONFIG)
    cycles = int(tiling_multiset(1024, [1, 10]).sum())
    least = least_s(floor_work(np.tile(src.blocksize, cycles), 8, 896, 29,
                               0))
    kernels = {"void floor_spectra_kernel<8, short>(float const*)": 0.004,
               "ampere_sgemm_128x64_nn": 1.0}
    assert read(_run(kernels)) == pytest.approx(100.0 * least / 0.004)


def test_residue01_reader(monkeypatch):
    from lewton_tpu_torch import profiling
    from lewton_tpu_torch.profiling import Count

    read = _reader("residue01_share.batch").read
    run = _run({})
    recs = [Count("frontend.busy_ns", 101.0, 400),
            Count("frontend.residue01_ns", 101.0, 260),
            Count("frontend.residue01_ns", 99.0, 999)]  # before the slice
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    assert read(run) == pytest.approx(100.0 * 260 / 400)
    assert read(_run({}, trace=False)) is None
    # a program without the counter (the parent of this metric): no reading
    monkeypatch.setattr(profiling, "records", lambda: recs[:1])
    assert read(run) is None


def test_cell_entries():
    spec = load_cell(ROOT, CELL)
    assert spec["cell"]["chips"] == 1
    assert spec["cell"]["traffic"] == "closed_b1024_t1to10"
    assert spec["config"]["name"] == "surround71_q4_44k"
    assert [m["name"] for m in spec["end_to_end"]] == ["x_realtime",
                                                        "setup_s"]
    names = {m["name"] for m in spec["per_layer"]}
    assert names == {
        "native_demux_share.batch", "frontend_share.batch",
        "h2d_bytes_per_audio_s.batch", "imdct_roofline.batch",
        "device_idle.batch", "pack_share.batch", "compact_share.batch",
        "slot_fill.batch", "frontend_thread_fill.batch",
        "floor_roofline.batch", "residue01_share.batch"}
    r01 = next(m for m in spec["per_layer"]
               if m["name"] == "residue01_share.batch")
    assert (r01["workloads"], r01["moves"], r01["source"]) == (
        [CELL], "x_realtime", "program_counter")


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(trace):
    res, out, err = rehearse(CELL, bool(trace))
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    assert res["check"]["max_lsb_diff"]["value"] <= 1
    assert res["check"]["length_mismatches"]["value"] == 0
    assert "49 packets from source packet 3" in out
    if trace:
        # no device and no tracer slice off the card
        assert not {"floor_roofline.batch", "residue01_share.batch",
                    "device_idle.batch"} & set(res["metrics"])
    else:
        assert set(res["metrics"]) == {"x_realtime", "setup_s"}
