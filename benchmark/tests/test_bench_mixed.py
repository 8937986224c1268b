"""The mixed-setup configuration (``mixed_corpus_4setups``) and what the
benchmark adds for it: its four frozen streams, the cell's entries, the
entry's file maker, a rehearsal of ``batch_mixed_setups`` on the CPU at a
tiny size, the control (``control_mixed.py``) against the limits, and the
reader of ``setup_switch_share.batch``."""

from __future__ import annotations

import hashlib
import io
import time
from collections import Counter
from types import SimpleNamespace

import pytest

from benchmark.harness import core
from benchmark.harness.core import ROOT, load_cell, load_module, run_cell
from benchmark.harness.source import load_json
from benchmark.harness.traffic import tiling_multiset

CELL = "batch_mixed_setups"
CONFIG = load_json(ROOT / "benchmark/configs/mixed_corpus_4setups.json")
SINGLE = ("music_q3_44k_stereo", "speech_q3_16k_mono", "surround51_q3_44k",
          "surround71_q4_44k")
TINY = {"files": 8, "tilings": [1, 2], "check_files": 8}
SEED = 2 ** 31 + 4242


def _entry():
    return load_module(ROOT / "benchmark/entries/batch_mixed.py",
                       "t_mixed_entry")


def _reader():
    return load_module(ROOT / "benchmark/metrics/setup_switch_share.batch.py",
                       "t_mixed_setup_switch_share")


def test_streams_are_the_single_setup_configurations_files():
    assert [s["name"] for s in CONFIG["streams"]] == list(SINGLE)
    for s in CONFIG["streams"]:
        one = load_json(ROOT / f"benchmark/configs/{s['name']}.json")
        assert s["share"] == 0.25
        for key in ("stream", "golden"):
            assert s[key] == one[key]
            assert s[key + "_sha256"] == one[key + "_sha256"]
            blob = (ROOT / s[key]).read_bytes()
            assert hashlib.sha256(blob).hexdigest() == s[key + "_sha256"]
    music = load_json(ROOT / "benchmark/configs/music_q3_44k_stereo.json")
    for key in ("stream", "stream_sha256", "golden", "golden_sha256"):
        assert CONFIG[key] == music[key]
    assert CONFIG["reduced"] == [] and len(CONFIG["source"]) <= 200
    assert CONFIG["limits"]["length_mismatches"] == 0
    assert CONFIG["limits"]["missing"] == 0


def test_cell_entries():
    spec = load_cell(ROOT, CELL)
    assert spec["cell"]["chips"] == 1
    assert spec["cell"]["traffic"] == "closed_b1024_mixed4_t1to10"
    assert spec["config"]["name"] == "mixed_corpus_4setups"
    assert spec["traffic"]["entry"] == "batch_mixed"
    assert [m["name"] for m in spec["end_to_end"]] == ["x_realtime",
                                                        "setup_s"]
    assert {m["name"] for m in spec["per_layer"]} == {
        "native_demux_share.batch", "frontend_share.batch",
        "h2d_bytes_per_audio_s.batch", "imdct_roofline.batch",
        "device_idle.batch", "pack_share.batch", "compact_share.batch",
        "slot_fill.batch", "frontend_thread_fill.batch",
        "setup_switch_share.batch"}
    m = next(m for m in spec["per_layer"]
             if m["name"] == "setup_switch_share.batch")
    assert (m["workloads"], m["moves"], m["source"], m["unit"]) == (
        [CELL], "x_realtime", "program_span", "%")


def test_file_maker_same_lengths_every_seed():
    """256 files a setup, each 1-10 whole cycles of its source, 25-26 of
    each length; the same multiset of lengths every seed, other files."""
    entry = _entry()
    spec = load_cell(ROOT, CELL)
    srcs = entry.sources(ROOT, spec["config"])
    made = {seed: entry.corpus(srcs, spec["traffic"], seed)
            for seed in (SEED, 2 ** 33 + 7)}
    want = sorted(tiling_multiset(256, [1, 10]).tolist())
    for files, sample in made.values():
        assert len(files) == 1024 and len(sample) == 48
        for k, src in enumerate(srcs):
            mine = [f for s, f in files if s == k]
            assert sorted(f.tilings for f in mine) == want
            assert set(Counter(f.tilings for f in mine).values()) == {25, 26}
            assert all(f.packets == f.tilings * len(src.cycle)
                       for f in mine)
            picked = [files[i][1] for i in sample if files[i][0] == k]
            assert len(picked) == 12
            longest = max(f.packets for f in mine)
            assert sum(f.packets == longest for f in picked) >= 3
    (a, _), (b, _) = made.values()
    assert [f.data for _, f in a] != [f.data for _, f in b]


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal(trace):
    out, err = io.StringIO(), io.StringIO()
    import torch

    res = run_cell(ROOT, CELL, SEED, 1.0, bool(trace), torch.device("cpu"),
                   time.perf_counter(), TINY, out=out, err=err)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and res["device"]["platform"] == "cpu"
    assert res["check"]["max_lsb_diff"]["value"] <= 1
    assert res["check"]["length_mismatches"]["value"] == 0
    text = out.getvalue()
    for n in (187, 55, 58, 49):
        assert f"cycle {n} packets" in text
    assert "4 decoders" in text and "decoders made in the window 0" in text
    if trace:
        # off the card no device metric and no tracer slice
        assert set(res["metrics"]) == {"native_demux_share.batch",
                                       "frontend_share.batch",
                                       "h2d_bytes_per_audio_s.batch"}
    else:
        assert set(res["metrics"]) == {"x_realtime", "setup_s"}


def test_control_exceeds_both_limits(monkeypatch):
    """The TF32 control on the cell's own files at a smaller size (8 files
    a setup, 8 compared): above both limits."""
    control = load_module(ROOT / "benchmark/control_mixed.py",
                          "t_control_mixed")
    real = core.load_cell

    def smaller(root, name):
        spec = real(root, name)
        spec["traffic"] = spec["traffic"] | {"files": 32, "check_files": 32}
        return spec

    monkeypatch.setattr(core, "load_cell", smaller)
    got = control.readings(CELL, SEED)
    limits = CONFIG["limits"]
    assert got["all"]["max_lsb_diff"] > limits["max_lsb_diff"]
    assert got["all"]["differ_ppm"] > limits["differ_ppm"]
    assert set(got) == {"all", *SINGLE}


def _run(trace=True):
    return SimpleNamespace(
        trace=SimpleNamespace(window_s=5.0) if trace else None,
        profiler=SimpleNamespace(t0=100.0))


def test_setup_switch_reader(monkeypatch):
    from lewton_tpu_torch import profiling
    from lewton_tpu_torch.profiling import Count, Span

    read = _reader().read
    recs = [Span("wait", 101.0, 101.1, "batch.setup_switch", None),
            Span("batch.setup_switch", 101.0, 101.25, "batch.mixed", 1),
            Span("batch.setup_switch", 104.9, 105.2, "batch.mixed", 2),
            Span("batch.setup_switch", 98.0, 99.0, "batch.mixed", 3),
            Span("batch.mixed", 100.5, 106.0, None, 1),
            Count("batch.setups", 101.0, 4)]
    monkeypatch.setattr(profiling, "records", lambda: list(recs))
    # children counted; clipped to the slice [100, 105]
    assert read(_run()) == pytest.approx(100.0 * (0.25 + 0.1) / 5.0)
    # off the card (no traced slice): None
    assert read(_run(trace=False)) is None
    # a program without the mixed path (the parent): None
    monkeypatch.setattr(profiling, "records", lambda: recs[4:])
    assert read(_run()) is None
    monkeypatch.delattr(profiling, "records")
    assert read(_run()) is None
