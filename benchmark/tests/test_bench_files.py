"""BENCHMARK.json against the contract's shape, every file it names, the
data-driven lookup (a cell and a metric added as files alone), and the
seeded generator."""

from __future__ import annotations

import hashlib
import json
import re
import shutil

import numpy as np
import pytest

from benchmark.harness import traffic
from benchmark.harness.core import ROOT, load_cell, load_module
from benchmark.harness.source import load_json, load_source
from benchmark.reference.ogg_demux import PacketReader

BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert (ROOT / BENCH["command"][1]).is_file()


def test_names_units_and_keys():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names), group
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
        for w in m.get("workloads", []):
            assert w in CELLS
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_names_existing_files(cell):
    spec = load_cell(ROOT, cell)
    w = spec["cell"]
    assert w["chips"] == 1 and len(w["why"]) <= 200
    assert spec["entry"].is_file()
    assert (ROOT / spec["config_entry"]["file"]).is_file()
    # every cell reports setup_s, another end-to-end metric and a per-layer
    # metric, each per-layer metric moving one of the cell's metrics
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in names
        mod = load_module(spec["metric_files"][m["name"]], "t_" + m["name"])
        assert callable(mod.read)
    load_module(spec["entry"], "t_entry")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    c = load_json(ROOT / conf["file"])
    assert c["name"] == conf["name"] and c["reduced"] == conf["reduced"]
    for key in ("stream", "golden"):
        blob = (ROOT / c[key]).read_bytes()
        assert hashlib.sha256(blob).hexdigest() == c[key + "_sha256"]
    assert set(c["limits"]) == {"max_lsb_diff", "differ_ppm",
                                "length_mismatches", "missing"}
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


def test_dummy_cell_and_metric_as_files(tmp_path):
    """A later PR adds a traffic mix, a metric and their entries without
    editing a file of the harness: the harness finds them by name."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*")
              if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    mix = load_json(ROOT / "benchmark/traffic/closed_b1024_t1to10.json")
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(
        json.dumps(mix | {"files": 3}))
    (tmp_path / "benchmark/metrics/dummy_share.batch.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["workloads"].append({"name": "dummy_cell",
                               "config": "music_q3_44k_stereo",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "dummy_share.batch", "unit": "%",
                               "better": "lower", "source": "program_span",
                               "layer": "a test", "moves": "x_realtime",
                               "workloads": ["dummy_cell"]})
    bench["end_to_end"][0]["workloads"].append("dummy_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = load_cell(tmp_path, "dummy_cell")
    assert spec["traffic"]["files"] == 3
    assert [m["name"] for m in spec["per_layer"]] == ["dummy_share.batch"]
    mod = load_module(spec["metric_files"]["dummy_share.batch"], "t_dummy")
    assert mod.read(None) == 42.0
    for p, blob in before.items():
        assert p.read_bytes() == blob, p


@pytest.mark.parametrize("conf", ["music_q3_44k_stereo", "speech_q3_16k_mono"])
def test_seeded_files(conf):
    src = load_source(ROOT, load_json(ROOT / f"benchmark/configs/{conf}.json"))
    a = traffic.make_files(src, 6, [1, 3], 2 ** 40 + 5)
    b = traffic.make_files(src, 6, [1, 3], 2 ** 40 + 5)
    c = traffic.make_files(src, 6, [1, 3], 2 ** 40 + 6)
    assert [f.data for f in a] == [f.data for f in b]
    assert [f.data for f in a] != [f.data for f in c]
    # the same work for every seed: the multiset of lengths
    assert sorted(f.tilings for f in a) == sorted(f.tilings for f in c)
    for f in a:
        rdr = PacketReader(f.data)  # checks every page's CRC
        pcks = []
        while (p := rdr.read_packet()) is not None:
            pcks.append(p)
        assert len(pcks) == 3 + f.packets == 3 + f.tilings * len(src.cycle)
        assert pcks[-1].last_in_stream and pcks[-1].absgp_page == f.samples


def test_rounds_hold_every_length_in_another_order():
    src = load_source(ROOT, load_json(
        ROOT / "benchmark/configs/speech_q3_16k_mono.json"))
    pool = traffic.make_files(src, 12, [1, 4], 3)
    a, b = (traffic.rounds(pool, s) for s in (3, 4))
    qa = [next(a) for _ in range(40)]
    qb = [next(b) for _ in range(40)]
    assert qa != qb
    for q in (qa, qb):
        for r in range(10):  # each round one file of every length
            assert sorted(pool[i].tilings for i in q[4 * r:4 * r + 4]) == [
                1, 2, 3, 4]
        assert set(q) == set(range(12))  # every file of the pool in turn


@pytest.mark.parametrize("conf", ["music_q3_44k_stereo", "speech_q3_16k_mono"])
def test_written_packets_read_back(conf):
    """The reference's Ogg reader gives back exactly the packets a file was
    made of, in order, each page with the granule of its last packet."""
    src = load_source(ROOT, load_json(ROOT / f"benchmark/configs/{conf}.json"))
    L = len(src.cycle)
    for rot, tilings, serial in ((0, 1, 7), (L // 3, 2, 2 ** 31 + 9),
                                 (L - 1, 3, 5)):
        f = src.make_file(rot, tilings, serial)
        idx = (rot + np.arange(tilings * L)) % L
        want = src.headers + [src.cycle[i] for i in idx]
        dec = src.decoded[idx].copy()
        dec[0] = 0
        granules = [0, 0, 0] + np.cumsum(dec).tolist()
        rdr = PacketReader(f.data)
        got = []
        while (p := rdr.read_packet()) is not None:
            got.append(p)
        assert [p.data for p in got] == want
        assert all(p.stream_serial == serial for p in got)
        ends = [i for i, p in enumerate(got) if p.last_in_page]
        assert ends[-1] == len(got) - 1
        for i in ends:
            assert got[i].absgp_page == granules[i], i
        assert granules[-1] == f.samples


def test_check_sample_holds_the_longest():
    src = load_source(ROOT, load_json(
        ROOT / "benchmark/configs/speech_q3_16k_mono.json"))
    files = traffic.make_files(src, 40, [1, 8], 9)
    pick = traffic.check_sample(files, 8, 9)
    assert len(pick) == len(set(pick)) == 8
    longest = max(f.packets for f in files)
    assert any(files[i].packets == longest for i in pick)
