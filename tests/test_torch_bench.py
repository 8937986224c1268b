"""``lewton_tpu_torch.bench`` (the port's benchmark surfaces) against the
repository's ``bench.py`` on JAX on the CPU.

Each surface is called in-process with ``--cpu`` at a small size, and its
last stdout line is held to the reference's at the same arguments: the same
metric, unit and detail keys (the port adds ``device`` everywhere, and the
keys each test names), and the same counts of work: streams, audio seconds,
packets, and the transport's host-to-device and device-to-host bytes.
Times and rates differ (another program on another runtime) and are not
compared. The reference's ``--check`` has no size argument and decodes its
39 streams on JAX (minutes here), so the port's conformance line is held to
the names the reference prints (bench.py:467-476) on a subset of the gate.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import bench as ref_bench
from lewton_tpu_torch import bench
from lewton_tpu_torch.models import decoder
from lewton_tpu_torch.ops import windowing
from lewton_tpu_torch.parallel import launch
from test_torch_corpus import CORPUS  # noqa: F401 -- makes the corpus
from test_torch_native import build_reference_native  # noqa: F401

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every port line's detail names the device ("cpu" or the card's name)
ADDED = {"device"}


def last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def run_ref(monkeypatch, capsys):
    """The reference's bench.py main() at ``argv`` from the repository's
    root (it reads tests/data/corpus and builds its library there)."""
    def run(argv: list) -> dict:
        monkeypatch.chdir(ROOT)
        monkeypatch.setattr(sys, "argv", ["bench.py", *argv])
        capsys.readouterr()
        ref_bench.main()
        return last_line(capsys.readouterr().out)
    return run


@pytest.fixture
def run_port(capsys):
    """The port's bench main() at ``argv``: the returned line is the one it
    printed last."""
    def run(argv: list, **kw) -> dict:
        capsys.readouterr()
        got = bench.main(argv, **kw)
        assert last_line(capsys.readouterr().out) == got
        return got
    return run


def same_shape(port: dict, ref: dict, added: set) -> None:
    assert port["metric"] == ref["metric"]
    assert port["unit"] == ref["unit"]
    assert set(port) == set(ref)
    assert set(port["detail"]) == set(ref["detail"]) | added
    assert port["detail"]["platform"] == "cpu"
    assert port["detail"]["device"] == "cpu"
    # vs_baseline: x realtime over 10,000 (the front-end's packets/s at
    # 1024 samples a packet of 44.1 kHz audio)
    x_rt = port["value"] * (1024 / 44100.0 if port["unit"] == "packets_per_s"
                            else 1.0)
    assert port["vs_baseline"] == round(x_rt / 10000.0, 3)


@pytest.mark.parametrize("scan", [2, 0])
def test_synthesis_line(scan, run_ref, run_port, monkeypatch):
    """The headline at S=4, T=8, one timed call: the reference's scan line
    has no platform, wall or audio seconds, which the port records on both
    of its lines (added by design; the audio seconds are the reference's,
    read from its calls)."""
    import lewton_tpu.parallel.batch as jbatch

    samples = []
    name = "decode_chunks_scan" if scan else "decode_chunk_batch"
    orig = getattr(jbatch, name)

    def counted(*a, **kw):
        (outs, lens), carry = orig(*a, **kw)
        samples.append(int(np.asarray(lens).sum()))
        return (outs, lens), carry

    monkeypatch.setattr(jbatch, name, counted)
    argv = ["--cpu", "--streams", "4", "--chunk", "8", "--iters", "1",
            "--scan", str(scan)]
    ref = run_ref(argv)
    port = run_port(argv)
    added = ADDED | ({"platform", "wall_s", "audio_s"} if scan else set())
    same_shape(port, ref, added)
    for k in set(ref["detail"]) - {"wall_s", "packets_per_s", "audio_s"}:
        assert port["detail"][k] == ref["detail"][k], k
    # one warm-up and one timed call of the reference: its audio seconds
    assert len(samples) == 2 and samples[0] == samples[1]
    audio_s = samples[0] / 44100
    assert port["detail"]["audio_s"] == round(audio_s, 2)
    # packets / audio seconds = packets_per_s / value on both lines, within
    # the rounding of the two printed rates (half a unit of their last
    # digit): both count S x T x max(scan, 1) x iters packets
    want = 4 * 8 * max(scan, 1) * 1 / audio_s
    for line in (ref, port):
        pps, value = line["detail"]["packets_per_s"], line["value"]
        rel = 0.05 / value + 0.05 / pps
        assert pps / value == pytest.approx(want, rel=rel * 1.01)


def test_e2e_line(run_ref, run_port):
    """File to PCM on 2 streams of ~30 s (i16 transport on the CPU,
    compaction on the device, scan 8): the same audio and bytes."""
    argv = ["--cpu", "--e2e", "--streams", "2"]
    ref = run_ref(argv)
    port = run_port(argv)
    same_shape(port, ref, ADDED)
    for k in ("streams", "audio_s", "h2d_bytes", "d2h_bytes"):
        assert port["detail"][k] == ref["detail"][k], k


def test_serve_line(run_ref, run_port):
    """The scheduler on 2 streams over three setups: the same audio, bytes
    and latency fields."""
    argv = ["--cpu", "--serve", "--streams", "2"]
    ref = run_ref(argv)
    port = run_port(argv)
    same_shape(port, ref, ADDED)
    for k in ("streams", "setups", "audio_s", "h2d_bytes", "d2h_bytes"):
        assert port["detail"][k] == ref["detail"][k], k
    lat = {k: v["detail"]["latency"] for k, v in (("ref", ref),
                                                   ("port", port))}
    assert lat["port"]["streams"] == lat["ref"]["streams"] == 2
    for k in ("first_pcm", "turnaround"):
        assert set(lat["port"][k]) == set(lat["ref"][k])


def test_frontend_line(run_ref, run_port, monkeypatch):
    """The native front-end alone: the same thread points, cores and
    fields. The port's seconds per point are a parameter (0.05 s here); the
    reference's 3 s are cut by a clock that runs 100 times fast for its
    call. The reference's line has no platform (the port's has)."""
    port = run_port(["--cpu", "--frontend"], frontend_seconds=0.05)
    real = time.perf_counter
    monkeypatch.setattr(time, "perf_counter", lambda: 100.0 * real())
    ref = run_ref(["--cpu", "--frontend"])
    monkeypatch.setattr(time, "perf_counter", real)
    same_shape(port, ref, ADDED | {"platform"})
    for k in ("cores", "one_core_host", "scaling_note"):
        assert port["detail"][k] == ref["detail"][k], k
    assert set(port["detail"]["per_thread_rates"]) == \
        set(ref["detail"]["per_thread_rates"])
    assert port["detail"]["p12_emit_packets_per_s"] > 0
    assert ref["detail"]["p12_emit_packets_per_s"] > 0


#: the reference's conformance line (bench.py:467-476) and its permutations
#: (bench.py:367-466), xla_fallback's place taken by the port's "plain"
REF_CHECK_DETAIL = {"platform", "samples_over_2lsb", "production_permutations"}
REF_PERMUTATIONS = {"scan8_p12_device", "scan16_p12_device", "scan16_i16_host",
                    "xla_fallback", "serve_scan8"}
#: one gate stream of each kind: corpus, crafted floor 1, floor 0, chained
CHECK_NAMES = ["stereo_44k_q3", "f1_bs8192", "f0_coupled_stereo",
               "chained_44k"]


def test_check_line(run_port):
    """--check on 4 gate streams and every permutation: at most 2 LSB from
    the golden, 0 samples over, under the reference's names; the port's
    detail adds the stream count, the stream left out of the gate and the
    single-stream programs' stats."""
    port = run_port(["--cpu", "--check"], check_names=CHECK_NAMES)
    assert port["metric"] == "conformance_max_lsb_diff"
    assert port["unit"] == "i16_lsb"
    assert port["value"] <= 2 and port["vs_baseline"] == 1.0
    d = port["detail"]
    assert set(d) == REF_CHECK_DETAIL | ADDED | {"streams", "left_out",
                                                 "stream_programs"}
    assert d["stream_programs"]["programs"] >= 1
    assert d["samples_over_2lsb"] == 0 and d["streams"] == len(CHECK_NAMES)
    assert set(d["production_permutations"]) == (
        REF_PERMUTATIONS - {"xla_fallback"}) | {"plain"}
    for r in d["production_permutations"].values():
        assert r["maxdiff"] <= 2 and r["samples_over_2lsb"] == 0
    assert set(d["left_out"]) == {"long_44k_q2"}


def test_check_streams_are_the_references():
    """The gate's 38 streams are the reference's 17 corpus names and 22
    crafted names (its craft variants and four floor-0 streams), less the
    one the manifest leaves out; each file is held to its sha256."""
    from tools import corpus
    from tools.craft import VARIANTS

    manifest = bench.gate_manifest()
    ref = ({n for n, _ in corpus.SPECS} | set(VARIANTS)
           | {"f0_restype0", "f0_coupled_stereo", "f0_two_books",
              "f0_max_amp"})
    assert len(ref) == 17 + 22
    assert set(manifest["streams"]) == ref - set(manifest["left_out"])
    assert len(manifest["streams"]) == 38
    assert set(bench.gate_streams(bench.PERM_CASES)) == set(bench.PERM_CASES)


def test_plain_kernels_swaps_and_restores():
    """launch.plain_kernels() puts every kernel wrapper's plain version in its
    place and restores the wrappers in a finally, also after a raise; the
    stand-ins' outputs have the kernels' (contiguous) strides."""
    before = (decoder.floor_spectra, decoder.fused_floor_couple,
              windowing.overlap_i16, windowing.overlap_i16_split,
              windowing.overlap_i16_audio)
    with pytest.raises(KeyError):
        with launch.plain_kernels():
            assert decoder.floor_spectra is not before[0]
            assert windowing.overlap_i16 is not before[2]
            raise KeyError("inside")
    assert (decoder.floor_spectra, decoder.fused_floor_couple,
            windowing.overlap_i16, windowing.overlap_i16_split,
            windowing.overlap_i16_audio) == before
    ref = lambda a, b: a.reshape(4, 1, 3).expand(4, 1, 3)  # noqa: E731
    out = launch._plain(ref, drop_xs=False)(torch.arange(12.0), None)
    assert out.is_contiguous() and out.stride() == (3, 3, 1)


def test_link_detail_is_the_references():
    """The transfer fields of the e2e and serve lines: the reference's
    formula on the same counts, and a probe that measures both ways."""
    args = (14972160, 13107200, 60.4, 1.25, (4000.0, 3500.0))
    assert bench._link_detail(*args) == ref_bench._link_detail(*args)
    h2d, d2h = bench.probe_link(torch.device("cpu"), mb=1, reps=2)
    assert h2d > 0 and d2h > 0
