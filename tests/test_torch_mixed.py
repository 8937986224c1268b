"""``MixedBatchDecoder``: one batch of streams encoded at the four setups of
the benchmark (music ``-q 3``, 16 kHz speech, 5.1 ``-q 3``, 7.1 ``-q 4``),
each stream a seeded run of its source's packet cycle, decoded on the CPU.

- The outputs, in the caller's order, equal bit for bit each setup's own
  ``BatchDecoder`` on that setup's streams, whatever the order of the
  batch (grouped, shuffled, alternating, one setup only, a setup with a
  single stream), at scan 1 and 2 and both compactions.
- The answers are within the configuration's limits of the plain NumPy
  reference (``benchmark/reference/decode.py``) and within 1 i16 LSB of
  the plain-torch device half (``benchmark/reference/synth_torch.py``,
  whose f64 IMDCT the port's f32 GEMM meets within its sum-order bound;
  the i16 truncation of two values that close can differ by one).
- The pipeline runs across a switch of setup: the next setup's first
  group is dispatched before the previous setup's last group is
  finished; one group loop drives both decoders.
- A second call parses and compiles nothing; traced, the spans
  ``batch.mixed`` and ``batch.setup_switch`` and the counters
  ``batch.setups`` and ``batch.setup_compiles`` are recorded; a header
  pair that does not parse raises ``BadHeader``.
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import check
from benchmark.harness.core import ROOT
from benchmark.harness.source import load_json, load_source
from benchmark.reference import synth_torch
from benchmark.reference.decode import Reference
from lewton_tpu_torch import native, profiling
from lewton_tpu_torch.errors import BadHeader
from lewton_tpu_torch.header import read_header_ident, read_header_setup
from lewton_tpu_torch.parallel import batch
from lewton_tpu_torch.parallel.batch import BatchDecoder, MixedBatchDecoder

torch.set_num_threads(1)

CONFIGS = ("music_q3_44k_stereo", "speech_q3_16k_mono", "surround51_q3_44k",
           "surround71_q4_44k")
#: packets of each setup's streams (a run of the source's cycle each)
PACKETS = {"music_q3_44k_stereo": (40, 9, 23),
           "speech_q3_16k_mono": (33, 12),
           "surround51_q3_44k": (7, 35, 18),
           "surround71_q4_44k": (26, 5)}
CHUNK = 8
SEED = 2 ** 31 + 26


def _config(name):
    return load_json(ROOT / f"benchmark/configs/{name}.json")


@functools.cache
def _files():
    """(setup index, file bytes) of every stream, grouped by setup."""
    rng = np.random.default_rng(SEED)
    out = []
    for k, name in enumerate(CONFIGS):
        src = load_source(ROOT, _config(name))
        for n in PACKETS[name]:
            rot, serial = rng.integers(len(src.cycle)), rng.integers(2 ** 32)
            f = src.make_file(int(rot), 1, int(serial), packets=n)
            out.append((k, f.data))
    return out


def _demuxed(data):
    pk = native.demux_spans(data)[0]
    return (pk[0], pk[2]), pk[3:]


def _key(k):
    """The header pair of setup ``k``."""
    files = _files()
    return _demuxed(next(d for s, d in files if s == k))[0]


def _order(kind):
    files = _files()
    idx = list(range(len(files)))
    by_setup = [[i for i in idx if files[i][0] == k] for k in range(4)]
    if kind == "grouped":
        return idx
    if kind == "shuffled":
        return list(np.random.default_rng(SEED + 1).permutation(idx))
    if kind == "alternating":
        return [i for row in zip(*by_setup) for i in row] + [
            i for row in by_setup for i in row[2:]]
    if kind == "one_setup":
        return by_setup[2][::-1]
    if kind == "single_stream_setup":  # speech has one stream here
        return by_setup[0] + by_setup[1][:1] + by_setup[3]
    raise ValueError(kind)


ORDERS = ("grouped", "shuffled", "alternating", "one_setup",
          "single_stream_setup")


@functools.cache
def _mixed(scan):
    return MixedBatchDecoder(chunk=CHUNK, scan=scan, device="cpu")


@functools.cache
def _own(scan, compact):
    """Each file's PCM through its setup's own BatchDecoder, all of the
    setup's streams in one call."""
    files = _files()
    out = {}
    for k in range(4):
        idx = [i for i, (s, _) in enumerate(files) if s == k]
        ident, setup = _key(k)
        hi = read_header_ident(ident)
        dec = BatchDecoder(hi, read_header_setup(setup, hi), chunk=CHUNK,
                           scan=scan, raw_headers=(ident, setup),
                           device="cpu")
        pcm = dec.decode_streams_i16([_demuxed(files[i][1])[1] for i in idx],
                                     compact=compact)
        out.update(zip(idx, pcm))
    return out


def _decode(dec, order, compact="device"):
    files = _files()
    pairs = [_demuxed(files[i][1]) for i in order]
    return dec.decode_streams_i16([s for _, s in pairs],
                                  [h for h, _ in pairs], compact=compact)


@pytest.mark.parametrize("compact", ["device", "host"])
@pytest.mark.parametrize("scan", [1, 2])
@pytest.mark.parametrize("kind", ORDERS)
def test_equals_each_setups_own_decoder(kind, scan, compact):
    order = _order(kind)
    got = _decode(_mixed(scan), order, compact)
    own = _own(scan, compact)
    assert len(got) == len(order)
    for i, pcm in zip(order, got):
        want = own[i]
        assert pcm.dtype == np.int16 and pcm.shape == want.shape
        assert np.array_equal(pcm, want), i


def test_within_the_configurations_limits_of_the_reference():
    files = _files()
    order = _order("shuffled")
    got = _decode(_mixed(1), order)
    for k, name in enumerate(CONFIGS):
        limits = _config(name)["limits"]
        answers = [(files[i][1], [pcm]) for i, pcm in zip(order, got)
                   if files[i][0] == k]
        numbers = check.compare(answers, Reference())
        assert all(numbers[n] <= limits[n] for n in check.NUMBERS), numbers
        assert numbers["max_lsb_diff"] <= 1


def test_within_1_lsb_of_the_plain_torch_device_half():
    files = _files()
    order = _order("alternating")
    got = _decode(_mixed(2), order)
    for i, pcm in zip(order, got):
        want = synth_torch.decode(files[i][1], device="cpu")
        assert pcm.shape == want.shape
        assert np.abs(pcm.astype(np.int32) - want).max() <= 1


def test_a_switch_does_not_drain_the_pipeline(monkeypatch):
    """The order of dispatches and finishes over a grouped batch: each
    setup's first group is dispatched before the last group of the setup
    before it is finished, and every group is finished once."""
    events = []
    dispatch = batch.TransferSlots.dispatch
    finish = batch.BatchDecoder._finish

    def spy_dispatch(slots, *args, **kw):
        events.append(("dispatch", slots))
        return dispatch(slots, *args, **kw)

    def spy_finish(dec, *args, **kw):
        events.append(("finish", dec._slots))
        return finish(dec, *args, **kw)

    loops = []
    monkeypatch.setattr(batch.TransferSlots, "dispatch", spy_dispatch)
    monkeypatch.setattr(batch.BatchDecoder, "_finish", spy_finish)
    monkeypatch.setattr(batch, "_decode_groups", lambda *a: loops.append(a)
                        or _decode_groups(*a))
    dec = _mixed(1)
    _decode(dec, _order("grouped"))
    slots = [dec.decoders[_key(k)]._slots for k in range(4)]
    assert len(loops) == 1
    owner = [slots.index(s) for _, s in events]
    assert [k for k, _ in events].count("dispatch") == [
        k for k, _ in events].count("finish")
    for a in range(3):
        last_finish = max(j for j, (k, _) in enumerate(events)
                          if k == "finish" and owner[j] == a)
        first_dispatch = min(j for j, (k, _) in enumerate(events)
                             if k == "dispatch" and owner[j] == a + 1)
        assert first_dispatch < last_finish
    # the one-setup decoder runs the same loop
    own = dec.decoders[_key(0)]
    own.decode_streams_i16([_demuxed(_files()[0][1])[1]])
    assert len(loops) == 2 and loops[1][0][0][0] is own


_decode_groups = batch._decode_groups


def test_stats_sum_the_setups_and_the_pool_is_shared():
    dec = _mixed(1)
    order = _order("shuffled")
    _decode(dec, order)
    st = dec.last_stats
    assert st["transport"] == "i16"  # the CPU takes no packed transport
    assert set(st["stages"]) >= {"frontend", "h2d", "device", "d2h",
                                 "compact", "wall"}
    files = _files()
    h2d = d2h = 0
    for d in dec.decoders.values():
        assert d._compact is dec._compact
    for k in range(4):
        idx = [i for i in order if files[i][0] == k]
        one = dec.decoders[_key(k)]
        one.decode_streams_i16([_demuxed(files[i][1])[1] for i in idx])
        h2d += one.last_stats["h2d_bytes"]
        d2h += one.last_stats["d2h_bytes"]
    assert (st["h2d_bytes"], st["d2h_bytes"]) == (h2d, d2h)


def _traced(dec, order):
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = _decode(dec, order)
        recs = profiling.records()
    finally:
        profiling.reset()
    spans = [r for r in recs if isinstance(r, profiling.Span)]
    counts = {}
    for r in recs:
        if isinstance(r, profiling.Count):
            counts[r.name] = counts.get(r.name, 0) + r.n
    return out, spans, counts


def test_spans_and_counters_under_the_tracer():
    dec = MixedBatchDecoder(chunk=CHUNK, device="cpu")
    order = _order("shuffled")
    first, spans, counts = _traced(dec, order)
    assert counts["batch.setups"] == counts["batch.setup_compiles"] == 4
    assert [(s.name, s.parent, s.rid) for s in spans
            if s.name.startswith("batch.")
            and s.name not in ("batch.compact", "batch.stage_sync")] == [
        ("batch.setup_switch", "batch.mixed", 1),
        ("batch.setup_switch", "batch.mixed", 2),
        ("batch.setup_switch", "batch.mixed", 3),
        ("batch.mixed", None, 1)]
    mixed = next(s for s in spans if s.name == "batch.mixed")
    switches = [s for s in spans if s.name == "batch.setup_switch"]
    assert all(mixed.t0 <= s.t0 <= s.t1 <= mixed.t1 for s in switches)
    assert {s.parent for s in spans if s.name == "batch.compact"} == {
        "batch.mixed"}
    # a second call compiles nothing and answers the same
    second, spans, counts = _traced(dec, order)
    assert counts["batch.setups"] == 4
    assert counts.get("batch.setup_compiles", 0) == 0
    assert len(dec.decoders) == 4
    assert [s.rid for s in spans if s.name == "batch.mixed"] == [2]
    assert all(np.array_equal(a, b) for a, b in zip(first, second))


def test_nothing_recorded_without_the_tracer():
    profiling.reset()
    _decode(_mixed(1), _order("grouped"))
    assert profiling.records() == []


def test_a_bad_setup_header_raises():
    files = _files()
    (ident, setup), audio = _demuxed(files[0][1])
    dec = MixedBatchDecoder(chunk=CHUNK, device="cpu")
    with pytest.raises(BadHeader):
        dec.decode_streams_i16([audio, audio],
                               [(ident, setup), (ident, setup[:40])])
    with pytest.raises(BadHeader):
        dec.decode_streams_i16([audio], [(ident, b"\x05vorbis")])
    assert (ident, setup) in dec.decoders and len(dec.decoders) == 1
    with pytest.raises(ValueError, match="header pairs"):
        dec.decode_streams_i16([audio, audio], [(ident, setup)])
