"""The port's tracer (``lewton_tpu_torch/profiling.py``) on the CPU.

- With no ``torch.profiler`` recording, a ``StreamingScheduler`` run and a
  ``BatchDecoder`` call record nothing, and each site reads the profiler's
  flag and does nothing else.
- Under a CPU profiler the spans nest as the layers do, with the right
  parents; one request's spans share its id; the ``lt.`` ranges in
  ``prof.events()`` nest the same way; self time (the benchmark's reader)
  is a span's duration less its children's, as the profiler's ranges give
  it; ``transfer.packets`` / ``transfer.slots`` is the padded fill of a
  ragged batch, and the native route sends every byte from the slots'
  blocks (``transfer.direct_bytes``), none staged; graph replays and first uses are one span each; waits on
  CUDA events are ``wait`` spans; ``batch.compact_bytes`` is the outputs'
  bytes and ``batch.compact_parts`` the parts the groups' copies ran in.
- The ring keeps its bound; ``idle_by_span`` splits a synthetic profile's
  idle time by innermost span; ``trace`` writes the ranges and counters.
- The native batch entries fill the workers' busy time and the call's wall
  time only when asked, and busy never exceeds the workers x the wall.
"""

import ctypes as C
import json
import os
from collections import Counter, deque
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness.tracer import self_share
from lewton_tpu_torch import native, profiling
from lewton_tpu_torch.header import read_header_ident, read_header_setup
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.ogg.demux import IncrementalPacketReader
from lewton_tpu_torch.parallel import batch, graphs
from lewton_tpu_torch.parallel.batch import BatchDecoder, TransferSlots
from lewton_tpu_torch.profiling import Count, Span
from lewton_tpu_torch.serve import StreamingScheduler

torch.set_num_threads(1)

GATE = os.path.join(os.path.dirname(__file__), "data", "torch_gate")
CHUNK = 8


def _bytes(name="mono_16k_q3"):
    with open(os.path.join(GATE, name + ".ogg"), "rb") as f:
        return f.read()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _decoder(data):
    rdr = PacketReader(data)
    pcks = []
    while (p := rdr.read_packet()) is not None:
        pcks.append(p)
    ident = read_header_ident(pcks[0].data)
    setup = read_header_setup(pcks[2].data, ident)
    return BatchDecoder(ident, setup, chunk=CHUNK,
                        raw_headers=(pcks[0].data, pcks[2].data),
                        device="cpu")


def _serve(sched, data, sids=("b", "c")):
    """Register ``sids`` (the last fed in two parts), step to the end and
    poll each after every step."""
    sched.add_stream(sids[0], data)
    sched.add_stream(sids[1], data[:3000])
    sched.feed(sids[1], data[3000:])
    while sched.step():
        for sid in sids:
            sched.poll(sid)
    for sid in sids:
        sched.poll(sid)


def _ragged(data, lengths):
    spans = native.demux_spans(data)[0][3:]
    return [spans[:n] for n in lengths]


def _spans():
    return [r for r in profiling.records() if isinstance(r, Span)]


def _counts():
    out = Counter()
    for r in profiling.records():
        if isinstance(r, Count):
            out[r.name] += r.n
    return out


class _Flag:
    """A stand-in for ``torch.autograd.profiler`` whose profiler is off and
    which counts the reads of its flag; anything past the read raises."""

    def __init__(self):
        self.reads = 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return False

    def record_function(self, name):
        raise AssertionError(f"a range opened with no profiler: {name}")


def test_no_profiler_records_nothing():
    data = _bytes()
    sched = StreamingScheduler(capacity=4, chunk=CHUNK, device="cpu")
    _serve(sched, data)
    dec = _decoder(data)
    outs = dec.decode_streams_i16(_ragged(data, [40, 9]))
    assert len(outs) == 2 and outs[0].size
    assert profiling.records() == []


def test_no_profiler_each_site_reads_the_flag_only(monkeypatch):
    """With the profiler off, the sites of a serve run and of a batch call
    read the flag and go no further: no open span, no range, no record."""
    flag = _Flag()
    monkeypatch.setattr(profiling, "_ap", flag)

    def refuse(*a, **k):
        raise AssertionError("the tracer went past the flag")
    monkeypatch.setattr(profiling, "_Open", refuse)
    data = _bytes()
    sched = StreamingScheduler(capacity=4, chunk=CHUNK, device="cpu")
    _serve(sched, data)
    serve_reads = flag.reads
    _decoder(data).decode_streams_i16(_ragged(data, [40, 9]))
    assert serve_reads > 0 and flag.reads > serve_reads
    assert profiling.records() == []
    assert profiling.span("x") is profiling.span("y")  # one shared no-op
    assert profiling.begin("x") is None
    profiling.end(None)
    profiling.count("x", 1)
    assert profiling.records() == []


SERVE_PARENTS = {
    ("serve.register", None), ("ogg.read", "serve.register"),
    ("serve.enter", "serve.register"), ("ogg.read", None),
    ("serve.enter", None), ("serve.step", None),
    ("frontend.entropy", "serve.step"), ("transfer.pack", "serve.step"),
    ("transfer.d2h", "serve.step"), ("serve.collect", "serve.step"),
    ("serve.poll", None)}
BATCH_PARENTS = {
    ("native.demux", None), ("batch.decode", None),
    ("frontend.entropy", "batch.decode"), ("transfer.pack", "batch.decode"),
    ("transfer.d2h", "batch.decode"), ("batch.compact", "batch.decode")}


def test_serve_spans_nest_and_share_the_request_id():
    data = _bytes()
    sched = StreamingScheduler(capacity=4, chunk=CHUNK, device="cpu")
    with _cpu_profile():
        _serve(sched, data)
    spans = _spans()
    assert {(s.name, s.parent) for s in spans} == SERVE_PARENTS
    # "c" was fed in two parts: its first read under the registration,
    # its second (which completed the headers) and the group entry not
    by_rid = Counter((s.rid, s.name, s.parent) for s in spans
                     if s.rid in ("b", "c"))
    assert by_rid[("b", "serve.register", None)] == 1
    assert by_rid[("b", "ogg.read", "serve.register")] == 2
    assert by_rid[("b", "serve.enter", "serve.register")] == 1
    assert by_rid[("c", "ogg.read", "serve.register")] == 1
    assert by_rid[("c", "ogg.read", None)] == 2
    assert by_rid[("c", "serve.enter", None)] == 1
    assert by_rid[("b", "serve.poll", None)] == by_rid[
        ("c", "serve.poll", None)] > 1
    steps = [s.rid for s in spans if s.name == "serve.step"]
    assert steps == sorted(steps) and len(set(steps)) == len(steps)
    # every child lies inside a span of its parent's name
    for s in spans:
        if s.parent is not None:
            assert any(p.name == s.parent and p.t0 <= s.t0 <= s.t1 <= p.t1
                       for p in spans), s
    c = _counts()
    assert c["serve.requests"] == 2
    assert c["ogg.bytes"] == 2 * len(data)
    total = PacketReader(data)
    while total.read_packet() is not None:
        pass
    assert c["ogg.pages"] == 2 * total.pages_read > 0
    assert 0 < c["frontend.busy_ns"] <= c["frontend.wall_ns"]


def test_serve_reads_pages_natively():
    """Every reader of the scheduler is the native one: a request's reads
    are still ``ogg.read`` spans, their ``ogg.bytes`` and ``ogg.pages``
    the Python reader's, and ``ogg.native_bytes`` counts every byte."""
    data = _bytes()
    sched = StreamingScheduler(capacity=4, chunk=CHUNK, device="cpu")
    with _cpu_profile():
        sched.add_stream("a", data)
        sched.add_stream("b")
        readers = [sched.pending["b"][0]]
        for i in range(0, len(data), 555):
            sched.feed("b", data[i:i + 555])
        readers += [st.reader for _, st in sched.streams.values()]
        while sched.step():
            pass
    assert len(readers) == 3 and readers[0] is readers[2]
    assert all(isinstance(r, native.NativeIncrementalReader)
               for r in readers)
    assert {s.rid for s in _spans() if s.name == "ogg.read"} == {"a", "b"}
    python = IncrementalPacketReader()
    for i in range(0, len(data), 555):
        python.feed(data[i:i + 555])
        while python.read_packet() is not None:
            pass
    c = _counts()
    assert c["ogg.bytes"] == c["ogg.native_bytes"] == 2 * len(data)
    assert c["ogg.pages"] == 2 * python.pages_read > 0


def test_batch_spans_nest_and_count_the_padded_slots():
    """A ragged batch of 3 streams at chunk 8: 7 chunks for the longest
    (52 packets), so 7 x 3 x 8 slots, of which 52 + 17 + 5 hold one."""
    data = _bytes()
    dec = _decoder(data)
    with _cpu_profile():
        streams = _ragged(data, [52, 17, 5])
        dec.decode_streams_i16(streams)
    spans = _spans()
    assert {(s.name, s.parent) for s in spans} == BATCH_PARENTS
    groups = -(-52 // CHUNK)
    assert Counter(s.name for s in spans)["transfer.pack"] == groups
    assert [s.rid for s in spans if s.name == "batch.decode"] == [1]
    c = _counts()
    assert c["transfer.slots"] == groups * 3 * CHUNK
    assert c["transfer.packets"] == 52 + 17 + 5
    # the native front-end wrote the slots' blocks: nothing is staged
    assert c["transfer.staged_bytes"] == 0
    assert c["transfer.direct_bytes"] == dec.last_stats["h2d_bytes"] > 0
    assert c["native.demux_bytes"] == len(data)
    assert 0 < c["frontend.busy_ns"] <= c["frontend.wall_ns"]
    assert "stages" in dec.last_stats  # the stage timer is left as it was


@pytest.mark.parametrize("split", [False, True])
def test_compaction_counts_its_bytes_and_parts(monkeypatch, split):
    """The same ragged batch with its groups copied on the calling thread
    (one part a group) and split over 4 pool threads (more parts than
    groups); ``batch.compact`` still nests under ``batch.decode``."""
    monkeypatch.setattr(batch, "host_threads", lambda: 4)
    monkeypatch.setattr(batch, "_COMPACT_PART_BYTES", 1 if split else 1 << 40)
    data = _bytes()
    dec = _decoder(data)
    with _cpu_profile():
        outs = dec.decode_streams_i16(_ragged(data, [52, 17, 5]))
    groups = -(-52 // CHUNK)
    c = _counts()
    assert c["batch.compact_bytes"] == sum(o.nbytes for o in outs) > 0
    assert (c["batch.compact_parts"] > groups if split
            else c["batch.compact_parts"] == groups)
    assert {(s.name, s.parent) for s in _spans()} == BATCH_PARENTS


def _lt_events(prof):
    """(name, nearest lt. ancestor's name) of each lt. range."""
    out = []
    for e in prof.events():
        if not e.name.startswith(profiling.PREFIX):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith(profiling.PREFIX):
            up = up.cpu_parent
        out.append((e.name[3:], None if up is None else up.name[3:]))
    return Counter(out)


def test_ranges_nest_as_the_spans_do():
    data = _bytes()
    sched = StreamingScheduler(capacity=4, chunk=CHUNK, device="cpu")
    dec = _decoder(data)
    with _cpu_profile() as prof:
        _serve(sched, data)
        dec.decode_streams_i16(_ragged(data, [30, 11]))
    assert _lt_events(prof) == Counter((s.name, s.parent) for s in _spans())


def test_self_time_is_the_duration_less_the_children():
    """The benchmark's self time of ``batch.decode`` and ``transfer.pack``
    over the whole record: the spans' durations less their children's,
    which lie inside them, as the profiler's ranges do."""
    data = _bytes()
    dec = _decoder(data)
    with _cpu_profile() as prof:
        dec.decode_streams_i16(_ragged(data, [52, 17, 5]))
    spans = _spans()
    t0 = min(s.t0 for s in spans)
    window = max(s.t1 for s in spans) - t0
    run = SimpleNamespace(trace=SimpleNamespace(window_s=window),
                          profiler=SimpleNamespace(t0=t0))
    ranges = Counter()
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            ranges[e.name[3:]] += e.time_range.elapsed_us() / 1e6
    for name in ("batch.decode", "transfer.pack"):
        own = sum(s.t1 - s.t0 for s in spans if s.name == name)
        kids = sum(s.t1 - s.t0 for s in spans if s.parent == name)
        assert self_share(run, name) * window / 100.0 == pytest.approx(
            own - kids)
        assert 0 <= kids < own <= ranges[name]  # a range holds its span
    assert self_share(run, "batch.decode") > 0


def test_graph_replay_and_capture_are_one_span_each(monkeypatch):
    """A program's first use on a card is one ``graphs.capture`` span and
    each replay one ``graphs.replay`` span (stand-ins for the capture and
    the replay, which need a card)."""
    owner = graphs.Programs()
    ins = {"x": torch.zeros(4)}
    carry = (torch.zeros(4),)
    out = (torch.zeros(4),)

    def body(i, c, o):
        o[0].copy_(i["x"] + c[0])
        return (c[0] + 1,)
    prog = graphs.ChunkProgram(owner, body, ins, carry, out, "k")
    monkeypatch.setattr(prog, "graphed", lambda: True)
    monkeypatch.setattr(prog, "_warm_up", lambda: prog._run())
    monkeypatch.setattr(prog, "_capture",
                        lambda side: setattr(prog, "graph", [None]))
    monkeypatch.setattr(prog, "_replay", prog._run)
    with _cpu_profile():
        with profiling.span("serve.step", 1):
            prog(ins, carry)
            prog(ins, carry)
            prog(ins, carry)
    assert [(s.name, s.parent) for s in _spans()] == [
        ("graphs.capture", "serve.step"), ("graphs.replay", "serve.step"),
        ("graphs.replay", "serve.step"), ("serve.step", None)]
    assert prog.replays == 2 and prog.first_s is not None
    assert set(owner.stats()) == {"programs", "captured", "replays",
                                  "first_use_s", "capture_s", "pool_mb"}


class _Event:
    def __init__(self):
        self.waited = 0

    def synchronize(self):
        self.waited += 1


def test_waits_on_events_are_wait_spans():
    data = _bytes()
    dec = _decoder(data)
    slots = TransferSlots(dec._sd)
    ev = _Event()
    slots.put_done[0] = ev
    outs = [np.zeros((4, 1), np.int16)]
    offs = np.zeros(1, np.int64)
    st = SimpleNamespace(lap=lambda *a, **k: None)
    with _cpu_profile():
        slots.wait_put(0)
        slots.wait_put(1)  # no copies through slot 1 yet: no wait
        with profiling.span("batch.decode", 1):
            dec._finish([np.ones((1, 4, 1), np.int16), ev,
                         np.array([[3]]), None], outs, offs, st,
                        batch._addresses(outs))
    assert ev.waited == 2
    assert [(s.name, s.parent) for s in _spans()] == [
        ("wait", None), ("wait", "batch.decode"),
        ("batch.compact", "batch.decode"), ("batch.decode", None)]
    assert offs[0] == 3 and outs[0][:3, 0].tolist() == [1, 1, 1]


def test_begin_end_closes_what_it_left_open():
    with _cpu_profile():
        a = profiling.begin("outer", 5)
        profiling.begin("inner")  # never ended: closed with its parent
        profiling.end(a)
        with profiling.span("after") as sp:
            assert sp is not None
            profiling.count("n", 3)
    spans = _spans()
    assert [(s.name, s.parent, s.rid) for s in spans] == [
        ("inner", "outer", None), ("outer", None, 5), ("after", None, None)]
    assert spans[0].t1 == spans[1].t1
    assert _counts() == {"n": 3}


def test_ring_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_records", deque(maxlen=16))
    with _cpu_profile():
        for i in range(40):
            with profiling.span("s", i):
                pass
    recs = profiling.records()
    assert len(recs) == 16 and [r.rid for r in recs] == list(range(24, 40))
    assert profiling.RING == 1 << 20


def _ev(name, a, b, cuda=False, annotation=False, parent=None):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=a, end=b),
        device_type=(torch.autograd.DeviceType.CUDA if cuda
                     else torch.autograd.DeviceType.CPU),
        is_user_annotation=annotation)


def test_idle_by_span_on_synthetic_events():
    """0-100 us: lt.outer over 0-80 with lt.inner over 20-50; kernels at
    10-30 and 60-70 (a range's device record at 0-100 is no activity); a
    host op at 90-100 outside every span."""
    events = [
        _ev("lt.outer", 0, 80, annotation=True),
        _ev("lt.inner", 20, 50, annotation=True),
        _ev("aten::add", 90, 100),
        _ev("lt.outer", 0, 100, cuda=True, annotation=True),
        _ev("kernel_a", 10, 30, cuda=True),
        _ev("memcpy", 25, 28, cuda=True),
        _ev("kernel_b", 60, 70, cuda=True),
    ]
    got = profiling.idle_by_span(events)
    assert got["busy_s"] == pytest.approx(30e-6)
    assert got["idle_s"] == pytest.approx(70e-6)
    # gaps: 0-10 outer, 30-60 (30-50 inner, 50-60 outer), 70-100 (70-80
    # outer, 80-100 other)
    assert got["by_span"] == pytest.approx(
        {"outer": 30e-6, "inner": 20e-6, "other": 20e-6})
    assert profiling.idle_by_span([]) == {"busy_s": 0.0, "idle_s": 0.0,
                                          "by_span": {}}


def test_trace_writes_the_ranges_and_the_counters(tmp_path):
    data = _bytes()
    dec = _decoder(data)
    with profiling.trace(str(tmp_path)) as prof:
        dec.decode_streams_i16(_ragged(data, [20, 9]))
    with open(tmp_path / profiling.TRACE_FILE) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"lt.batch.decode", "lt.transfer.pack",
            "lt.native.demux"} <= names
    assert doc["lt_counts"]["transfer.slots"] == 3 * 2 * CHUNK
    assert doc["lt_counts"]["transfer.packets"] == 29
    got = profiling.idle_by_span(prof)
    assert got["busy_s"] == 0.0  # no card: every gap is idle
    assert got["by_span"]["batch.decode"] > 0


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_native_busy_counters_only_when_asked(threads):
    """The chunk entry fills busy (one slot a worker) and wall only when
    given them; busy sums to at most the workers x the wall."""
    data = _bytes()
    dec = _decoder(data)
    ns = dec._sd._native
    S = 5
    streams = [native.demux_spans(data)[0][3:3 + 6 + s] for s in range(S)]
    tables = native.span_tables(streams, CHUNK)[:4]
    out = ns.frame_buffers(CHUNK, lead=(S,))

    def call(busy, wall, stages=None):
        status = np.zeros((S, CHUNK), np.uint8)
        ns._lib.lt_decode_chunk(*ns.chunk_args(*tables, out, status),
                                threads, busy, wall, stages)
        return status

    plain = call(None, None)
    sentinel = np.uint64(0xDEADBEEF)
    busy = np.full(threads + 2, sentinel, np.uint64)
    wall = np.full(1, sentinel, np.uint64)
    timed = call(native._ptr(busy, C.c_uint64), native._ptr(wall, C.c_uint64))
    assert (plain == timed).all()
    workers = min(threads, S) if threads > 1 else 1
    assert (busy[workers:] == sentinel).all()
    assert (busy[:workers] != sentinel).all() and wall[0] != sentinel
    assert 0 < int(busy[:workers].sum()) <= int(wall[0])
    # the stage slots: a row a worker, added to, only when given
    stages = np.zeros((threads + 2, len(native._STAGE_COUNTERS)), np.uint64)
    stages[workers:] = sentinel
    assert (call(None, None, native._ptr(stages, C.c_uint64)) == plain).all()
    assert (stages[workers:] == sentinel).all()
