"""``BatchDecoder``'s compaction split over the host threads, on the CPU.

- ``_byte_ranges``: every stream in exactly one range, the ranges
  contiguous, in order and at most the parts asked for, each within one
  stream's bytes of the mean; all-zero totals, one stream and fewer streams
  than parts.
- ``decode_streams_i16`` with every group split (``_COMPACT_PART_BYTES``
  at 1) is bit for bit the same call with every group copied by the calling
  thread (the constant above the batch's bytes): both compacts, scan 1 and
  2, ragged streams that end groups before the longest. The padded layout
  (``compact="host"``) is copied on the calling thread either way.
- A part's exception reaches the caller, after every part has ended.
- ``native.compact_rows`` (a device-compacted part's copies in one call) is
  bit for bit NumPy's slices, and refuses rows outside the chunk or an
  output before it copies anything.
"""

import os
import threading

import numpy as np
import pytest
import torch

from lewton_tpu_torch import native
from lewton_tpu_torch.header import read_header_ident, read_header_setup
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.parallel import batch
from lewton_tpu_torch.parallel.batch import BatchDecoder, _byte_ranges

torch.set_num_threads(1)

GATE = os.path.join(os.path.dirname(__file__), "data", "torch_gate")
CHUNK = 8
THREADS = 4
#: packets a stream: the longest sets the groups (8 chunks of 8), the
#: others end groups before it
LENGTHS = [60, 23, 5, 41, 60, 9, 1, 33]
PART = batch._compact_part


@pytest.fixture(scope="module")
def stream():
    """stereo_44k_q3's ident and setup packets and its audio spans."""
    with open(os.path.join(GATE, "stereo_44k_q3.ogg"), "rb") as f:
        data = f.read()
    rdr = PacketReader(data)
    pcks = [rdr.read_packet() for _ in range(3)]
    return pcks[0].data, pcks[2].data, native.demux_spans(data)[0][3:]


def _decoder(stream, scan):
    raw_ident, raw_setup, _ = stream
    ident = read_header_ident(raw_ident)
    return BatchDecoder(ident, read_header_setup(raw_setup, ident),
                        chunk=CHUNK, scan=scan,
                        raw_headers=(raw_ident, raw_setup), device="cpu")


def _ranges_ok(nbytes, parts, ranges):
    nbytes = np.asarray(nbytes)
    assert 1 <= len(ranges) <= parts
    assert ranges[0][0] == 0 and ranges[-1][1] == len(nbytes)
    for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(len(nbytes), 0)]):
        assert lo < hi == nxt
    mean = nbytes.sum() / parts
    for lo, hi in ranges:
        assert abs(int(nbytes[lo:hi].sum()) - mean) <= nbytes.max()


@pytest.mark.parametrize("nbytes, parts", [
    ([0] * 7, 4),                      # all-zero totals: one range
    ([5_000_000], 8),                  # a single stream
    ([3, 900, 17], 8),                 # fewer streams than parts
    ([10, 1] * 50, 8),                 # lengths 10x apart, alternating
    ([1] * 90 + [10] * 10, 8),         # the long streams at the end
    ([4] * 16, 4),                     # equal streams: equal ranges
])
def test_byte_ranges(nbytes, parts):
    ranges = _byte_ranges(np.array(nbytes, np.int64), parts)
    _ranges_ok(nbytes, parts, ranges)
    if nbytes == [4] * 16:
        assert ranges == [(i, i + 4) for i in range(0, 16, 4)]


def test_byte_ranges_random():
    """1024 streams of 1-10 cycles' bytes, as the batch cells' traffic
    draws them, at every part count up to 8."""
    rng = np.random.default_rng(2025)
    for _ in range(20):
        nbytes = rng.integers(1, 11, 1024) * rng.integers(40_000, 60_000)
        nbytes[rng.random(1024) < 0.3] = 0  # streams that ended
        for parts in range(1, 9):
            _ranges_ok(nbytes, parts, _byte_ranges(nbytes, parts))


def _decode(monkeypatch, stream, compact, scan, part_bytes):
    """The ragged batch's PCM with ``_COMPACT_PART_BYTES`` at
    ``part_bytes``, and the ranges of the parts the calling thread ran and
    those the pool ran."""
    monkeypatch.setattr(batch, "host_threads", lambda: THREADS)
    monkeypatch.setattr(batch, "_COMPACT_PART_BYTES", part_bytes)
    ranges = ([], [])
    caller = threading.current_thread()

    def recorded(a, totals, starts, dst, lo, hi):
        ranges[threading.current_thread() is not caller].append((lo, hi))
        PART(a, totals, starts, dst, lo, hi)
    monkeypatch.setattr(batch, "_compact_part", recorded)
    dec = _decoder(stream, scan)
    outs = dec.decode_streams_i16([stream[2][:n] for n in LENGTHS],
                                  compact=compact)
    return outs, ranges


@pytest.mark.parametrize("scan", [1, 2])
@pytest.mark.parametrize("compact", ["device", "host"])
def test_split_is_bit_for_bit_the_serial_copy(monkeypatch, stream, compact,
                                              scan):
    serial, (one, none) = _decode(monkeypatch, stream, compact, scan,
                                  1 << 40)
    split, (mine, many) = _decode(monkeypatch, stream, compact, scan, 1)
    S = len(LENGTHS)
    groups = -(-max(LENGTHS) // (CHUNK * scan))
    assert none == []  # the calling thread copied every group
    if compact == "device":
        assert one == [(0, S)] * len(one) and len(one) >= groups
        assert mine == []
        assert len(many) > groups and max(hi - lo for lo, hi in many) < S
    else:  # the padded layout copies without parts
        assert one == mine == many == []
    assert len(serial) == len(split) == S
    for s, g in zip(serial, split):
        assert g.dtype == np.int16 and g.shape[1] == 2
        assert np.array_equal(s, g)


def test_small_groups_make_no_pool(stream):
    """At the shipped constant, a small decode copies on the calling
    thread: no pool is made."""
    dec = _decoder(stream, 1)
    outs = dec.decode_streams_i16([stream[2][:n] for n in LENGTHS])
    assert len(outs) == len(LENGTHS) and dec._compact.pool is None


def test_a_part_error_reaches_the_caller(monkeypatch, stream):
    """A part that raises in a pool thread: the decode raises it, and only
    after every other part of its group has ended."""
    monkeypatch.setattr(batch, "host_threads", lambda: THREADS)
    monkeypatch.setattr(batch, "_COMPACT_PART_BYTES", 1)
    calls, ended = [], []

    def failing(a, totals, starts, dst, lo, hi):
        calls.append(threading.current_thread())
        if lo == 0:
            raise RuntimeError("a part failed")
        threading.Event().wait(0.05)  # still running when the first raises
        PART(a, totals, starts, dst, lo, hi)
        ended.append((lo, hi))
    monkeypatch.setattr(batch, "_compact_part", failing)
    dec = _decoder(stream, 1)
    with pytest.raises(RuntimeError, match="a part failed"):
        dec.decode_streams_i16([stream[2][:n] for n in LENGTHS])
    # the first group's parts only, each on a pool thread
    assert len(calls) >= 2 and len(ended) == len(calls) - 1
    assert all(t.name.startswith("lt-compact") for t in calls)


def _rows_case(seed=3, S=6, cap=40, C=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(-30000, 30000, (S, cap, C)).astype(np.int16)
    totals = rng.integers(0, cap + 1, S)
    totals[2] = 0
    starts = rng.integers(0, 50, S)
    outs = [np.full((int(o + m) + int(rng.integers(0, 5)), C), -7, np.int16)
            for o, m in zip(starts, totals)]
    return src, totals, starts, outs


@pytest.mark.parametrize("lo, hi", [(0, 6), (1, 4), (3, 3), (5, 6)])
def test_compact_rows_is_numpy_slicing(lo, hi):
    src, totals, starts, outs = _rows_case()
    want = [o.copy() for o in outs]
    for s in range(lo, hi):
        want[s][starts[s]: starts[s] + totals[s]] = src[s, :totals[s]]
    native.compact_rows(src, totals, starts, *batch._addresses(outs), lo, hi)
    for g, w in zip(outs, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("fault", ["past_output", "past_chunk", "negative",
                                   "part", "table", "layout"])
def test_compact_rows_refuses_rows_outside(fault):
    src, totals, starts, outs = _rows_case()
    dst, rows = batch._addresses(outs)
    lo, hi = 0, len(outs)
    if fault == "past_output":
        starts[4] += 1 + rows[4] - starts[4] - totals[4]
    elif fault == "past_chunk":
        totals[1] = src.shape[1] + 1
    elif fault == "negative":
        starts[0] = -1
    elif fault == "part":
        hi = len(outs) + 1
    elif fault == "table":
        rows = rows[:-1]
    else:
        src = src[:, ::2]
    before = [o.copy() for o in outs]
    with pytest.raises(ValueError):
        native.compact_rows(src, totals, starts, dst, rows, lo, hi)
    assert all(np.array_equal(o, b) for o, b in zip(outs, before))
