"""The port's native host front-end (``lewton_tpu_torch/native/``) on the CPU.

Both host libraries are built while this module is imported, each under a
file lock: the reference's (``make -C lewton_tpu/native``, which the
reference's own fixtures run, and which the ``native.available()`` checks
inside the reference's test bodies then find on a tree that starts without
it: every pytest worker imports every test file before it runs a test) and
the port's (``_build.load_host_library``).

Every comparison here is exact, with two known exceptions, each held to
its exact extent:

- floor 0's ``f0_cosc`` within 1 f32 ulp against the Python front-end:
  the library rounds a double ``cos`` to f32 where the Python front-end
  calls numpy's f32 ``cos``;
- the residue of the packets in ``REFERENCE_RESIDUE_DIVERGES`` and
  ``DAMAGED_REFERENCE_DIVERGES`` against the reference's library: packets
  whose bits run out in the residue section (four packets of a crafted
  stream end exactly where it begins). The reference's Huffman decode
  gives up at end-of-packet without consuming the codeword's last bits,
  and a later read decodes them; the port's copy spends those bits, as
  libvorbis and the Python front-end do, and so equals the Python
  front-end there (ROADMAP §3, repaired).

The comparisons:

- the native demux (``demux``, ``demux_spans``, ``NativePacketReader`` with
  ``seek_absgp``) against the port's Python ``PacketReader`` on the 38
  committed gate streams and the corpus file they leave out (chained and
  multi-page streams among them), on the damaged streams below, on crafted
  pages of every checksummed length mod 16 and of 255 segments, with a
  one-bit flip at every offset mod 16 of a page's header, lacing and body,
  and on pages that carry state (multiplexed serials, a packet over three
  pages, zero-length packets, held heads across holes);
- ``NativeIncrementalReader`` (the scheduler's reader) against the port's
  Python ``IncrementalPacketReader``, both fed whole and in steps of 1,
  17, 555 and 777 bytes, on those streams and on damaged ones (a broken
  CRC, junk between pages, a truncated tail, sequence holes, garbage,
  nothing), and the bytes it holds between feeds;
- the frames and status of every audio packet of those streams from the
  native front-end against the port's Python front-end and against the
  reference's native library, in f32, i16 and p12 emit, through the
  one-stream entry, the list-of-bytes batch entry on 1 thread and the
  ``PacketSpans`` batch entry on 4;
- the chunk entry's worker pool: skewed batches (S of 0 to 257, empty
  streams among full ones) on 2 to 16 workers against the calling thread
  alone, bit for bit in every emit; its counters over two traced calls;
  calls from two Python threads at once; a child forked from a process
  whose pool is warm (each of these within ``POOL_TIMEOUT``);
- the status codes and frames of truncated and bit-flipped packets;
- ``native.pack12`` against ``pack12_np``'s numpy form;
- ``BatchDecoder``'s reused (slot, N) buffers across calls of different S;
- ``StreamDecoder``'s ``frontend`` selection and its failure when the
  library cannot be built.
"""

import ctypes as C
import fcntl
import multiprocessing
import os
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lewton_tpu import native as jnative
from lewton_tpu_torch import _build
from lewton_tpu_torch import native, profiling
from lewton_tpu_torch.inside_ogg import read_headers
from lewton_tpu_torch.models.decoder import StreamDecoder
from lewton_tpu_torch.ogg import PacketReader, crc32_ogg
from lewton_tpu_torch.ogg.demux import IncrementalPacketReader
from lewton_tpu_torch.parallel import pack12 as tpack12
from lewton_tpu_torch.parallel.batch import BatchDecoder
from test_torch_frontend import MUTATIONS, STREAMS, stream_bytes

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NATIVE = os.path.join(ROOT, "lewton_tpu", "native")


def build_reference_native() -> None:
    """``make -C lewton_tpu/native`` one process at a time (the lock file
    lies in the ignored ``build/``, the reference's tree gets only the
    objects its Makefile writes)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "lewton_tpu_native.lock"),
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", REF_NATIVE, "-s", "-j4"], check=True)


build_reference_native()
_build.load_host_library()

CHUNK = 64
#: emit -> residue dtype of the native front-end
EMITS = {"f32": np.float32, "i16": np.int16, "p12": np.uint32}
#: stream -> audio packets (first link) whose residue from the reference's
#: library differs from the port's (and the Python front-end's), and the
#: damaged packets (MUTATIONS) of the same kind; see the module docstring
REFERENCE_RESIDUE_DIVERGES = {"f1_two_submaps": {16, 20, 28, 32}}
DAMAGED_REFERENCE_DIVERGES = {("ch6_44k_q3", 0, "truncate", 40)}


@pytest.fixture
def data(request, corpus_dir):
    return stream_bytes(request.param, corpus_dir)


def _packets(rdr) -> list:
    out = []
    while (p := rdr.read_packet()) is not None:
        out.append(p)
    return out


_FIELDS = ("data", "stream_serial", "first_in_stream", "last_in_stream",
           "absgp_page", "first_in_page", "last_in_page", "page_granule")


def _same_packets(mine, want) -> None:
    assert len(mine) == len(want)
    for p, q in zip(mine, want):
        assert [getattr(p, f) for f in _FIELDS] == \
            [getattr(q, f) for f in _FIELDS]


@pytest.mark.parametrize("data", STREAMS, indirect=True)
def test_demux_matches_python(data):
    """demux, NativePacketReader and demux_spans: the Python reader's
    packets, serials, flags and granules."""
    want = _packets(PacketReader(data))
    assert len(want) > 3
    _same_packets(native.demux(data), want)
    _same_packets(_packets(native.NativePacketReader(data)), want)
    spans, serials, flags, absgp, pgran = native.demux_spans(data)
    assert len(spans) == len(want)
    for i, p in enumerate(want):
        assert spans[i] == p.data and serials[i] == p.stream_serial
        assert bool(flags[i] & 1) == p.first_in_stream
        assert bool(flags[i] & 2) == p.last_in_stream
        assert (int(absgp[i]) if flags[i] & 16 else None) == p.absgp_page
        assert (int(pgran[i]) if flags[i] & 32 else None) == p.page_granule


@pytest.mark.parametrize("name", ["tiny_44k", "chained_44k", "stereo_44k_q3",
                                  "ch6_44k_q3"])
def test_seek_matches_python(name):
    """seek_absgp to granules before, inside, at page edges of and past
    the stream: the same packets from there to the end."""
    data = stream_bytes(name)
    granules = sorted({p.page_granule for p in _packets(PacketReader(data))
                       if p.page_granule is not None})
    targets = [0, 1, granules[len(granules) // 2], granules[-1],
               granules[-1] + 10**6] + [g + 1 for g in granules[1:4]]
    for target in targets:
        py, nat = PacketReader(data), native.NativePacketReader(data)
        py.seek_absgp(target)
        nat.seek_absgp(target)
        _same_packets(_packets(nat), _packets(py))


def _fed(rdr, data: bytes, step: int | None) -> tuple[list, int]:
    """Feed ``data`` whole (step None) or in pieces of ``step`` bytes,
    reading the packets after each feed as the scheduler does; returns
    (packets, pages_read)."""
    step = step or max(len(data), 1)
    out = []
    for i in range(0, max(len(data), 1), step):
        rdr.feed(data[i:i + step])
        out += _packets(rdr)
    return out, rdr.pages_read


def _same_fed(data: bytes, step: int | None) -> None:
    """The native incremental reader against the Python one, fed alike."""
    want, pages = _fed(IncrementalPacketReader(), data, step)
    mine, native_pages = _fed(native.NativeIncrementalReader(), data, step)
    _same_packets(mine, want)
    assert native_pages == pages


@pytest.mark.parametrize("step", [None, 1, 17, 555, 777])
@pytest.mark.parametrize("data", STREAMS, indirect=True)
def test_incremental_reader_matches_python(data, step):
    """NativeIncrementalReader fed whole and in steps: the Python
    IncrementalPacketReader's packets, in order, and its pages."""
    _same_fed(data, step)


def _small_pages(data: bytes, max_segs: int = 2) -> bytes:
    """The stream's packets laced again into pages of at most ``max_segs``
    lacing values (right CRCs; a page's granule is the index of the last
    packet it completes, or -1), so packets span pages."""
    pcks = _packets(PacketReader(data))
    laces = []  # (lacing value, index of the packet it ends or None, bytes)
    for i, p in enumerate(pcks):
        d = p.data
        whole = len(d) // 255 * 255
        laces += [(255, None, d[j:j + 255]) for j in range(0, whole, 255)]
        laces.append((len(d) - whole, i, d[whole:]))
    out, continued = bytearray(), False
    for seq, k in enumerate(range(0, len(laces), max_segs)):
        group = laces[k:k + max_segs]
        ends = [i for _, i, _ in group if i is not None]
        flags = (continued | (2 if k == 0 else 0)
                 | (4 if k + max_segs >= len(laces) else 0))
        head = struct.pack("<4sBBQIII", b"OggS", 0, flags,
                           ends[-1] if ends else (1 << 64) - 1,
                           pcks[0].stream_serial, seq, 0)
        head += bytes([len(group), *(v for v, _, _ in group)])
        body = b"".join(b for _, _, b in group)
        crc = struct.pack("<I", crc32_ogg(head + body))
        out += head[:22] + crc + head[26:] + body
        continued = group[-1][0] == 255
    return bytes(out)


def _page_starts(data: bytes) -> list[int]:
    """Byte offsets of a clean stream's pages, and its length last."""
    starts = [0]
    while starts[-1] < len(data):
        s = starts[-1]
        nsegs = data[s + 26]
        starts.append(s + 27 + nsegs + sum(data[s + 27:s + 27 + nsegs]))
    return starts


def _hole(data: bytes, drop: bool) -> bytes:
    """Small pages with a page that carries only a middle fragment of a
    packet broken (its CRC) or dropped: a sequence hole."""
    small = _small_pages(data)
    starts = _page_starts(small)
    for s, e in zip(starts, starts[1:]):
        nsegs = small[s + 26]
        if small[s + 5] & 1 and small[s + 26 + nsegs] == 255:
            if drop:
                return small[:s] + small[e:]
            return small[:s + 30] + bytes([small[s + 30] ^ 0xFF]) + small[
                s + 31:]
    raise AssertionError("no page carries a middle fragment")


def _damaged(kind: str) -> bytes:
    data = stream_bytes("stereo_44k_q3")
    starts = _page_starts(data)
    if kind == "crc":
        mid = starts[len(starts) // 2] + 40
        return data[:mid] + bytes([data[mid] ^ 0x40]) + data[mid + 1:]
    if kind == "junk":
        return (data[:starts[2]] + b"\xde\xad\xbe\xef" * 8 + b"OggS\x01junk"
                + b"Ogg" + data[starts[2]:])
    if kind == "truncate":
        return data[:starts[-2] + (starts[-1] - starts[-2]) // 2]
    if kind in ("hole", "hole_dropped"):
        return _hole(stream_bytes("mono_16k_q3"), kind == "hole_dropped")
    if kind == "garbage":
        return b"\x00" * 1000 + b"OggS" + b"\xff" * 100
    assert kind == "empty"
    return b""


@pytest.mark.parametrize("step", [1, 555])
@pytest.mark.parametrize("kind", ["crc", "junk", "truncate", "hole",
                                  "hole_dropped", "garbage", "empty"])
def test_incremental_reader_matches_python_on_damage(kind, step):
    """Broken CRCs, junk between pages (a false capture among it),
    truncated tails, sequence holes (a pending head dropped, never
    spliced), garbage and nothing: the Python reader's packets."""
    _same_fed(_damaged(kind), step)


def test_incremental_reader_holds_under_a_page(corpus_dir):
    """Fed a long stream in 4 KB pieces, the native reader holds less
    than its largest page after every feed, and nothing at the end."""
    data = stream_bytes("long_44k_q2", corpus_dir)
    starts = _page_starts(data)
    largest = max(b - a for a, b in zip(starts, starts[1:]))
    rdr = native.NativeIncrementalReader()
    for i in range(0, len(data), 4096):
        rdr.feed(data[i:i + 4096])
        assert rdr.held_bytes < largest
    assert rdr.held_bytes == 0


def _same_demux(data: bytes) -> list:
    """The whole-buffer demux (``demux``, ``NativePacketReader`` and
    ``demux_spans``, each flag bit) against the Python reader; returns the
    Python reader's packets."""
    want = _packets(PacketReader(data))
    _same_packets(native.demux(data), want)
    _same_packets(_packets(native.NativePacketReader(data)), want)
    spans, serials, flags, absgp, pgran = native.demux_spans(data)
    assert len(spans) == len(want)
    assert int(spans.lens.sum()) <= len(data)
    for i, p in enumerate(want):
        assert spans[i] == p.data and serials[i] == p.stream_serial
        assert [bool(flags[i] >> b & 1) for b in range(4)] == [
            p.first_in_stream, p.last_in_stream, p.first_in_page,
            p.last_in_page]
        assert (int(absgp[i]) if flags[i] & 16 else None) == p.absgp_page
        assert (int(pgran[i]) if flags[i] & 32 else None) == p.page_granule
    return want


@pytest.mark.parametrize("kind", ["crc", "junk", "truncate", "hole",
                                  "hole_dropped", "garbage", "empty"])
def test_demux_matches_python_on_damage(kind):
    """The whole-buffer demux on broken CRCs, junk between pages, a
    truncated tail, sequence holes, garbage and nothing: the Python
    reader's packets."""
    _same_demux(_damaged(kind))


def _page(serial: int, seq: int, flags: int, granule: int,
          segs: list) -> bytes:
    """One Ogg page of the lacing segments ``segs`` (each at most 255
    bytes; a 255-byte segment continues its packet), signed with
    ``crc32_ogg``; granule -1 for none."""
    head = struct.pack("<4sBBQIII", b"OggS", 0, flags, granule % (1 << 64),
                       serial, seq, 0)
    head += bytes([len(segs), *map(len, segs)])
    body = b"".join(segs)
    crc = struct.pack("<I", crc32_ogg(head + body))
    return head[:22] + crc + head[26:] + body


def _body(n: int, salt: int = 0) -> bytes:
    return bytes((i * 7 + salt) & 0xFF for i in range(n))


def _laced(packet: bytes) -> list:
    """A packet's lacing segments (a 0-byte one ends a multiple of 255)."""
    return [packet[i:i + 255] for i in range(0, len(packet) // 255 * 255,
                                             255)] + [packet[len(packet)
                                                             // 255 * 255:]]


#: single-page streams: one packet whose page is 28 + r or 228 + r bytes
#: (every residue of the checksummed length mod 16, a short run through the
#: tables alone and a long one folded 16 bytes a step), and the 255-segment
#: bodies
CRC_PAGES = {f"len{n}": _page(7, 0, 6, 5, [_body(n)])
             for r in range(16) for n in (r, 200 + r)}
CRC_PAGES["segs255_one_packet"] = _page(7, 0, 6, 5,
                                        _laced(_body(254 * 255 + 17)))
CRC_PAGES["segs255_packets"] = _page(
    7, 0, 6, 5, [_body(i % 255, i) for i in range(255)])
#: three pages; the middle one (255 segments) takes a bit flip (the last
#: is longer than a flipped lacing value can stretch the middle one)
_FLIP_PAGES = (_page(9, 0, 2, 0, [_body(40)]),
               _page(9, 1, 0, 10, [_body(i % 200 + 1, i) for i in range(255)]),
               _page(9, 2, 4, 20, [_body(250), _body(3)]))
#: (name, offset in the middle page): every offset mod 16 of its header
#: (granule, serial, sequence), its lacing and its body
FLIPS = [(f"{region}{j}", start + j) for region, start in
         (("header", 6), ("lacing", 27 + 8), ("body", 27 + 255 + 100))
         for j in range(16)]


@pytest.mark.parametrize("name", [*CRC_PAGES, *(n for n, _ in FLIPS)])
def test_demux_crc_every_tail(name):
    """The page CRC at every tail length (16 bytes a step by the tables or
    by the carry-less fold, then the byte tail): signed pages of every
    checksummed length mod 16, short and long, and of 255 segments give
    their packets; a one-bit flip at every offset mod 16 of a page's
    header, lacing or body makes that page, and only it, vanish, as from
    the Python reader."""
    if name in CRC_PAGES:
        want = _same_demux(CRC_PAGES[name])
        assert len(want) == {"segs255_packets": 255}.get(name, 1)
        return
    off = dict(FLIPS)[name]
    a, b, c = _FLIP_PAGES
    mid = bytearray(b)
    mid[off] ^= 1 << (off % 8)
    want = _same_demux(a + bytes(mid) + c)
    assert [len(p.data) for p in want] == [40, 250, 3]


def _stateful(kind: str) -> bytes:
    """Pages whose packets carry state from page to page."""
    big = _body(955, 1)  # three 255-byte segments and a 190-byte one
    if kind == "multiplexed":
        # two serials' pages interleaved, each holding a head across the
        # other's page
        x = _laced(_body(300, 2))
        y = _laced(_body(520, 3))
        return b"".join([
            _page(1, 0, 2, 0, [_body(30), x[0]]),
            _page(2, 0, 2, 0, [y[0], y[1]]),
            _page(1, 1, 1, 100, [x[1], _body(5)]),
            _page(2, 1, 1, -1, [y[2]]),
            _page(1, 2, 4, 200, [_body(60)]),
            _page(2, 2, 4, 300, [_body(8)])])
    if kind == "three_pages":
        # a packet begun on the BOS page, through a page of 255s, to a third
        s = _laced(big)
        return b"".join([_page(4, 0, 2, -1, [s[0]]),
                         _page(4, 1, 1, -1, [s[1], s[2]]),
                         _page(4, 2, 5, 50, [s[3], _body(9)])])
    if kind == "three_pages_hole":
        # the middle page lost: the head is dropped, never spliced
        s = _laced(big)
        return b"".join([_page(4, 0, 2, -1, [_body(10), s[0]]),
                         _page(4, 2, 5, 50, [s[3], _body(9)])])
    if kind == "zero_length":
        # zero-length packets mid-page and ending a page, and a packet of
        # exactly 255 bytes (a 255 lacing value, then a 0)
        return b"".join([
            _page(5, 0, 2, 0, [_body(4), b"", _body(255), b"", b""]),
            _page(5, 1, 4, 9, [b"", _body(6)])])
    if kind == "stale_head":
        # a held head, then a page of the serial not flagged continued,
        # then a continued one
        s = _laced(big)
        return b"".join([_page(6, 0, 2, 0, [_body(3), s[0]]),
                         _page(6, 1, 0, 1, [_body(11)]),
                         _page(6, 2, 1, 2, [s[3], _body(12)])])
    assert kind == "eos_unterminated"
    # an EOS page ending in a held head, and a continued page with no head
    s = _laced(big)
    return b"".join([_page(8, 0, 2, 0, [_body(3)]),
                     _page(8, 1, 4, 5, [_body(7), s[0]]),
                     _page(8, 3, 1, 6, [s[3], _body(2)])])


@pytest.mark.parametrize("kind", ["multiplexed", "three_pages",
                                  "three_pages_hole", "zero_length",
                                  "stale_head", "eos_unterminated"])
def test_demux_page_state(kind):
    """Multiplexed serials, a packet over three pages (whole and with its
    middle page lost), zero-length packets, a held head under a page not
    flagged continued, an EOS page ending in a held head: the Python
    reader's packets and flags from the whole-buffer demux and from the
    fed reader (whole and a byte a feed); ``spans_pages`` on exactly the
    packets that began on an earlier page."""
    data = _stateful(kind)
    want = _same_demux(data)
    _same_fed(data, None)
    _same_fed(data, 1)
    spans, _, flags, _, _ = native.demux_spans(data)
    began_earlier = {"multiplexed": {1, 3}, "three_pages": {0},
                     "three_pages_hole": set(), "zero_length": set(),
                     "stale_head": {2}, "eos_unterminated": set()}[kind]
    assert {i for i in range(len(spans)) if flags[i] & 64} == began_earlier
    if kind == "three_pages":
        assert [len(p.data) for p in want] == [955, 9]
        assert want[0].first_in_stream and not want[1].first_in_stream
    if kind == "zero_length":
        assert [len(p.data) for p in want] == [4, 0, 255, 0, 0, 6]


def _first_link(data: bytes):
    """(headers, audio packets) of a stream's first link (Python demux)."""
    rdr = PacketReader(data)
    headers, serial = read_headers(rdr)
    audio = []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial != serial:
            continue
        if p.first_in_stream:  # the next link of a chained stream
            break
        audio.append(p.data)
    return headers, audio


_python_frames: dict = {}


def _python_chunks(name: str, data: bytes):
    """Per chunk of CHUNK packets: the Python front-end's (frames, status),
    cached per stream (the slow half of every comparison)."""
    if name not in _python_frames:
        headers, audio = _first_link(data)
        sd = StreamDecoder(headers.ident, headers.setup, chunk=CHUNK,
                           frontend="python", device="cpu")
        chunks = [sd.entropy_chunk_status(audio[i:i + CHUNK])
                  for i in range(0, len(audio), CHUNK)]
        _python_frames[name] = (headers, audio, sd.cs, chunks)
    return _python_frames[name]


def _as_emit(fr: dict, dtype) -> dict:
    """Python frames with the residue in the native emit's encoding."""
    res = fr["residue"]
    if dtype == np.uint32:
        res = tpack12.pack12_np(res)
    return dict(fr, residue=res.astype(dtype))


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _equal_to_python(fr: dict, py: dict) -> None:
    """Native frames against the Python front-end's: bit for bit, but
    ``f0_cosc`` within 1 f32 ulp."""
    assert fr.keys() == py.keys()
    for k in fr:
        a, b = fr[k], py[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k == "f0_cosc" and a.tobytes() != b.tobytes():
            assert (np.abs(a - b) <= np.spacing(np.abs(b))).all(), k
        else:
            assert a.tobytes() == b.tobytes(), k


def _residue_rows_differ(fr: dict, ref: dict) -> set:
    """The port's native frames against the reference library's: every
    leaf bit for bit but the residue; returns the packet rows whose residue
    differs (for the caller to hold to REFERENCE_RESIDUE_DIVERGES)."""
    _equal({k: v for k, v in fr.items() if k != "residue"},
           {k: v for k, v in ref.items() if k != "residue"})
    a, b = fr["residue"], ref["residue"]
    assert a.dtype == b.dtype and a.shape == b.shape
    return {int(t) for t in np.flatnonzero((a != b).any(axis=-1))}


def _decode(ns, streams: list, threads: int = 1):
    """(frames [S, CHUNK, ...], status [S, CHUNK]) of one chunk of a
    stream batch through the one native call: lists of bytes as one joined
    blob, PacketSpans each from its own."""
    out = ns.frame_buffers(CHUNK, lead=(len(streams),))
    bufs, offs, lens, counts, held = native.span_tables(streams, CHUNK)
    return out, ns.decode_spans(bufs, offs, lens, counts, out, threads)


@pytest.mark.parametrize("emit", EMITS)
@pytest.mark.parametrize("name", STREAMS)
def test_frames_match_python_and_reference(name, emit, corpus_dir):
    """Every audio packet's frames and status, bit for bit: the native
    front-end one stream a call (S = 1) against the Python front-end
    (residue cast to f32 or packed to p12) and against the reference's
    native library, which differs on exactly the residue of
    REFERENCE_RESIDUE_DIVERGES; the whole stream as one batch (one joined
    blob on 1 thread, PacketSpans on 4) against the S = 1 calls. An emit
    the setup's static bound does not allow is refused."""
    headers, audio, cs, chunks = _python_chunks(
        name, stream_bytes(name, corpus_dir))
    raw = (headers.raw_ident, headers.raw_setup)
    ns, ref = native.NativeStream(*raw), jnative.NativeStream(*raw)
    for s in (ns, ref):
        s.frame_width = cs.w_eff
    sd = StreamDecoder(headers.ident, headers.setup, chunk=CHUNK,
                       raw_headers=raw, device="cpu")
    if emit == "p12" and not tpack12.pack12_supported(cs):
        with pytest.raises(ValueError):
            sd.set_residue_transport("p12")
        return
    if emit == "i16" and not cs.residue_i16:
        # the i16 emit would not be exact: the decoder emits f32
        assert sd.frame_layout["residue"][1] == np.float32
        return
    ns.residue_dtype = ref.residue_dtype = EMITS[emit]
    starts = range(0, len(audio), CHUNK)
    streams = [audio[i:i + CHUNK] for i in starts]
    mine = []
    for pcks in streams:
        fr, status = _decode(ns, [pcks])
        mine.append(({k: v[0] for k, v in fr.items()}, status[0]))
    diverged = set()
    for (fr, status), (py_fr, py_status), i in zip(mine, chunks, starts):
        assert status.tobytes() == py_status.tobytes()
        _equal_to_python(fr, _as_emit(py_fr, EMITS[emit]))
        theirs, j_status = ref.decode_chunk(audio[i:i + CHUNK], CHUNK)
        assert status.tobytes() == j_status.tobytes()
        diverged |= {i + t for t in _residue_rows_differ(fr, theirs)}
    assert diverged == REFERENCE_RESIDUE_DIVERGES.get(name, set())
    # the whole stream as a batch of chunk-long streams
    spans = [native.PacketSpans.from_bytes(s) for s in streams]
    for threads, batch in ((1, streams), (4, spans)):
        out, status = _decode(ns, batch, threads)
        for s, (fr, st1) in enumerate(mine):
            assert status[s].tobytes() == st1.tobytes()
            _equal({k: v[s] for k, v in out.items()}, fr)


#: each pool test's time limit, seconds: a hang fails the test
POOL_TIMEOUT = 120


def _within(fn, *args, seconds: float = POOL_TIMEOUT):
    """``fn(*args)`` on a daemon thread, its result or its error; fails
    the test when it has not returned within ``seconds`` (a hung call is
    left behind on the daemon thread)."""
    got = {}

    def run():
        try:
            got["value"] = fn(*args)
        except BaseException as e:  # handed to the test's thread
            got["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"{fn.__name__} still running after {seconds} s"
    if "error" in got:
        raise got["error"]
    return got["value"]


def _skewed(spans: "native.PacketSpans", S: int, seed: int) -> list:
    """S windows of a stream's audio packets, as a batch's chunk sees
    them: empty streams, a few packets and full chunks mixed, at seeded
    offsets (so long and short blocks both)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(S):
        n = int(rng.choice([0, int(rng.integers(1, 9)),
                            int(rng.integers(9, CHUNK)), CHUNK]))
        n = min(n, len(spans))
        o = int(rng.integers(0, len(spans) - n + 1))
        out.append(spans[o:o + n])
    return out


_pool_batches: dict = {}


def _pool_batch(S: int, emit: str):
    """(NativeStream, the skewed batch, its frames and status on the
    calling thread alone) of stereo_44k_q3 at S streams, cached."""
    if (S, emit) not in _pool_batches:
        headers, audio = _first_link(stream_bytes("stereo_44k_q3"))
        ns = native.NativeStream(headers.raw_ident, headers.raw_setup)
        ns.residue_dtype = EMITS[emit]
        batch = _skewed(native.PacketSpans.from_bytes(audio), S, seed=S)
        _pool_batches[S, emit] = (ns, batch, _decode(ns, batch, 1))
    return _pool_batches[S, emit]


@pytest.mark.parametrize("threads", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("S", [0, 1, 3, 64, 257])
@pytest.mark.parametrize("emit", EMITS)
def test_pool_frames_match_one_thread(emit, S, threads):
    """A skewed chunk (counts 0 to CHUNK mixed, empty streams, more
    threads than streams) on ``threads`` workers claiming streams largest
    first: frames and status bit for bit as on the calling thread alone,
    in every emit (stereo_44k_q3 allows all three)."""
    ns, batch, (want, want_status) = _pool_batch(S, emit)
    if S >= 64:  # the skew the workers' claims have to even out
        assert {0, CHUNK} <= {len(b) for b in batch}
    out, status = _within(_decode, ns, batch, threads)
    assert status.tobytes() == want_status.tobytes()
    _equal(out, want)


def _pool_counts(ns, batch, threads: int) -> dict:
    """One traced call's counters (``_run_batch``'s)."""
    profiling.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            _decode(ns, batch, threads)
        return {r.name: r.n for r in profiling.records()
                if isinstance(r, profiling.Count)}
    finally:
        profiling.reset()


def test_pool_spawns_once_and_bounds_its_tail():
    """Two successive traced calls: the second starts no thread (the pool
    is warm), and each call's tail lies within its wall x workers."""
    ns, batch, _ = _pool_batch(64, "i16")
    first, second = (_within(_pool_counts, ns, batch, 8) for _ in range(2))
    assert second["frontend.spawned"] == 0
    for c in (first, second):
        assert 0 <= c["frontend.tail_ns"] <= c["frontend.wall_ns"]
        assert 0 < c["frontend.busy_ns"] <= c["frontend.wall_ns"]


def test_pool_calls_from_two_threads():
    """Two Python threads decoding at once on two NativeStreams of
    different setups (stereo and 5.1), the interpreter switching threads
    every microsecond: each call's frames and status as in serial calls."""
    jobs = []
    for name, S in (("stereo_44k_q3", 64), ("ch6_44k_q3", 48)):
        headers, audio = _first_link(stream_bytes(name))
        ns = native.NativeStream(headers.raw_ident, headers.raw_setup)
        batch = _skewed(native.PacketSpans.from_bytes(audio), S, seed=7)
        jobs.append((ns, batch, _decode(ns, batch, 1)))
    bad = []

    def hammer(ns, batch, want):
        for _ in range(6):
            out, status = _decode(ns, batch, 16)
            try:
                assert status.tobytes() == want[1].tobytes()
                _equal(out, want[0])
            except AssertionError as e:
                bad.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=hammer, args=job, daemon=True)
              for job in jobs]
        for t in ts:
            t.start()
        for t in ts:
            t.join(POOL_TIMEOUT)
        assert not any(t.is_alive() for t in ts), "a call hung"
    finally:
        sys.setswitchinterval(old)
    assert not bad, bad[0]


def _decode_in_child(ns, batch, want, status) -> None:
    out, got = _decode(ns, batch, 4)
    spawned, tail = np.zeros(1, np.uint64), np.zeros(1, np.uint64)
    native._load().lt_chunk_pool_stats(native._ptr(spawned, C.c_uint64),
                                       native._ptr(tail, C.c_uint64))
    ok = got.tobytes() == status.tobytes() and all(
        out[k].tobytes() == want[k].tobytes() for k in want)
    # the child's first call on 4 workers started its own 3 threads
    os._exit(0 if ok and spawned[0] == 3 else 3)


@pytest.mark.filterwarnings("ignore:os.fork\\(\\) was called")
@pytest.mark.filterwarnings("ignore:This process .* is multi-threaded")
def test_pool_in_a_forked_child():
    """A child forked once the parent's pool is warm starts its own pool
    (its first call starts 3 threads): it decodes a batch on 4 threads as
    the parent does and exits within the time limit."""
    ns, batch, _ = _pool_batch(64, "f32")
    want, status = _within(_decode, ns, batch, 4)  # the pool is warm
    child = multiprocessing.get_context("fork").Process(
        target=_decode_in_child, args=(ns, batch, want, status))
    child.start()
    child.join(POOL_TIMEOUT)
    if child.is_alive():
        child.kill()
        child.join()
        pytest.fail(f"the forked child hung past {POOL_TIMEOUT} s")
    assert child.exitcode == 0


@pytest.mark.parametrize("name,idx,kind,arg", MUTATIONS)
def test_damaged_packets_status(name, idx, kind, arg):
    """A truncated or bit-flipped packet: the status the Python front-end
    gives it (0 ok, 1 header, 2 bad), the same frames when it decodes, and
    the reference's native status and frames (its residue apart on exactly
    DAMAGED_REFERENCE_DIVERGES)."""
    headers, audio = _first_link(stream_bytes(name))
    p = bytearray(audio[idx])
    if kind == "truncate":
        p = p[:arg]
    else:
        p[arg // 8 % len(p)] ^= 1 << (arg % 8)
    raw = (headers.raw_ident, headers.raw_setup)
    mine = StreamDecoder(headers.ident, headers.setup, chunk=2,
                         raw_headers=raw, device="cpu")
    py = StreamDecoder(headers.ident, headers.setup, chunk=2,
                       frontend="python", device="cpu")
    pair = [bytes(p), audio[idx + 1]]
    fr, status = mine.entropy_chunk_status(pair)
    py_fr, py_status = py.entropy_chunk_status(pair)
    assert status.tobytes() == py_status.tobytes()
    _equal_to_python(fr, py_fr)
    ref = jnative.NativeStream(*raw)
    ref.frame_width = mine.cs.w_eff
    ref.residue_dtype = mine.frame_layout["residue"][1]
    j_fr, j_status = ref.decode_chunk(pair, 2)
    assert status.tobytes() == j_status.tobytes()
    assert _residue_rows_differ(fr, j_fr) == (
        {0} if (name, idx, kind, arg) in DAMAGED_REFERENCE_DIVERGES else set())
    if status[0]:  # the strict entry raises the Python front-end's class
        with pytest.raises(Exception) as got:
            mine.entropy_chunk(pair)
        with pytest.raises(Exception) as want:
            py.entropy_chunk(pair)
        assert type(got.value) is type(want.value)


@pytest.mark.parametrize("emit", EMITS)
def test_eop_mid_codeword_drains(emit):
    """Audio packets 16, 20, 28 and 32 of f1_two_submaps end inside a
    Huffman codeword at the start of the residue section: decoded natively,
    one at a time, their frames equal the Python front-end's bit for bit
    (the codeword's last bits are spent, not decoded by a later read)."""
    headers, audio = _first_link(stream_bytes("f1_two_submaps"))
    raw = (headers.raw_ident, headers.raw_setup)
    mine = StreamDecoder(headers.ident, headers.setup, chunk=1,
                         raw_headers=raw, device="cpu")
    py = StreamDecoder(headers.ident, headers.setup, chunk=1,
                       frontend="python", device="cpu")
    if emit == "p12" and not tpack12.pack12_supported(mine.cs):
        pytest.skip("p12 emit needs the static bound < 2048")
    if emit != "p12":
        mine._native.residue_dtype = EMITS[emit]
    else:
        mine.set_residue_transport("p12")
    for idx in sorted(REFERENCE_RESIDUE_DIVERGES["f1_two_submaps"]):
        fr, status = mine.entropy_chunk_status([audio[idx]])
        py_fr, py_status = py.entropy_chunk_status([audio[idx]])
        assert status.tobytes() == py_status.tobytes() == b"\x00"
        _equal(fr, _as_emit(py_fr, EMITS[emit]))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 40), st.lists(st.integers(1, 3), max_size=2),
       st.integers(0, 2 ** 32 - 1))
def test_pack12_native_matches_numpy(k, lead, seed):
    """native.pack12 (which pack12_np runs once the library is loaded)
    gives the numpy form's words over the whole 12-bit range."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2048, 2048, size=tuple(lead) + (8 * k,), dtype=np.int16)
    x.reshape(-1)[:2] = (-2048, 2047)
    got = native.pack12(x)
    assert native.available()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        want = tpack12.pack12_np(x)
    assert got.dtype == want.dtype == np.uint32
    assert got.tobytes() == want.tobytes() == tpack12.pack12_np(x).tobytes()


@pytest.mark.parametrize("value", [2048, -2049, 32767, -32768])
def test_pack12_native_refuses_out_of_range(value):
    x = np.zeros((3, 16), np.int16)
    x[1, 5] = value
    with pytest.raises(ValueError, match="outside"):
        native.pack12(x)
    with pytest.raises(ValueError, match="outside"):
        tpack12.pack12_np(x)


@pytest.mark.parametrize("transport,compact", [("p12", "host"),
                                               ("i16", "device")])
def test_batch_buffers_reused_across_calls(transport, compact):
    """One BatchDecoder, calls of S = 3, 3 and 2 streams: each call's PCM
    equals a fresh decoder's, and the second call decodes into the (slot,
    N) frame buffers of the first, whose slots past each stream's packets
    hold the first call's frames."""
    headers, audio = _first_link(stream_bytes("stereo_44k_q3"))
    raw = (headers.raw_ident, headers.raw_setup)

    def make():
        return BatchDecoder(headers.ident, headers.setup, chunk=16, scan=2,
                            raw_headers=raw, device="cpu")

    dec = make()
    kept = None
    for streams in ([audio[:70], audio[5:60], audio[:33]],
                    [audio[10:90], audio[:47], audio[20:41]],
                    [audio[10:90], audio[:47]]):
        got = dec.decode_streams_i16(streams, compact=compact,
                                     transport=transport)
        want = make().decode_streams_i16(streams, compact=compact,
                                         transport=transport)
        assert dec.last_stats["transport"] == transport
        assert len(got) == len(streams)
        for g, w in zip(got, want):
            assert g.shape[0] > 0 and np.array_equal(g, w)
        if kept is None:
            kept = dict(dec._slots.frames)
            assert {n for _, n in kept} == {1, 2}
        elif len(streams) == 3:
            assert all(dec._slots.frames[k] is v for k, v in kept.items())


def test_batch_decoder_takes_packet_spans():
    """decode_streams_i16 over PacketSpans (the zero-copy entry) gives the
    same PCM as over lists of bytes."""
    data = stream_bytes("stereo_44k_q3")
    headers, audio = _first_link(data)
    spans, serials, _, _, _ = native.demux_spans(data)
    first = len(spans) - len(audio)
    assert spans[first] == audio[0]
    dec = BatchDecoder(headers.ident, headers.setup, chunk=32, scan=2,
                       raw_headers=(headers.raw_ident, headers.raw_setup),
                       device="cpu")
    by_bytes = dec.decode_streams_i16([audio, audio[:50]], compact="host")
    by_spans = dec.decode_streams_i16(
        [spans[first:], spans[first:first + 50]], compact="host")
    for a, b in zip(by_bytes, by_spans):
        assert np.array_equal(a, b)


def test_frontend_selection():
    """"auto" with raw headers and "native" take the native library, "auto"
    without them and "python" the Python front-end; "native" without raw
    headers and an unknown front-end raise ValueError."""
    headers, _ = _first_link(stream_bytes("tiny_44k"))
    hs = (headers.ident, headers.setup)
    raw = (headers.raw_ident, headers.raw_setup)
    for frontend, raw_headers, native_on in (
            ("auto", raw, True), ("native", raw, True), ("auto", None, False),
            ("python", raw, False)):
        sd = StreamDecoder(*hs, raw_headers=raw_headers, frontend=frontend,
                           device="cpu")
        assert (sd._native is not None) == native_on, frontend
    with pytest.raises(ValueError, match="raw_headers"):
        StreamDecoder(*hs, frontend="native", device="cpu")
    with pytest.raises(ValueError, match="frontend"):
        StreamDecoder(*hs, raw_headers=raw, frontend="numpy", device="cpu")


def test_failed_build_raises(monkeypatch):
    """A library that cannot be built raises from StreamDecoder and the
    reader; neither falls back to the Python front-end."""
    from lewton_tpu_torch.inside_ogg import OggStreamReader

    def broken():
        raise RuntimeError("c++ failed (exit 1)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_build, "load_host_library", broken)
    data = stream_bytes("tiny_44k")
    headers, _ = _first_link(data)
    for frontend in ("auto", "native"):
        with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
            StreamDecoder(headers.ident, headers.setup,
                          raw_headers=(headers.raw_ident, headers.raw_setup),
                          frontend=frontend, device="cpu")
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        OggStreamReader(data, device="cpu")
