"""The port's native host front-end (``lewton_tpu_torch/native/``) on the CPU.

Both host libraries are built while this module is imported, each under a
file lock: the reference's (``make -C lewton_tpu/native``, which the
reference's own fixtures run, and which the ``native.available()`` checks
inside the reference's test bodies then find on a tree that starts without
it: every pytest worker imports every test file before it runs a test) and
the port's (``_build.load_host_library``).

Every comparison here is exact, with two known exceptions, each held to
its exact extent, in which the native library (the reference's and the
port's copy alike) differs from the Python front-end:

- floor 0's ``f0_cosc`` within 1 f32 ulp: the library rounds a double
  ``cos`` to f32 where the Python front-end calls numpy's f32 ``cos``;
- the residue of the packets in ``RESIDUE_DIVERGES`` and
  ``DAMAGED_RESIDUE_DIVERGES``: packets whose bits run out in the residue
  section (four packets of a crafted stream end exactly where it begins),
  where the library adds a vector that the Python front-end does not: the
  library's Huffman decode gives up at end-of-packet without consuming
  the codeword's last bits, and a later read decodes them (ROADMAP §3).
  The gate streams' PCM stays within +/-2 LSB of libvorbis either way.

The comparisons:

- the native demux (``demux``, ``demux_spans``, ``NativePacketReader`` with
  ``seek_absgp``) against the port's Python ``PacketReader`` on the 38
  committed gate streams and the corpus file they leave out (chained and
  multi-page streams among them);
- the frames and status of every audio packet of those streams from the
  native front-end against the port's Python front-end and against the
  reference's native library, in f32, i16 and p12 emit, through the
  one-stream entry, the list-of-bytes batch entry on 1 thread and the
  ``PacketSpans`` batch entry on 4;
- the status codes and frames of truncated and bit-flipped packets;
- ``native.pack12`` against ``pack12_np``'s numpy form;
- ``BatchDecoder``'s reused (slot, N) buffers across calls of different S;
- ``StreamDecoder``'s ``frontend`` selection and its failure when the
  library cannot be built.
"""

import fcntl
import os
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lewton_tpu import native as jnative
from lewton_tpu_torch import _build
from lewton_tpu_torch import native
from lewton_tpu_torch.inside_ogg import read_headers
from lewton_tpu_torch.models.decoder import StreamDecoder
from lewton_tpu_torch.ogg import PacketReader
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
#: stream -> audio packets (first link) whose native residue differs from
#: the Python front-end's, and the damaged packets (MUTATIONS) of the same
#: kind; see the module docstring
RESIDUE_DIVERGES = {"f1_two_submaps": {16, 20, 28, 32}}
DAMAGED_RESIDUE_DIVERGES = {("ch6_44k_q3", 0, "truncate", 40)}


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


def _equal_to_python(fr: dict, py: dict) -> set:
    """Native frames against the Python front-end's: bit for bit, but
    ``f0_cosc`` within 1 f32 ulp; returns the packet rows whose residue
    differs (for the caller to hold to RESIDUE_DIVERGES)."""
    assert fr.keys() == py.keys()
    rows = set()
    for k in fr:
        a, b = fr[k], py[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if a.tobytes() == b.tobytes():
            continue
        if k == "f0_cosc":
            assert (np.abs(a - b) <= np.spacing(np.abs(b))).all(), k
        else:
            assert k == "residue", k
            rows |= {int(t) for t in np.flatnonzero((a != b).any(axis=-1))}
    return rows


@pytest.mark.parametrize("emit", EMITS)
@pytest.mark.parametrize("name", STREAMS)
def test_frames_match_python_and_reference(name, emit, corpus_dir):
    """Every audio packet's frames and status, bit for bit: the native
    front-end against the Python front-end (residue cast to f32 or packed
    to p12) and against the reference's native library; the batch entries
    (bytes on 1 thread, PacketSpans on 4) against the one-stream entry.
    An emit the setup's static bound does not allow is refused."""
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
        assert sd._native.residue_dtype == np.float32
        return
    ns.residue_dtype = ref.residue_dtype = EMITS[emit]
    mine = [ns.decode_chunk(audio[i:i + CHUNK], CHUNK)
            for i in range(0, len(audio), CHUNK)]
    diverged = set()
    for (fr, status), (py_fr, py_status), i in zip(mine, chunks,
                                                   range(0, len(audio), CHUNK)):
        assert status.tobytes() == py_status.tobytes()
        diverged |= {i + t for t in _equal_to_python(
            fr, _as_emit(py_fr, EMITS[emit]))}
        theirs, j_status = ref.decode_chunk(audio[i:i + CHUNK], CHUNK)
        assert status.tobytes() == j_status.tobytes()
        _equal(fr, theirs)
    assert diverged == RESIDUE_DIVERGES.get(name, set())
    # the whole stream as a batch of chunk-long streams
    streams = [audio[i:i + CHUNK] for i in range(0, len(audio), CHUNK)]
    spans = [native.PacketSpans.from_bytes(s) for s in streams]
    S = len(streams)
    for threads, view in ((1, False), (4, True)):
        out = ns.frame_buffers(CHUNK, lead=(S,))
        if view:
            offs = np.zeros((S, CHUNK), np.uint64)
            lens = np.zeros((S, CHUNK), np.uint64)
            counts = np.array([len(s) for s in spans], np.int32)
            for s, sp in enumerate(spans):
                offs[s, :len(sp)] = sp.offs
                lens[s, :len(sp)] = sp.lens
            bufs = np.array([sp.data.ctypes.data for sp in spans], np.uint64)
            status = ns.decode_chunk_batch_view(bufs, offs, lens, counts, out,
                                                threads=threads)
        else:
            status = ns.decode_chunk_batch(streams, CHUNK, out,
                                           threads=threads)
        for s, (fr, st1) in enumerate(mine):
            assert status[s].tobytes() == st1.tobytes()
            _equal({k: v[s] for k, v in out.items()}, fr)


@pytest.mark.parametrize("name,idx,kind,arg", MUTATIONS)
def test_damaged_packets_status(name, idx, kind, arg):
    """A truncated or bit-flipped packet: the status the Python front-end
    gives it (0 ok, 1 header, 2 bad), the same frames when it decodes, and
    the reference's native status and frames."""
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
    diverged = _equal_to_python(fr, py_fr)
    assert diverged == ({0} if (name, idx, kind, arg)
                        in DAMAGED_RESIDUE_DIVERGES else set())
    ref = jnative.NativeStream(*raw)
    ref.frame_width = mine.cs.w_eff
    ref.residue_dtype = mine._native.residue_dtype
    j_fr, j_status = ref.decode_chunk(pair, 2)
    assert status.tobytes() == j_status.tobytes()
    _equal(fr, j_fr)
    if status[0]:  # the strict entry raises the Python front-end's class
        with pytest.raises(Exception) as got:
            mine.entropy_chunk(pair)
        with pytest.raises(Exception) as want:
            py.entropy_chunk(pair)
        assert type(got.value) is type(want.value)


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
            kept = dict(dec._frames)
            assert {n for _, n in kept} == {1, 2}
        elif len(streams) == 3:
            assert all(dec._frames[k] is v for k, v in kept.items())


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


def test_interleaved_lanes_match_sequential(monkeypatch):
    """LT_ILEAVE_K > 1 sends chunks through the library's round-robin lane
    driver (an opt-in path of the copied sources): the same frames as the
    sequential path, in i16 and f32 emit."""
    headers, audio = _first_link(stream_bytes("stereo_44k_q3"))
    sd = StreamDecoder(headers.ident, headers.setup, chunk=48,
                       raw_headers=(headers.raw_ident, headers.raw_setup),
                       device="cpu")
    for dtype in (np.int16, np.float32):
        sd._native.residue_dtype = dtype
        monkeypatch.setenv("LT_ILEAVE_K", "0")
        seq = {k: v.copy() for k, v in
               sd.entropy_chunk_batch([audio[:48]] * 2).items()}
        monkeypatch.setenv("LT_ILEAVE_K", "4")
        _equal(seq, sd.entropy_chunk_batch([audio[:48]] * 2))
