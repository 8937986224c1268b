"""The port's host front-end against the reference's on the CPU.

The port keeps its own copies of the reference's pure-Python host modules
(``ogg/demux.py``, ``bitpack``, ``huffman``, ``header``, the decode half of
``floor``, ``residue``, the entropy half of ``audio``) and of the numpy
frame helpers (``models/decoder.pack_frames``, ``compact_invalid_frames``,
``predict_out_lens``). Every comparison here is exact:

- the demuxed packets (data, serial, granules, flags) on every committed
  gate stream and the corpus file the gate leaves out;
- the parsed headers, field by field, codebook ``vq`` arrays and Huffman
  tables included;
- the frames of every audio packet (entropy decode, ``pack_frames`` in
  chunks of 64, ``compact_invalid_frames``), bit for bit, on the 17 corpus
  files and the crafted floor-1 and floor-0 streams;
- the exception class raised on truncated and bit-flipped packets;
- ``predict_out_lens``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from lewton_tpu import audio as jaudio
from lewton_tpu import header as jheader
from lewton_tpu import ogg as jogg
from lewton_tpu.models import decoder as jdec
from lewton_tpu_torch import audio as taudio
from lewton_tpu_torch import header as theader
from lewton_tpu_torch import ogg as togg
from lewton_tpu_torch.models import decoder as tdec

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

GATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_gate")
with open(os.path.join(GATE_DIR, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
GATE = sorted(MANIFEST["streams"])
#: every stream: the committed gate streams and the corpus files it leaves out
STREAMS = GATE + sorted(MANIFEST["left_out"])
CHUNK = 64


def stream_bytes(name: str, corpus_dir=None) -> bytes:
    """A committed gate stream, or a corpus file the gate leaves out."""
    if name in MANIFEST["streams"]:
        path = os.path.join(GATE_DIR, MANIFEST["streams"][name]["ogg"])
    else:
        path = os.path.join(corpus_dir, name + ".ogg")
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def data(request, corpus_dir):
    return stream_bytes(request.param, corpus_dir)


def _packets(pkg, data: bytes) -> list:
    rdr = pkg.PacketReader(data)
    out = []
    while (p := rdr.read_packet()) is not None:
        out.append(p)
    return out


def _headers_and_audio(pkg_ogg, pkg_header, data: bytes):
    """(ident, setup, audio packets) of a stream's first link."""
    pcks = _packets(pkg_ogg, data)
    ident = pkg_header.read_header_ident(pcks[0].data)
    serial = pcks[0].stream_serial
    rest = [p for p in pcks[1:] if p.stream_serial == serial]
    pkg_header.read_header_comment(rest[0].data)
    setup = pkg_header.read_header_setup(rest[1].data, ident)
    audio = []
    for p in rest[2:]:
        if p.first_in_stream:  # the next link of a chained stream
            break
        audio.append(p.data)
    return ident, setup, audio


def _fields(obj) -> dict:
    if hasattr(obj, "__dict__"):
        return vars(obj)
    return {k: getattr(obj, k, None) for k in obj.__slots__}


def assert_same(a, b, path="") -> None:
    """Field-by-field equality of two packages' records (classes matched by
    name, arrays bitwise)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif hasattr(a, "__dict__") or hasattr(a, "__slots__"):
        assert type(a).__name__ == type(b).__name__, path
        fa, fb = _fields(a), _fields(b)
        assert fa.keys() == fb.keys(), path
        for k in fa:
            assert_same(fa[k], fb[k], f"{path}.{k}")
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


@pytest.mark.parametrize("data", STREAMS, indirect=True)
def test_demux_packets_match_reference(data):
    mine, ref = _packets(togg, data), _packets(jogg, data)
    assert len(mine) == len(ref) > 3
    for p, q in zip(mine, ref):
        assert dataclasses.astuple(p) == dataclasses.astuple(q)


@pytest.mark.parametrize("data", STREAMS, indirect=True)
def test_headers_match_reference(data):
    """Ident, comment and setup headers field-equal, codebook vq arrays,
    Huffman tables and floor-1 neighbour tables included."""
    pcks = _packets(togg, data)
    for parse in ("read_header_ident", "read_header_comment"):
        p = pcks[0] if parse.endswith("ident") else pcks[1]
        assert_same(getattr(theader, parse)(p.data),
                    getattr(jheader, parse)(p.data), parse)
    mine = _headers_and_audio(togg, theader, data)
    ref = _headers_and_audio(jogg, jheader, data)
    assert_same(mine[0], ref[0], "ident")
    assert_same(mine[1], ref[1], "setup")
    assert any(cb.vq is not None for cb in mine[1].codebooks)


def _frames(pkg_audio, pack, ident, setup, cs, packets) -> dict:
    """Frames [1, N*CHUNK, ...] of every audio packet: entropy decode (an
    undecodable packet becomes an invalid slot, as the tolerant batch
    front-end makes it), pack_frames per chunk, compact_invalid_frames."""
    chunks = []
    for i in range(0, len(packets), CHUNK):
        plans = []
        for p in packets[i:i + CHUNK]:
            try:
                plans.append(pkg_audio.decode_packet_entropy(ident, setup, p))
            except Exception as e:  # noqa: BLE001 -- both packages' classes
                assert type(e).__name__ in ("AudioBadFormat", "AudioIsHeader")
                plans.append(None)
        fr = {k: v[None] for k, v in pack(cs, plans, CHUNK).items()}
        (tdec.compact_invalid_frames if pkg_audio is taudio
         else jdec.compact_invalid_frames)(fr)
        chunks.append(fr)
    return {k: np.concatenate([c[k] for c in chunks], 1) for k in chunks[0]}


@pytest.mark.parametrize("data", STREAMS, indirect=True)
def test_frames_bit_identical(data):
    """The port's decode_packet_entropy + pack_frames +
    compact_invalid_frames against the reference's on every audio packet
    of the stream's first link. The reference's pack_frames reads only the
    setup's static fields, so both take the port's CPU setup."""
    ident, setup, packets = _headers_and_audio(togg, theader, data)
    j_ident, j_setup, _ = _headers_and_audio(jogg, jheader, data)
    cs = tdec.compile_setup(ident, setup, device="cpu")
    mine = _frames(taudio, tdec.pack_frames, ident, setup, cs, packets)
    ref = _frames(jaudio, jdec.pack_frames, j_ident, j_setup, cs, packets)
    assert mine.keys() == ref.keys()
    for k in mine:
        assert mine[k].dtype == ref[k].dtype, k
        assert mine[k].tobytes() == ref[k].tobytes(), k
    assert mine["valid"].sum() > 0
    lens, started = tdec.predict_out_lens(cs, mine, False)
    j_lens, j_started = jdec.predict_out_lens(cs, ref, False)
    assert np.array_equal(lens, j_lens) and np.array_equal(started, j_started)


#: (stream, packet index, mutation): truncations to a few lengths and bit
#: flips at a few offsets of audio packets of three corpus streams
MUTATIONS = [(name, idx, kind, arg)
             for name in ("stereo_44k_q3", "ch6_44k_q3", "mono_8k_q-1")
             for idx in (0, 7)
             for kind, arg in (("truncate", 0), ("truncate", 1),
                               ("truncate", 5), ("truncate", 40),
                               ("flip", 0), ("flip", 1), ("flip", 9),
                               ("flip", 100))]


def _outcome(pkg_audio, ident, setup, packet):
    try:
        pkg_audio.decode_packet_entropy(ident, setup, packet)
    except Exception as e:  # noqa: BLE001 -- compared by class name
        return type(e).__name__
    return None


@pytest.mark.parametrize("name,idx,kind,arg", MUTATIONS)
def test_damaged_packets_raise_the_same_class(name, idx, kind, arg):
    """A truncated or bit-flipped packet: the same exception class (or
    none) from both front-ends, and equal frames when it decodes."""
    data = stream_bytes(name)
    ident, setup, packets = _headers_and_audio(togg, theader, data)
    j_ident, j_setup, _ = _headers_and_audio(jogg, jheader, data)
    p = bytearray(packets[idx])
    if kind == "truncate":
        p = p[:arg]
    else:
        p[arg // 8 % len(p)] ^= 1 << (arg % 8)
    p = bytes(p)
    got = _outcome(taudio, ident, setup, p)
    assert got == _outcome(jaudio, j_ident, j_setup, p)
    if got is None:
        cs = tdec.compile_setup(ident, setup, device="cpu")
        a = tdec.pack_frames(cs, [taudio.decode_packet_entropy(
            ident, setup, p)], 1)
        b = jdec.pack_frames(cs, [jaudio.decode_packet_entropy(
            j_ident, j_setup, p)], 1)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_predict_out_lens_with_streams_and_carry_in():
    """predict_out_lens on frames with a stream axis, invalid suffixes and a
    per-stream carry-in, against the reference's."""
    ident, setup, packets = _headers_and_audio(
        togg, theader, stream_bytes("stereo_44k_q3"))
    cs = tdec.compile_setup(ident, setup, device="cpu")
    plans = [taudio.decode_packet_entropy(ident, setup, p)
             for p in packets[:3 * 16]]
    fr = {k: np.stack([tdec.pack_frames(cs, plans[s * 16:(s + 1) * 16], 16)[k]
                       for s in range(3)]) for k in ("mode", "prev_flag",
                                                     "next_flag", "valid")}
    fr["valid"][1, 9:] = False
    fr["valid"][2, :] = False
    for started in (np.array([False, True, True]), np.zeros(3, bool), True):
        got = tdec.predict_out_lens(cs, fr, started)
        want = jdec.predict_out_lens(cs, fr, started)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert got[0].dtype == np.int64 and got[0].sum() > 0
