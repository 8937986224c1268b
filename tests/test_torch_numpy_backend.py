"""The port's numpy backend (``OggStreamReader(backend="numpy")``) on the CPU.

The port keeps its own copies of the reference's numpy synthesis
(``audio.read_audio_packet_generic`` / ``_synthesize`` with an f64 IMDCT,
``floor.floor1_synthesis``, ``floor.floor0_curve``, ``PreviousWindowRight``)
and of its reader's ``"numpy"`` branches. Every comparison with the
reference is bit for bit:

- ``read_audio_packet_generic`` in all four formats and ``read_audio_packet``
  on the first packets of six streams (the carry after them too), and the
  floor curves of every channel of those packets;
- ``read_all_i16`` against the reference's numpy reader, and within +/-2
  LSB of the libvorbis golden with the exact length;
- skip, seek, granules, the chained-stream cases and save/restore, the
  saved state loading across the two packages in both directions;
- the reference's error cases (header and garbage packets, truncations,
  bit flips), and the 14 malformed variants of tests/test_malformed.py on
  both CPU backends: each decodes or raises VorbisError.
"""

import os
import random

import numpy as np
import pytest
import torch

from lewton_tpu import audio as jaudio
from lewton_tpu import floor as jfloor
from lewton_tpu.inside_ogg import OggStreamReader as JReader
from lewton_tpu_torch import audio, errors, floor
from lewton_tpu_torch.errors import AudioIsHeader, OggError, VorbisError
from lewton_tpu_torch.inside_ogg import OggStreamReader
from test_torch_frontend import GATE_DIR, stream_bytes

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

STREAMS = ("tiny_44k", "stereo_44k_q3", "ch6_44k_q3", "f1_bs8192",
           "f0_coupled_stereo", "chained_44k")
FORMATS = ("planar_i16", "interleaved_i16", "planar_f32", "interleaved_f32")
N_PACKETS = 16  # packets of each stream through the per-packet entries


def golden(name: str) -> np.ndarray:
    with np.load(os.path.join(GATE_DIR, name + ".golden.npz")) as z:
        return z["pcm"]


def first_link(data: bytes, reader):
    """(ident, setup, audio packets of the first chain link) as ``reader``
    (either package's OggStreamReader) parses them."""
    r = reader(data, backend="numpy")
    pcks = []
    while (p := r.read_next_audio_packet()) is not None and not r._fresh_link:
        pcks.append(p.data)
    return r.ident_hdr, r.setup_hdr, pcks


def same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", STREAMS)
def test_read_audio_packet_matches_reference(name, corpus_dir):
    data = stream_bytes(name, corpus_dir)
    ti, ts, pcks = first_link(data, OggStreamReader)
    ji, js, _ = first_link(data, JReader)
    pcks = pcks[:N_PACKETS]
    for fmt in FORMATS:
        tp, jp = audio.PreviousWindowRight(), jaudio.PreviousWindowRight()
        for i, p in enumerate(pcks):
            a = audio.read_audio_packet_generic(ti, ts, p, tp, fmt)
            b = jaudio.read_audio_packet_generic(ji, js, p, jp, fmt)
            assert same(a, b), (fmt, i)
        assert same(tp.data, jp.data) and not tp.is_empty()
        tp.reset()
        assert tp.is_empty()
    tp, jp = audio.PreviousWindowRight(), jaudio.PreviousWindowRight()
    for p in pcks:
        assert same(audio.read_audio_packet(ti, ts, p, tp),
                    jaudio.read_audio_packet(ji, js, p, jp))


@pytest.mark.parametrize("name", STREAMS)
def test_floor_curves_match_reference(name, corpus_dir):
    """floor1_synthesis and floor0_curve of every used channel of the first
    packets, each package on its own entropy decode."""
    data = stream_bytes(name, corpus_dir)
    ti, ts, pcks = first_link(data, OggStreamReader)
    ji, js, _ = first_link(data, JReader)
    kinds = set()
    for p in pcks[:N_PACKETS]:
        tplan = audio.decode_packet_entropy(ti, ts, p)
        jplan = jaudio.decode_packet_entropy(ji, js, p)
        n2 = tplan.n // 2
        for tf, jf in zip(tplan.floors, jplan.floors, strict=True):
            assert tf[0] == jf[0]
            if tf[0] == "f1":
                a = floor.floor1_synthesis(tf[1].final_y, tf[1].step2_flag,
                                           tf[1].floor, n2)
                b = jfloor.floor1_synthesis(jf[1].final_y, jf[1].step2_flag,
                                            jf[1].floor, n2)
            elif tf[0] == "f0":
                a = floor.floor0_curve(tf[1], tplan.mode_blockflag, n2,
                                       ti.sample_rate)
                b = jfloor.floor0_curve(jf[1], jplan.mode_blockflag, n2,
                                        ji.sample_rate)
            else:
                continue
            assert a.shape == (n2,) and same(a, b), (tf[0], n2)
            kinds.add(tf[0])
    assert kinds == ({"f0"} if name.startswith("f0_") else {"f1"})


def test_render_line_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(200):
        x0 = int(rng.integers(0, 500))
        x1 = x0 + int(rng.integers(1, 300))
        y0, y1 = (int(v) for v in rng.integers(0, 256, 2))
        a, b = [], []
        floor._render_line(x0, y0, x1, y1, a)
        jfloor._render_line(x0, y0, x1, y1, b)
        assert a == b and len(a) == x1 - x0


@pytest.mark.parametrize("name", STREAMS)
def test_read_all_i16_matches_reference_and_golden(name, corpus_dir):
    data = stream_bytes(name, corpus_dir)
    out = OggStreamReader(data, backend="numpy").read_all_i16()
    assert same(out, JReader(data, backend="numpy").read_all_i16())
    want = golden(name)
    assert out.shape == want.shape
    assert np.abs(out.astype(np.int32) - want).max() <= 2


def test_skip_samples_linear(corpus_dir):
    data = stream_bytes("stereo_44k_q3", corpus_dir)
    r = OggStreamReader(data, backend="numpy")
    pck, leftover = r.skip_samples_linear(30000, fmt="planar_i16")
    jpck, jleft = JReader(data, backend="numpy").skip_samples_linear(30000)
    assert leftover == jleft and same(pck, jpck)
    start = 30000 - leftover
    want = golden("stereo_44k_q3")[start: start + pck.shape[1]].T
    assert np.abs(pck.astype(np.int32) - want).max() <= 2
    pck, leftover = OggStreamReader(stream_bytes("tiny_44k", corpus_dir),
                                    backend="numpy").skip_samples_linear(
        10_000_000)
    assert pck is None and leftover > 0


def test_seek_and_granules(corpus_dir):
    """Page-granularity seek, then packet by packet to the end: the
    reference's packets bit for bit, the golden's tail within +/-2; the
    granule rises to the stream's length."""
    data = stream_bytes("stereo_44k_q3", corpus_dir)
    r, j = (R(data, backend="numpy") for R in (OggStreamReader, JReader))
    r.seek_absgp_pg(66150)
    j.seek_absgp_pg(66150)
    chunks = []
    while (p := r.read_dec_packet()) is not None:
        assert same(p, j.read_dec_packet())
        chunks.append(p)
    assert j.read_dec_packet() is None
    out = np.concatenate(chunks, axis=1)
    total = 132300
    assert out.shape[1] >= total - 66150 - 4096
    want = golden("stereo_44k_q3")[total - out.shape[1]:].T
    assert np.abs(out.astype(np.int32) - want).max() <= 2
    r = OggStreamReader(data, backend="numpy")
    seen = []
    while r.read_dec_packet_itl() is not None:
        seen.append(r.get_last_absgp())
    assert seen[-1] == total
    assert all(b >= a for a, b in zip(seen, seen[1:]))


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_save_restore_across_packages(backend, corpus_dir):
    """A state saved after 10 packets, restored in a reader of the other
    package positioned by packet count: the next 5 packets as the saving
    reader decodes them, both ways; a numpy state holds "pwr"."""
    data = stream_bytes("stereo_44k_q3", corpus_dir)
    for save_cls, load_cls in ((OggStreamReader, JReader),
                               (JReader, OggStreamReader)):
        r = save_cls(data, backend=backend)
        for _ in range(10):
            r.read_dec_packet()
        state = r.save_decode_state()
        assert ("pwr" if backend == "numpy" else "native") in state
        next5 = [r.read_dec_packet() for _ in range(5)]
        r2 = load_cls(data, backend=backend)
        for _ in range(10):
            r2.read_next_audio_packet()
        r2.restore_decode_state(state)
        for a in next5:
            assert same(r2.read_dec_packet(), a)


def _chain(serials=(101, 202), seconds=(0.4, 0.15)):
    from tools import vorbisref as vr

    rng = np.random.default_rng(11)
    links = [vr.encode((rng.standard_normal((2, int(44100 * s))) * 0.3)
                       .astype(np.float32), 44100, quality=0.3, serial=k)
             for k, s in zip(serials, seconds)]
    return b"".join(links), links


def test_chained_links():
    """A chained file whose second link's audio sits on one page: the
    numpy backend as the reference's, the native backend's one call and
    its per-link loop as the reference's native backend, all four within
    1 LSB of each other."""
    data, _ = _chain()
    want = JReader(data, backend="numpy").read_all_planar_f32()
    assert same(OggStreamReader(data, backend="numpy").read_all_planar_f32(),
                want)
    got = OggStreamReader(data, backend="native").read_all_planar_f32()
    assert same(got, JReader(data, backend="native").read_all_planar_f32())
    np.testing.assert_allclose(got, want, atol=2e-4)
    r = OggStreamReader(data, backend="native")
    one = r.read_all_i16()
    assert r.native_route == "one-call"
    assert same(one, JReader(data, backend="native").read_all_i16())
    r = OggStreamReader(data, backend="native")
    r.read_next_audio_packet()  # no longer fresh: the per-link loop
    assert r.read_all_i16().shape[0] < one.shape[0]
    assert r.native_route == "packets"


def test_skip_across_chain_boundary():
    """skip_samples_linear landing in the second link: the first packet of
    a link primes and counts 0 samples."""
    data, links = _chain(serials=(31, 32), seconds=(0.25, 0.3))
    full = OggStreamReader(data, backend="numpy").read_all_planar_f32()
    target = OggStreamReader(links[0], backend="numpy") \
        .read_all_planar_f32().shape[1] + 3000
    got, leftover = OggStreamReader(data, backend="numpy") \
        .skip_samples_linear(target)
    jgot, jleft = JReader(data, backend="numpy").skip_samples_linear(target)
    assert leftover == jleft and same(got, jgot)
    start = target - leftover
    want = np.clip(full[:, start: start + got.shape[1]] * 32768.0,
                   -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(got, want)


def test_sample_count_and_first_packet(corpus_dir):
    ident, setup, pcks = first_link(stream_bytes("stereo_44k_q3", corpus_dir),
                                    OggStreamReader)
    pwr = audio.PreviousWindowRight()
    out = audio.read_audio_packet(ident, setup, pcks[0], pwr)
    assert out.shape == (ident.channels, 0) and not pwr.is_empty()
    for p in pcks[1:40]:
        want = audio.get_decoded_sample_count(ident, setup, p)
        assert audio.read_audio_packet(ident, setup, p, pwr).shape[1] == want


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 -- compared by class name
        return type(e).__name__
    return out


def test_header_garbage_and_damaged_packets(corpus_dir):
    """Header, empty, random, truncated and bit-flipped packets: the
    reference's outcome (PCM bit for bit, or the same VorbisError class)."""
    data = stream_bytes("stereo_44k_q3", corpus_dir)
    ti, ts, pcks = first_link(data, OggStreamReader)
    ji, js, _ = first_link(data, JReader)
    with pytest.raises(AudioIsHeader):
        audio.read_audio_packet(ti, ts, b"\x01vorbis",
                                audio.PreviousWindowRight())
    rng = random.Random(7)
    blobs = [bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
             for _ in range(100)]
    base = pcks[1]
    blobs += [base[:cut] for cut in (1, 2, 5, len(base) // 2)]
    for _ in range(60):
        m = bytearray(base)
        for _ in range(rng.randint(1, 6)):
            m[rng.randrange(len(m))] ^= 1 << rng.randrange(8)
        blobs.append(bytes(m))
    decoded = 0
    for blob in blobs:
        tp, jp = audio.PreviousWindowRight(), jaudio.PreviousWindowRight()
        audio.read_audio_packet(ti, ts, pcks[0], tp)
        jaudio.read_audio_packet(ji, js, pcks[0], jp)
        a = _outcome(lambda: audio.read_audio_packet(ti, ts, blob, tp))
        b = _outcome(lambda: jaudio.read_audio_packet(ji, js, blob, jp))
        if isinstance(a, str):
            assert a == b and issubclass(getattr(errors, a), VorbisError), a
        else:
            assert same(a, b)
            decoded += 1
    assert decoded >= 4  # the truncations decode (EOP is data)


def _variants(data: bytes):
    """tests/test_malformed.py's 14 variants of a stream."""
    rng = np.random.RandomState(1234)
    yield "trunc_header", data[:40]
    yield "trunc_mid", data[: len(data) // 2]
    yield "trunc_1byte", data[:-1]
    yield "empty", b""
    yield "garbage_prefix", b"\x00" * 100 + data
    for _ in range(8):
        b = bytearray(data)
        pos = int(rng.randint(0, len(data)))
        b[pos] ^= 1 << int(rng.randint(0, 8))
        yield f"bitflip_{pos}", bytes(b)
    b = bytearray(data)
    for pos in range(120, min(200, len(b))):
        b[pos] ^= 0xA5
    yield "setup_scramble", bytes(b)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_malformed_never_crashes(backend, corpus_dir):
    """Each variant decodes (packet by packet) or raises VorbisError, and
    OggError is one."""
    assert issubclass(OggError, VorbisError)
    data = stream_bytes("tiny_44k", corpus_dir)
    outcomes = []
    for name, variant in _variants(data):
        try:
            r = OggStreamReader(variant, backend=backend)
            while (pck := r.read_next_audio_packet()) is not None:
                r.dec_packet_planar_f32(pck)
            outcomes.append("ok")
        except VorbisError:
            outcomes.append("error")
        except Exception as e:  # noqa: BLE001
            raise AssertionError(f"variant {name} raised "
                                 f"{type(e).__name__}: {e}") from e
    assert len(outcomes) == 14
