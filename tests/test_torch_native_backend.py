"""The port's CPU decoder (``native/lt_synth.cc``, ``lt_file.cc``) and the
reader's ``backend="native"`` on the CPU.

Both host libraries are built under the file locks of
``tests/test_torch_native.py`` (importing it builds them). The port's
``NativeDecoder`` and ``decode_ogg_i16`` are held to the reference's
library bit for bit, with the exceptions that file names:
``REFERENCE_RESIDUE_DIVERGES`` (packets whose bits run out inside a
codeword, which the port's library spends) and ``DAMAGED_REFERENCE_DIVERGES``.
Those packets, and the packet after each (which laps with it), are held to
the libvorbis golden (+/-2 LSB) and within 2 LSB of the port's numpy
backend instead. Also: the whole-file decode's return codes on chained
streams, those whose links change the channel count and a chain cut inside
a link's headers; ``decode_many`` in runs of fewer than 8 packets (one
thread) against whole runs (up to 8 threads); a saved state loading into
the other package's decoder; the reader's one-call and per-link routes;
and the sanitizer build of the fuzzer over ``tiny_44k``.
"""

import ctypes as C
import os
import subprocess

import numpy as np
import pytest
import torch

from lewton_tpu import errors as jerrors
from lewton_tpu import native as jnative
from lewton_tpu.inside_ogg import OggStreamReader as JReader
from lewton_tpu_torch import _build, native
from lewton_tpu_torch.errors import AudioBadFormat, AudioIsHeader, VorbisError
from lewton_tpu_torch.inside_ogg import OggStreamReader
from lewton_tpu_torch.samples import to_i16
from test_torch_frontend import GATE_DIR, MUTATIONS, STREAMS, stream_bytes
from test_torch_native import (DAMAGED_REFERENCE_DIVERGES,
                               REFERENCE_RESIDUE_DIVERGES)

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

#: chained streams made of two gate streams: (first, second, return code
#: of the whole-file decode)
CHAINS = (("tiny_44k", "stereo_44k_q3", None),
          ("mono_16k_q3", "tiny_44k", -4),
          ("tiny_44k", "ch6_44k_q3", -4),
          ("mono_8k_q-1", "mono_16k_q3", None))


def first_link(data: bytes):
    """(raw ident and setup packets, audio packets) of the first link."""
    r = OggStreamReader(data, backend="native")
    pcks = []
    while (p := r.read_next_audio_packet()) is not None and not r._fresh_link:
        pcks.append(p.data)
    return r._raw_headers, pcks


def decode_all(dec, pcks) -> list:
    out = []
    for p in pcks:
        try:
            out.append(dec.decode(p))
        except (VorbisError, jerrors.VorbisError) as e:
            out.append(type(e).__name__)
    return out


def same_out(a, b) -> bool:
    """Two decode outcomes (PCM, or an error's class name) are equal."""
    if isinstance(a, str) or isinstance(b, str):
        return isinstance(a, str) and isinstance(b, str) and a == b
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def ref_decode_ogg_i16(data: bytes, channels: int, n1: int):
    """The reference library's lt_decode_ogg_i16: (code, planar i16)."""
    lib = jnative._load()
    src = np.frombuffer(data, dtype=np.uint8)
    h = lib.lt_ogg_new(src.ctypes.data_as(C.POINTER(C.c_uint8)), len(data))
    try:
        cap = max(int(lib.lt_ogg_packet_count(h)), 1) * (3 * n1 // 4) + 8
        pcm = np.zeros((channels, cap), np.int16)
        absgp = C.c_int64(0)
        n = int(lib.lt_decode_ogg_i16(
            h, pcm.ctypes.data_as(C.POINTER(C.c_int16)), cap, C.byref(absgp)))
    finally:
        lib.lt_ogg_free(h)
    return n, pcm[:, :max(n, 0)], int(absgp.value)


def golden(name: str):
    path = os.path.join(GATE_DIR, name + ".golden.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return z["pcm"]


def numpy_packets(data: bytes) -> list:
    """The port's numpy backend, packet by packet (first link), planar f32."""
    r = OggStreamReader(data, backend="numpy")
    out = []
    while (p := r.read_next_audio_packet()) is not None and not r._fresh_link:
        out.append(r._decode(p.data))
    return out


@pytest.mark.parametrize("name", STREAMS)
def test_native_decoder_matches_reference(name, corpus_dir):
    data = stream_bytes(name, corpus_dir)
    raw, pcks = first_link(data)
    mine = decode_all(native.NativeDecoder(*raw), pcks)
    want = decode_all(jnative.NativeDecoder(*raw), pcks)
    apart = set()
    for i in REFERENCE_RESIDUE_DIVERGES.get(name, ()):
        apart |= {i, i + 1}
    differ = {i for i, (a, b) in enumerate(zip(mine, want, strict=True))
              if not same_out(a, b)}
    assert differ == apart
    if not apart:
        return
    ref = numpy_packets(data)
    pos = np.cumsum([0] + [a.shape[1] for a in mine])
    gold = golden(name)
    for i in sorted(apart):
        got = to_i16(mine[i]).astype(np.int32)
        assert np.abs(got - to_i16(ref[i])).max() <= 2
        assert np.abs(got - gold[pos[i]: pos[i + 1]].T).max() <= 2


@pytest.mark.parametrize("name,idx,kind,arg",
                         [m for m in MUTATIONS if m[2] == "truncate"])
def test_damaged_packets_match_reference(name, idx, kind, arg):
    """A truncated packet, then the next one: the reference's outcome bit
    for bit, except DAMAGED_REFERENCE_DIVERGES, held within 2 LSB of the
    numpy backend."""
    data = stream_bytes(name)
    raw, pcks = first_link(data)
    seq = pcks[:idx] + [pcks[idx][:arg]] + pcks[idx + 1: idx + 2]
    mine = decode_all(native.NativeDecoder(*raw), seq)[idx:]
    want = decode_all(jnative.NativeDecoder(*raw), seq)[idx:]
    if (name, idx, kind, arg) not in DAMAGED_REFERENCE_DIVERGES:
        assert all(same_out(a, b) for a, b in zip(mine, want, strict=True))
        return
    r = OggStreamReader(data, backend="numpy")
    ref = [r._decode(p) for p in seq][idx:]
    assert mine[-1].size  # the next packet laps with the damaged one
    for a, b in zip(mine, ref, strict=True):
        assert a.shape == b.shape
        if a.size:
            assert np.abs(to_i16(a).astype(np.int32) - to_i16(b)).max() <= 2


def _chain_bytes(first, second, corpus_dir):
    return stream_bytes(first, corpus_dir) + stream_bytes(second, corpus_dir)


@pytest.mark.parametrize("name", ["chained_44k", "tiny_44k", "f1_two_submaps",
                                  "ch6_44k_q3", "f1_bs8192",
                                  "f0_coupled_stereo"]
                         + [f"{a}+{b}" for a, b, _ in CHAINS] + ["cut_chain"])
def test_decode_ogg_i16_matches_reference(name, corpus_dir):
    """The one-call whole-file decode: the reference's return code, PCM bit
    for bit (f1_two_submaps: the golden's +/-2 instead) and granule."""
    if name == "cut_chain":  # the second link's ident page alone
        data = stream_bytes("tiny_44k", corpus_dir) + \
            stream_bytes("mono_16k_q3", corpus_dir)[:58]
    elif "+" in name:
        data = _chain_bytes(*name.split("+"), corpus_dir)
    else:
        data = stream_bytes(name, corpus_dir)
    r = OggStreamReader(data, backend="native")
    args = (r.ident_hdr.channels, 1 << r.ident_hdr.blocksize_1)
    n, pcm, absgp = native.decode_ogg_i16_rc(data, *args)
    jn, jpcm, jabsgp = ref_decode_ogg_i16(data, *args)
    assert n == jn
    want_rc = {f"{a}+{b}": rc for a, b, rc in CHAINS}.get(name)
    if want_rc is not None or name == "cut_chain":
        assert n == (want_rc or -2)
        assert native.decode_ogg_i16(data, *args) is None
        return
    assert n > 0 and absgp == jabsgp
    if name in REFERENCE_RESIDUE_DIVERGES:
        assert pcm.tobytes() != jpcm.tobytes()
        assert np.abs(pcm.T.astype(np.int32) - golden(name)).max() <= 2
    else:
        assert pcm.tobytes() == jpcm.tobytes()
    if golden(name) is not None and "+" not in name:
        assert pcm.T.shape == golden(name).shape


@pytest.mark.parametrize("name", ["stereo_44k_q3", "ch6_44k_q3", "f1_bs8192",
                                  "f0_coupled_stereo"])
def test_decode_many_one_and_eight_threads(name, corpus_dir):
    """decode_many over the whole first link (runs of 8 or more spread over
    up to 8 threads) against runs of 7 (the sequential path, one thread)
    and against decode(), packet by packet, bit for bit."""
    assert (os.cpu_count() or 1) > 1
    raw, pcks = first_link(stream_bytes(name, corpus_dir))
    assert len(pcks) >= 8
    pcm, lens = native.NativeDecoder(*raw).decode_many(pcks)
    one = native.NativeDecoder(*raw)
    parts = [one.decode_many(pcks[i: i + 7]) for i in range(0, len(pcks), 7)]
    assert np.array_equal(lens, np.concatenate([p[1] for p in parts]))
    assert pcm.tobytes() == np.concatenate([p[0] for p in parts]).tobytes()
    loop = decode_all(native.NativeDecoder(*raw), pcks)
    C_ = pcm.shape[1]
    for i, a in enumerate(loop):
        n = int(lens[i])
        assert a.tobytes() == pcm[i].reshape(-1)[: C_ * n].tobytes()


def test_decoder_state_across_packages(corpus_dir):
    """save_state after 10 packets, load_state into the other package's
    decoder: the next 5 packets as the saver decodes them, both ways; a
    state of the wrong size is refused."""
    raw, pcks = first_link(stream_bytes("stereo_44k_q3", corpus_dir))
    for save_cls, load_cls in ((native.NativeDecoder, jnative.NativeDecoder),
                               (jnative.NativeDecoder, native.NativeDecoder)):
        a = save_cls(*raw)
        for p in pcks[:10]:
            a.decode(p)
        state = a.save_state()
        b = load_cls(*raw)
        b.load_state(state)
        for p in pcks[10:15]:
            assert a.decode(p).tobytes() == b.decode(p).tobytes()
    with pytest.raises(ValueError):
        native.NativeDecoder(*raw).load_state(
            {"pwr": np.zeros(3, np.float32), "plen": 2, "started": True})
    dec = native.NativeDecoder(*raw)
    with pytest.raises(AudioBadFormat):
        dec.decode(b"")
    with pytest.raises(AudioIsHeader):
        dec.decode(b"\x01vorbis")
    dec.reset()
    assert dec.save_state()["plen"] == 0


@pytest.mark.parametrize("pair", [f"{a}+{b}" for a, b, _ in CHAINS])
def test_reader_routes(pair, corpus_dir):
    """read_all_i16 on a fresh native reader: one call where the library
    takes the stream, the per-link loop where it hands it back (the links
    change the channel count), the reference's native reader's output bit
    for bit either way, and the route recorded."""
    data = _chain_bytes(*pair.split("+"), corpus_dir)
    rc = dict((f"{a}+{b}", rc) for a, b, rc in CHAINS)[pair]
    r = OggStreamReader(data, backend="native")
    out = r.read_all_i16()
    assert r.native_route == ("packets" if rc else "one-call")
    want = JReader(data, backend="native").read_all_i16()
    assert out.dtype == want.dtype and out.tobytes() == want.tobytes()
    f32 = OggStreamReader(data, backend="native").read_all_planar_f32()
    assert f32.shape[::-1] == out.shape


def test_native_asan_fuzz(corpus_dir):
    """native/tools/lt_fuzz.cc with the library's sources under ASAN and
    UBSAN over tiny_44k and its mutations: no sanitizer finding."""
    exe = _build.build_fuzzer()
    r = subprocess.run([str(exe), os.path.join(GATE_DIR, "tiny_44k.ogg")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "without sanitizer findings" in r.stdout
