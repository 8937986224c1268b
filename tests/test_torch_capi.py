"""The port's lewton-compatible C ABI (``native/lt_capi.cc``,
``native/lewton_tpu.h``) on the CPU: the cases of tests/test_capi.py against
the port's library (``_build.capi_library``, the stable link C clients use)
and header.

``lewton_context_from_extradata`` / ``lewton_decode_packet`` through
ctypes: within +/-2 LSB of the libvorbis golden and bit for bit as the
reference's library's C ABI; ``lewton_context_reset``; malformed
extradata refused; the reader's ``backend="native"`` against the golden;
and ``examples/capi_demo.c`` built with ``cc`` against the port's header
and library, its WAV within +/-2 LSB of the port's numpy backend over the
granule-trimmed range.
"""

import ctypes as C
import os
import subprocess
import wave

import numpy as np
import pytest
import torch

from lewton_tpu import native as jnative
from lewton_tpu.inside_ogg import OggStreamReader as JReader
from lewton_tpu_torch import _build, native
from lewton_tpu_torch.inside_ogg import OggStreamReader
from test_torch_frontend import GATE_DIR, stream_bytes
from test_torch_native import build_reference_native

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def declare(lib: C.CDLL) -> C.CDLL:
    """Declare the C ABI's entry points (lewton_tpu.h) on ``lib``."""
    u8p = C.POINTER(C.c_uint8)
    lib.lewton_context_from_extradata.restype = C.c_void_p
    lib.lewton_context_from_extradata.argtypes = [u8p, C.c_size_t]
    lib.lewton_context_reset.argtypes = [C.c_void_p]
    lib.lewton_context_reset.restype = None
    lib.lewton_decode_packet.restype = C.c_int
    lib.lewton_decode_packet.argtypes = [C.c_void_p, u8p, C.c_size_t,
                                         C.POINTER(C.c_void_p)]
    lib.lewton_samples_count.restype = C.c_size_t
    lib.lewton_samples_count.argtypes = [C.c_void_p]
    lib.lewton_samples_channels.restype = C.c_size_t
    lib.lewton_samples_channels.argtypes = [C.c_void_p]
    lib.lewton_samples_f32.restype = C.POINTER(C.c_float)
    lib.lewton_samples_f32.argtypes = [C.c_void_p, C.c_size_t]
    lib.lewton_samples_drop.argtypes = [C.c_void_p]
    lib.lewton_samples_drop.restype = None
    lib.lewton_context_drop.argtypes = [C.c_void_p]
    lib.lewton_context_drop.restype = None
    return lib


@pytest.fixture(scope="module")
def lib():
    link = _build.capi_library()
    assert link.is_symlink() and link.resolve() == \
        _build.host_library_path().resolve()
    return declare(C.CDLL(str(link)))


@pytest.fixture(scope="module")
def ref_lib():
    build_reference_native()
    return declare(C.CDLL(os.path.join(ROOT, "lewton_tpu", "native",
                                       "liblewton_host.so")))


def _u8(b: bytes):
    return (C.c_uint8 * len(b)).from_buffer_copy(b)


def xiph_extradata(ident: bytes, comment: bytes, setup: bytes) -> bytes:
    def lace(n):
        return b"\xff" * (n // 255) + bytes([n % 255])

    return (bytes([2]) + lace(len(ident)) + lace(len(comment)) + ident
            + comment + setup)


def header_packets(data: bytes):
    pcks = native.demux(data)
    serial = pcks[0].stream_serial
    mine = [p for p in pcks if p.stream_serial == serial]
    return mine[0].data, mine[1].data, mine[2].data, [p.data for p in mine[3:]]


def capi_decode(lib, data: bytes) -> np.ndarray:
    """Every audio packet through the C ABI: planar f32 [C, n] (no
    end-of-stream trim: the packet API knows no granules)."""
    ident, comment, setup, audio = header_packets(data)
    extradata = xiph_extradata(ident, comment, setup)
    ctx = lib.lewton_context_from_extradata(_u8(extradata), len(extradata))
    assert ctx
    chunks = []
    try:
        for pck in audio:
            out = C.c_void_p()
            assert lib.lewton_decode_packet(ctx, _u8(pck), len(pck),
                                            C.byref(out)) == 0
            n = lib.lewton_samples_count(out)
            ch = lib.lewton_samples_channels(out)
            if n:
                chunks.append(np.stack([np.ctypeslib.as_array(
                    lib.lewton_samples_f32(out, c), (n,)).copy()
                    for c in range(ch)]))
            lib.lewton_samples_drop(out)
    finally:
        lib.lewton_context_drop(ctx)
    return np.concatenate(chunks, axis=1)


def golden(name: str) -> np.ndarray:
    with np.load(os.path.join(GATE_DIR, name + ".golden.npz")) as z:
        return z["pcm"]


@pytest.mark.parametrize("name", ["stereo_44k_q3", "mono_8k_q-1",
                                  "ch6_44k_q3"])
def test_capi_decode_matches_golden(lib, ref_lib, name, corpus_dir):
    data = stream_bytes(name, corpus_dir)
    pcm = capi_decode(lib, data)
    assert pcm.tobytes() == capi_decode(ref_lib, data).tobytes()
    i16 = np.trunc(np.clip(pcm * 32768.0, -32768, 32767)).astype(np.int16).T
    want = golden(name)
    assert i16.shape[0] >= want.shape[0]
    d = np.abs(i16[: want.shape[0]].astype(np.int32) - want)
    assert int((d > 2).sum()) == 0, f"max diff {d.max()}"


def test_capi_reset(lib, corpus_dir):
    """The first 4 packets, reset, the same 4 again: equal PCM."""
    ident, comment, setup, audio = header_packets(
        stream_bytes("tiny_44k", corpus_dir))
    extradata = xiph_extradata(ident, comment, setup)
    ctx = lib.lewton_context_from_extradata(_u8(extradata), len(extradata))

    def run():
        outs = []
        for pck in audio[:4]:
            out = C.c_void_p()
            assert lib.lewton_decode_packet(ctx, _u8(pck), len(pck),
                                            C.byref(out)) == 0
            n = lib.lewton_samples_count(out)
            if n:
                outs.append(np.stack([np.ctypeslib.as_array(
                    lib.lewton_samples_f32(out, c), (n,)).copy()
                    for c in range(lib.lewton_samples_channels(out))]))
            lib.lewton_samples_drop(out)
        return np.concatenate(outs, axis=1)

    a = run()
    lib.lewton_context_reset(ctx)
    np.testing.assert_array_equal(a, run())
    lib.lewton_context_drop(ctx)


def test_capi_rejects_bad_extradata(lib, corpus_dir):
    """A count byte other than 2, lacing past the end and an unparsable
    setup: no context; a NULL packet: a nonzero code."""
    ident, comment, setup, audio = header_packets(
        stream_bytes("tiny_44k", corpus_dir))
    good = xiph_extradata(ident, comment, setup)
    for bad in (bytes([3, 1, 1, 0, 0, 0]), good[:5],
                xiph_extradata(ident, comment, setup[:20]), b""):
        assert not lib.lewton_context_from_extradata(_u8(bad or b"\0"),
                                                     len(bad))
    ctx = lib.lewton_context_from_extradata(_u8(good), len(good))
    out = C.c_void_p()
    assert lib.lewton_decode_packet(ctx, None, 0, C.byref(out)) != 0
    assert lib.lewton_decode_packet(ctx, _u8(b"\x01vorbis"), 7,
                                    C.byref(out)) != 0
    lib.lewton_context_drop(ctx)


@pytest.mark.parametrize("name", ["stereo_44k_q3", "mono_8k_q-1",
                                  "chained_44k", "tiny_44k"])
def test_native_backend_matches_golden(name, corpus_dir):
    """OggStreamReader(backend='native'): the whole C++ CPU decode, exact
    length and 0 samples over +/-2 LSB; the reference's native reader bit
    for bit."""
    data = stream_bytes(name, corpus_dir)
    out = OggStreamReader(data, backend="native").read_all_i16()
    want = golden(name)
    assert out.shape == want.shape
    d = np.abs(out.astype(np.int32) - want)
    assert int((d > 2).sum()) == 0, f"max diff {d.max()}"
    assert jnative.available()
    assert out.tobytes() == JReader(data, backend="native").read_all_i16() \
        .tobytes()


def build_capi_demo(exe: str) -> None:
    """examples/capi_demo.c, unchanged, against the port's header and the
    stable link of its library."""
    link = _build.capi_library()
    subprocess.run(
        ["cc", "-O2", os.path.join(ROOT, "examples", "capi_demo.c"),
         "-I", os.path.join(ROOT, "lewton_tpu_torch", "native"),
         "-L", str(link.parent), "-llewton_host", "-lm", "-o", exe],
        check=True)


@pytest.mark.parametrize("name", ["stereo_44k_q3", "ch6_44k_q3"])
def test_capi_demo_c_builds_and_decodes(name, corpus_dir, tmp_path):
    """The pure-C client (demux through lt_ogg_*, xiph extradata,
    lewton_decode_packet, WAV out) within +/-2 LSB of the port's numpy
    backend over the granule-trimmed range (the C demo keeps the untrimmed
    tail, as lewton's capi does)."""
    exe = str(tmp_path / "capi_demo")
    build_capi_demo(exe)
    src = tmp_path / f"{name}.ogg"
    data = stream_bytes(name, corpus_dir)
    src.write_bytes(data)
    wav_path = str(tmp_path / "out.wav")
    env = dict(os.environ, LD_LIBRARY_PATH=str(_build.BUILD_DIR))
    r = subprocess.run([exe, str(src), wav_path], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    with wave.open(wav_path) as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), dtype=np.int16)
        pcm = pcm.reshape(-1, w.getnchannels())
        rate, channels = w.getframerate(), w.getnchannels()
    ref_rdr = OggStreamReader(data, backend="numpy")
    ref = ref_rdr.read_all_i16()
    assert (rate, channels) == (ref_rdr.ident_hdr.sample_rate, ref.shape[1])
    assert len(pcm) >= len(ref)
    d = np.abs(pcm[: len(ref)].astype(np.int32) - ref)
    assert int((d > 2).sum()) == 0, f"max diff {d.max()}"
