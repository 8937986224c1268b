"""The port's OggStreamReader and the conformance gate's committed data.

- ``read_all_i16`` on the CPU plain path within +/-2 LSB of the committed
  libvorbis golden on every committed gate stream, exact length (the
  conformance contract; the card runs the same gate in chip_smoke.py);
- each committed golden equals ``tools/vorbisref``'s decode of the
  committed stream, and the manifest's sha256 match the files;
- the per-packet reads, the chained-stream re-init, ``skip_samples_linear``,
  ``seek_absgp_pg`` and ``save_decode_state`` / ``restore_decode_state``
  against the reference's ``backend="jax"`` reader on ``tiny_44k`` and
  ``chained_44k``: the same packet shapes and positions exactly, samples
  within 1 LSB (the GEMMs' sum order), and a restored state replaying the
  port's own samples bit for bit.

The port's reads run on each of its host front-ends: the native library
(the default: native demux and entropy decode) and the Python one.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from lewton_tpu.inside_ogg import OggStreamReader as JReader
from lewton_tpu_torch.inside_ogg import OggStreamReader
from lewton_tpu_torch.models.decoder import StreamDecoder
from lewton_tpu_torch.native import NativePacketReader
from lewton_tpu_torch.ogg import PacketReader
from test_torch_decoders import FRONTENDS, _lsb
from test_torch_frontend import GATE, GATE_DIR, MANIFEST, stream_bytes

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)


def golden(name: str) -> np.ndarray:
    path = os.path.join(GATE_DIR, MANIFEST["streams"][name]["golden"])
    with np.load(path) as z:
        return z["pcm"]


def port_reader(data: bytes, frontend: str) -> OggStreamReader:
    """The port's reader on its native front-end (the default: native demux
    and entropy decode) or on its Python one (the Python PacketReader, and
    StreamDecoders with frontend="python")."""
    if frontend == "native":
        r = OggStreamReader(data, device="cpu")
        assert isinstance(r.rdr, NativePacketReader)
        return r
    r = OggStreamReader(PacketReader(data), device="cpu")
    r._stream_decoder = lambda **kw: StreamDecoder(
        r.ident_hdr, r.setup_hdr, raw_headers=r._raw_headers,
        frontend="python", device=r.device, **kw)
    return r


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("name", GATE)
def test_read_all_i16_matches_golden(name, frontend):
    out = port_reader(stream_bytes(name), frontend).read_all_i16()
    want = golden(name)
    assert out.dtype == np.int16 and out.shape == want.shape
    assert _lsb(out, want) <= 2


@pytest.mark.parametrize("name", GATE)
def test_gate_data_matches_libvorbis(tmp_path, name):
    """The committed golden is libvorbisfile's decode of the committed
    stream; both files carry the manifest's sha256."""
    from tools import vorbisref

    entry = MANIFEST["streams"][name]
    for key in ("ogg", "golden"):
        with open(os.path.join(GATE_DIR, entry[key]), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == \
                entry[key + "_sha256"], key
    path = tmp_path / entry["ogg"]
    path.write_bytes(stream_bytes(name))
    want = vorbisref.decode_file_i16(str(path))
    got = golden(name)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert got.shape == (entry["samples"], entry["channels"])


def test_gate_data_budget_and_coverage():
    """The committed set stays within its budget and covers every channel
    count, rate, floor type and stream kind the gate is meant to cover."""
    total = sum(os.path.getsize(os.path.join(GATE_DIR, e[k]))
                for e in MANIFEST["streams"].values() for k in ("ogg", "golden"))
    assert total == MANIFEST["bytes"] <= MANIFEST["budget"] <= 4_000_000
    streams = MANIFEST["streams"]
    assert {e["channels"] for e in streams.values()} >= {1, 2, 4, 6, 8}
    kinds = {e["kind"] for e in streams.values()}
    assert kinds == {"corpus", "crafted_floor1", "floor0"}
    assert {"chained_44k", "silence_44k", "impulses_44k", "tiny_44k",
            "stereo_44k_managed", "mono_8k_q-1", "stereo_96k_q6",
            "f1_three_modes_coupled"} <= set(streams)
    assert set(MANIFEST["left_out"]) == {"long_44k_q2"}


def _readers(name, frontend):
    data = stream_bytes(name)
    return port_reader(data, frontend), JReader(data, backend="jax")


def _same_packet(a, b) -> None:
    assert (a is None) == (b is None)
    if a is not None:
        assert a.dtype == b.dtype and _lsb(a, b) <= 1


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("name", ["tiny_44k", "chained_44k"])
def test_per_packet_reads_match_reference(name, frontend):
    """read_dec_packet / read_dec_packet_itl packet by packet to the end of
    the stream (through the chained re-init on chained_44k), the granule
    after each packet, and read_all_planar_f32 of a fresh reader."""
    mine, ref = _readers(name, frontend)
    n, serials = 0, {mine.stream_serial}
    while True:
        fmt = "read_dec_packet_itl" if n % 3 == 2 else "read_dec_packet"
        a, b = getattr(mine, fmt)(), getattr(ref, fmt)()
        _same_packet(a, b)
        if a is None:
            break
        assert mine.get_last_absgp() == ref.get_last_absgp()
        assert mine.stream_serial == ref.stream_serial
        serials.add(mine.stream_serial)
        n += 1
    assert n > 5 and len(serials) == 1 + (name == "chained_44k")
    mine, ref = _readers(name, frontend)
    a, b = mine.read_all_planar_f32(), ref.read_all_planar_f32()
    assert a.dtype == np.float32 and a.shape == b.shape
    assert np.abs(a - b).max() <= 2.0 ** -15


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("name,skip,seek", [("tiny_44k", 700, 1000),
                                            ("chained_44k", 33000, 20000)])
def test_skip_and_seek_match_reference(name, skip, seek, frontend):
    """skip_samples_linear (into the second link on chained_44k), then the
    rest of the stream; seek_absgp_pg, then the rest of the stream."""
    mine, ref = _readers(name, frontend)
    (a, la), (b, lb) = (r.skip_samples_linear(skip) for r in (mine, ref))
    assert la == lb
    _same_packet(a, b)
    while True:
        a, b = mine.read_dec_packet(), ref.read_dec_packet()
        _same_packet(a, b)
        if a is None:
            break
    mine, ref = _readers(name, frontend)
    mine.seek_absgp_pg(seek)
    ref.seek_absgp_pg(seek)
    n = 0
    while True:
        a, b = mine.read_dec_packet(), ref.read_dec_packet()
        _same_packet(a, b)
        if a is None:
            break
        assert mine.get_last_absgp() == ref.get_last_absgp()
        n += 1
    assert n > 0


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("name", ["tiny_44k", "chained_44k"])
def test_save_restore_matches_reference(name, frontend):
    """A state saved after a few packets and restored into a fresh reader
    at the same position replays the same samples bit for bit; the
    reference's saved carry, restored into the port's reader, continues
    within 1 LSB of the reference."""
    def positioned(reader, k):
        for _ in range(k):
            reader.read_next_audio_packet()
        return reader

    k = 4
    mine, ref = _readers(name, frontend)
    for _ in range(k):
        mine.read_dec_packet()
        ref.read_dec_packet()
    state, j_state = mine.save_decode_state(), ref.save_decode_state()
    assert state.keys() == {"cur_absgp", "backend", "started", "torch"}
    nxt = [mine.read_dec_packet() for _ in range(3)]
    j_nxt = [ref.read_dec_packet() for _ in range(3)]
    again = positioned(port_reader(stream_bytes(name), frontend), k)
    again.restore_decode_state(state)
    for a, b in zip(nxt, (again.read_dec_packet() for _ in range(3))):
        assert np.array_equal(a, b)
    cross = positioned(port_reader(stream_bytes(name), frontend), k)
    cross.restore_decode_state(
        {"cur_absgp": j_state["cur_absgp"], "started": j_state["started"],
         "backend": "torch", "torch": j_state["jax"]})
    for a, b in zip(j_nxt, (cross.read_dec_packet() for _ in range(3))):
        _same_packet(b, a)
    # a state saved before any decode resets a live decoder's window
    fresh = port_reader(stream_bytes(name), frontend)
    first = fresh.save_decode_state()
    assert "torch" not in first
    fresh.read_dec_packet()
    fresh.restore_decode_state(first)
    assert not fresh._decode_started
