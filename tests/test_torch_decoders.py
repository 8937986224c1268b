"""The port's host-facing decoders against the reference's on the CPU.

``StreamDecoder`` (decode_packets, decode_packets_i16, save_state /
load_state across the two packages), ``BatchDecoder.decode_streams_i16`` in
all eight ``compact`` x ``scan`` x ``transport`` combinations, the packed
transport (``pack_frame_buffers`` / ``unpack_frame_buffers``) and the 12-bit
residue planes (``pack12_np`` / ``unpack12``). The port runs its plain path
(``device="cpu"``); the reference its XLA path on the CPU, with its Python
front-end.

Tolerances, each with its reason:
- i16 within 1 LSB: the GEMMs sum in different orders, and the reference's
  own kernel and XLA paths differ by that much (tests/test_overlap_kernel.py);
- f32 PCM within 2 x the fp32 sum-order bound of the chunk's spectra plus
  2 ulp of |out| (tests/test_torch_generic_slice.py);
- everything of one package against itself (scan groups against one chunk
  at a time, a state saved and loaded, the transport's round trip) and the
  12-bit planes bit for bit.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lewton_tpu.inside_ogg import read_headers as j_read_headers
from lewton_tpu.models.decoder import StreamDecoder as JStreamDecoder
from lewton_tpu.ogg import PacketReader as JPacketReader
from lewton_tpu.parallel import pack12 as jpack12
from lewton_tpu.parallel.batch import BatchDecoder as JBatchDecoder
from lewton_tpu_torch import native
from lewton_tpu_torch.inside_ogg import read_headers
from lewton_tpu_torch.models.decoder import (StreamDecoder,
                                             synthesize_spectra_tapped)
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.ops.imdct import sum_order_bound
from lewton_tpu_torch.parallel import pack12 as tpack12
from lewton_tpu_torch.parallel.batch import (BatchDecoder, pack_frame_buffers,
                                             unpack_frame_buffers)
from test_torch_frontend import stream_bytes

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

CHUNK = 16
#: the port's two host front-ends
FRONTENDS = ["python", "native"]


def _stream(pkg_reader, pkg_read_headers, name):
    """(headers, audio packets) of a committed gate stream."""
    rdr = pkg_reader(stream_bytes(name))
    headers, serial = pkg_read_headers(rdr)
    pcks = []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial == serial:
            pcks.append(p.data)
    return headers, pcks


def _lsb(a, b) -> int:
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) \
        if a.size else 0


def _f32_bound(sd: StreamDecoder, packets) -> float:
    """2 x the fp32 sum-order bound of the spectra of every chunk."""
    worst = 0.0
    for i in range(0, len(packets), sd.chunk):
        fr = {k: torch.from_numpy(v)[None]
              for k, v in sd.entropy_chunk(packets[i:i + sd.chunk]).items()}
        spectra, _, _ = synthesize_spectra_tapped(sd.cs, fr)
        worst = max(worst, sum_order_bound(spectra))
    return 2.0 * worst


def _raw(headers) -> tuple:
    return headers.raw_ident, headers.raw_setup


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("with_i16", [True, False])
@pytest.mark.parametrize("name", ["stereo_44k_q3", "ch6_44k_q3",
                                  "mono_16k_q3"])
def test_stream_decoder_matches_reference(name, with_i16, frontend):
    """decode_packets_i16 / decode_packets over three chunks, on the port's
    Python and native front-ends, against the reference's
    StreamDecoder(frontend="python"), packet by packet."""
    headers, pcks = _stream(PacketReader, read_headers, name)
    j_headers, _ = _stream(JPacketReader, j_read_headers, name)
    pcks = pcks[:2 * CHUNK + 7]
    sd = StreamDecoder(headers.ident, headers.setup, chunk=CHUNK,
                       raw_headers=_raw(headers), frontend=frontend,
                       device="cpu")
    assert (sd._native is not None) == (frontend == "native")
    ref = JStreamDecoder(j_headers.ident, j_headers.setup, chunk=CHUNK,
                         frontend="python")
    if with_i16:
        got, want = sd.decode_packets_i16(pcks), ref.decode_packets_i16(pcks)
    else:
        got, want = sd.decode_packets(pcks), ref.decode_packets(pcks)
        bound = _f32_bound(sd, pcks)
    assert len(got) == len(want) == len(pcks)
    assert got[0].shape[1] == 0 and sum(g.shape[1] for g in got) > 0
    for g, w in zip(got, want):
        if with_i16:
            assert g.dtype == np.int16 and _lsb(g, np.asarray(w)) <= 1
        else:
            w = np.asarray(w)
            assert g.dtype == np.float32 and g.shape == w.shape
            tol = bound + 2.0 * np.spacing(np.abs(w))
            assert (np.abs(g.astype(np.float64) - w) <= tol).all()


def test_state_round_trip_across_packages():
    """A window carry saved by one package's StreamDecoder and loaded into
    the other's continues to the same PCM within 1 LSB, and a state saved
    and loaded within the port replays the same samples exactly."""
    name = "stereo_44k_q3"
    headers, pcks = _stream(PacketReader, read_headers, name)
    j_headers, _ = _stream(JPacketReader, j_read_headers, name)
    head, tail = pcks[:CHUNK + 5], pcks[CHUNK + 5:2 * CHUNK + 9]
    sd = StreamDecoder(headers.ident, headers.setup, chunk=CHUNK,
                       device="cpu")
    ref = JStreamDecoder(j_headers.ident, j_headers.setup, chunk=CHUNK,
                         frontend="python")
    sd.decode_packets_i16(head)
    ref.decode_packets_i16(head)
    mine, theirs = sd.save_state(), ref.save_state()
    assert [a.dtype for a in mine] == [np.asarray(b).dtype for b in theirs]
    assert [a.shape for a in mine] == [np.shape(b) for b in theirs]
    # the port continues from the reference's state, and the other way
    sd2 = StreamDecoder(headers.ident, headers.setup, chunk=CHUNK,
                        device="cpu")
    sd2.load_state(theirs)
    ref2 = JStreamDecoder(j_headers.ident, j_headers.setup, chunk=CHUNK,
                          frontend="python")
    ref2.load_state(mine)
    want = ref.decode_packets_i16(tail)
    for g, w in zip(sd2.decode_packets_i16(tail), want):
        assert _lsb(g, np.asarray(w)) <= 1
    got = sd.decode_packets_i16(tail)
    for g, w in zip(got, ref2.decode_packets_i16(tail)):
        assert _lsb(g, np.asarray(w)) <= 1
    # within the port: load the saved state again, replay bit for bit
    sd.load_state(mine)
    for g, again in zip(got, sd.decode_packets_i16(tail)):
        assert np.array_equal(g, again)
    assert sum(g.shape[1] for g in got) > 0


def test_entry_points_default_to_the_card():
    """StreamDecoder, BatchDecoder and OggStreamReader take
    ``device="cuda"`` unless the caller names another; without a card the
    decoders fail instead of running on the CPU."""
    from lewton_tpu_torch.inside_ogg import OggStreamReader

    for fn in (StreamDecoder, BatchDecoder, OggStreamReader):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    headers, _ = _stream(PacketReader, read_headers, "tiny_44k")
    if torch.cuda.is_available():
        assert StreamDecoder(headers.ident, headers.setup).cs.device.type \
            == "cuda"
    else:
        for make in (StreamDecoder, BatchDecoder):
            with pytest.raises((AssertionError, RuntimeError)):
                make(headers.ident, headers.setup)


def test_no_native_front_end_and_no_mesh(tmp_path):
    """frontend="native" takes the port's library and decodes; without the
    raw header packets it raises ValueError. mesh=: a 1-rank gloo CPU mesh
    decodes tiny_44k bit for bit as the unsharded decoder (one rank holds
    every stream and the whole contraction); an object that is not a mesh
    raises TypeError."""
    import torch.distributed as dist

    from lewton_tpu_torch.parallel import make_mesh

    headers, pcks = _stream(PacketReader, read_headers, "tiny_44k")
    hs = (headers.ident, headers.setup)
    sd = StreamDecoder(*hs, raw_headers=_raw(headers), frontend="native",
                       device="cpu")
    assert isinstance(sd._native, native.NativeStream)
    assert sum(p.shape[1] for p in sd.decode_packets_i16(pcks)) > 0
    with pytest.raises(ValueError, match="raw_headers"):
        StreamDecoder(*hs, frontend="native", device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        BatchDecoder(*hs, mesh=object(), device="cpu")
    streams = [pcks, pcks[:7]]
    plain = BatchDecoder(*hs, chunk=CHUNK, device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'pg'}",
                            rank=0, world_size=1)
    try:
        dec = BatchDecoder(*hs, chunk=CHUNK, mesh=make_mesh(1, 1, "cpu"))
        assert dec.device.type == "cpu"
        for got, want in ((dec.decode_streams(streams),
                           plain.decode_streams(streams)),
                          (dec.decode_streams_i16(streams),
                           plain.decode_streams_i16(streams))):
            assert len(got) == 2
            for g, w in zip(got, want):
                assert g.size and np.array_equal(g, w)
    finally:
        dist.destroy_process_group()


# ---- BatchDecoder ----

#: every compact x scan x transport combination; the two the reference is
#: run in are first
COMBOS = [("device", 1, "i16"), ("host", 3, "p12"), ("device", 1, "p12"),
          ("device", 3, "i16"), ("device", 3, "p12"), ("host", 1, "i16"),
          ("host", 1, "p12"), ("host", 3, "i16")]


@pytest.fixture(scope="module")
def batch():
    """Two streams of stereo_44k_q3 (56 and 41 packets: scan-3 groups of 2
    chunks of 16 and a tail), the reference's decode_streams_i16 in the
    first two COMBOS, and a cache of the port's outputs."""
    name = "stereo_44k_q3"
    headers, pcks = _stream(PacketReader, read_headers, name)
    j_headers, _ = _stream(JPacketReader, j_read_headers, name)
    streams = [pcks[:56], pcks[:41]]
    ref = {}
    for compact, scan, transport in COMBOS[:2]:
        dec = JBatchDecoder(j_headers.ident, j_headers.setup, chunk=CHUNK,
                            frontend="python", scan=scan)
        ref[(compact, scan, transport)] = dec.decode_streams_i16(
            streams, compact=compact, transport=transport)
    return headers, streams, ref, {}


def _port_batch(batch, combo, frontend="python"):
    headers, streams, _, cache = batch
    if (combo, frontend) not in cache:
        compact, scan, transport = combo
        dec = BatchDecoder(headers.ident, headers.setup, chunk=CHUNK,
                           scan=scan, raw_headers=_raw(headers),
                           frontend=frontend, device="cpu")
        cache[(combo, frontend)] = (dec.decode_streams_i16(
            streams, compact=compact, transport=transport), dec.last_stats)
    return cache[(combo, frontend)]


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("combo", COMBOS,
                         ids=lambda c: "-".join(map(str, c)))
def test_batch_decoder_i16(batch, combo, frontend):
    """Each combination, on either front-end, within 1 LSB of the reference
    (in the two combinations it ran, the other six held to them), a scan
    group bit for bit equal to one chunk at a time and the native
    front-end's PCM to the Python front-end's, and the transport's bytes as
    the encoding sets them."""
    compact, scan, transport = combo
    outs, stats = _port_batch(batch, combo, frontend)
    _, streams, ref, _ = batch
    assert stats["transport"] == transport
    for want in ref.values():
        assert len(outs) == len(want) == 2
        for g, w in zip(outs, want):
            assert g.dtype == np.int16 and _lsb(g, w) <= 1
    if scan > 1:
        for g, w in zip(outs, _port_batch(batch, (compact, 1, transport),
                                          frontend)[0]):
            assert np.array_equal(g, w)
    for g, w in zip(outs, _port_batch(batch, combo)[0]):
        assert np.array_equal(g, w)
    i16_stats = _port_batch(batch, (compact, scan, "i16"), frontend)[1]
    assert stats["d2h_bytes"] == i16_stats["d2h_bytes"] > 0
    stages = stats["stages"]
    assert stages["wall"] > 0 and abs(sum(
        stages[k] for k in ("frontend", "h2d", "device", "d2h", "compact",
                            "other")) - stages["wall"]) < 1e-6
    if transport == "p12":
        assert stats["h2d_bytes"] < i16_stats["h2d_bytes"]


def test_batch_decode_streams_f32(batch):
    """decode_streams (planar f32) against decode_streams_i16 of the same
    streams: the i16 conversion of the one within 1 LSB of the other."""
    headers, streams, _, _ = batch
    dec = BatchDecoder(headers.ident, headers.setup, chunk=CHUNK,
                       raw_headers=_raw(headers), device="cpu")
    f32 = dec.decode_streams(streams)
    i16 = _port_batch(batch, ("device", 1, "i16"))[0]
    for f, g in zip(f32, i16):
        conv = np.trunc(np.clip(f.T * 32768.0, -32768, 32767)).astype(np.int16)
        assert _lsb(conv, g) <= 1
    assert dec.last_stats["h2d_bytes"] > 0 and dec.last_stats["d2h_bytes"] > 0


@pytest.mark.parametrize("p12", [False, True])
def test_frame_buffers_round_trip(p12):
    """pack_frame_buffers -> (pack12) -> unpack_frame_buffers gives the
    frames back exactly, as the reference's layout."""
    headers, pcks = _stream(PacketReader, read_headers, "stereo_44k_q3")
    sd = StreamDecoder(headers.ident, headers.setup, chunk=CHUNK,
                       device="cpu")
    fr = sd.entropy_chunk_batch([pcks[:CHUNK], pcks[3:12]])
    residue, b, i, f, shapes = pack_frame_buffers(fr)
    assert b.dtype == np.uint8 and i.dtype == np.int32 \
        and f.dtype == np.float32
    if p12:
        assert tpack12.pack12_supported(sd.cs)
        residue = tpack12.pack12_np(residue).view(np.int32)
    got = unpack_frame_buffers(*(torch.from_numpy(a)
                                 for a in (residue, b, i, f)), shapes)
    assert got.keys() == fr.keys()
    for k in fr:
        assert got[k].numpy().dtype == fr[k].dtype, k
        assert got[k].numpy().tobytes() == fr[k].tobytes(), k


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 6), st.lists(st.integers(1, 3), max_size=2),
       st.integers(0, 2 ** 32 - 1))
def test_pack12_matches_reference(k, lead, seed):
    """pack12_np and unpack12 bit for bit against the reference's, on
    random values over the whole 12-bit range and its edges."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2048, 2048, size=tuple(lead) + (8 * k,), dtype=np.int16)
    x.reshape(-1)[:2] = (-2048, 2047)
    got = tpack12.pack12_np(x)
    want = jpack12.pack12_np(x)
    assert got.dtype == want.dtype == np.uint32
    assert got.tobytes() == want.tobytes()
    un = tpack12.unpack12(torch.from_numpy(got.view(np.int32)), 8 * k)
    assert un.dtype == torch.int16
    assert un.numpy().tobytes() == np.asarray(
        jpack12.unpack12(jnp.asarray(want), 8 * k)).tobytes() == x.tobytes()


def test_pack12_refuses_out_of_range_and_auto_is_i16_on_the_cpu():
    with pytest.raises(ValueError, match="outside"):
        tpack12.pack12_np(np.full(8, 2048, np.int16))
    headers, _ = _stream(PacketReader, read_headers, "stereo_44k_q3")
    sd = StreamDecoder(headers.ident, headers.setup, device="cpu")
    assert tpack12.pack12_supported(sd.cs)
    assert not tpack12.p12_auto(sd.cs)
