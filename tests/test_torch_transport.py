"""The packed transport's slot blocks (``parallel.batch.TransferSlots``).

On the CPU:

- a slot's native frame buffers are views into four flat blocks, the
  residue, then the bool, i32 and f32 leaves in ``pack_frame_buffers``'
  order, zeroed;
- for a ragged batch at N = 1 and N = 2, under the i16 and the p12
  transport (the native emit's 12-bit planes), ``dispatch``'s four arrays
  and its shapes are byte for byte what ``pack_frame_buffers`` and the p12
  branch make of the same frames, every byte sent from the blocks;
- ``decode_streams_i16`` and a serve run give the same PCM whether the
  frames go from the slot's blocks or are staged (``dispatch`` handed a
  fresh dict of copies), and the counters say which route each byte took.

On a card (marked ``cuda``): the blocks are pinned, a native decode of
seven groups through both slots stages nothing and sends its H2D bytes from
the blocks, and its PCM is bit for bit the staged route's on the card and
within 1 i16 LSB of the CPU route's (the GEMMs sum in other orders there,
as in ``test_torch_cuda.py``). No JAX here, so that the card runs this file
without the conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_transport.py
"""

import os
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lewton_tpu_torch import native, profiling
from lewton_tpu_torch import serve as tserve
from lewton_tpu_torch.header import read_header_ident, read_header_setup
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.parallel import batch
from lewton_tpu_torch.parallel.batch import (BatchDecoder, TransferSlots,
                                             pack_frame_buffers)
from lewton_tpu_torch.parallel.pack12 import pack12_np, pack12_supported
from lewton_tpu_torch.profiling import Count
from lewton_tpu_torch.serve import StreamingScheduler

torch.set_num_threads(1)

GATE = os.path.join(os.path.dirname(__file__), "data", "torch_gate")
CHUNK = 8
#: a ragged batch at chunk 8: 7 groups at scan 1 for the longest stream
LENGTHS = [52, 17, 5]


def _bytes(name="stereo_44k_q3"):
    with open(os.path.join(GATE, name + ".ogg"), "rb") as f:
        return f.read()


def _decoder(data, device="cpu", frontend="auto", scan=1):
    rdr = PacketReader(data)
    pcks = []
    while (p := rdr.read_packet()) is not None:
        pcks.append(p)
    ident = read_header_ident(pcks[0].data)
    setup = read_header_setup(pcks[2].data, ident)
    return BatchDecoder(ident, setup, chunk=CHUNK, scan=scan,
                        raw_headers=(pcks[0].data, pcks[2].data),
                        frontend=frontend, device=device)


def _ragged(data, lengths=LENGTHS):
    spans = native.demux_spans(data)[0][3:]
    return [spans[:n] for n in lengths]


def _counts():
    out = Counter()
    for r in profiling.records():
        if isinstance(r, Count):
            out[r.name] += r.n
    return out


@pytest.fixture(autouse=True)
def _fresh():
    profiling.reset()
    yield
    profiling.reset()


def _staged(monkeypatch):
    """Hand ``dispatch`` a fresh dict of copies of the frames: no array of
    it is a slot's block, so every byte is staged (the route of frames a
    caller built)."""
    orig = TransferSlots.dispatch

    def dispatch(self, slot, fr, *a, **kw):
        return orig(self, slot, {k: v.copy() for k, v in fr.items()}, *a,
                    **kw)
    monkeypatch.setattr(TransferSlots, "dispatch", dispatch)


def _as_packed(fr: dict, N: int, p12: bool):
    """The arrays and shapes that packing the frames makes: the leading N
    dropped at N = 1, ``pack_frame_buffers``, then the p12 branch (the
    native planes re-labelled with the logical width, or ``pack12_np``);
    copies, taken before the frames are sent."""
    if N == 1:
        fr = {k: v[0] for k, v in fr.items()}
    residue, bb, ib, fb, shapes = pack_frame_buffers(fr)
    if p12:
        if residue.dtype == np.uint32:
            logical = residue.shape[:-1] + (residue.shape[-1] * 8 // 3,)
            shapes = (("residue", logical),) + shapes[1:]
        else:
            residue = pack12_np(residue)
        residue = residue.view(np.int32)
    return tuple(a.copy() for a in (residue, bb, ib, fb)), shapes


@pytest.mark.parametrize("transport", ["default", "p12"])
def test_slot_leaves_are_views_into_four_blocks(transport):
    dec = _decoder(_bytes())
    dec._sd.set_residue_transport(transport)
    slots = dec._slots
    N, S = 2, 3
    fr = slots.frame_slot(1, N, S)
    assert fr is slots.frames[(1, N)]
    assert list(fr) == list(dec._sd._native._frame_layout(CHUNK))
    assert fr["residue"].dtype == dec._sd._native.residue_dtype
    blocks = slots.blocks[(1, N)]
    assert len(blocks) == len(batch._PACKED) == 4
    for block, keys in zip(blocks, batch._PACKED):
        assert block.dtype == torch.uint8 and not block.is_pinned()
        off = 0
        for k in keys:
            assert fr[k].ctypes.data == block.data_ptr() + off, k
            assert fr[k].flags.c_contiguous and fr[k].shape[:3] == (N, S,
                                                                     CHUNK)
            off += fr[k].nbytes
        assert off == block.numel()
    assert not any(v.any() for v in fr.values())
    # kept per (slot, N) and handed out again
    assert slots.frame_slot(1, N, S) is fr


@pytest.mark.parametrize("transport", ["i16", "p12"])
@pytest.mark.parametrize("N", [1, 2])
def test_dispatch_sends_the_packed_bytes(monkeypatch, N, transport):
    """The slot's blocks, sent as they are, are the packed buffers of the
    frames the native front-end wrote, byte for byte, shapes too."""
    data = _bytes()
    dec = _decoder(data)
    sd, slots, p12 = dec._sd, dec._slots, transport == "p12"
    assert pack12_supported(sd.cs)
    sd.set_residue_transport("p12" if p12 else "default")
    streams = _ragged(data, [2 * CHUNK + 3, CHUNK - 3, 5])
    S = len(streams)
    fr = slots.frame_slot(0, N, S)
    for n in range(N):
        sd.entropy_chunk_batch([s[n * CHUNK: (n + 1) * CHUNK]
                                for s in streams],
                               out={k: v[n] for k, v in fr.items()})
    assert fr["valid"].sum() == sum(min(len(s), N * CHUNK) for s in streams)
    want, want_shapes = _as_packed(fr, N, p12)
    seen = []
    orig = batch.packed_program

    def packed_program(programs, cs, inputs, shapes, *a, **kw):
        seen.append((inputs, shapes))
        return orig(programs, cs, inputs, shapes, *a, **kw)
    monkeypatch.setattr(batch, "packed_program", packed_program)
    with profile(activities=[ProfilerActivity.CPU]):
        _, _, _, h2d, _ = slots.dispatch(
            0, fr, np.zeros((N, S, CHUNK), np.int64),
            batch._stream_carry(sd.cs, S), p12)
    (got, shapes), = seen
    assert shapes == want_shapes
    for g, w in zip(got, want):
        assert (g.dtype, g.shape) == (w.dtype, w.shape)
        assert g.tobytes() == w.tobytes()
    assert [slots._block(0, g) is not None for g in got] == [True] * 4
    c = _counts()
    assert c["transfer.staged_bytes"] == 0
    assert c["transfer.direct_bytes"] == h2d == sum(w.nbytes for w in want)


def test_python_front_end_frames_are_staged():
    """The Python front-end's fresh buffers (and ``pack12_np``'s planes)
    are no block of a slot: every byte is staged."""
    data = _bytes()
    dec = _decoder(data, frontend="python")
    with profile(activities=[ProfilerActivity.CPU]):
        dec.decode_streams_i16(_ragged(data, [20, 9]), transport="p12")
    c = _counts()
    assert dec.last_stats["transport"] == "p12" and not dec._slots.blocks
    assert c["transfer.direct_bytes"] == 0
    assert c["transfer.staged_bytes"] == dec.last_stats["h2d_bytes"] > 0


@pytest.mark.parametrize("scan", [1, 2])
@pytest.mark.parametrize("transport", ["i16", "p12"])
def test_decode_streams_in_place_equals_staged(monkeypatch, transport, scan):
    data = _bytes()
    streams = _ragged(data)
    dec = _decoder(data, scan=scan)
    with profile(activities=[ProfilerActivity.CPU]):
        got = dec.decode_streams_i16(streams, transport=transport)
    c = _counts()
    assert c["transfer.staged_bytes"] == 0
    assert c["transfer.direct_bytes"] == dec.last_stats["h2d_bytes"]
    profiling.reset()
    _staged(monkeypatch)
    ref = _decoder(data, scan=scan)
    with profile(activities=[ProfilerActivity.CPU]):
        want = ref.decode_streams_i16(streams, transport=transport)
    c = _counts()
    assert c["transfer.direct_bytes"] == 0
    assert c["transfer.staged_bytes"] == ref.last_stats["h2d_bytes"]
    assert ref.last_stats == {**dec.last_stats,
                              "stages": ref.last_stats["stages"]}
    assert len(got) == len(want) == len(streams)
    for g, w in zip(got, want):
        assert g.shape[0] > 0 and np.array_equal(g, w)


def _serve_all(data):
    """Two streams of ``data`` (the second fed in two parts) through a
    CPU scheduler at chunk 8 and scan 2, stepped to the end; each stream's
    polled PCM."""
    sched = StreamingScheduler(capacity=4, chunk=CHUNK, scan=2, device="cpu")
    sched.add_stream("a", data)
    sched.add_stream("b", data[:3000])
    sched.feed("b", data[3000:])
    got = {"a": [], "b": []}
    while sched.step():
        for sid in got:
            got[sid].append(sched.poll(sid))
    for sid in got:
        got[sid].append(sched.poll(sid))
    return {sid: np.concatenate(v) for sid, v in got.items()}, sched


@pytest.mark.parametrize("p12", [False, True])
def test_serve_in_place_equals_staged(monkeypatch, p12):
    data = _bytes()
    if p12:
        monkeypatch.setattr(tserve, "p12_auto",
                            lambda cs, device=None: pack12_supported(cs))
    got, sched = _serve_all(data)
    ((grp,),) = sched.groups.values()
    assert grp._p12 is p12 and grp._slots.blocks
    _staged(monkeypatch)
    want, _ = _serve_all(data)
    for sid in got:
        assert got[sid].shape[0] > 0
        np.testing.assert_array_equal(got[sid], want[sid])


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["i16", "p12"])
def test_card_sends_from_pinned_blocks(monkeypatch, transport):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = _bytes()
    streams = _ragged(data)
    dec = _decoder(data, device="cuda")
    with profile(activities=[ProfilerActivity.CPU]):
        got = dec.decode_streams_i16(streams, transport=transport)
    c = _counts()
    assert dec.last_stats["transport"] == transport
    assert {n for _, n in dec._slots.blocks} == {1}
    assert len(dec._slots.blocks) == 2  # both slots, each reused
    assert all(b.is_pinned() for bs in dec._slots.blocks.values()
               for b in bs)
    assert not dec._slots.pinned  # no staging was needed
    assert c["transfer.staged_bytes"] == 0
    assert c["transfer.direct_bytes"] == dec.last_stats["h2d_bytes"] > 0
    _staged(monkeypatch)
    want = _decoder(data, device="cuda").decode_streams_i16(
        streams, transport=transport)
    cpu = _decoder(data).decode_streams_i16(streams, transport=transport)
    for g, w, h in zip(got, want, cpu):
        assert g.shape[0] > 0 and np.array_equal(g, w)
        assert g.shape == h.shape
        assert np.abs(g.astype(np.int32) - h).max() <= 1
