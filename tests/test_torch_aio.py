"""The port's async reader (``lewton_tpu_torch/aio.py``) on the CPU.

Every case of ``tests/test_aio.py``: the bytes dribble in through an async
source in steps of 1, 17, 333, 555, 777 or 1024 bytes, and the port's
``AsyncOggStreamReader`` gives the port's sync ``OggStreamReader`` PCM bit
for bit, packet for packet, the chained stream included; the same bytes
through the reference's async reader (its numpy decoder) give the same
packet lengths and PCM within 1 i16 LSB (the port's device path is held to
the reference's by as much). Also the header surface, the iterator
protocol, EOF before the headers (the port's ``OggError``) and the backend
check. The CPU backends (``"numpy"``, ``"native"``) at the same steps: the
port's sync reader on the same backend and the reference's async reader on
it, bit for bit.
"""

import asyncio

import numpy as np
import pytest
import torch

from lewton_tpu.aio import AsyncOggStreamReader as JAsyncReader
from lewton_tpu_torch.aio import AsyncOggStreamReader, HeadersReader
from lewton_tpu_torch.errors import OggError
from lewton_tpu_torch.inside_ogg import OggStreamReader
from test_torch_frontend import stream_bytes

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)


class _Dribble:
    """async source: serves the file in tiny uneven chunks."""

    def __init__(self, data: bytes, step: int):
        self._data = data
        self._pos = 0
        self._step = step

    async def read(self, n: int) -> bytes:
        await asyncio.sleep(0)
        step = min(self._step, n)
        out = self._data[self._pos: self._pos + step]
        self._pos += len(out)
        return out


class _Chunks:
    """async source: an async iterator of byte chunks."""

    def __init__(self, data: bytes, step: int):
        self._it = iter(data[i: i + step] for i in range(0, len(data), step))

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        try:
            return next(self._it)
        except StopIteration:
            raise StopAsyncIteration from None


async def _packets(rdr) -> list:
    out = []
    async for pcm in rdr:
        out.append(pcm)
    return out


def _port_packets(data: bytes, step: int, source=_Dribble, backend="torch"):
    async def go():
        rdr = await AsyncOggStreamReader.new(source(data, step),
                                             backend=backend, device="cpu")
        return await _packets(rdr), rdr
    return asyncio.run(go())


def _ref_packets(data: bytes, step: int, backend="numpy") -> list:
    async def go():
        return await _packets(await JAsyncReader.new(_Dribble(data, step),
                                                     backend=backend))
    return asyncio.run(go())


def _sync_packets(data: bytes, backend="torch") -> list:
    sync = OggStreamReader(data, backend=backend, device="cpu")
    out = []
    while (pcm := sync.read_dec_packet()) is not None:
        out.append(pcm)
    return out, sync


@pytest.mark.parametrize("name,step", [("stereo_44k_q3", 777),
                                       ("chained_44k", 555),
                                       ("chained_44k", 17),
                                       ("tiny_44k", 1)])
def test_async_matches_sync_and_reference(name, step):
    """Every packet's planar i16 as the sync reader's, bit for bit, and
    the granule at the end; the reference's async reader: the same packet
    shapes, PCM within 1 LSB. chained_44k: a link's BOS ident page and its
    comment/setup page arrive separately, so the chain re-init starves
    and resumes."""
    data = stream_bytes(name)
    got, rdr = _port_packets(data, step)
    want, sync = _sync_packets(data)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int16 and g.shape == w.shape
        assert np.array_equal(g, w)
    assert rdr.get_last_absgp() == sync.get_last_absgp()
    assert rdr.ident_hdr.channels == sync.ident_hdr.channels
    ref = _ref_packets(data, step)
    assert [r.shape for r in ref] == [g.shape for g in got]
    a, b = np.concatenate(got, axis=1), np.concatenate(ref, axis=1)
    assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("name,step", [("stereo_44k_q3", 777),
                                       ("chained_44k", 555),
                                       ("chained_44k", 17),
                                       ("tiny_44k", 1)])
def test_async_cpu_backends(backend, name, step):
    """The numpy and native backends: every packet as the sync reader's
    on the same backend and as the reference's async reader's, bit for
    bit, and the granule at the end."""
    data = stream_bytes(name)
    got, rdr = _port_packets(data, step, backend=backend)
    want, sync = _sync_packets(data, backend)
    ref = _ref_packets(data, step, backend)
    assert len(got) == len(want) == len(ref)
    for g, w, r in zip(got, want, ref):
        assert g.dtype == np.int16 and g.shape == w.shape == r.shape
        assert np.array_equal(g, w) and np.array_equal(g, r)
    assert rdr.get_last_absgp() == sync.get_last_absgp()


def test_async_iterator_source():
    """An async iterator of byte chunks is a source too."""
    data = stream_bytes("tiny_44k")
    got, _ = _port_packets(data, 1000, source=_Chunks)
    want, _ = _sync_packets(data)
    assert np.array_equal(np.concatenate(got, axis=1),
                          np.concatenate(want, axis=1))


def test_headers_reader():
    data = stream_bytes("mono_16k_q3")

    async def go():
        hr = HeadersReader(_Dribble(data, 333))
        ident, comment, setup_pck = await hr.read_headers()
        return ident, comment, setup_pck, hr

    ident, comment, setup_pck, hr = asyncio.run(go())
    assert ident.channels == 1 and ident.sample_rate == 16000
    assert comment.vendor  # libvorbis vendor string
    sync = OggStreamReader(data, device="cpu")
    assert setup_pck.data == sync._raw_headers[1]

    async def resume():  # the buffered reader continues into the audio
        rdr = await AsyncOggStreamReader.new(hr, device="cpu")
        return await _packets(rdr)

    want, _ = _sync_packets(data)
    got = asyncio.run(resume())
    assert np.array_equal(np.concatenate(got, axis=1),
                          np.concatenate(want, axis=1))


def test_headers_eof_errors():
    async def go():
        hr = HeadersReader(_Dribble(b"OggS\x00trunc", 4))
        await hr.read_headers()

    with pytest.raises(OggError):
        asyncio.run(go())


def test_async_iterator_protocol():
    data = stream_bytes("tiny_44k")

    async def go():
        rdr = await AsyncOggStreamReader.new(_Dribble(data, 1024),
                                             device="cpu")
        out = await rdr.read_dec_packet_itl()
        total = 0 if out is None else out.shape[0]
        async for pcm in rdr:
            total += pcm.size
        return total

    total = asyncio.run(go())
    want = OggStreamReader(data, device="cpu").read_all_i16().size
    assert total == want


def test_backend_and_source_checks():
    """Only the sync reader's backends ('torch', 'numpy', 'native'); a
    source without read() or __aiter__ is refused; the class is built
    through new()."""
    data = stream_bytes("tiny_44k")
    with pytest.raises(ValueError, match="torch"):
        asyncio.run(AsyncOggStreamReader.new(_Dribble(data, 100),
                                             backend="jax", device="cpu"))
    with pytest.raises(TypeError):
        HeadersReader(object())
    with pytest.raises(TypeError):
        AsyncOggStreamReader()
