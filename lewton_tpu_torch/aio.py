"""Async I/O API (ref parity: lewton src/inside_ogg.rs:316-451, the
`async_ogg` feature's `async_api` module); the port of lewton_tpu/aio.py.

The reference exposes two async-ready types over any `AsyncRead`:
`HeadersReader`, a Future resolving to the three Vorbis headers, and
`OggStreamReader`, a Stream yielding per-packet planar i16. The analog
here wraps any *async byte source* around the incremental demuxer
(ogg/demux.IncrementalPacketReader) and the sync OggStreamReader's decode
and granule bookkeeping:

    headers = await HeadersReader(source).read_headers()
    rdr = await AsyncOggStreamReader.new(source)   # decodes on the card
    async for pcm in rdr:           # planar i16 [ch, n] per packet
        ...

``backend=`` takes the sync reader's backends: ``"torch"`` (the default,
on ``device``), ``"numpy"`` and ``"native"`` (CPU decoders).

A *source* is an object with ``async def read(n) -> bytes`` (asyncio's
StreamReader qualifies; empty bytes = end of stream) or an async iterator
of byte chunks. Any chunking works, including byte-at-a-time: when a
chain link's comment/setup packets have not been fed yet, the sync
reader's resumable re-init (inside_ogg `_resumable_chain`) pushes the
consumed packets back and this wrapper awaits more bytes — a link's BOS
ident page and its comment/setup page are always separate pages, so this
is the common case, not a corner.

For decoding *many* concurrent streams on the card, use serve.py's
StreamingScheduler instead — this module is the per-stream convenience
surface; the scheduler is the throughput path.
"""

from __future__ import annotations

import numpy as np

from .errors import OggError
from .header import read_header_comment, read_header_ident
from .inside_ogg import BACKENDS, OggStreamReader
from .ogg.demux import IncrementalPacketReader

__all__ = ["HeadersReader", "AsyncOggStreamReader"]

_CHUNK = 64 * 1024


class _Source:
    """Normalizes the two accepted source shapes to `await pull() -> bytes`
    (empty = exhausted)."""

    def __init__(self, source):
        if hasattr(source, "read"):
            self._mode = "read"
            self._src = source
        elif hasattr(source, "__aiter__"):
            self._mode = "aiter"
            self._src = source.__aiter__()
        else:
            raise TypeError(
                "async source must have `async def read(n)` or be an "
                "async iterator of byte chunks")
        self.exhausted = False

    async def pull(self) -> bytes:
        if self.exhausted:
            return b""
        if self._mode == "read":
            chunk = await self._src.read(_CHUNK)
        else:
            try:
                chunk = await self._src.__anext__()
            except StopAsyncIteration:
                chunk = b""
        if not chunk:
            self.exhausted = True
        return bytes(chunk)


class HeadersReader:
    """Await the three Vorbis headers out of an async byte stream
    (ref: async_api::HeadersReader, src/inside_ogg.rs:337-393). After
    `read_headers()`, pass this object to AsyncOggStreamReader.new to
    continue with the already-buffered audio packets."""

    def __init__(self, source):
        self._source = _Source(source)
        self._rdr = IncrementalPacketReader()
        self._hdr_packets: list = []

    async def _next_packet(self):
        while True:
            pck = self._rdr.read_packet()
            if pck is not None:
                return pck
            chunk = await self._source.pull()
            if not chunk:
                return None
            self._rdr.feed(chunk)

    async def read_headers(self):
        """Returns (ident, comment, setup packet) by buffering exactly the
        three header packets; raises OggError on EOF first (the reference
        maps this to an UnexpectedEof read error)."""
        while len(self._hdr_packets) < 3:
            pck = await self._next_packet()
            if pck is None:
                raise OggError(
                    "Expected header packet but found end of stream")
            if self._hdr_packets and (
                    pck.stream_serial
                    != self._hdr_packets[0].stream_serial):
                continue  # multiplexed: skip other serials
            self._hdr_packets.append(pck)
        ident = read_header_ident(self._hdr_packets[0].data)
        comment = read_header_comment(self._hdr_packets[1].data)
        return ident, comment, self._hdr_packets[2]


class _Replay:
    """The packet source of the sync reader: the three buffered header
    packets first, then the incremental demuxer's packets (None while it
    is starved)."""

    def __init__(self, headers: list, inner: IncrementalPacketReader):
        self._headers = headers
        self._inner = inner

    def read_packet(self):
        if self._headers:
            return self._headers.pop(0)
        return self._inner.read_packet()

    def read_packet_expected(self):
        p = self.read_packet()
        if p is None:
            raise OggError("unexpected end of ogg stream")
        return p

    def delete_unread_packets(self):
        pass

    def seek_absgp(self, *a, **kw):
        raise NotImplementedError(
            "seek is not available on a live async stream")


class AsyncOggStreamReader:
    """Async per-packet decode stream (ref: async_api::OggStreamReader,
    src/inside_ogg.rs:405-450 — a Stream of planar i16). Decoding itself
    is synchronous (as in the reference, whose poll() decodes inline), on
    ``device`` through the sync reader's per-packet decoder; the awaits
    are for input bytes only."""

    def __init__(self):
        raise TypeError("use `await AsyncOggStreamReader.new(source)`")

    @classmethod
    async def new(cls, source, backend: str = "torch", device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        hr = source if isinstance(source, HeadersReader) \
            else HeadersReader(source)
        await hr.read_headers()
        self = object.__new__(cls)
        self._source = hr._source
        self._rdr = hr._rdr
        # replay the three header packets in front of the audio stream so
        # the sync reader performs its own (identical) header parse
        self._osr = OggStreamReader(_Replay(list(hr._hdr_packets), self._rdr),
                                    backend=backend, device=device)
        # chained-stream re-inits must surface "need more data" (None) so
        # read_dec_packet can await more bytes, not raise mid-chain
        self._osr._resumable_chain = True
        return self

    # header surface (ref: pub ident_hdr/comment_hdr/setup_hdr fields)
    @property
    def ident_hdr(self):
        return self._osr.ident_hdr

    @property
    def comment_hdr(self):
        return self._osr.comment_hdr

    @property
    def setup_hdr(self):
        return self._osr.setup_hdr

    def get_last_absgp(self):
        return self._osr.cur_absgp

    async def read_dec_packet(self) -> np.ndarray | None:
        """Planar i16 [ch, n] for the next audio packet, or None at end
        of stream (Stream::poll parity, with the sync reader's absgp
        end-truncation semantics)."""
        while True:
            out = self._osr.read_dec_packet()
            if out is not None:
                return out
            # None = demuxer starved OR true end: distinguish by feeding
            chunk = await self._source.pull()
            if not chunk:
                return None
            self._rdr.feed(chunk)

    async def read_dec_packet_itl(self) -> np.ndarray | None:
        out = await self.read_dec_packet()
        return None if out is None else out.T.reshape(-1)

    def __aiter__(self):
        return self

    async def __anext__(self) -> np.ndarray:
        out = await self.read_dec_packet()
        if out is None:
            raise StopAsyncIteration
        return out
