# Frozen copy of lewton_tpu_torch/ogg/demux.py as of commit b69f200 (only
# the import of errors changed), part of the benchmark's plain NumPy reference
# decoder. Imports nothing outside this folder.
"""Ogg container demux (host side, pure Python reference implementation).

The reference delegates this to the external `ogg` crate (PacketReader,
page CRC, lacing, granule positions, seek — see SURVEY.md L5). Here it is a
first-class component: pages -> packets with CRC verification, multiplexed
logical streams, continued-packet reassembly, end-of-stream flags, granule
bookkeeping and page-granularity bisection seek.

The port's copy of lewton_tpu/ogg/demux.py: the same packets, flags and
granules, held equal to it by the CPU tests.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

from .errors import OggError

__all__ = ["Packet", "PacketReader", "IncrementalPacketReader", "OggError",
           "crc32_ogg"]

CAPTURE = b"OggS"
CONTINUED = 0x01
BOS = 0x02
EOS = 0x04
NO_GRANULE = (1 << 64) - 1  # granule field value -1: no packet ends on page

# Ogg CRC32: polynomial 0x04c11db7, MSB-first (non-reflected), init 0,
# no final xor — deliberately not zlib's CRC.
_CRC_TABLE = []
for _i in range(256):
    _r = _i << 24
    for _ in range(8):
        _r = ((_r << 1) ^ 0x04C11DB7) if (_r & 0x80000000) else (_r << 1)
        _r &= 0xFFFFFFFF
    _CRC_TABLE.append(_r)


def crc32_ogg(data: bytes, crc: int = 0) -> int:
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) & 0xFF) ^ b]
    return crc


@dataclass
class Packet:
    """One logical bitstream packet (parity: ogg crate's Packet)."""

    data: bytes
    stream_serial: int
    #: first packet of its logical stream (began on a BOS page)
    first_in_stream: bool
    #: packet ends on an EOS page and is the last delivered for the stream
    last_in_stream: bool
    #: granule position of the page this packet *ends* on, if this packet is
    #: the last packet completed on that page; None otherwise
    absgp_page: int | None
    first_in_page: bool
    last_in_page: bool
    #: granule of the page this packet ends on regardless of position
    #: (the ogg crate exposes this for every packet; None if the page
    #: carries no granule)
    page_granule: int | None = None


@dataclass
class _Page:
    header_type: int
    granule: int
    serial: int
    seq: int
    segments: list[bytes]
    continued: bool
    offset: int  # byte offset of the page start in the input


class PacketReader:
    """Sequential packet reader over a seekable byte source.

    Verifies page CRCs, reassembles packets across page boundaries (lacing),
    handles multiplexed serials, and supports page-granularity seeking by
    absolute granule position (bisection, parity with ogg crate seek_absgp).
    """

    def __init__(self, source):
        if isinstance(source, (bytes, bytearray, memoryview)):
            self._f = io.BytesIO(bytes(source))
        else:
            self._f = source
        self._f.seek(0, 2)
        self._size = self._f.tell()
        self._f.seek(0)
        # per-serial reassembly state
        self._partial: dict[int, bytearray] = {}
        self._started_on_bos: dict[int, bool] = {}
        #: per-serial last page sequence number: a gap (lost/corrupt page
        #: skipped by CRC resync, or a seek) means any pending continued
        #: data lost its tail and must be dropped, never spliced onto the
        #: next page's data (the external `ogg` crate does the same)
        self._last_seq: dict[int, int] = {}
        self._queue: list[Packet] = []

    # ------------------------------------------------------------------ #

    def _read_page_at(self, offset: int, resync: bool = True) -> _Page | None:
        """Parse one page at/after ``offset``. Returns None at EOF.

        With resync=True, scans forward for the capture pattern (tolerates
        junk between pages, as the ogg crate does)."""
        f = self._f
        f.seek(offset)
        window = f.read(65536 + 27)
        while True:
            idx = window.find(CAPTURE)
            if idx < 0:
                if len(window) < 4:
                    return None
                if not resync:
                    raise OggError("capture pattern missing")
                offset += len(window) - 3
                f.seek(offset)
                window = f.read(65536 + 27)
                if not window:
                    return None
                continue
            start = offset + idx
            f.seek(start)
            header = f.read(27)
            if len(header) < 27:
                return None
            version = header[4]
            if version != 0:
                if not resync:
                    raise OggError(f"unsupported ogg page version {version}")
                offset = start + 4
                f.seek(offset)
                window = f.read(65536 + 27)
                continue
            header_type = header[5]
            granule = int.from_bytes(header[6:14], "little")
            serial = int.from_bytes(header[14:18], "little")
            seq = int.from_bytes(header[18:22], "little")
            crc = int.from_bytes(header[22:26], "little")
            nsegs = header[26]
            lacing = f.read(nsegs)
            if len(lacing) < nsegs:
                return None
            body_len = sum(lacing)
            body = f.read(body_len)
            if len(body) < body_len:
                return None
            # CRC check with the CRC field zeroed
            check = crc32_ogg(
                header[:22] + b"\x00\x00\x00\x00" + header[26:27] + lacing + body
            )
            if check != crc:
                if not resync:
                    raise OggError("page CRC mismatch")
                # skip this capture and rescan (corrupt page)
                offset = start + 4
                f.seek(offset)
                window = f.read(65536 + 27)
                continue
            segments: list[bytes] = []
            pos = 0
            cur = bytearray()
            for lace in lacing:
                cur += body[pos : pos + lace]
                pos += lace
                if lace < 255:
                    segments.append(bytes(cur))
                    cur = bytearray()
            unterminated = nsegs > 0 and lacing[-1] == 255
            if unterminated:
                segments.append(bytes(cur))  # partial packet data (may be long)
            page = _Page(
                header_type=header_type,
                granule=granule,
                serial=serial,
                seq=seq,
                segments=segments,
                continued=bool(header_type & CONTINUED),
                offset=start,
            )
            page._unterminated = unterminated  # type: ignore[attr-defined]
            page._end = f.tell()  # type: ignore[attr-defined]
            return page

    def _next_page(self) -> _Page | None:
        pos = self._f.tell()
        page = self._read_page_at(pos)
        if page is None:
            # partial page (or EOF): restore so a later feed() can resume
            self._f.seek(pos)
        return page

    def _deliver_page(self, page: _Page) -> None:
        serial = page.serial
        is_bos = bool(page.header_type & BOS)
        is_eos = bool(page.header_type & EOS)
        last = self._last_seq.get(serial)
        self._last_seq[serial] = page.seq
        if last is not None and page.seq != (last + 1) & 0xFFFFFFFF:
            # sequence hole: the pending packet head lost its tail
            self._partial.pop(serial, None)
            self._started_on_bos.pop(serial, None)
        unterminated = getattr(page, "_unterminated", False)
        segs = page.segments
        n = len(segs)
        packets_here: list[bytes] = []
        firsts: list[bool] = []
        for i, seg in enumerate(segs):
            last_unterminated = unterminated and i == n - 1
            if i == 0 and page.continued:
                pending = self._partial.pop(serial, None)
                if pending is None:
                    # continuation of a packet whose head was never seen
                    # (post-seek or sequence hole): drop the tail — never
                    # seed it as a packet head (a later page would splice
                    # onto it and deliver a garbage packet). If it spans
                    # this page too, the next page's continued flag drops
                    # the rest the same way.
                    continue
                data = bytes(pending) + seg
                first = self._started_on_bos.pop(serial, False)
            else:
                data = seg
                first = is_bos
            if last_unterminated:
                self._partial[serial] = bytearray(data)
                self._started_on_bos[serial] = first
            else:
                packets_here.append(data)
                firsts.append(first)
        m = len(packets_here)
        for i, (data, first) in enumerate(zip(packets_here, firsts)):
            ends_page = i == m - 1
            self._queue.append(
                Packet(
                    data=data,
                    stream_serial=serial,
                    first_in_stream=first and i == 0,
                    last_in_stream=is_eos and ends_page and not unterminated,
                    absgp_page=(
                        page.granule
                        if ends_page and page.granule != NO_GRANULE
                        else None
                    ),
                    first_in_page=i == 0,
                    last_in_page=ends_page,
                    page_granule=(
                        page.granule if page.granule != NO_GRANULE else None
                    ),
                )
            )

    # ------------------------------------------------------------------ #

    def read_packet(self) -> Packet | None:
        """Next packet in page order, or None at end of input."""
        while not self._queue:
            page = self._next_page()
            if page is None:
                return None
            self._f.seek(page._end)  # type: ignore[attr-defined]
            self._deliver_page(page)
        return self._queue.pop(0)

    def read_packet_expected(self) -> Packet:
        p = self.read_packet()
        if p is None:
            raise OggError("unexpected end of ogg stream")
        return p

    def delete_unread_packets(self) -> None:
        self._queue.clear()
        self._partial.clear()
        self._started_on_bos.clear()
        self._last_seq.clear()

    # ------------------------------------------------------------------ #

    def seek_absgp(self, absgp: int, serial: int | None = None) -> None:
        """Page-granularity seek: position so the next page delivered is the
        earliest page (of ``serial``, or any) whose granule is >= absgp,
        i.e. decode resumes at the last page boundary before the target.

        Parity: ogg crate seek_absgp as used by OggStreamReader::seek_absgp_pg
        (lewton src/inside_ogg.rs:307-313).
        """
        lo, hi = 0, self._size
        best_after = None  # offset of first page with granule >= absgp
        # Bisection over byte offsets; each probe scans forward to a page.
        for _ in range(64):
            if hi - lo < 65536 * 2:
                break
            mid = (lo + hi) // 2
            page = self._read_page_at(mid)
            # skip pages of other serials / no-granule pages going forward
            while page is not None and (
                (serial is not None and page.serial != serial)
                or page.granule == NO_GRANULE
            ):
                page = self._read_page_at(page._end)  # type: ignore[attr-defined]
            if page is None or page.granule >= absgp:
                if page is not None:
                    best_after = page.offset
                hi = mid
            else:
                lo = page._end  # type: ignore[attr-defined]
        # linear scan of the remaining window
        off = lo
        target = None
        prev_end = lo
        while off < hi:
            page = self._read_page_at(off)
            if page is None or page.offset >= hi:
                break
            matches = (serial is None or page.serial == serial) and (
                page.granule != NO_GRANULE
            )
            if matches and page.granule >= absgp:
                target = page.offset
                break
            off = page._end  # type: ignore[attr-defined]
            if matches:
                prev_end = page.offset
        if target is None:
            target = best_after if best_after is not None else prev_end
        self.delete_unread_packets()
        self._f.seek(target)


class IncrementalPacketReader(PacketReader):
    """Streaming ingestion: bytes arrive in arbitrary chunks via feed();
    read_packet() returns packets as soon as their pages are complete and
    None (retryable) otherwise. Partial trailing pages are left buffered.
    """

    def __init__(self, initial: bytes = b""):
        super().__init__(initial)

    def feed(self, data: bytes) -> None:
        pos = self._f.tell()
        self._f.seek(0, 2)
        self._f.write(data)
        self._size = self._f.tell()
        self._f.seek(pos)
