"""The benchmark's own Ogg page writer (RFC 3533), with the page CRC.

A stream is written as libvorbis lays one out: the identification header
alone on the first page (beginning of stream), the comment and setup
headers on the second, then audio pages of about ``PAGE_BYTES`` each, each
page ending on a packet boundary and carrying the granule position of the
last packet it completes; the last page has the end-of-stream flag.

The Ogg CRC is CRC-32 with polynomial 0x04C11DB7, initial value 0, no
reflection and no final xor. It equals the bit reversal of the reflected
CRC (zlib's polynomial) of the bit-reversed bytes, so the whole file is
bit-reversed once with a table and each page's CRC is one ``zlib.crc32``
call: a few hundred MB a second on one core.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_stream", "ogg_crc", "ogg_crc_bitwise", "PAGE_BYTES"]

#: audio page body size at which a page is closed (libvorbis: about 4 KB)
PAGE_BYTES = 4096
_HEADER = struct.Struct("<4sBBqIII")  # capture .. crc; then the segment count
_REV8 = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


def _rev32(x: int) -> int:
    return int(f"{x:032b}"[::-1], 2)


def _crc_of_reversed(rev: memoryview) -> int:
    """The Ogg CRC of the bytes whose bit-reversed image is ``rev``."""
    return _rev32(zlib.crc32(rev, 0xFFFFFFFF) ^ 0xFFFFFFFF)


def ogg_crc(data: bytes) -> int:
    return _crc_of_reversed(memoryview(_REV8[np.frombuffer(data, np.uint8)]))


def ogg_crc_bitwise(data: bytes) -> int:
    """The same CRC bit by bit, as the specification states it (tests)."""
    crc = 0
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7 if crc & 0x80000000 else crc << 1)
            crc &= 0xFFFFFFFF
    return crc


def _pages(packets: list[bytes], granules: list[int], first_audio: int):
    """(packet indices, granule, flags) of each page: headers 0 and 1..
    first_audio-1 on pages of their own as above, audio packets closed
    into a page once its body reaches PAGE_BYTES or its lacing 255
    segments."""
    pages = [([0], 0, 2)]
    if first_audio > 1:
        pages.append((list(range(1, first_audio)), 0, 0))
    cur, body, segs = [], 0, 0
    for i in range(first_audio, len(packets)):
        n = len(packets[i]) // 255 + 1
        if cur and (segs + n > 255 or body >= PAGE_BYTES):
            pages.append((cur, granules[cur[-1]], 0))
            cur, body, segs = [], 0, 0
        cur.append(i)
        body += len(packets[i])
        segs += n
    if cur:
        pages.append((cur, granules[cur[-1]], 0))
    idx, gran, flags = pages[-1]
    pages[-1] = (idx, gran, flags | 4)
    return pages


def write_stream(packets: list[bytes], granules: list[int], serial: int,
                 first_audio: int = 3) -> bytes:
    """One logical Ogg stream holding ``packets`` (the first
    ``first_audio`` are headers), each page's granule the ``granules``
    entry of the last packet on it. No packet is longer than 255 * 254
    bytes (a Vorbis audio packet is a few hundred)."""
    out = bytearray()
    crc_at = []  # (page start, page end)
    for seq, (idx, gran, flags) in enumerate(
            _pages(packets, granules, first_audio)):
        lacing = bytearray()
        for i in idx:
            n = len(packets[i])
            if n >= 255 * 255:
                raise ValueError("packet too long for one page")
            lacing += b"\xff" * (n // 255) + bytes([n % 255])
        start = len(out)
        out += _HEADER.pack(b"OggS", 0, flags, gran, serial & 0xFFFFFFFF,
                            seq, 0)
        out.append(len(lacing))
        out += lacing
        for i in idx:
            out += packets[i]
        crc_at.append((start, len(out)))
    rev = memoryview(_REV8[np.frombuffer(out, np.uint8)])
    for start, end in crc_at:
        struct.pack_into("<I", out, start + 22,
                         _crc_of_reversed(rev[start:end]))
    return bytes(out)
