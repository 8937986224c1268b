"""A configuration's source stream and the files the benchmark makes of it.

A file is the source stream's three header packets, then its audio
packets in a seeded rotation of their cycle, repeated a whole number of
times, written into Ogg pages with right granules (``oggwrite``). The cycle
is the source's audio packets from the first one at which the stream can
wrap around: Vorbis long blocks carry the sizes of their neighbours'
windows (spec 4.3.1), so the last packet of the cycle must end in the
window that its first packet begins with. Every packet order inside such a
cycle is a valid Vorbis stream, and the last page's granule is the exact
number of samples the packets decode to, so no decoder cuts anything.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..reference.audio import _packet_begin, _window_geometry
from ..reference.bitpack import BitCursor
from ..reference.header import read_header_ident, read_header_setup
from ..reference.ogg_demux import PacketReader
from .oggwrite import write_stream

__all__ = ["Source", "File", "load_source"]


@dataclass
class File:
    """One generated file: its bytes and what the harness knows of it."""

    data: bytes
    tilings: int
    blocksizes: np.ndarray  # int32 [packets]: n of each audio packet
    samples: int  # per channel, after the last page's granule

    @property
    def packets(self) -> int:
        return len(self.blocksizes)


class Source:
    """The parsed source stream of a configuration."""

    def __init__(self, data: bytes):
        rdr = PacketReader(data)
        first = rdr.read_packet()
        serial = first.stream_serial
        pcks = [first.data]
        while (p := rdr.read_packet()) is not None:
            if p.stream_serial == serial:
                pcks.append(p.data)
        self.headers = pcks[:3]
        self.ident = read_header_ident(pcks[0])
        self.setup = read_header_setup(pcks[2], self.ident)
        self.channels = self.ident.channels
        self.rate = self.ident.sample_rate
        audio = pcks[3:]
        geo = []  # (n, left slope, right slope, decoded samples)
        for pck in audio:
            mode, _, n, prev_f, next_f = _packet_begin(
                self.ident, self.setup, BitCursor(pck))
            left, right, right_end, _ = _window_geometry(
                self.ident, mode.blockflag, prev_f, next_f)
            left_slope = (self.ident.bs1 if mode.blockflag and prev_f
                          else self.ident.bs0) // 2
            geo.append((n, left_slope, right_end - right, right - left))
        # the cycle: from the first packet that the last one can precede
        start = next(i for i, g in enumerate(geo) if g[1] == geo[-1][2])
        self.cycle = audio[start:]
        self.cycle_start = start
        self.blocksize = np.array([g[0] for g in geo[start:]], np.int32)
        self.decoded = np.array([g[3] for g in geo[start:]], np.int64)
        for a, b in zip(geo[start:], geo[start + 1:] + [geo[start]]):
            if a[2] != b[1]:
                raise ValueError("the source's packets do not form a cycle")

    def make_file(self, rotation: int, tilings: int, serial: int,
                  packets: int | None = None) -> File:
        """The file of ``tilings`` cycles from cycle packet ``rotation``
        (``packets``: that many packets instead)."""
        L = len(self.cycle)
        count = tilings * L if packets is None else packets
        idx = (rotation + np.arange(count)) % L
        dec = self.decoded[idx].copy()
        dec[0] = 0  # the first packet only fills the window
        granules = [0, 0, 0] + np.cumsum(dec).tolist()
        data = write_stream(self.headers + [self.cycle[i] for i in idx],
                            granules, serial)
        return File(data, tilings, self.blocksize[idx],
                    int(dec.sum()))


def _sha256(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def load_source(root: Path, config: dict) -> Source:
    """The configuration's frozen stream, held to its sha256."""
    path = root / config["stream"]
    if _sha256(path) != config["stream_sha256"]:
        raise ValueError(f"{path}: sha256 differs from the configuration")
    return Source(path.read_bytes())


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)
