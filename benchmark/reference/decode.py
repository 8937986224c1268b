"""The benchmark's plain reference: Ogg Vorbis bytes to interleaved i16 PCM,
in NumPy, on the frozen copies beside this file (the Ogg page reader with
its CRC check, the header, Huffman, floor and residue decoders, an f64
IMDCT rounded once to f32, the window overlap-add and lewton's i16
conversion). It imports nothing of the program under test.

A packet's IMDCT output depends on its bytes and the setup alone (the
window overlap is the only state that crosses packets), so it is computed
once per distinct packet and kept: the benchmark's files repeat the
packets of their source stream, and the overlap-add, the granule rules and
the conversion run for every packet of every file.

``precision="tf32"`` is the control of the correctness check: the IMDCT's
two operands rounded to TF32 (10 mantissa bits, round to nearest even) and
the product summed in f32, as a TF32 tensor-core GEMM computes it: the
precision just below the f32 GEMM (TF32 off) that the program runs.
"""

from __future__ import annotations

import numpy as np

from . import floor as floor_mod
from .audio import _inverse_coupling, _window_geometry, decode_packet_entropy
from .errors import AudioBadFormat, AudioIsHeader
from .header import read_header_ident, read_header_setup
from .ogg_demux import PacketReader
from .samples import to_i16
from .tables import imdct_matrix, window_slope

__all__ = ["Reference", "tf32"]


def tf32(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to TF32's 10 mantissa bits (nearest, ties to
    even), kept in f32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = u + np.uint32(0xFFF) + ((u >> np.uint32(13)) & np.uint32(1))
    return (r & np.uint32(0xFFFFE000)).view(np.float32)


class Reference:
    """Decoder of whole single-link Ogg Vorbis files, with its per-packet
    cache (keyed by the header packets and the packet's bytes)."""

    def __init__(self, precision: str = "f64"):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision
        self._headers: dict = {}
        self._packets: dict = {}
        self._mats: dict = {}

    def _setup(self, ident_pck: bytes, setup_pck: bytes):
        key = (ident_pck, setup_pck)
        if key not in self._headers:
            ident = read_header_ident(ident_pck)
            self._headers[key] = (ident, read_header_setup(setup_pck, ident))
        return self._headers[key]

    def _imdct(self, spectra: np.ndarray, n: int) -> np.ndarray:
        if self.precision == "f64":
            m = imdct_matrix(n, dtype=np.float64)
            return (spectra.astype(np.float64) @ m).astype(np.float32)
        if n not in self._mats:
            self._mats[n] = tf32(imdct_matrix(n, dtype=np.float64)
                                 .astype(np.float32))
        return tf32(spectra) @ self._mats[n]

    def packet_audio(self, ident, setup, key, packet: bytes):
        """(IMDCT output f32 [C, n], window geometry) of one audio packet
        (spec 4.3: floor curves, inverse coupling, dot product, IMDCT)."""
        hit = self._packets.get((key, packet))
        if hit is not None:
            return hit
        plan = decode_packet_entropy(ident, setup, packet)
        residue = _inverse_coupling(plan.residue.copy(), plan.coupling)
        n2 = plan.n // 2
        spectra = np.zeros((ident.channels, n2), np.float32)
        for ch, f in enumerate(plan.floors):
            if f[0] == "f0":
                curve = floor_mod.floor0_curve(f[1], plan.mode_blockflag, n2,
                                               ident.sample_rate)
            elif f[0] == "f1":
                df = f[1]
                curve = floor_mod.floor1_synthesis(df.final_y, df.step2_flag,
                                                   df.floor, n2)
            else:
                continue
            spectra[ch] = curve * residue[ch]
        geo = _window_geometry(ident, plan.mode_blockflag,
                               plan.prev_window_flag, plan.next_window_flag)
        hit = (self._imdct(spectra, plan.n), geo)
        self._packets[(key, packet)] = hit
        return hit

    def decode(self, data: bytes) -> np.ndarray:
        """Interleaved i16 PCM [samples, channels] of the first logical
        stream of ``data``, cut at the end-of-stream granule as lewton's
        reader cuts it."""
        rdr = PacketReader(data)
        heads, serial = [], None
        while len(heads) < 3:
            p = rdr.read_packet()
            if p is None:
                raise AudioBadFormat("stream ends inside its headers")
            serial = p.stream_serial if serial is None else serial
            if p.stream_serial == serial:
                heads.append(p.data)
        key = (heads[0], heads[2])
        ident, setup = self._setup(*key)
        out, prev, cur_absgp = [], None, 0
        while (p := rdr.read_packet()) is not None:
            if p.stream_serial != serial:
                continue
            try:
                audio, (left, right, right_end, left_long) = \
                    self.packet_audio(ident, setup, key, p.data)
            except (AudioBadFormat, AudioIsHeader):
                continue  # no PCM, window state untouched
            if prev is None:
                pcm = np.zeros((ident.channels, 0), np.float32)
            else:
                plen = prev.shape[1]
                slope = window_slope(ident.bs1 // 2 if left_long
                                     else ident.bs0 // 2)
                if len(slope) < plen:
                    raise AudioBadFormat("window slope shorter than the "
                                         "previous right half")
                lhs = slope[:plen]
                pcm = audio[:, left:right].copy()
                pcm[:, :plen] = audio[:, left:left + plen] * lhs \
                    + prev * lhs[::-1]
            prev = audio[:, right:right_end]
            keep = pcm.shape[1]
            if cur_absgp is not None and p.last_in_stream:
                keep = min(keep, max(0, (p.absgp_page or 0) - cur_absgp))
            if p.last_in_page and p.absgp_page is not None:
                cur_absgp = p.absgp_page
            elif cur_absgp is not None:
                cur_absgp += keep
            out.append(pcm[:, :keep])
        pcm = (np.concatenate(out, axis=1) if out
               else np.zeros((ident.channels, 0), np.float32))
        return to_i16(pcm).T.copy()
