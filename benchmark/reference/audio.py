# Frozen copy of lewton_tpu_torch/audio.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Audio packet decode: the per-packet "forward pass".

The port's copy of lewton_tpu/audio.py, in two halves:

1. :func:`decode_packet_entropy` reads the mode and window flags, the floor
   posts or coefficients and the residue vectors of one packet into a dense
   :class:`PacketPlan`, which ``models.decoder.pack_frames`` stacks into the
   frames the device decodes (the ``torch`` backend).
2. :func:`_synthesize`, the numpy synthesis of the ``numpy`` backend: floor
   curve, dot product, inverse coupling, an f64 IMDCT rounded once to f32,
   window/overlap-add against :class:`PreviousWindowRight`, with the four
   ``debug.record`` tap points.

ref parity: lewton src/audio.rs:919-1173 (read_audio_packet_generic),
independently implemented from Vorbis I spec section 4.3.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import debug
from . import floor as floor_mod
from . import samples as samples_mod
from .bitpack import BitCursor, ilog
from .errors import AudioBadFormat, AudioIsHeader, EndOfPacket
from .header import IdentHeader, SetupHeader
from .residue import residue_decode
from .tables import imdct_matrix, window_slope

__all__ = [
    "PreviousWindowRight",
    "PacketPlan",
    "decode_packet_entropy",
    "read_audio_packet",
    "read_audio_packet_generic",
    "get_decoded_sample_count",
]


@dataclass
class PreviousWindowRight:
    """Per-stream carry state: the unwindowed right half of the previous
    block (ref: lewton src/audio.rs:848-861). The only inter-packet state."""

    data: np.ndarray | None = None  # f32 [channels, prev_right_len]

    def is_empty(self) -> bool:
        return self.data is None

    def reset(self) -> None:
        self.data = None


@dataclass
class PacketPlan:
    """Dense device-ready outputs of the host entropy half for one packet."""

    mode_blockflag: int
    mode_number: int
    n: int  # current blocksize
    prev_window_flag: bool
    next_window_flag: bool
    #: per channel: ("f1", DecodedFloor1) | ("f0", DecodedFloor0) | ("unused",)
    floors: list[tuple]
    #: f32 [channels, n//2] accumulated residue (pre-coupling)
    residue: np.ndarray
    #: coupling steps (magnitude_ch, angle_ch), applied in reverse
    coupling: list[tuple[int, int]]


def _window_geometry(ident: IdentHeader, blockflag: int, prev_flag: bool, next_flag: bool):
    """left/right window start/end (spec 4.3.1 window decode).

    Returns (left_win_start, right_win_start, right_win_end, left_slope_is_long).
    """
    n = ident.bs1 if blockflag else ident.bs0
    window_center = n >> 1
    if blockflag and not prev_flag:
        bs0 = ident.bs0
        left_start = (n - bs0) >> 2
        left_use_bs1 = False
    else:
        left_start = 0
        left_use_bs1 = bool(blockflag)
    if blockflag and not next_flag:
        bs0 = ident.bs0
        right_start = (n * 3 - bs0) >> 2
        right_end = (n * 3 + bs0) >> 2
    else:
        right_start = window_center
        right_end = n
    return left_start, right_start, right_end, left_use_bs1


def _packet_begin(ident: IdentHeader, setup: SetupHeader, cur: BitCursor):
    if cur.read_bit_flag():
        raise AudioIsHeader()
    mode_number = cur.read_bits(ilog(len(setup.modes) - 1))
    if mode_number >= len(setup.modes):
        raise AudioBadFormat("mode number out of range")
    mode = setup.modes[mode_number]
    n = ident.bs1 if mode.blockflag else ident.bs0
    if mode.blockflag:
        prev_flag = cur.read_bit_flag()
        next_flag = cur.read_bit_flag()
    else:
        prev_flag = next_flag = True
    return mode, mode_number, n, prev_flag, next_flag


def decode_packet_entropy(
    ident: IdentHeader, setup: SetupHeader, packet: bytes
) -> PacketPlan:
    """Host half: everything bit-serial, producing dense tensors."""
    cur = BitCursor(packet)
    try:
        mode, mode_number, n, prev_flag, next_flag = _packet_begin(
            ident, setup, cur
        )
    except EndOfPacket as e:
        raise AudioBadFormat(f"truncated packet start: {e}") from e
    mapping = setup.mappings[mode.mapping]
    channels = ident.channels

    # Floor decode per channel (EOP => channel unused, ref audio.rs:94-105)
    floors: list[tuple] = []
    for ch in range(channels):
        fl = setup.floors[mapping.submap_floor[mapping.mux[ch]]]
        try:
            if fl.floor_type == 0:
                df = floor_mod.floor0_decode(cur, setup.codebooks, fl)
                floors.append(("f0", df))
            else:
                y = floor_mod.floor1_decode(cur, setup.codebooks, fl)
                fy, step2 = floor_mod.floor1_amplitudes(y, fl)
                floors.append(("f1", floor_mod.DecodedFloor1(fy, step2, fl)))
        except (floor_mod.FloorUnused, EndOfPacket):
            floors.append(("unused",))
        except floor_mod.PacketUndecodable as e:
            raise AudioBadFormat(str(e)) from e

    # no_residue flags + coupling propagation (spec 4.3.4)
    no_residue = [f[0] == "unused" for f in floors]
    for mag, ang in zip(mapping.coupling_magnitude, mapping.coupling_angle):
        if not (no_residue[mag] and no_residue[ang]):
            no_residue[mag] = False
            no_residue[ang] = False

    # Residue decode per submap
    residue = np.zeros((channels, n // 2), dtype=np.float32)
    for i, residue_number in enumerate(mapping.submap_residue):
        chans = [j for j in range(channels) if mapping.mux[j] == i]
        dnd = [no_residue[j] for j in chans]
        resid = setup.residues[residue_number]
        vectors = residue_decode(cur, n, dnd, resid, setup.codebooks)
        for k, j in enumerate(chans):
            residue[j] = vectors[k]

    coupling = list(zip(mapping.coupling_magnitude, mapping.coupling_angle))
    return PacketPlan(
        mode.blockflag, mode_number, n, prev_flag, next_flag, floors, residue,
        coupling,
    )


def _inverse_coupling(residue: np.ndarray, coupling) -> np.ndarray:
    """Square-polar reconstruction, steps in reverse (spec 4.3.5;
    ref lewton src/audio.rs:762-777, 991-1002)."""
    for mag, ang in reversed(coupling):
        m = residue[mag]
        a = residue[ang]
        # m>0, a>0 -> (m, m-a); m>0, a<=0 -> (m+a, m);
        # m<=0, a>0 -> (m, m+a); m<=0, a<=0 -> (m-a, m)
        mpos = m > 0
        apos = a > 0
        new_m = np.where(mpos, np.where(apos, m, m + a), np.where(apos, m, m - a))
        new_a = np.where(mpos, np.where(apos, m - a, m), np.where(apos, m + a, m))
        residue[mag] = new_m
        residue[ang] = new_a
    return residue


def _synthesize(
    ident: IdentHeader, plan: PacketPlan, pwr: PreviousWindowRight
) -> np.ndarray:
    """Numpy reference of the device half. Returns f32 [channels, out_len]."""
    n = plan.n
    n2 = n // 2
    channels = ident.channels

    debug.record("residue_pre_inverse", plan.residue)
    residue = _inverse_coupling(plan.residue.copy(), plan.coupling)
    debug.record("residue_post_inverse", residue)

    # floor curve synthesis + dot product
    spectra = np.zeros((channels, n2), dtype=np.float32)
    for ch, f in enumerate(plan.floors):
        if f[0] == "unused":
            continue
        if f[0] == "f0":
            curve = floor_mod.floor0_curve(f[1], plan.mode_blockflag, n2, ident.sample_rate)
        else:
            df = f[1]
            curve = floor_mod.floor1_synthesis(df.final_y, df.step2_flag, df.floor, n2)
        spectra[ch] = curve * residue[ch]

    # IMDCT: y = X @ M, f64 accumulation, one rounding to f32
    debug.record("pre_mdct", spectra)
    m = imdct_matrix(n, dtype=np.float64)
    audio = (spectra.astype(np.float64) @ m).astype(np.float32)
    debug.record("post_mdct", audio)

    left_start, right_start, right_end, left_use_bs1 = _window_geometry(
        ident, plan.mode_blockflag, plan.prev_window_flag, plan.next_window_flag
    )

    prev = pwr.data
    # save the unwindowed right region as next packet's pwr
    pwr.data = np.ascontiguousarray(audio[:, right_start:right_end])

    if prev is None:
        return np.zeros((channels, 0), dtype=np.float32)

    plen = prev.shape[1]
    slope_half = ident.bs1 // 2 if left_use_bs1 else ident.bs0 // 2
    slope = window_slope(slope_half)
    if len(slope) < plen:
        raise AudioBadFormat("window slope shorter than previous right half")
    lhs = slope[:plen]
    rhs = lhs[::-1]
    out = audio[:, left_start:right_start].copy()
    out[:, :plen] = audio[:, left_start : left_start + plen] * lhs + prev * rhs
    return out


def read_audio_packet_generic(
    ident: IdentHeader,
    setup: SetupHeader,
    packet: bytes,
    pwr: PreviousWindowRight,
    fmt: str = "planar_i16",
) -> np.ndarray:
    """Decode one audio packet. ``fmt`` in {planar,interleaved}_{i16,f32}."""
    plan = decode_packet_entropy(ident, setup, packet)
    out = _synthesize(ident, plan, pwr)
    return getattr(samples_mod, fmt)(out)


def read_audio_packet(ident, setup, packet, pwr):
    """i16 planar convenience wrapper (ref: lewton src/audio.rs:1170-1173)."""
    return read_audio_packet_generic(ident, setup, packet, pwr, "planar_i16")


def get_decoded_sample_count(
    ident: IdentHeader, setup: SetupHeader, packet: bytes
) -> int:
    """Cheap per-channel sample count without decoding
    (ref: lewton src/audio.rs:874-908)."""
    cur = BitCursor(packet)
    try:
        mode, _, n, prev_flag, next_flag = _packet_begin(ident, setup, cur)
    except EndOfPacket as e:
        raise AudioBadFormat(f"truncated packet start: {e}") from e
    left_start, right_start, _, _ = _window_geometry(
        ident, mode.blockflag, prev_flag, next_flag
    )
    return right_start - left_start
