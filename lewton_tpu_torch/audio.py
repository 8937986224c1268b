"""Audio packet decode, the host half: the per-packet entropy decode.

The port's copy of the entropy half of lewton_tpu/audio.py:
:func:`decode_packet_entropy` reads the mode and window flags, the floor
posts or coefficients and the residue vectors of one packet into a dense
:class:`PacketPlan`, which ``models.decoder.pack_frames`` stacks into the
frames the device decodes. The reference's numpy synthesis is not copied:
on the port the device synthesizes.

ref parity: lewton src/audio.rs:919-1173 (read_audio_packet_generic),
independently implemented from Vorbis I spec section 4.3.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import floor as floor_mod
from .bitpack import BitCursor, ilog
from .errors import AudioBadFormat, AudioIsHeader, EndOfPacket
from .header import IdentHeader, SetupHeader
from .residue import residue_decode

__all__ = [
    "PacketPlan",
    "decode_packet_entropy",
    "get_decoded_sample_count",
]


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
