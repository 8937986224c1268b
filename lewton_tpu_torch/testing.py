"""Synthetic stream setups and frames for checks and timing runs (numpy).

The same configuration and the same random frames as lewton_tpu/testing.py
(flagship stereo 44.1 kHz, blocksizes 256/2048, floor 1 with square-polar
coupling, what libvorbisenc emits at q3), built from the port's own header
records so that chip_smoke.py runs where only torch and numpy are
installed. tests/test_torch_setup.py holds both functions equal to the
reference's at their defaults.

Two variants of that setup reach the generic path, for checks on the card
where neither JAX nor ``tools/`` is available: ``per_mode_coupling`` moves
mode 1 onto a second, uncoupled mapping, and ``floor0`` replaces floor 1
with the floor 0 of tools/floor0_stream.py (order 2, bark map 64,
amplitude bits 6, offset 136); :func:`synthetic_floor0_frames` gives that
setup frames with finite, audible curves.
"""

from __future__ import annotations

import numpy as np

from .header import (Floor0, Floor1, IdentHeader, Mapping, Mode, Residue,
                     SetupHeader)

__all__ = ["synthetic_headers", "synthetic_frames", "synthetic_floor0_frames"]

# A typical floor1 x-list (libvorbisenc's 44.1 kHz long-block layout shape)
_XLIST = [
    0, 1024, 93, 23, 372, 6, 46, 186, 750, 14, 33, 65, 130,
    260, 556, 3, 10, 18, 28, 39, 55, 79, 111, 158, 220, 312,
    464, 650, 850,
]


def synthetic_headers(
    channels: int = 2, bs0_exp: int = 8, bs1_exp: int = 11, rate: int = 44100,
    per_mode_coupling: bool = False, floor0: bool = False,
) -> tuple[IdentHeader, SetupHeader]:
    ident = IdentHeader(
        channels=channels, sample_rate=rate,
        bitrate_maximum=0, bitrate_nominal=128000, bitrate_minimum=0,
        blocksize_0=bs0_exp, blocksize_1=bs1_exp,
    )
    floor = Floor1(
        partitions=8,
        partition_class=[0] * 8,
        class_dims=[3] * 8,
        class_subclasses=[0] * 8,
        class_masterbooks=[-1] * 8,
        subclass_books=[[-1]] * 8,
        multiplier=2,
        x_list=list(_XLIST[: 2 + 8 * 3]),
    )
    # stereo pairs coupled (mag=0, ang=1), remaining channels uncoupled
    n_pairs = channels // 2
    mapping = Mapping(
        submaps=1,
        coupling_magnitude=[2 * i for i in range(n_pairs)],
        coupling_angle=[2 * i + 1 for i in range(n_pairs)],
        mux=[0] * channels,
        submap_floor=[0],
        submap_residue=[0],
    )
    # residue extent as libvorbisenc emits at ~q3 (type 2, end well short of
    # the interleaved n1*C/2), so the w_eff clipping is realistic
    n1 = 1 << bs1_exp
    residue = Residue(
        residue_type=2, begin=0, end=min(1600, n1 * channels // 2),
        partition_size=32, classifications=10, classbook=0,
        cascades=[0] * 10, books=[[-1] * 8] * 10,
    )
    if floor0:
        floor = Floor0(order=2, rate=rate, bark_map_size=64, amplitude_bits=6,
                       amplitude_offset=136, books=[0])
    setup = SetupHeader(
        codebooks=[], floors=[floor], residues=[residue], mappings=[mapping],
        modes=[Mode(0, 0), Mode(1, 0)],
    )
    if per_mode_coupling:
        setup.mappings.append(Mapping(
            submaps=1, coupling_magnitude=[], coupling_angle=[],
            mux=[0] * channels, submap_floor=[0], submap_residue=[0]))
        setup.modes[1] = Mode(1, 1)
    return ident, setup


def synthetic_frames(
    cs, T: int, S: int | None = None, seed: int = 0
) -> dict[str, np.ndarray]:
    """Random-but-plausible dense frames (numpy, the reference's
    ``pack_frames`` layout). With S given, adds a leading stream axis."""
    rng = np.random.RandomState(seed)
    lead = () if S is None else (S,)
    C, W, P = cs.channels, cs.w_eff, cs.max_posts
    shp = lambda *s: lead + (T,) + s  # noqa: E731
    n_modes = 2
    fr = {
        "mode": rng.randint(0, n_modes, shp()).astype(np.int32),
        "prev_flag": rng.rand(*shp()) < 0.5,
        "next_flag": rng.rand(*shp()) < 0.5,
        "valid": np.ones(shp(), bool),
        # integer lattice, like i16 residue transport when the setup's
        # codebooks are integer-valued (residue_i16)
        "residue": np.round(rng.randn(*shp(C * W)) * 80.0).astype(
            np.int16 if getattr(cs, "residue_i16", False) else np.float32),
        "f_used": np.ones(shp(C), bool),
        "f1_ys": rng.randint(0, 128, shp(C, P)).astype(np.int32),
        "f1_flags": rng.rand(*shp(C, P)) < 0.7,
        "f0_cosc": np.zeros(shp(C, max(cs.f0_order_max, 1)), np.float32),
        "f0_amp": np.zeros(shp(C), np.float32),
    }
    fr["f1_flags"][..., :2] = True
    return fr


def synthetic_floor0_frames(
    cs, T: int, S: int | None = None, seed: int = 0
) -> dict[str, np.ndarray]:
    """:func:`synthetic_frames` with floor-0 fields for an order-2 floor 0:
    ``f0_cosc`` the cosines of a low LSP root in [0.5, 1] and a high one in
    [1.5, 2] (at least 0.5 rad apart, the layout of tools/floor0_stream.py's
    LSP book), ``f0_amp`` in 1..12. Then p + q never nears 0 at a bark bin
    and the curve stays below 1."""
    fr = synthetic_frames(cs, T, S, seed)
    rng = np.random.RandomState(seed + 1)
    shp = fr["f0_amp"].shape
    roots = np.stack([rng.uniform(0.5, 1.0, shp), rng.uniform(1.5, 2.0, shp)],
                     -1)
    order = max(cs.f0_order_max, 1)
    cosc = np.zeros(shp + (order,), np.float32)
    cosc[..., :min(order, 2)] = np.cos(roots[..., :order])
    fr["f0_cosc"] = cosc
    fr["f0_amp"] = rng.randint(1, 13, shp).astype(np.float32)
    return fr
