# Frozen copy of lewton_tpu_torch/floor.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Floor decode (types 0 and 1): packet entropy half + numpy curve synthesis.

The port's copy of lewton_tpu/floor.py: ``floor0_decode`` and
``floor1_decode`` read the posts or LSP coefficients, and
``floor1_amplitudes`` reconstructs the final posts (libvorbis-exact). The
numpy curve synthesis (``floor0_curve``, ``floor1_synthesis``) serves the
numpy backend (``audio._synthesize``); on the ``torch`` backend the curves
are computed on the device (``ops/floor_curve.py`` and the floor kernel).

ref parity: lewton src/audio.rs:109-555 (floor_zero_decode/compute_curve,
floor_one_decode, render_point/render_line, curve synthesis), independently
implemented from Vorbis I spec sections 6 and 7.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bitpack import BitCursor, ilog
from .header import Codebook, Floor0, Floor1
from .tables import bark_cos_omega, floor1_inverse_db_table

__all__ = [
    "FloorUnused",
    "PacketUndecodable",
    "DecodedFloor0",
    "DecodedFloor1",
    "floor0_decode",
    "floor1_decode",
    "floor0_curve",
    "floor1_amplitudes",
    "floor1_synthesis",
    "render_point",
    "FLOOR1_RANGES",
]

FLOOR1_RANGES = (256, 128, 86, 64)  # indexed by multiplier-1 (spec 7.2.3)


class FloorUnused(Exception):
    """This channel contributes zeros this frame (not an error)."""


class PacketUndecodable(Exception):
    """Floor data is invalid; the whole packet must be discarded."""


@dataclass
class DecodedFloor0:
    cos_coefficients: np.ndarray  # f32 [order] (cosines, reference quirk)
    amplitude: int
    floor: Floor0


@dataclass
class DecodedFloor1:
    final_y: np.ndarray  # i64 [values] after amplitude reconstruction+clamp
    step2_flag: np.ndarray  # bool [values]
    floor: Floor1


# --------------------------------------------------------------------------- #
# Floor type 0 (spec 6.2; ref lewton src/audio.rs:109-212)
# --------------------------------------------------------------------------- #


def floor0_decode(
    cur: BitCursor, codebooks: list[Codebook], fl: Floor0
) -> DecodedFloor0:
    """Read amplitude + LSP coefficients. Stores cos(coeff) directly
    (the reference's optimization; the curve only ever uses the cosine)."""
    amplitude = cur.read_bits(fl.amplitude_bits)
    if amplitude == 0:
        raise FloorUnused
    booknumber = cur.read_bits(ilog(len(fl.books)))
    if booknumber >= len(fl.books):
        raise PacketUndecodable("floor0 book number out of range")
    codebook = codebooks[fl.books[booknumber]]
    if codebook.vq is None:
        raise PacketUndecodable("floor0 book has no VQ table")
    coeffs: list[np.float32] = []
    last = np.float32(0.0)
    while True:
        vec = codebook.vq[cur.read_huffman(codebook.tree)]
        for e in vec:
            coeffs.append(np.cos(last + np.float32(e), dtype=np.float32))
            if len(coeffs) == fl.order:
                return DecodedFloor0(
                    np.array(coeffs, dtype=np.float32), amplitude, fl
                )
        # `last` accumulates the final element of each full vector
        # (ref behavior, lewton src/audio.rs:128-151)
        last = np.float32(last + np.float32(vec[-1]))


def floor0_curve(df: DecodedFloor0, blockflag: int, n2: int, rate: int) -> np.ndarray:
    """LSP curve synthesis over the bark map (spec 6.2.3), vectorized.

    The reference shares p/q across runs of equal cos(omega) — a pure
    optimization; computing per-bin gives bit-identical f32 results.
    """
    fl = df.floor
    cos_omega = bark_cos_omega(n2, fl.rate, fl.bark_map_size)  # f32 [n2]
    cosc = df.cos_coefficients  # f32 [order]
    order = fl.order
    # p/q products in f32, same factor order as the scalar reference loop
    if order & 1:
        p = (np.float32(1.0) - cos_omega * cos_omega).astype(np.float32)
        q = np.full(n2, 0.25, dtype=np.float32)
        p_js = np.arange(0, (order - 3) // 2 + 1)
        q_js = np.arange(0, (order - 1) // 2 + 1)
    else:
        p = ((np.float32(1.0) - cos_omega) / np.float32(2.0)).astype(np.float32)
        q = ((np.float32(1.0) + cos_omega) / np.float32(2.0)).astype(np.float32)
        p_js = q_js = np.arange(0, (order - 2) // 2 + 1)
    for j in p_js:
        pm = (cosc[2 * j + 1] - cos_omega).astype(np.float32)
        p = (p * (np.float32(4.0) * pm * pm)).astype(np.float32)
    for j in q_js:
        qm = (cosc[2 * j] - cos_omega).astype(np.float32)
        q = (q * (np.float32(4.0) * qm * qm)).astype(np.float32)
    lfv_common = np.float32(
        np.float32(df.amplitude)
        * np.float32(fl.amplitude_offset)
        / np.float32((1 << fl.amplitude_bits) - 1)
    )
    arg = np.float32(0.11512925) * (
        lfv_common / np.sqrt(p + q) - np.float32(fl.amplitude_offset)
    )
    # Saturate instead of overflowing to inf: libvorbis (the conformance
    # oracle) computes plain exp here too, so for args up to the f32 exp
    # overflow edge (~88.72) we match its f32-rounded value; note libvorbis
    # computes in double, which stays finite to ~709 — args in (88.72, 709]
    # produce a finite-but-unrepresentable-in-f32 curve there while we
    # saturate (reachable only by crafted max-amplitude near-singular-LSP
    # streams — no encoder emits them). Past that libvorbis goes inf and
    # then NaN (inf x 0 residue), which no backend can pin. Clamping at
    # 88.7 (just inside the f32 edge) keeps the divergence window minimal:
    # huge spectra still clamp to +/-32767, zero residues stay 0 (never
    # NaN). Deliberate, documented divergence on unreachable input.
    lfv = np.exp(np.minimum(arg, np.float32(88.7)), dtype=np.float32)
    return lfv.astype(np.float32)


# --------------------------------------------------------------------------- #
# Floor type 1 (spec 7.2-7.3; ref lewton src/audio.rs:215-555)
# --------------------------------------------------------------------------- #


def floor1_decode(
    cur: BitCursor, codebooks: list[Codebook], fl: Floor1
) -> list[int]:
    """Read the raw Y list (before amplitude reconstruction)."""
    if not cur.read_bit_flag():
        raise FloorUnused
    rng = FLOOR1_RANGES[fl.multiplier - 1]
    b = ilog(rng - 1)
    y = [cur.read_bits(b), cur.read_bits(b)]
    for cls in fl.partition_class:
        cdim = fl.class_dims[cls]
        cbits = fl.class_subclasses[cls]
        csub = (1 << cbits) - 1
        cval = 0
        if cbits > 0:
            mb = codebooks[fl.class_masterbooks[cls]]
            cval = cur.read_huffman(mb.tree)
        for _ in range(cdim):
            book = fl.subclass_books[cls][cval & csub]
            cval >>= cbits
            if book >= 0:
                y.append(cur.read_huffman(codebooks[book].tree))
            else:
                y.append(0)
    return y


def render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    """Integer line prediction (spec 9.2.6), signed like libvorbis's
    render_point (C ints; the reference wraps in u32 instead, which only
    differs for out-of-range posts no encoder emits)."""
    dy = y1 - y0
    adx = x1 - x0
    ady = abs(dy)
    off = (ady * (x - x0)) // adx
    return y0 - off if dy < 0 else y0 + off


def floor1_amplitudes(y: list[int], fl: Floor1) -> tuple[np.ndarray, np.ndarray]:
    """Amplitude reconstruction (spec 7.2.4 part 1), libvorbis-exact.

    Returns (per-post dB-table INDEX values — already multiplied by the
    floor multiplier and clamped to [0, 255] — and "used" flags), both in
    decode (x_list) order.

    Semantics verified against libvorbis 1.3.7's floor1_inverse1/2 (by
    disassembly; no two implementations agree in the escape corners):
    - fit values evolve as SIGNED ints; render_point reads neighbors
      masked ``& 0x7fff``
    - a nonzero val stores ``(escape + predicted) & 0x7fff`` and clears
      the neighbor flags (masking them in place)
    - a zero val stores ``predicted | 0x8000``; at render time any post
      with bits in 0xffff8000 (flagged OR negative) is skipped
    - the render endpoints are ``clamp(fit * multiplier, 0, 255)`` — the
      Bresenham line runs in clamped index space

    The reference instead wraps negatives in u32 and clamps to range-1
    (lewton src/audio.rs:392-436), which diverges from libvorbis on
    escape-heavy posts no encoder emits (crafted coverage:
    tests/test_crafted.py). We match libvorbis, the conformance oracle.
    In-range streams — every encoder-emitted stream — decode identically
    under both semantics.
    """
    rng = FLOOR1_RANGES[fl.multiplier - 1]
    values = len(fl.x_list)
    fit = [0] * values
    fit[0], fit[1] = y[0], y[1]
    x = fl.x_list
    for i in range(2, values):
        lo = int(fl.low_neighbors[i])
        hi = int(fl.high_neighbors[i])
        predicted = render_point(
            x[lo], fit[lo] & 0x7FFF, x[hi], fit[hi] & 0x7FFF, x[i]
        )
        val = y[i]
        highroom = rng - predicted
        lowroom = predicted
        room = 2 * min(highroom, lowroom)
        if val:
            if val >= room:
                if highroom > lowroom:
                    v = val - lowroom
                else:
                    v = -1 - (val - highroom)
            else:
                v = -((val + 1) >> 1) if val & 1 else val >> 1
            fit[i] = (v + predicted) & 0x7FFF
            fit[lo] &= 0x7FFF
            fit[hi] &= 0x7FFF
        else:
            fit[i] = predicted | 0x8000
    used = np.array([(f & ~0x7FFF) == 0 for f in fit], dtype=bool)
    idx = np.minimum(
        np.array([(f & 0x7FFF) for f in fit], dtype=np.int64) * fl.multiplier,
        255,
    )
    return idx, used


def _render_line(x0: int, y0: int, x1: int, y1: int, out: list[int]) -> None:
    """Integer Bresenham (spec 9.2.7), appending y for x in [x0, x1)."""
    dy = y1 - y0
    adx = x1 - x0
    base = dy // adx if dy >= 0 else -((-dy) // adx)  # trunc toward zero
    ady = abs(dy) - abs(base) * adx
    sy = base - 1 if dy < 0 else base + 1
    y = y0
    err = 0
    out.append(y)
    for _ in range(x0 + 1, x1):
        err += ady
        if err >= adx:
            err -= adx
            y += sy
        else:
            y += base
        out.append(y)


def floor1_synthesis(
    final_y: np.ndarray, step2: np.ndarray, fl: Floor1, n2: int
) -> np.ndarray:
    """Curve synthesis part 2 (spec 7.2.4): Bresenham lines between used
    posts in sorted-x order, then the inverse-dB table gather.

    ``final_y`` carries INDEX-SPACE values (already multiplied by the
    floor multiplier and clamped to [0, 255] — see floor1_amplitudes), so
    the line endpoints are the clamped indexes, exactly like libvorbis's
    floor1_inverse2."""
    s = fl.sort_order
    xs = fl.x_list
    out: list[int] = []
    hx = 0
    hy = 0
    lx = 0
    ly = int(final_y[s[0]])
    for i in range(1, len(xs)):
        si = s[i]
        if step2[si]:
            hy = int(final_y[si])
            hx = xs[si]
            _render_line(lx, ly, hx, hy, out)
            lx, ly = hx, hy
    if hx < n2:
        _render_line(hx, hy, n2, hy, out)
    elif hx > n2:
        del out[n2:]
    idx = np.minimum(np.array(out[:n2], dtype=np.int64), 255)
    return floor1_inverse_db_table()[idx]
