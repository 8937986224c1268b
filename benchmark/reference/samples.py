# Frozen copy of lewton_tpu_torch/samples.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Sample output formats (ref: lewton src/samples.rs).

Planar / interleaved containers over f32 or i16, with the reference's exact
i16 conversion: scale by 32768, clamp to [-32768, 32767], truncate toward
zero (lewton src/samples.rs:91-103).

The port's copy of lewton_tpu/samples.py, held equal to it by the CPU tests.
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_i16", "planar_f32", "planar_i16", "interleaved_f32", "interleaved_i16"]


def to_i16(x: np.ndarray) -> np.ndarray:
    """f32 -> i16 with the reference's rounding (truncation toward zero).

    The pre-scale clip is exact for every in-range value (|x| < 2 already
    clamps after scaling) and keeps saturation-scale floor0 spectra
    (~1e35, crafted max-amplitude streams) from overflowing the f32
    multiply to inf — the clamp result is identical either way."""
    x = np.clip(x.astype(np.float32), -2.0, 2.0)
    scaled = x * np.float32(32768.0)
    clamped = np.clip(scaled, -32768.0, 32767.0)
    return np.trunc(clamped).astype(np.int16)


def planar_f32(chans: np.ndarray) -> np.ndarray:
    return np.asarray(chans, dtype=np.float32)


def planar_i16(chans: np.ndarray) -> np.ndarray:
    return to_i16(np.asarray(chans))


def interleaved_f32(chans: np.ndarray) -> np.ndarray:
    """[ch, n] -> [n*ch] interleaved."""
    return np.asarray(chans, dtype=np.float32).T.reshape(-1)


def interleaved_i16(chans: np.ndarray) -> np.ndarray:
    return to_i16(np.asarray(chans)).T.reshape(-1)
