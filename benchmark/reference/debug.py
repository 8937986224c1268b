# Frozen copy of lewton_tpu_torch/debug.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Intermediate-tensor taps for numerics triage.

The reference reserves four record points (lewton src/lib.rs:56-94, invoked
at src/audio.rs:988,1004,1041,1054): residues before/after inverse coupling
and audio before/after the MDCT. Here they are a first-class facility: a
context manager collects the intermediates from the numpy backend
(``audio._synthesize``), and the device pipeline exposes the same four
tensors via ``models.decoder.decode_frames(..., with_taps=True)`` so the
two halves can be diffed stage by stage. The port's copy of
lewton_tpu/debug.py.

    with taps() as t:
        read_audio_packet(...)
    t["residue_pre_inverse"]  # list of [C, n/2] arrays, one per packet
"""

from __future__ import annotations

import contextlib

__all__ = ["taps", "record", "TAP_NAMES"]

TAP_NAMES = (
    "residue_pre_inverse",   # after entropy decode, before coupling
    "residue_post_inverse",  # after inverse coupling
    "pre_mdct",              # floor x residue spectra
    "post_mdct",             # raw IMDCT output
)

_active: list[dict] = []


@contextlib.contextmanager
def taps():
    """Collect stage intermediates from decodes running in this context."""
    sink: dict[str, list] = {k: [] for k in TAP_NAMES}
    _active.append(sink)
    try:
        yield sink
    finally:
        # by identity: list.remove compares sinks by value, and two nested
        # sinks holding arrays compare ambiguously (ValueError)
        _active[:] = [s for s in _active if s is not sink]


def record(name: str, value) -> None:
    """Called by the decode paths at each tap point (cheap when inactive)."""
    if _active:
        arr = value.copy()
        for sink in _active:
            sink[name].append(arr)
