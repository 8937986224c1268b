"""Inverse square-polar channel coupling (Vorbis I spec 4.3.5).

Ports lewton_tpu/ops/coupling.py: the steps are applied in reverse order
over (magnitude, angle) channel pairs. ``inverse_coupling_static`` takes a
step list shared by every mode (Python ints); ``inverse_coupling_batch``
takes per-mode step tables and gathers each packet's channels, where the
reference contracts one-hot masks. Both are exact: every value is one of
m, m + a, m - a, as in the reference.
"""

from __future__ import annotations

import torch

__all__ = ["inverse_coupling_static", "inverse_coupling_batch", "couple_step"]


def couple_step(m: torch.Tensor, a: torch.Tensor):
    """One inverse coupling step on magnitude m and angle a:
    (new magnitude, new angle)."""
    mpos, apos = m > 0, a > 0
    new_m = torch.where(mpos, torch.where(apos, m, m + a),
                        torch.where(apos, m, m - a))
    new_a = torch.where(mpos, torch.where(apos, m - a, m),
                        torch.where(apos, m + a, m))
    return new_m, new_a


def inverse_coupling_static(residue: torch.Tensor, steps) -> torch.Tensor:
    """residue f32 [T, C, W], steps ((mag, ang), ...) shared by all modes
    -> coupled residue f32 [T, C, W]."""
    res = list(residue.unbind(1))
    for mag, ang in reversed(tuple(steps)):
        res[mag], res[ang] = couple_step(res[mag], res[ang])
    return torch.stack(res, 1)


def inverse_coupling_batch(residue: torch.Tensor, mode: torch.Tensor,
                           coup_mag: torch.Tensor, coup_ang: torch.Tensor,
                           coup_n: torch.Tensor) -> torch.Tensor:
    """Per-mode coupling: residue f32 [T, C, W], mode [T], coup_mag /
    coup_ang i32 [M, Smax] (channel per (mode, step)), coup_n i32 [M]
    (steps per mode; steps past it are inactive) -> f32 [T, C, W]."""
    smax = coup_mag.shape[1]
    if smax == 0:
        return residue
    mode = mode.long()
    rows = torch.arange(residue.shape[0], device=residue.device)
    n_steps = coup_n[mode]
    res = residue.clone()  # updated in place, step by step
    for s in reversed(range(smax)):
        active = (s < n_steps)[:, None]
        mag, ang = coup_mag[mode, s].long(), coup_ang[mode, s].long()
        m, a = res[rows, mag], res[rows, ang]  # [T, W]
        new_m, new_a = couple_step(m, a)
        res[rows, mag] = torch.where(active, new_m, m)
        res[rows, ang] = torch.where(active, new_a, a)
    return res
