"""K3 — floor-1 render + inverse coupling + floor x residue from
precomputed brackets: plain torch version, CUDA kernel wrapper.

Ports lewton_tpu/ops/synth_kernel.py::fused_floor_couple, the opt-in path
of ``models.decoder.USE_FUSED_SYNTH_KERNEL`` for frames that carry
``f1_brackets`` (``precompute_brackets``). The CUDA kernel is
csrc/synth_kernel.cu, which shares K1's epilogue (csrc/floor_epilogue.cuh).

:func:`fused_floor_couple` takes CPU tensors to
:func:`fused_floor_couple_ref` and CUDA tensors to the kernel; it never
falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .coupling import inverse_coupling_static
from .floor_curve import floor1_render
from .floor_kernel import MAX_STREAM_CHANNELS, epilogue_args

__all__ = ["fused_floor_couple", "fused_floor_couple_ref"]

#: number of kernel launches made by :func:`fused_floor_couple`
LAUNCHES = 0


def fused_floor_couple_ref(brackets, residue, used, steps) -> torch.Tensor:
    """Plain torch version: spectra f32 [T, C, W] = floor1_render(brackets)
    x used x inverse_coupling_static(residue).

    brackets f32 [T, 4, C, W] (lo_x, lo_y, hi_x, hi_y); residue f32
    [T, C, W]; used bool|f32 [T, C]; steps: static coupling
    ((mag, ang), ...)."""
    curve = floor1_render(brackets.unbind(1)) * used.to(torch.float32)[:, :, None]
    return curve * inverse_coupling_static(residue, steps)


def fused_floor_couple(brackets, residue, used, steps) -> torch.Tensor:
    """Spectra f32 [T, C, W]: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (same arguments as
    :func:`fused_floor_couple_ref`)."""
    global LAUNCHES
    dev = brackets.device
    if dev.type == "cpu":
        return fused_floor_couple_ref(brackets, residue, used, steps)
    if dev.type != "cuda":
        raise ValueError(f"fused_floor_couple: unsupported device {dev}")
    T, _, C, W = brackets.shape
    n_steps, steps_arr, db_arr = epilogue_args(steps, C, MAX_STREAM_CHANNELS)
    check = _build.check_operand
    check("brackets", brackets, torch.float32, (T, 4, C, W), dev)
    check("residue", residue, torch.float32, (T, C, W), dev)
    if used.dtype != torch.float32:
        used = used.to(torch.float32)
    check("used", used, torch.float32, (T, C), dev)
    out = torch.empty((T, C, W), dtype=torch.float32, device=dev)
    if T == 0 or W == 0:
        return out
    fn = _build.load_library().lt_fused_floor_couple
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(brackets.data_ptr(), residue.data_ptr(), used.data_ptr(),
                 out.data_ptr(), T, C, W, n_steps,
                 ctypes.addressof(steps_arr), ctypes.addressof(db_arr), stream)
    if err != 0:
        raise RuntimeError(f"synth kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
