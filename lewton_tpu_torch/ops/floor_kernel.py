"""K1 — floor-1 spectra: plain torch version, CUDA kernel wrapper.

Ports lewton_tpu/ops/floor_kernel.py::floor_spectra_pallas: bracket
contraction of the telescopes against the setup's step function, exact
Bresenham, inverse dB masked by ``f_used``, static inverse coupling, and
spectra = curve x coupled residue. Three output forms, as in the
reference: channel-major [C, rows, W] (``ct_out``, the i16 path's DCT-IV
GEMM input), flat [rows, C, W] (the f32 path) and, with ``cd_n`` = n1/2,
the Wang split's rotated pair [C, rows, cd_n] = (c || d) of the
channel-major spectra (the split i16 path's GEMM input,
ops/imdct.split_butterfly). The CUDA kernels are csrc/floor_kernel.cu; they
share their epilogue with K3 (csrc/floor_epilogue.cuh).

:func:`floor_spectra` takes CPU tensors to :func:`floor_spectra_ref` and
CUDA tensors to the kernel; it never falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import _build
from ..tables import floor1_db_four_factor
from .coupling import inverse_coupling_static
from .floor_curve import bresenham_idx, floor1_db_value
from .imdct import split_butterfly, split_tables

__all__ = ["floor_spectra", "floor_spectra_ref", "epilogue_args",
           "MAX_CHANNELS"]

#: kernel launches made by :func:`floor_spectra`, channel-major layout
LAUNCHES = 0
#: kernel launches made by :func:`floor_spectra`, flat layout
LAUNCHES_FLAT = 0
#: kernel launches made by :func:`floor_spectra`, ``cd_n`` form
LAUNCHES_CD = 0

MAX_CHANNELS = 8  # K1 keeps one register slot per channel
MAX_STREAM_CHANNELS = 255  # a Vorbis stream's channel count is 8 bits (K3)
MAX_STEPS = 256  # Vorbis coupling steps per mapping


def floor_spectra_ref(tele, residue, scal, step, steps,
                      ct_out: bool = True, cd_n: int = 0) -> torch.Tensor:
    """Plain torch version: f32 spectra [C, rows, W] (``ct_out``) or
    [rows, C, W]; with ``cd_n`` (needs ``ct_out``, W <= cd_n), the split
    pair (c || d) [C, rows, cd_n] of the channel-major spectra.

    tele: f32 [rows, C*4*(P+1)] packed telescopes (channel-major, then
    ex/ey/gx/gy); residue: i16|f32 [rows, C*W]; scal: f32 [rows, 1+C]
    (mode, f_used per channel); step: f32 [C, M*(P+1), W] 0/1 step matrix
    ``[x_p <= w]`` (``CompiledSetup.f1_step``); steps: static coupling
    ((mag, ang), ...). The bracket contraction is a matmul against the step
    matrix, exact because every partial sum is an integer below 2^24."""
    C, MP1, W = step.shape
    rows = tele.shape[0]
    P1 = tele.shape[1] // (4 * C)
    M = MP1 // P1
    dev = tele.device
    # fold the packet's mode one-hot into its M*P1 segment layout
    onehot = (scal[:, 0:1] == torch.arange(M, device=dev)).to(torch.float32)
    t4 = tele.reshape(rows, C, 4, P1)
    folded = (t4[:, :, :, None, :] * onehot[:, None, None, :, None]).reshape(
        rows, C, 4, MP1)
    br = torch.einsum("rcqk,ckw->qcrw", folded, step)  # [4, C, rows, W]
    lo_x, lo_y, gxc, gyc = br.unbind(0)
    g_full = t4[:, :, 2:4].sum(-1).permute(2, 1, 0)[..., None]  # [2, C, rows, 1]
    hi_x = g_full[0] - gxc
    hi_y = g_full[1] - gyc
    binx = torch.arange(W, device=dev, dtype=torch.float32)
    idx = bresenham_idx(lo_x, lo_y, hi_x, hi_y, binx)
    used = scal[:, 1:].t()[:, :, None]  # [C, rows, 1]
    curve = floor1_db_value(idx) * used
    res = inverse_coupling_static(
        residue.reshape(rows, C, W).to(torch.float32), steps)
    spectra = curve * res.permute(1, 0, 2)
    if cd_n:
        return torch.cat(split_butterfly(spectra, 2 * cd_n), -1)
    return spectra if ct_out else spectra.permute(1, 0, 2).contiguous()


@functools.cache
def _db_arg():
    """The 16 inverse-dB factors as the kernel's host argument."""
    db = np.concatenate(floor1_db_four_factor()).astype(np.float32)
    return (ctypes.c_float * 16)(*db.tolist())


@functools.cache
def _steps_arg(steps: tuple):
    """Coupling steps as the kernel's host argument (mag0, ang0, ...)."""
    flat = [int(i) for st in steps for i in st]
    return (ctypes.c_int * max(1, len(flat)))(*flat)


def epilogue_args(steps, C: int, max_channels: int = MAX_CHANNELS):
    """Check the static coupling steps against the epilogue's bounds
    (csrc/floor_epilogue.cuh; ``max_channels`` is the calling kernel's)
    and return the host arguments the kernels take: (n_steps, steps array,
    inverse-dB factors)."""
    steps = tuple(tuple(int(i) for i in st) for st in steps)
    if not 1 <= C <= max_channels or len(steps) > MAX_STEPS:
        raise ValueError(f"the kernel takes 1..{max_channels} channels and "
                         f"<= {MAX_STEPS} coupling steps")
    if any(not (0 <= i < C) for st in steps for i in st):
        raise ValueError(f"coupling steps {steps} index past {C} channels")
    return len(steps), _steps_arg(steps), _db_arg()


def floor_spectra(tele, residue, scal, xs, step, steps,
                  ct_out: bool = True, cd_n: int = 0) -> torch.Tensor:
    """Spectra f32 [C, rows, W] (``ct_out``) or [rows, C, W], or the split
    pair [C, rows, cd_n] (``cd_n``): the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors. Arguments as :func:`floor_spectra_ref`,
    plus xs: i32 [M, C, P] sorted post x (pad BIG_X), from which the kernel
    evaluates the step function itself (``step`` is not read there)."""
    global LAUNCHES, LAUNCHES_FLAT, LAUNCHES_CD
    dev = tele.device
    if dev.type == "cpu":
        return floor_spectra_ref(tele, residue, scal, step, steps, ct_out,
                                 cd_n)
    if dev.type != "cuda":
        raise ValueError(f"floor_spectra: unsupported device {dev}")
    rows = tele.shape[0]
    M, C, P = xs.shape
    W = step.shape[-1]
    n_steps, steps_arr, db_arr = epilogue_args(steps, C)
    check = _build.check_operand
    check("tele", tele, torch.float32, (rows, C * 4 * (P + 1)), dev)
    if residue.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"residue dtype {residue.dtype}: need int16 or float32")
    check("residue", residue, residue.dtype, (rows, C * W), dev)
    check("scal", scal, torch.float32, (rows, 1 + C), dev)
    check("xs", xs, torch.int32, (M, C, P), dev)
    check("step", step, torch.float32, (C, M * (P + 1), W), dev)
    if cd_n and (not ct_out or cd_n % 2 or cd_n < W):
        raise ValueError(f"cd_n={cd_n}: needs ct_out, an even cd_n and "
                         f"w_eff={W} <= cd_n")
    shape = ((C, rows, cd_n) if cd_n else (C, rows, W) if ct_out
             else (rows, C, W))
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if rows == 0 or W == 0:
        return out.zero_()
    lib = _build.load_library()
    common = (tele.data_ptr(), residue.data_ptr(),
              int(residue.dtype == torch.int16), scal.data_ptr(),
              xs.data_ptr())
    host = (n_steps, ctypes.addressof(steps_arr), ctypes.addressof(db_arr))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if cd_n:
            tw = split_tables(2 * cd_n, dev)[2]
            err = lib.lt_floor_spectra_cd(*common, tw.data_ptr(),
                                          out.data_ptr(), rows, C, W, P, M,
                                          cd_n, *host, stream)
        else:
            err = lib.lt_floor_spectra(*common, out.data_ptr(), rows, C, W,
                                       P, M, *host, int(ct_out), stream)
    if err != 0:
        raise RuntimeError(f"floor kernel launch failed: cudaError {err}")
    if cd_n:
        LAUNCHES_CD += 1
    elif ct_out:
        LAUNCHES += 1
    else:
        LAUNCHES_FLAT += 1
    return out
