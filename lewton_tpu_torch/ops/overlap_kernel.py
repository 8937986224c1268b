"""K2 — windowed overlap-add + i16: plain torch versions, CUDA kernel
wrappers.

Ports lewton_tpu/ops/overlap_kernel.py::overlap_i16_pallas in its three
input forms: the half-width DCT-IV X, channel-major (``_kernel_x`` with
``ct_in``, :func:`overlap_i16`); the Wang-split halves U, V of the long X
(``split_in``, :func:`overlap_i16_split`); and the IMDCT audio itself from
a caller-supplied IMDCT (``_kernel``, :func:`overlap_i16_audio`),
channel-major or [rows, C, n], un-selected (long, short) or pre-selected.
Each form rebuilds the window regions from its input, selects long/short
and the lapped start, mixes against the previous packet's right region (or
the carried ``pwr0`` at the chunk's first row), zeroes past ``out_len``,
x32768, clamps, truncates to i16, and carries the right region of each
stream's last valid packet. The column map of ``scal`` is
lewton_tpu/ops/windowing.overlap_add_i16_kernel_batch's. The CUDA kernel
(one template over the three input forms) is csrc/overlap_kernel.cu.

Valid packets must form a prefix of each stream's chunk (the reference's
``compact_invalid_frames`` contract): the carry is the right region of row
``nvalid - 1``.

Each wrapper takes CPU tensors to its plain version and CUDA tensors to
the kernel; it never falls back from one to the other. The kernel writes 8
samples a thread and needs n0 and n1 to be multiples of 32 (every Vorbis
blocksize is): its C interface refuses other geometries, and the wrapper
then raises.
"""

from __future__ import annotations

import torch

from .. import _build
from .imdct import combine_split

__all__ = ["overlap_i16", "overlap_i16_ref", "overlap_i16_split",
           "overlap_i16_split_ref", "overlap_i16_audio",
           "overlap_i16_audio_ref"]

#: kernel launches made by :func:`overlap_i16` (X form)
LAUNCHES = 0
#: kernel launches made by :func:`overlap_i16_split`
LAUNCHES_SPLIT = 0
#: kernel launches made by :func:`overlap_i16_audio`
LAUNCHES_AUDIO = 0

N_SCAL = 13


def _audio(x: torch.Tensor) -> torch.Tensor:
    """IMDCT output [.., 2h] from DCT-IV X [.., h]:
    [X[h/2:], -rev(X), -X[:h/2]]."""
    q = x.shape[-1] // 2
    return torch.cat([x[..., q:], -x.flip(-1), -x[..., :q]], -1)


def _overlap_core(al, ash, scal, slopes, pwr0, n0: int, n1: int, out):
    """The tail on IMDCT audio rows al f32 [C, S, T, n1] and ash f32
    [C, S, T, n0], or ash None: al is pre-selected (short rows hold their
    n0 samples first; with n0 == n1 every row is whole)."""
    S, T, _ = scal.shape
    C = al.shape[0]
    W = n1 // 2
    m = n0 // 2
    outw = 3 * n1 // 4
    ls = (n1 - n0) // 4
    m_start = (3 * n1 - n0) // 4

    def col(k):  # [1, S, T, 1]
        return scal[None, :, :, k, None]

    def pad_w(x):
        return torch.nn.functional.pad(x, (0, W - x.shape[-1]))

    a_long = torch.where(col(2) > 0, al[..., ls:ls + outw], al[..., :outw])
    rr_l = al[..., W:]
    rr_m = pad_w(al[..., m_start:m_start + m])
    if ash is not None:
        a_short = torch.nn.functional.pad(ash, (0, outw - n0))
        a_cur = torch.where(col(8) > 0, a_long, a_short)
        rr_s = pad_w(ash[..., m:2 * m])
    else:
        a_cur = a_long
        rr_s = pad_w(al[..., m:2 * m])

    def prev(x):  # row t-1 of the same stream (row 0: masked below)
        return torch.cat([torch.zeros_like(x[:, :, :1]), x[:, :, :-1]], 2)

    pwr = torch.where(col(3) > 0, prev(rr_l),
                      torch.where(col(4) > 0, prev(rr_m), prev(rr_s)))
    p0 = pwr0.permute(1, 0, 2)[:, :, None, :]  # [C, S, 1, W]
    pwr = torch.where(col(5) > 0, p0, pwr)

    lhs = torch.where(col(0) > 0, slopes[1], slopes[0])
    rhs = torch.where(col(1) > 0, slopes[3], slopes[2])
    dev = al.device
    iota_w = torch.arange(W, device=dev, dtype=torch.float32)
    iota_ow = torch.arange(outw, device=dev, dtype=torch.float32)
    head = a_cur[..., :W]
    mix = torch.where(iota_w < col(6), head * lhs + pwr * rhs, head)
    full = torch.cat([mix, a_cur[..., W:]], -1)
    outf = torch.where(iota_ow < col(7), full, torch.zeros_like(full))
    i16 = torch.trunc(torch.clamp(outf * 32768.0, -32768.0, 32767.0))
    i16 = i16.to(torch.int16).permute(1, 2, 0, 3).reshape(S, T, C * outw)
    out = i16 if out is None else out.copy_(i16)

    rr = torch.where(col(10) > 0, rr_l,
                     torch.where(col(11) > 0, rr_m, rr_s))  # [C, S, T, W]
    nvalid = (scal[:, :, 9] > 0).sum(1)
    last = torch.clamp(nvalid - 1, min=0)
    pwr_last = rr[:, torch.arange(S, device=dev), last]  # [C, S, W]
    pwr_out = torch.where((nvalid > 0)[None, :, None], pwr_last,
                          pwr0.permute(1, 0, 2))
    return out, pwr_out.permute(1, 0, 2).contiguous()


def overlap_i16_ref(x_long, x_short, scal, slopes, pwr0, n0: int, n1: int,
                    out=None):
    """Plain torch version of the X form: (i16 [S, T, C*3n1/4], pwr_out
    f32 [S, C, n1/2]).

    x_long: f32 [C, S*T, n1/2]; x_short: f32 [C, S*T, n0/2] or None
    (n0 == n1); scal: f32 [S, T, 13]; slopes: f32 [4, n1/2] (slope0,
    slope1, rev0, rev1); pwr0: f32 [S, C, n1/2]; out: i16 [S, T, C*3n1/4]
    to write the samples into, or None."""
    S, T, _ = scal.shape
    C = x_long.shape[0]
    ash = (None if x_short is None
           else _audio(x_short.reshape(C, S, T, n0 // 2)))
    return _overlap_core(_audio(x_long.reshape(C, S, T, n1 // 2)), ash,
                         scal, slopes, pwr0, n0, n1, out)


def overlap_i16_split_ref(u, v, x_short, scal, slopes, pwr0, n0: int,
                          n1: int, out=None):
    """Plain torch version of the split form: the long X recombined from
    u, v f32 [C, S*T, n1/4] (ops/imdct.combine_split), then the X form.
    Other arguments and the result as :func:`overlap_i16_ref`'s."""
    return overlap_i16_ref(combine_split(u, v), x_short, scal, slopes, pwr0,
                           n0, n1, out)


def _as_cst(a, S: int, T: int, ct_in: bool):
    """Audio [C, S*T, n] (ct_in) or [S*T, C, n] as a [C, S, T, n] view."""
    if ct_in:
        return a.reshape(a.shape[0], S, T, a.shape[-1])
    return a.reshape(S, T, a.shape[1], a.shape[-1]).permute(2, 0, 1, 3)


def overlap_i16_audio_ref(long_a, short_a, scal, slopes, pwr0, n0: int,
                          n1: int, ct_in: bool = False, out=None):
    """Plain torch version of the audio form: long_a f32 [C, S*T, n1]
    (``ct_in``) or [S*T, C, n1]; short_a the same with n0 columns, or None
    when long_a is pre-selected (short rows hold their n0 samples first).
    Other arguments and the result as :func:`overlap_i16_ref`'s."""
    S, T, _ = scal.shape
    ash = None if short_a is None else _as_cst(short_a, S, T, ct_in)
    return _overlap_core(_as_cst(long_a, S, T, ct_in), ash, scal, slopes,
                         pwr0, n0, n1, out)


def _outputs(scal, slopes, pwr0, out, C: int, n0: int, n1: int, dev):
    """Check the operands every form shares; allocate (out, pwr_out)."""
    S, T = scal.shape[:2]
    W = n1 // 2
    if n0 % 4 or n1 % 4 or not 4 <= n0 <= n1:
        raise ValueError(f"overlap kernel: bad blocksizes n0={n0}, n1={n1}")
    check = _build.check_operand
    f32 = torch.float32
    check("scal", scal, f32, (S, T, N_SCAL), dev)
    check("slopes", slopes, f32, (4, W), dev)
    check("pwr0", pwr0, f32, (S, C, W), dev)
    if out is None:
        out = torch.empty((S, T, C * (3 * n1 // 4)), dtype=torch.int16,
                          device=dev)
    check("out", out, torch.int16, (S, T, C * (3 * n1 // 4)), dev)
    return out, torch.empty((S, C, W), dtype=f32, device=dev)


def _launch(name: str, inputs, scal, slopes, pwr0, out, pwr_out, C: int,
            n0: int, n1: int, *extra) -> None:
    """Launch the C entry ``name`` on the current stream; raise on error."""
    S, T = scal.shape[:2]
    dev = scal.device
    fn = getattr(_build.load_library(), name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(None if x is None else x.data_ptr() for x in inputs),
                 scal.data_ptr(), slopes.data_ptr(), pwr0.data_ptr(),
                 out.data_ptr(), pwr_out.data_ptr(), S, T, C, n0, n1,
                 *extra, stream)
    if err != 0:
        raise RuntimeError(f"overlap kernel launch failed: cudaError {err}")


def _device(x, what: str) -> torch.device | None:
    """None for a CPU tensor (the plain version runs), the device for a
    CUDA tensor; raise for any other."""
    dev = x.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def overlap_i16(x_long, x_short, scal, slopes, pwr0, n0: int, n1: int,
                out=None):
    """(i16 [S, T, C*3n1/4], pwr_out f32 [S, C, n1/2]) from DCT-IV X: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors (same
    arguments as :func:`overlap_i16_ref`)."""
    global LAUNCHES
    dev = _device(x_long, "overlap_i16")
    if dev is None:
        return overlap_i16_ref(x_long, x_short, scal, slopes, pwr0, n0, n1,
                               out)
    S, T = scal.shape[:2]
    C = x_long.shape[0]
    if (x_short is None) != (n0 == n1):
        raise ValueError(f"overlap kernel: x_short must be given exactly "
                         f"when n0={n0} < n1={n1}")
    out, pwr_out = _outputs(scal, slopes, pwr0, out, C, n0, n1, dev)
    check = _build.check_operand
    check("x_long", x_long, torch.float32, (C, S * T, n1 // 2), dev)
    if x_short is not None:
        check("x_short", x_short, torch.float32, (C, S * T, n0 // 2), dev)
    if S == 0 or T == 0 or C == 0:
        return out, pwr_out.copy_(pwr0)
    _launch("lt_overlap_i16", (x_long, x_short), scal, slopes, pwr0, out,
            pwr_out, C, n0, n1)
    LAUNCHES += 1
    return out, pwr_out


def overlap_i16_split(u, v, x_short, scal, slopes, pwr0, n0: int, n1: int,
                      out=None):
    """The split form (same result as :func:`overlap_i16` on the recombined
    X): the plain version for CPU tensors, the CUDA kernel for CUDA tensors
    (arguments as :func:`overlap_i16_split_ref`)."""
    global LAUNCHES_SPLIT
    dev = _device(u, "overlap_i16_split")
    if dev is None:
        return overlap_i16_split_ref(u, v, x_short, scal, slopes, pwr0, n0,
                                     n1, out)
    S, T = scal.shape[:2]
    C = u.shape[0]
    if (x_short is None) != (n0 == n1):
        raise ValueError(f"overlap kernel: x_short must be given exactly "
                         f"when n0={n0} < n1={n1}")
    out, pwr_out = _outputs(scal, slopes, pwr0, out, C, n0, n1, dev)
    check = _build.check_operand
    check("u", u, torch.float32, (C, S * T, n1 // 4), dev)
    check("v", v, torch.float32, (C, S * T, n1 // 4), dev)
    if x_short is not None:
        check("x_short", x_short, torch.float32, (C, S * T, n0 // 2), dev)
    if S == 0 or T == 0 or C == 0:
        return out, pwr_out.copy_(pwr0)
    _launch("lt_overlap_i16_split", (u, v, x_short), scal, slopes, pwr0,
            out, pwr_out, C, n0, n1)
    LAUNCHES_SPLIT += 1
    return out, pwr_out


def overlap_i16_audio(long_a, short_a, scal, slopes, pwr0, n0: int, n1: int,
                      ct_in: bool = False, out=None):
    """The audio form: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors (arguments as :func:`overlap_i16_audio_ref`). Unlike
    the X form, ``short_a=None`` with n0 < n1 is allowed: it means the
    audio is pre-selected."""
    global LAUNCHES_AUDIO
    dev = _device(long_a, "overlap_i16_audio")
    if dev is None:
        return overlap_i16_audio_ref(long_a, short_a, scal, slopes, pwr0, n0,
                                     n1, ct_in, out)
    S, T = scal.shape[:2]
    C = long_a.shape[0 if ct_in else 1]
    out, pwr_out = _outputs(scal, slopes, pwr0, out, C, n0, n1, dev)

    def shape(n):
        return (C, S * T, n) if ct_in else (S * T, C, n)

    check = _build.check_operand
    check("long", long_a, torch.float32, shape(n1), dev)
    if short_a is not None:
        check("short", short_a, torch.float32, shape(n0), dev)
    if S == 0 or T == 0 or C == 0:
        return out, pwr_out.copy_(pwr0)
    _launch("lt_overlap_i16_audio", (long_a, short_a), scal, slopes, pwr0,
            out, pwr_out, C, n0, n1, int(ct_in))
    LAUNCHES_AUDIO += 1
    return out, pwr_out
