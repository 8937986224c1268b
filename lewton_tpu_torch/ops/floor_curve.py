"""Floor numerics: floor 1 for the kernels' plain versions and the generic
path, the two exported floor-1 curve ops, and the floor-0 LSP curve.

Torch twins of lewton_tpu/ops/floor_curve.py, op for op. Floor 1 is
bit-identical: every intermediate is an exactly representable integer
(< 2^24) in f32, and the inverse-dB value is the same 4-factor product in
the same rounding order. The CUDA kernels (csrc/floor_epilogue.cuh) repeat
the same arithmetic per element. Floor 0 goes through ``sqrt`` and ``exp``,
which differ by an ulp or two between libraries, so it is held to a
relative bound instead (tests/test_torch_generic.py).

``floor1_curve_batch`` (bracketing posts by packed max/min reductions over
the post axis) and ``floor1_curve_mxu`` (the step-matrix contraction, then
the render) are plain torch ops on the device of their inputs, bit for bit
equal to each other and to the reference's. The reference fuses the first
one's [T, C, P, W] compare-selects into its reductions; eager torch
materialises them (about 10 bytes per element at once), so a caller bounds
T*C*P*W.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tables import floor1_db_four_factor

__all__ = ["BIG_X", "floor1_db_value", "floor1_telescopes", "bresenham_idx",
           "floor1_step_matrix", "floor1_brackets_mxu", "floor1_render",
           "floor1_curve_batch", "floor1_curve_mxu", "floor0_curve_batch"]

BIG_X = 1 << 24  # sentinel "no post here" x position
VX = 1 << 15  # virtual tail post x (beyond any real x)


def floor1_db_value(idx: torch.Tensor) -> torch.Tensor:
    """Inverse-dB value for integer-valued f32 idx in [0, 255]:
    ``(H1[idx>>6] * H0[(idx>>4)&3]) * (L1[(idx>>2)&3] * L0[idx&3])``
    (tables.floor1_db_four_factor, max 2 ulp from the spec table)."""
    H1, H0, L1, L0 = floor1_db_four_factor()
    ia = torch.floor(idx * (1.0 / 64.0))
    r = idx - ia * 64.0
    ib = torch.floor(r * (1.0 / 16.0))
    r = r - ib * 16.0
    ic = torch.floor(r * 0.25)
    il = r - ic * 4.0

    def sel4(s, tab):
        v = torch.full_like(s, float(tab[0]))
        for j in range(1, 4):
            v = torch.where(s == j, torch.full_like(s, float(tab[j])), v)
        return v

    hi = sel4(ia, H1) * sel4(ib, H0)
    lo = sel4(ic, L1) * sel4(il, L0)
    return hi * lo


def floor1_curve_batch(xs: torch.Tensor, ys: torch.Tensor,
                       flags: torch.Tensor, mult: torch.Tensor,
                       width: int) -> torch.Tensor:
    """Floor-1 curve f32 [T, C, width] (inverse-dB domain;
    lewton_tpu/ops/floor_curve.floor1_curve_batch).

    xs: i32 [T, C, P] post x positions, sorted ascending, pad BIG_X; ys:
    i32 [T, C, P] final_y in the same order; flags: bool [T, C, P] step2
    flags (pad False); mult: i32 [T, C] floor multiplier. Each bin's
    bracketing flagged posts come from two reductions over the post axis on
    packed (x << 11 | y) values: the max such pack with x <= bin is the
    segment start, the min with x > bin the segment end (x < 2^15 per spec
    rangebits, y <= 255*4 < 2^11, so packs fit i32 and compare in (x, y)
    order). Then the Bresenham closed form in integers and the inverse-dB
    value."""
    binx = torch.arange(width, dtype=torch.int32, device=xs.device)
    ysm = ys * mult[:, :, None]
    pack4 = ((torch.clamp(xs, max=1 << 15) << 11) | ysm)[..., None]
    xs4 = xs[..., None]
    fl4 = flags[..., None]
    none_lo, none_hi = -1, 2 ** 31 - 1
    lo = torch.where(fl4 & (xs4 <= binx), pack4,
                     torch.full_like(pack4, none_lo)).amax(2)  # [T, C, W]
    hi = torch.where(fl4 & (xs4 > binx), pack4,
                     torch.full_like(pack4, none_hi)).amin(2)
    # a row with no flagged posts (unused channel, padding) yields the
    # minimum curve, as the bracket contraction does
    no_lo = lo == none_lo
    lo_x = torch.where(no_lo, 0, lo >> 11)
    lo_y = torch.where(no_lo, 0, lo & 2047)
    no_hi = hi == none_hi
    hi_x = torch.where(no_hi, lo_x + 1, hi >> 11)
    hi_y = torch.where(no_hi, lo_y, hi & 2047)

    # Bresenham closed form between (lo_x, lo_y) and (hi_x, hi_y); every
    # operand of a division is >= 0, so floor and trunc agree. Past the
    # last flagged post dy = 0: the horizontal tail.
    dy = hi_y - lo_y
    adx = torch.clamp(hi_x - lo_x, min=1)
    ady = torch.abs(dy)
    base = torch.sign(dy) * torch.div(ady, adx, rounding_mode="floor")
    ady_r = ady - torch.abs(base) * adx
    d = binx - lo_x
    k = torch.div(d * ady_r, adx, rounding_mode="floor")
    y = lo_y + base * d + torch.sign(dy) * k
    return floor1_db_value(torch.clamp(y, 0, 255).to(torch.float32))


def floor1_curve_mxu(xs, ys, flags, mult, mode, step,
                     width: int | None = None) -> torch.Tensor:
    """Floor-1 curve f32 [T, C, W] through the step-matrix brackets and the
    render (lewton_tpu/ops/floor_curve.floor1_curve_mxu); W is the step
    matrix's, which ``width`` must equal when given."""
    if width is not None and width != step.shape[2]:
        raise ValueError(f"width {width}, step matrix width {step.shape[2]}")
    return floor1_render(floor1_brackets_mxu(xs, ys, flags, mult, mode, step))


def floor1_telescopes(xs: torch.Tensor, ys: torch.Tensor,
                      flags: torch.Tensor, mult: torch.Tensor):
    """Per-post telescoping differences (ex, ey, gx, gy), f32 [T, C, P+1].

    xs, ys: i32 [T, C, P] (mode-gathered sorted post x, pad BIG_X; final_y
    in the same order); flags: bool [T, C, P]; mult: i32 [T, C]. For every
    bin w, ``lo(w) = sum_p e_p [x_p <= w]`` and
    ``hi(w) = sum_p g_p - sum_p g_p [x_p <= w]`` give the bracketing flagged
    posts (lewton_tpu/ops/floor_curve.floor1_brackets_mxu)."""
    T, C, P = xs.shape
    ysm = ys * mult[:, :, None]
    iota_p = torch.arange(P, dtype=torch.int32, device=xs.device)
    xc = torch.clamp(xs, max=VX)

    def cummax(a):  # scan P as the outer dim (one thread per column): the
        # CUDA scan along the short innermost dim cost 0.63 ms per call
        # at S*T = 32768 rows on an H100, 2.5 ms of a 10 ms chunk
        a = a.permute(2, 0, 1).contiguous()
        return torch.cummax(a, dim=0).values.permute(1, 2, 0)

    def rcummax(a):
        return cummax(a.flip(2)).flip(2)

    def shift(a):  # a[p-1], -1 at p=0
        return torch.cat([torch.full_like(a[:, :, :1], -1), a[:, :, :-1]], 2)

    def shiftr(a):  # a[p+1], -1 at p=P-1
        return torch.cat([a[:, :, 1:], torch.full_like(a[:, :, :1], -1)], 2)

    neg = torch.full_like(xs, -1)
    # previous flagged (x, y) per post via cummax scans of (p, value) tags
    cx = cummax(torch.where(flags, (iota_p << 16) | xc, neg))
    cy = cummax(torch.where(flags, (iota_p << 11) | ysm, neg))
    sx, sy = shift(cx), shift(cy)
    prevx = torch.where(sx < 0, 0, sx & 0xFFFF)
    prevy = torch.where(sy < 0, 0, sy & 0x7FF)
    # next flagged via reversed scans
    nx_ = rcummax(torch.where(flags, ((P - 1 - iota_p) << 16) | xc, neg))
    ny_ = rcummax(torch.where(flags, ((P - 1 - iota_p) << 11) | ysm, neg))
    last_y = torch.where(cy[:, :, -1] < 0, 0, cy[:, :, -1] & 0x7FF)  # [T, C]
    snx, sny = shiftr(nx_), shiftr(ny_)
    nextx = torch.where(snx < 0, VX, snx & 0xFFFF)
    nexty = torch.where(sny < 0, last_y[:, :, None], sny & 0x7FF)

    flf = flags.to(torch.float32)
    xsf = xc.to(torch.float32)
    ysf = ysm.to(torch.float32)
    ex = flf * (xsf - prevx.to(torch.float32))
    ey = flf * (ysf - prevy.to(torch.float32))
    gx = flf * (xsf - nextx.to(torch.float32))
    gy = flf * (ysf - nexty.to(torch.float32))
    # virtual tail post: x = VX, y = last flagged y; only participates in g
    zero = torch.zeros((T, C, 1), dtype=torch.float32, device=xs.device)
    ex = torch.cat([ex, zero], 2)
    ey = torch.cat([ey, zero], 2)
    gx = torch.cat([gx, torch.full_like(zero, float(VX))], 2)
    gy = torch.cat([gy, last_y[:, :, None].to(torch.float32)], 2)
    return ex, ey, gx, gy


def bresenham_idx(lo_x, lo_y, hi_x, hi_y, binx_f):
    """Exact-f32 single-quotient Bresenham between the bracketing posts ->
    floor1 index clipped to [0, 255] (f32). All operands are f32 integers.

    ``y = lo_y + sgn(dy) * floor(d * ady / adx)``: d * ady < 2^23 is exact,
    the IEEE quotient is within 1 of the integer floor, and one remainder
    correction recovers it (proof: lewton_tpu/ops/floor_curve.bresenham_idx).
    ``sgn`` is 0 for dy = 0."""
    dy = hi_y - lo_y
    adx = torch.clamp(hi_x - lo_x, min=1.0)
    sgn = torch.sign(dy)
    ady = torch.abs(dy)
    x = (binx_f - lo_x) * ady
    q = torch.floor(x / adx)
    r = x - q * adx
    q = q + (r >= adx).to(torch.float32)
    q = q - (r < 0).to(torch.float32)
    y = lo_y + sgn * q
    return torch.clamp(y, 0.0, 255.0)


def floor1_brackets_mxu(xs, ys, flags, mult, mode, step):
    """The bracketing flagged posts of every bin, (lo_x, lo_y, hi_x, hi_y)
    f32 [T, C, W] (lewton_tpu/ops/floor_curve.floor1_brackets_mxu).

    xs, ys: i32 [T, C, P] (mode-gathered sorted post x, final_y in the same
    order); flags bool [T, C, P]; mult i32 [T, C]; mode [T]; step f32
    [C, M*(P+1), W] (``CompiledSetup.f1_step``). The packet's mode one-hot
    is folded into its telescopes, which are contracted against the step
    matrix: lo = sum_p e_p [x_p <= w], hi = sum_p g_p - sum_p g_p [x_p <= w].
    An fp32 contraction (TF32 off, pinned at package import) is exact
    because every partial sum is an integer below 2^24."""
    T, C, P = xs.shape
    ex, ey, gx, gy = floor1_telescopes(xs, ys, flags, mult)
    m = step.shape[1] // (P + 1)
    oh = (mode[:, None] == torch.arange(m, device=xs.device)).to(torch.float32)

    def contract(v):
        vm = (v[:, :, None, :] * oh[:, None, :, None]).reshape(T, C, m * (P + 1))
        return torch.einsum("tcp,cpw->tcw", vm, step)

    return (contract(ex), contract(ey),
            gx.sum(2, keepdim=True) - contract(gx),
            gy.sum(2, keepdim=True) - contract(gy))


def floor1_render(brackets) -> torch.Tensor:
    """Floor-1 curve f32 [T, C, W] from the brackets (4-tuple of [T, C, W]):
    the exact Bresenham index, then the inverse-dB value
    (lewton_tpu/ops/floor_curve.floor1_render)."""
    lo_x, lo_y, hi_x, hi_y = brackets
    binx = torch.arange(lo_x.shape[-1], device=lo_x.device, dtype=torch.float32)
    return floor1_db_value(bresenham_idx(lo_x, lo_y, hi_x, hi_y, binx))


def floor0_curve_batch(cosc, amp, order, lfv_scale, amp_offset, cos_omega):
    """Floor-0 LSP curve f32 [T, C, W] (spec 6.2.3;
    lewton_tpu/ops/floor_curve.floor0_curve_batch, same ops in the same
    order).

    cosc f32 [T, C, Omax] cos(coefficient), pad 0; amp f32 [T, C] (0 =>
    unused); order i32 [T, C]; lfv_scale, amp_offset f32 [T, C]; cos_omega
    f32 [T, C, W] bark-mapped cos(omega) per bin. The exp argument is
    clamped at 88.7, just inside f32's overflow edge, so the curve stays
    finite."""
    omax = cosc.shape[2]
    odd = (order % 2) == 1
    oddb = odd[:, :, None]
    cw = cos_omega
    p = torch.where(oddb, 1.0 - cw * cw, (1.0 - cw) * 0.5)
    q = torch.where(oddb, torch.full_like(cw, 0.25), (1.0 + cw) * 0.5)

    def half(x):  # floor division, as Python's // on negative orders
        return torch.div(x, 2, rounding_mode="floor")

    p_hi = torch.where(odd, half(order - 3), half(order - 2))[:, :, None]
    q_hi = torch.where(odd, half(order - 1), half(order - 2))[:, :, None]
    for j in range(omax // 2 + 1):
        pm = cosc[:, :, min(2 * j + 1, omax - 1), None] - cw
        qm = cosc[:, :, min(2 * j, omax - 1), None] - cw
        p = torch.where(j <= p_hi, p * (4.0 * pm * pm), p)
        q = torch.where(j <= q_hi, q * (4.0 * qm * qm), q)
    arg = 0.11512925 * ((amp * lfv_scale)[:, :, None] / torch.sqrt(p + q)
                        - amp_offset[:, :, None])
    curve = torch.exp(torch.clamp(arg, max=88.7))
    return torch.where((amp > 0)[:, :, None], curve, torch.zeros_like(curve))


def floor1_step_matrix(f1_xs, width: int) -> np.ndarray:
    """Static step matrix ``[x_p <= w]`` in GEMM layout [C, M*(P+1), W]
    (numpy; the virtual tail post row is all-zero)."""
    xs = np.asarray(f1_xs)  # [M, C, P]
    M, C, P = xs.shape
    step = (xs[..., None] <= np.arange(width)).astype(np.float32)
    step = np.concatenate([step, np.zeros((M, C, 1, width), np.float32)],
                          axis=2)
    return np.ascontiguousarray(
        step.transpose(1, 0, 2, 3).reshape(C, M * (P + 1), width))
