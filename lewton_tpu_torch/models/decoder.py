"""Compiled stream setup and the per-chunk decode core, in PyTorch.

Ports lewton_tpu/models/decoder.py: ``CompiledSetup`` / ``compile_setup``
(decoder.py:91-335, same field names, same static fields) and the whole
dispatch of ``decode_frames_core`` (decoder.py:436-757) with an explicit
stream axis in place of ``vmap``. Setups in the floor kernel's gate
(:func:`floor_kernel_ok`: floor 1 only, static coupling, <= 8 channels, a
flat residue) run

    i16:  floor kernel K1 (channel-major) -> half-width DCT-IV GEMM
          -> overlap kernel K2 (X form)
    f32:  floor kernel K1 (flat) -> IMDCT GEMM -> f32 overlap-add

and every other setup (floor 0, per-mode coupling, more channels) runs the
generic stages -- coupling, floor curves, curve x residue -- before the
same GEMMs and tails, as the reference does on the TPU. With
``USE_FUSED_SYNTH_KERNEL``, floor-1 setups with static coupling outside
K1's gate -- frames that carry ``f1_brackets`` (:func:`precompute_brackets`),
more than 8 channels -- go through K3. :func:`synthesis_route` makes that
choice once per chunk. With ``ops.imdct.USE_DCT4_SPLIT`` (:func:`split_ok`)
the i16 path's long DCT-IV goes through the Wang split: K1 emits the
rotated pair (c || d) (``cd_n``), two half-size GEMMs give (U, V), and K2's
split form rebuilds X from them; on the other routes the rotation is plain
torch ops. A caller-supplied ``imdct`` takes the generic stages and K2's
audio form (:func:`finish_stream`). ``compact_cap`` packs the f32 tail's
PCM into one i16 buffer per stream; ``with_taps`` returns the stage
intermediates.

The reference's setup helpers live in modules that import JAX, so the small
ones this path needs (``residue_i16_bound``, ``_dct4_np``, the ``w_eff`` and
static-coupling logic) are numpy copies here; the test suite holds them
leaf-for-leaf against the reference's ``compile_setup``. ``compile_setup``
reads header fields only: it takes the port's records (``header.py``) and
lewton_tpu's parsed headers alike.

The host-facing half is the reference's too: :func:`pack_frames` stacks the
host front-end's packet plans (``audio.decode_packet_entropy``) into the
dense frames, :func:`compact_invalid_frames` and :func:`predict_out_lens`
are its numpy helpers, bit for bit, and :class:`StreamDecoder` decodes one
stream chunk by chunk on a device (the card unless the caller names
another), carrying the window state across chunks.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..audio import PacketPlan, decode_packet_entropy
from ..debug import TAP_NAMES
from ..errors import AudioBadFormat, AudioIsHeader, VorbisError
from ..header import IdentHeader, SetupHeader
from ..native import NativeStream, span_tables
from ..ops import imdct as imdct_mod
from ..ops.coupling import inverse_coupling_batch, inverse_coupling_static
from ..ops.floor_curve import (BIG_X, floor0_curve_batch, floor1_brackets_mxu,
                               floor1_render, floor1_step_matrix,
                               floor1_telescopes)
from ..ops.floor_kernel import MAX_CHANNELS, floor_spectra, floor_spectra_ref
from ..ops.imdct import (dct4_batch_parts_ct, dct4_split_uv_ct,
                         dct4_split_uv_from_cd, imdct_batch, split_cd_head)
from ..ops.synth_kernel import fused_floor_couple, fused_floor_couple_ref
from ..ops.windowing import (compact_i16, init_window_carry,
                             overlap_add_batch, overlap_add_i16_kernel_batch)
from ..tables import bark_cos_omega, imdct_matrix, window_slope

__all__ = ["CompiledSetup", "compile_setup", "from_jax_setup",
           "floor_kernel_inputs", "floor_stage", "floor_kernel_ok",
           "synthesis_route", "precompute_brackets", "synthesize_spectra_tapped",
           "synthesize_audio_tapped", "synthesize_audio", "synthesize_local",
           "finish_stream",
           "split_ok", "decode_frames_core", "decode_frames",
           "frames_program", "routing_flags",
           "USE_FUSED_SYNTH_KERNEL", "DEFAULT_CHUNK", "pack_frames",
           "compact_invalid_frames", "predict_out_lens", "frames_to_device",
           "host_threads", "StreamDecoder"]

DEFAULT_CHUNK = 64

#: opt-in, as in the reference (decoder.py:61): floor-1 render + coupling +
#: product through K3 for frames that carry ``f1_brackets``
USE_FUSED_SYNTH_KERNEL = False


@dataclass
class CompiledSetup:
    """Per-stream constant tables stacked over (mode, channel); leaves are
    torch tensors on one device, the static fields plain Python values.
    Field meanings: lewton_tpu.models.decoder.CompiledSetup."""

    # static geometry
    channels: int
    n0: int
    n1: int
    sample_rate: int
    max_posts: int  # P
    f0_order_max: int
    has_floor0: bool
    has_floor1: bool
    w_eff: int  # effective spectral width (residues are zero past it)
    static_coupling: tuple | None  # coupling steps when identical per mode
    residue_i16: bool  # residues lie on the integer lattice within i16
    residue_bound: float | None
    # stacked tables (leaves)
    mode_blockflag: torch.Tensor  # i32 [M]
    f_is_floor1: torch.Tensor  # bool [M, C]
    f1_xs: torch.Tensor  # i32 [M, C, P] sorted x positions (pad BIG_X)
    f1_mult: torch.Tensor  # i32 [M, C]
    f0_order: torch.Tensor  # i32 [M, C]
    f0_lfv_scale: torch.Tensor  # f32 [M, C]
    f0_amp_offset: torch.Tensor  # f32 [M, C]
    f0_cos_omega: torch.Tensor  # f32 [M, C, w_eff]
    coup_mag: torch.Tensor  # i32 [M, Smax]
    coup_ang: torch.Tensor  # i32 [M, Smax]
    coup_n: torch.Tensor  # i32 [M]
    f1_step: torch.Tensor  # f32 [C, M*(P+1), w_eff]
    slope0: torch.Tensor  # f32 [W] (zero past n0/2)
    slope1: torch.Tensor  # f32 [W]
    imdct_m0: torch.Tensor  # f32 [<=n0/2, n0]
    imdct_m1: torch.Tensor  # f32 [w_eff, n1]
    dct4_m0: torch.Tensor  # f32 [<=n0/2, n0/2]
    dct4_m1: torch.Tensor  # f32 [w_eff, n1/2]

    _leaf_names = (
        "mode_blockflag", "f_is_floor1", "f1_xs", "f1_mult", "f0_order",
        "f0_lfv_scale", "f0_amp_offset", "f0_cos_omega", "coup_mag",
        "coup_ang", "coup_n", "f1_step", "slope0", "slope1", "imdct_m0",
        "imdct_m1", "dct4_m0", "dct4_m1",
    )
    _static_names = (
        "channels", "n0", "n1", "sample_rate", "max_posts", "f0_order_max",
        "has_floor0", "has_floor1", "w_eff",
        "static_coupling", "residue_i16", "residue_bound",
    )

    @property
    def device(self) -> torch.device:
        return self.f1_xs.device


def from_jax_setup(leaves: dict, static: dict,
                   device="cuda") -> CompiledSetup:
    """Build the torch setup from the reference's setup carried across as
    numpy arrays (``leaves``: every name in ``_leaf_names``) and Python
    values (``static``: every name in ``_static_names``), on ``device``
    (the card unless the caller names another)."""
    return CompiledSetup(
        **{k: static[k] for k in CompiledSetup._static_names},
        **{k: torch.tensor(np.asarray(leaves[k]), device=device)
           for k in CompiledSetup._leaf_names})


def residue_i16_bound(setup: SetupHeader) -> float | None:
    """Worst-case |residue value| if every codebook used by any residue is
    integer-valued; None if any is fractional (numpy copy of
    lewton_tpu.models.decoder.residue_i16_bound)."""
    worst = 0.0
    for r in setup.residues:
        if r is None:
            continue
        bound = 0.0
        for p in range(8):
            mx = 0.0
            for cls_books in r.books:
                b = cls_books[p]
                if b is None or b < 0:
                    continue
                vq = setup.codebooks[b].vq
                if vq is None or vq.size == 0:
                    continue
                if not np.array_equal(vq, np.trunc(vq)):
                    return None
                mx = max(mx, float(np.abs(vq).max()))
            bound += mx
        worst = max(worst, bound)
    return worst


def _dct4_np(m: np.ndarray) -> np.ndarray:
    """[K, n] IMDCT matrix -> [K, n/2] DCT-IV matrix (sign-flipped column
    copies, so X rebuilds bit-identical audio)."""
    M = m.shape[1] // 2
    return np.concatenate([-m[:, 3 * M // 2:], m[:, : M // 2]], axis=1)


def compile_setup(ident: IdentHeader, setup: SetupHeader,
                  device="cuda") -> CompiledSetup:
    """Compile the decoded setup header into stacked tables on ``device``,
    the card unless the caller names another (numpy port of
    lewton_tpu.models.decoder.compile_setup)."""
    C = ident.channels
    n0, n1 = ident.bs0, ident.bs1
    W = n1 // 2
    M = len(setup.modes)
    floors = [
        [setup.floors[setup.mappings[m.mapping].submap_floor[
            setup.mappings[m.mapping].mux[c]]] for c in range(C)]
        for m in setup.modes
    ]
    f1s = [f for row in floors for f in row if f.floor_type == 1]
    f0s = [f for row in floors for f in row if f.floor_type == 0]
    P = max((len(f.x_list) for f in f1s), default=2)
    Omax = max((f.order for f in f0s), default=0)
    Smax = max((len(setup.mappings[m.mapping].coupling_magnitude)
                for m in setup.modes), default=0)

    f_is_floor1 = np.zeros((M, C), dtype=bool)
    f1_xs = np.full((M, C, P), BIG_X, dtype=np.int32)
    f1_mult = np.ones((M, C), dtype=np.int32)
    f0_order = np.zeros((M, C), dtype=np.int32)
    f0_lfv_scale = np.zeros((M, C), dtype=np.float32)
    f0_amp_offset = np.zeros((M, C), dtype=np.float32)
    f0_cos_omega = np.zeros((M, C, W), dtype=np.float32)
    coup_mag = np.zeros((M, Smax), dtype=np.int32)
    coup_ang = np.zeros((M, Smax), dtype=np.int32)
    coup_n = np.zeros((M,), dtype=np.int32)
    for mi, mode in enumerate(setup.modes):
        mapping = setup.mappings[mode.mapping]
        ns = len(mapping.coupling_magnitude)
        coup_n[mi] = ns
        coup_mag[mi, :ns] = mapping.coupling_magnitude
        coup_ang[mi, :ns] = mapping.coupling_angle
        n2 = (n1 if mode.blockflag else n0) // 2
        for c in range(C):
            fl = floors[mi][c]
            if fl.floor_type == 1:
                f_is_floor1[mi, c] = True
                xs = np.asarray(fl.x_list, dtype=np.int32)[fl.sort_order]
                f1_xs[mi, c, : len(xs)] = xs
                # f1_mult stays 1: frames carry index-space post values
            else:
                f0_order[mi, c] = fl.order
                f0_lfv_scale[mi, c] = np.float32(fl.amplitude_offset) / \
                    np.float32((1 << fl.amplitude_bits) - 1)
                f0_amp_offset[mi, c] = fl.amplitude_offset
                f0_cos_omega[mi, c, :n2] = bark_cos_omega(
                    n2, fl.rate, fl.bark_map_size)

    slope0 = np.zeros(W, dtype=np.float32)
    slope0[: n0 // 2] = window_slope(n0 // 2)
    slope1 = window_slope(n1 // 2)

    # effective spectral width: max per-channel residue extent over all
    # (mode, submap); type-2 ends are over the interleaved vector
    w_eff = 0
    for m in setup.modes:
        mapping = setup.mappings[m.mapping]
        n2 = (n1 if m.blockflag else n0) // 2
        for sm_i, res_i in enumerate(mapping.submap_residue):
            r = setup.residues[res_i]
            if r is None:
                w_eff = W
                continue
            ch_in = max(1, sum(1 for c in range(C) if mapping.mux[c] == sm_i))
            if r.residue_type == 2:
                per_ch = -(-min(r.end, n2 * ch_in) // ch_in)
            else:
                per_ch = min(r.end, n2)
            w_eff = max(w_eff, per_ch)
    w_eff = min(W, max(128, -(-w_eff // 128) * 128))

    step_lists = {
        tuple(zip(setup.mappings[m.mapping].coupling_magnitude,
                  setup.mappings[m.mapping].coupling_angle))
        for m in setup.modes
    }
    static_coupling = step_lists.pop() if len(step_lists) == 1 else None
    i16_bound = residue_i16_bound(setup)
    m0_np = imdct_matrix(n0)[: min(w_eff, n0 // 2)]
    m1_np = imdct_matrix(n1)[:w_eff]
    leaves = dict(
        mode_blockflag=np.array([m.blockflag for m in setup.modes],
                                dtype=np.int32),
        f_is_floor1=f_is_floor1, f1_xs=f1_xs, f1_mult=f1_mult,
        f0_order=f0_order, f0_lfv_scale=f0_lfv_scale,
        f0_amp_offset=f0_amp_offset, f0_cos_omega=f0_cos_omega[:, :, :w_eff],
        coup_mag=coup_mag, coup_ang=coup_ang, coup_n=coup_n,
        f1_step=floor1_step_matrix(f1_xs, w_eff),
        slope0=slope0, slope1=slope1, imdct_m0=m0_np, imdct_m1=m1_np,
        dct4_m0=_dct4_np(m0_np), dct4_m1=_dct4_np(m1_np),
    )
    static = dict(
        channels=C, n0=n0, n1=n1, sample_rate=ident.sample_rate,
        max_posts=P, f0_order_max=Omax, has_floor0=bool(f0s),
        has_floor1=bool(f1s), w_eff=w_eff, static_coupling=static_coupling,
        residue_i16=i16_bound is not None and i16_bound < 32768,
        residue_bound=i16_bound,
    )
    return from_jax_setup(leaves, static, device)


def floor_kernel_inputs(cs: CompiledSetup, fr: dict):
    """Operands of the floor kernel for frames with leaves [S, T, ...]:
    (tele f32 [S*T, C*4*(P+1)], residue [S*T, C*w_eff], scal f32
    [S*T, 1+C]) -- lewton_tpu.models.decoder._floor_kernel_spectra's
    preparation, with its one-hot ``_by_mode`` contraction as an exact
    gather."""
    S, T = fr["mode"].shape
    C, W, P = cs.channels, cs.w_eff, cs.max_posts
    rows = S * T
    if tuple(fr["residue"].shape) != (S, T, C * W):
        raise ValueError(f"residue frames {tuple(fr['residue'].shape)}: "
                         f"expected flat {(S, T, C * W)}")
    mode = fr["mode"].reshape(rows).long()
    tele = floor1_telescopes(cs.f1_xs[mode],
                             fr["f1_ys"].reshape(rows, C, P),
                             fr["f1_flags"].reshape(rows, C, P),
                             cs.f1_mult[mode])
    tele = torch.stack(tele, dim=2).reshape(rows, C * 4 * (P + 1))
    scal = torch.cat([mode.to(torch.float32)[:, None],
                      fr["f_used"].reshape(rows, C).to(torch.float32)], 1)
    return tele, fr["residue"].reshape(rows, C * W), scal


def floor_stage(cs: CompiledSetup, fr: dict, plain: bool = False,
                ct_out: bool = True, cd_n: int = 0):
    """Spectra f32 [C, S*T, w_eff] (``ct_out``) or [S*T, C, w_eff] of
    frames [S, T, ...], or with ``cd_n`` the Wang split's rotated pair
    (c || d) [C, S*T, cd_n]: the floor kernel (its plain version with
    ``plain``, or on the CPU)."""
    tele, residue, scal = floor_kernel_inputs(cs, fr)
    if plain:
        return floor_spectra_ref(tele, residue, scal, cs.f1_step,
                                 cs.static_coupling, ct_out, cd_n)
    return floor_spectra(tele, residue, scal, cs.f1_xs, cs.f1_step,
                         cs.static_coupling, ct_out, cd_n)


def floor_kernel_ok(cs: CompiledSetup, fr: dict,
                    allow_fused: bool = True) -> bool:
    """Whether frames [S, T, ...] take the floor kernel (the reference's
    ``_floor_kernel_ok`` without its TPU-only VMEM and lane bounds): floor 1
    only, static coupling, at most 8 channels, no precomputed brackets,
    and a flat residue [S, T, C*w_eff]. Everything else takes the generic
    stages."""
    return (allow_fused and "f1_brackets" not in fr
            and cs.has_floor1 and not cs.has_floor0
            and cs.static_coupling is not None
            and cs.channels <= MAX_CHANNELS
            and fr["residue"].dim() == 3
            and fr["residue"].shape[-1] == cs.channels * cs.w_eff)


def synthesis_route(cs: CompiledSetup, fr: dict,
                    allow_fused: bool = True) -> str:
    """Which stages synthesize the spectra of frames [S, T, ...], as the
    reference's ``_synthesize_spectra_tapped`` decides: ``"k1"`` (the floor
    kernel, :func:`floor_kernel_ok`), ``"k3"`` (``USE_FUSED_SYNTH_KERNEL``
    on a floor-1 setup with static coupling: K3 on the frames' brackets or
    one contraction) or ``"generic"``."""
    if floor_kernel_ok(cs, fr, allow_fused):
        return "k1"
    if (USE_FUSED_SYNTH_KERNEL and allow_fused and cs.has_floor1
            and not cs.has_floor0 and cs.static_coupling is not None):
        return "k3"
    return "generic"


def _brackets(cs: CompiledSetup, fr: dict, mode: torch.Tensor):
    """Floor-1 brackets of frames [..., T, ...], 4-tuple of [rows, C,
    w_eff]: the frames' ``f1_brackets`` or one contraction."""
    C, W, P = cs.channels, cs.w_eff, cs.max_posts
    rows = mode.shape[0]
    if "f1_brackets" in fr:
        return tuple(b.reshape(rows, C, W) for b in fr["f1_brackets"])
    return floor1_brackets_mxu(cs.f1_xs[mode], fr["f1_ys"].reshape(rows, C, P),
                               fr["f1_flags"].reshape(rows, C, P),
                               cs.f1_mult[mode], mode, cs.f1_step)


def precompute_brackets(cs: CompiledSetup, fr: dict) -> dict:
    """fr with an ``f1_brackets`` entry: the floor-1 brackets of all the
    frames (leaves [..., T, ...]) in one contraction over the flattened
    leading axes, a 4-tuple of [..., T, C, w_eff]
    (lewton_tpu.models.decoder.precompute_brackets)."""
    if not cs.has_floor1:
        return fr
    lead = tuple(fr["mode"].shape)
    br = _brackets(cs, fr, fr["mode"].reshape(-1).long())
    fr = dict(fr)
    fr["f1_brackets"] = tuple(b.reshape(lead + b.shape[1:]) for b in br)
    return fr


def synthesize_spectra_tapped(cs: CompiledSetup, fr: dict,
                              route: str | None = None, plain: bool = False):
    """Stages 1-3 (coupling, floors, curve x residue) of frames [S, T, ...],
    per packet, on ``route`` (default :func:`synthesis_route`). Returns
    (spectra f32 [S*T, C, w_eff], blockflag [S*T], taps); taps
    (``residue_pre_inverse``, ``residue_post_inverse``, ``pre_mdct``,
    [S*T, C, w_eff]) come from the generic stages only. With ``plain`` the
    kernels' plain versions run in their place."""
    S, T = fr["mode"].shape
    C, W = cs.channels, cs.w_eff
    rows = S * T
    mode = fr["mode"].reshape(rows).long()
    bf = cs.mode_blockflag[mode]
    route = route or synthesis_route(cs, fr)
    if route == "k1":
        return floor_stage(cs, fr, plain, ct_out=False), bf, {}

    residue = fr["residue"].reshape(rows, C, -1)[:, :, :W].to(torch.float32)
    used = fr["f_used"].reshape(rows, C)
    if route == "k3":
        fn = fused_floor_couple_ref if plain else fused_floor_couple
        spectra = fn(torch.stack(_brackets(cs, fr, mode), 1),
                     residue.contiguous(), used, cs.static_coupling)
        return spectra, bf, {}

    # 1. inverse coupling on the raw residue (before the floor multiply)
    taps = {"residue_pre_inverse": residue}
    if cs.static_coupling is not None:
        residue = inverse_coupling_static(residue, cs.static_coupling)
    else:
        residue = inverse_coupling_batch(residue, mode, cs.coup_mag,
                                         cs.coup_ang, cs.coup_n)
    taps["residue_post_inverse"] = residue

    # 2. floor curves: floor 1 or floor 0 per (mode, channel), 0 if unused
    is_f1 = cs.f_is_floor1[mode][:, :, None]
    curve = torch.zeros_like(residue)
    if cs.has_floor1:
        curve = torch.where(is_f1, floor1_render(_brackets(cs, fr, mode)),
                            curve)
    if cs.has_floor0:
        c0 = floor0_curve_batch(
            fr["f0_cosc"].reshape(rows, C, -1), fr["f0_amp"].reshape(rows, C),
            cs.f0_order[mode], cs.f0_lfv_scale[mode], cs.f0_amp_offset[mode],
            cs.f0_cos_omega[mode])
        curve = torch.where(is_f1, curve, c0)
    curve = torch.where(used[:, :, None], curve, torch.zeros_like(curve))

    # 3. spectra = floor x residue
    spectra = curve * residue
    taps["pre_mdct"] = spectra
    return spectra, bf, taps


def synthesize_audio_tapped(cs: CompiledSetup, fr: dict,
                            route: str | None = None, plain: bool = False,
                            imdct=imdct_batch):
    """Stages 1-4: :func:`synthesize_spectra_tapped`, then ``imdct``
    (default the IMDCT GEMMs). Returns (audio f32 [S*T, C, n1] -- or what
    a caller's ``imdct`` returns -- blockflag [S*T], taps +
    ``post_mdct``)."""
    spectra, bf, taps = synthesize_spectra_tapped(cs, fr, route, plain)
    audio = imdct(spectra, bf, cs.imdct_m0, cs.imdct_m1)
    taps["post_mdct"] = audio
    return audio, bf, taps


def synthesize_audio(cs: CompiledSetup, fr: dict, imdct=imdct_batch):
    """The per-packet synthesis prefix (coupling, floors, curve x residue,
    IMDCT) of frames [S, T, ...] over the flattened (stream, packet) axis
    (lewton_tpu.models.decoder.synthesize_audio). A caller's ``imdct``
    (same signature as :func:`imdct_batch`) turns K1 and K3 off, as in the
    reference. Returns (audio, blockflag [S*T])."""
    route = synthesis_route(cs, fr, allow_fused=imdct is imdct_batch)
    audio, bf, _ = synthesize_audio_tapped(cs, fr, route, imdct=imdct)
    return audio, bf


def synthesize_local(cs: CompiledSetup, fr: dict, local, plain: bool = False):
    """The part of a chunk before the collective of a caller's IMDCT that
    holds one (the tp IMDCT's all-reduce, ``parallel.batch``): the generic
    stages of frames [S, T, ...], as :func:`synthesize_audio` routes a
    caller's IMDCT, then ``local`` (the transform up to its collective,
    :func:`imdct_batch`'s signature). Returns (the local audio, blockflag
    [S*T]). The collective on that audio, then :func:`finish_stream`, end
    the chunk: the ops of :func:`decode_frames_core` with that IMDCT, in
    its order, with the collective between two captured segments
    (``parallel.graphs.SegmentedProgram``)."""
    route = synthesis_route(cs, fr, allow_fused=False)
    spectra, bf, _ = synthesize_spectra_tapped(cs, fr, route, plain)
    return local(spectra, bf, cs.imdct_m0, cs.imdct_m1), bf


def finish_stream(cs: CompiledSetup, audio, bf, fr: dict, carry,
                  with_i16: bool = False, compact_cap: int | None = None,
                  plain: bool = False, out=None):
    """The tail of a chunk after the IMDCT (lewton_tpu.models.decoder.
    finish_stream, with a stream axis): audio f32 [S*T, C, n1] (short
    blocks in [:n0]) or a (long [S*T, C, n1], short [S*T, C, n0]) pair of
    un-selected outputs, bf [S*T], frames [S, T, ...]. With ``with_i16``
    (no ``compact_cap``) the overlap kernel's audio form: ((i16
    [S, T, C*3n1/4], out_len), new_carry); otherwise the f32 overlap-add,
    results as :func:`decode_frames_core`'s."""
    S, T = fr["mode"].shape
    bf = bf.reshape(S, T)
    if with_i16 and compact_cap is None:
        return overlap_add_i16_kernel_batch(
            audio, bf, fr["prev_flag"], fr["next_flag"], fr["valid"],
            cs.slope0, cs.slope1, cs.n0, cs.n1, carry, plain=plain, out=out)
    if isinstance(audio, tuple):
        raise TypeError("un-selected IMDCT parts need the overlap kernel "
                        "(with_i16 without compact_cap)")
    if compact_cap is not None and out is not None:
        raise ValueError("out is not taken with compact_cap")
    (pcm, out_len), carry = overlap_add_batch(
        audio.reshape(S, T, cs.channels, cs.n1), bf, fr["prev_flag"],
        fr["next_flag"], fr["valid"], cs.slope0, cs.slope1, cs.n0, cs.n1,
        carry, out=out)
    if compact_cap is not None:
        buf, total = compact_i16(pcm, out_len, compact_cap)
        return (buf, total, out_len), carry
    return (pcm, out_len), carry


def split_ok(cs: CompiledSetup) -> bool:
    """Whether the i16 path's long transform goes through the Wang split:
    ``ops.imdct.USE_DCT4_SPLIT`` and the reference's own conditions
    (decoder.py:655-656) without its TPU lane gates -- w_eff clips the
    long GEMM little (w_eff * 8 >= 3 n1; the split has no clip) and
    n1 >= 512."""
    return bool(imdct_mod.USE_DCT4_SPLIT and cs.w_eff * 8 >= 3 * cs.n1
                and cs.n1 >= 512)


def _decode_i16(cs: CompiledSetup, fr: dict, carry, route: str, plain: bool,
                out):
    """The i16 path with the stock IMDCT: spectra channel-major, the
    half-width DCT-IV (direct, or through the Wang split when
    :func:`split_ok`), then the overlap kernel's X or split form
    (lewton_tpu.models.decoder.decode_frames_core, :654-702). On the K1
    route with the split, K1 emits the rotated pair (c || d) itself and
    the short GEMM reads its head back out of it (``split_cd_head``)."""
    n0, n1, mx0 = cs.n0, cs.n1, cs.dct4_m0
    split = split_ok(cs)
    if route == "k1" and split:
        cd = floor_stage(cs, fr, plain, cd_n=n1 // 2)
        long_x = dct4_split_uv_from_cd(cd, n1)
        head = None if n0 == n1 else split_cd_head(cd, n1, mx0.shape[0])
    else:
        if route == "k1":
            spectra_ct = floor_stage(cs, fr, plain)
        else:
            spectra, _, _ = synthesize_spectra_tapped(cs, fr, route, plain)
            spectra_ct = spectra.permute(1, 0, 2).contiguous()
        if split:
            long_x = dct4_split_uv_ct(spectra_ct, n1)
            head = None if n0 == n1 else spectra_ct[:, :, :mx0.shape[0]]
        else:
            long_x, short_x = dct4_batch_parts_ct(spectra_ct, mx0, cs.dct4_m1)
    if split:
        short_x = None if head is None else torch.matmul(head, mx0)
    return overlap_add_i16_kernel_batch(
        (long_x, short_x), cs.mode_blockflag[fr["mode"].long()],
        fr["prev_flag"], fr["next_flag"], fr["valid"], cs.slope0, cs.slope1,
        n0, n1, carry, ct_in=True, x_rep=True, x_split=split, plain=plain,
        out=out)


def decode_frames_core(cs: CompiledSetup, fr: dict, carry,
                       with_i16: bool = False, compact_cap: int | None = None,
                       with_taps: bool = False, plain: bool = False,
                       out=None, imdct=imdct_batch):
    """Decode one chunk of T packets for S streams.

    fr: frame tensors with leaves [S, T, ...] (lewton_tpu's pack_frames
    layout; residue flat [S, T, C*w_eff] or [S, T, C, >=w_eff]); carry (pwr
    [S, C, n1/2], plen [S], started [S]). Returns, with new_carry:

    - ``with_i16`` (no ``compact_cap``, no ``with_taps``): ((i16
      [S, T, C*3n1/4], out_len i32 [S, T]), new_carry), through the
      overlap kernel;
    - ``compact_cap``: ((pcm i16 [S, cap, C], total i32 [S], out_len),
      new_carry);
    - ``with_taps``: ((f32 [S, T, C, 3n1/4], out_len, taps with leaves
      [S, T, ...]), new_carry);
    - otherwise ((f32 [S, T, C, 3n1/4], out_len), new_carry).

    ``out``, if given, is the tensor the samples are written into (i16 or
    f32, as returned; not with ``compact_cap``). With ``plain`` the
    kernels' plain versions run in their place (on any device). A caller's
    ``imdct`` (signature of :func:`imdct_batch`: spectra [S*T, C, w_eff],
    bf, m0, m1 -> audio [S*T, C, n1] or a (long, short) pair) takes the
    generic stages, then the overlap kernel's audio form on the i16 path,
    as the reference routes ``imdct is not imdct_batch``."""
    S, T = fr["mode"].shape
    stock = imdct is imdct_batch
    route = synthesis_route(cs, fr, allow_fused=stock and not with_taps)
    if with_i16 and compact_cap is None and not with_taps and stock:
        return _decode_i16(cs, fr, carry, route, plain, out)

    audio, bf, taps = synthesize_audio_tapped(cs, fr, route, plain, imdct)
    if with_taps:
        (pcm, out_len), carry = finish_stream(cs, audio, bf, fr, carry,
                                              out=out)
        taps = {k: v.reshape((S, T) + tuple(v.shape[1:]))
                for k, v in taps.items()}
        return (pcm, out_len, taps), carry
    return finish_stream(cs, audio, bf, fr, carry, with_i16, compact_cap,
                         plain, out)


def _decode_one(cs: CompiledSetup, fr: dict, carry, with_i16: bool,
                compact_cap, with_taps: bool = False, out=None):
    """One stream's chunk through :func:`decode_frames_core` (a stream
    axis of 1 added and taken off); ``out`` [T, ...], if given, is written
    in place."""
    fr = {k: tuple(b[None] for b in v) if isinstance(v, tuple) else v[None]
          for k, v in fr.items()}
    res, carry = decode_frames_core(cs, fr, tuple(c[None] for c in carry),
                                    with_i16, compact_cap, with_taps,
                                    out=None if out is None else out[None])
    res = tuple({k: v[0] for k, v in r.items()} if isinstance(r, dict)
                else r[0] for r in res)
    return res, tuple(c[0] for c in carry)


def routing_flags() -> tuple:
    """The routing flags a chunk reads while it is enqueued, which a
    captured graph would keep: part of every program's key."""
    return (imdct_mod.USE_DCT4_SPLIT, USE_FUSED_SYNTH_KERNEL)


def frames_program(programs, cs: CompiledSetup, fr: dict, carry,
                   with_i16: bool = False, compact_cap: int | None = None,
                   with_taps: bool = False):
    """The program of ``programs`` (a ``parallel.graphs.Programs``) that
    decodes one chunk of one stream, frames of ``fr``'s layout (leaves
    [T, ...]) from ``carry``'s layout, made at its first use: the
    counterpart of the reference's jitted ``decode_frames``. Keyed as that
    jit is: the setup's static fields and its tables' signature (not its
    identity), ``with_i16``, ``compact_cap``, ``with_taps``, the frames'
    signature and the routing flags. The setup's tables are loaded into
    the owner's static copy of their layout (``Programs.static_tables``, a
    copy only when the setup changes), and the program reads them there, so
    every setup of one geometry shares it. Call it as ``prog(fr, carry)``
    -> ((out, out_len), (pcm, total, out_len) or, with ``with_taps``, (f32
    out, out_len, taps)), carry); ``fr`` may lie on the host, and is copied
    straight into the program's static inputs. With ``with_taps`` the
    program takes the eager taps route (the generic stages, the f32
    overlap-add; ``with_i16`` and ``compact_cap`` not read, as there), and
    its taps are static buffers of the eager taps' shapes."""
    from ..parallel import graphs

    if with_taps:
        with_i16, compact_cap = False, None
    tables = {k: getattr(cs, k) for k in CompiledSetup._leaf_names}
    static = programs.static_tables(tables, cs)
    key = ("frames",
           tuple(getattr(cs, k) for k in CompiledSetup._static_names),
           graphs.signature(tables), bool(with_i16), compact_cap,
           bool(with_taps), graphs.signature(fr), routing_flags())

    def make():
        scs = dataclasses.replace(cs, **static)
        dev, T, C = cs.device, fr["mode"].shape[0], cs.channels
        outw = 3 * cs.n1 // 4
        lens = torch.empty(T, dtype=torch.int32, device=dev)
        if compact_cap is not None:
            outs = (torch.empty((compact_cap, C), dtype=torch.int16,
                                device=dev),
                    torch.empty((), dtype=torch.int32, device=dev), lens)
        elif with_i16:
            outs = (torch.empty((T, C * outw), dtype=torch.int16,
                                device=dev), lens)
        else:
            outs = (torch.empty((T, C, outw), dtype=torch.float32,
                                device=dev), lens)
        if with_taps:
            outs += ({k: torch.empty((T, C, cs.n1 if k == "post_mdct"
                                      else cs.w_eff), dtype=torch.float32,
                                     device=dev) for k in TAP_NAMES},)

        def body(inputs, c, o):
            res, c = _decode_one(scs, inputs, c, with_i16, compact_cap,
                                 with_taps, out=None if compact_cap is not None
                                 else o[0])
            for dst, src in zip(o, res):
                if isinstance(dst, dict):  # the taps
                    for k, t in dst.items():
                        t.copy_(src[k])
                elif not graphs._same(dst, src):  # out_len; compact's
                    dst.copy_(src)
            return c
        return graphs.ChunkProgram(programs, body, fr, carry, outs, key)
    return programs.get(key, make)


def decode_frames(cs: CompiledSetup, fr: dict, carry, with_i16: bool = False,
                  compact_cap: int | None = None, with_taps: bool = False,
                  programs=None):
    """Single-stream chunk decode: frame leaves [T, ...], carry (pwr
    [C, n1/2], plen [], started []); outputs as
    :func:`decode_frames_core`'s without the stream axis.

    With ``programs`` (a ``parallel.graphs.Programs``) the chunk runs as a
    program of that owner (:func:`frames_program`): captured as a CUDA
    graph at its first call on a card and replayed, one dispatch a chunk,
    as the reference's jitted ``decode_frames`` (``with_taps`` among its
    static arguments: the taps come out of a captured program too). Its
    outputs (the taps among them) are then the program's own buffers,
    valid until its next run, and its carry the owner's, valid until the
    next run of any of its programs with that carry layout (``graphs``'
    lifetime); ``fr`` may lie on the host. Without ``programs`` the chunk
    is enqueued one op at a time into fresh outputs."""
    if programs is None:
        return _decode_one(cs, fr, carry, with_i16, compact_cap, with_taps)
    return frames_program(programs, cs, fr, carry, with_i16, compact_cap,
                          with_taps)(fr, carry)


# --------------------------------------------------------------------------- #
# Frame packing (host): PacketPlan list -> fixed-shape arrays
# --------------------------------------------------------------------------- #


def pack_frames(cs: CompiledSetup, plans: list[PacketPlan], chunk: int) -> dict:
    """Stack T <= chunk packet plans into padded dense numpy frames (the
    reference's pack_frames, bit for bit): residue flat [T, C*w_eff] (i16
    when ``cs.residue_i16``, else f32; zero past w_eff), a ``None`` plan an
    invalid slot."""
    T = chunk
    C, W, P, Omax = cs.channels, cs.w_eff, cs.max_posts, cs.f0_order_max
    fr = {
        "mode": np.zeros(T, np.int32),
        "prev_flag": np.zeros(T, bool),
        "next_flag": np.zeros(T, bool),
        "valid": np.zeros(T, bool),
        "residue": np.zeros((T, C * W),
                            np.int16 if cs.residue_i16 else np.float32),
        "f_used": np.zeros((T, C), bool),
        "f1_ys": np.zeros((T, C, P), np.int32),
        "f1_flags": np.zeros((T, C, P), bool),
        "f0_cosc": np.zeros((T, C, max(Omax, 1)), np.float32),
        "f0_amp": np.zeros((T, C), np.float32),
    }
    for t, plan in enumerate(plans):
        if plan is None:  # undecodable packet: invalid slot (device no-op)
            continue
        fr["mode"][t] = plan.mode_number
        fr["prev_flag"][t] = plan.prev_window_flag
        fr["next_flag"][t] = plan.next_window_flag
        fr["valid"][t] = True
        w = min(plan.n // 2, W)
        fr["residue"][t].reshape(C, W)[:, :w] = plan.residue[:, :w]
        for c, f in enumerate(plan.floors):
            if f[0] == "unused":
                continue
            fr["f_used"][t, c] = True
            df = f[1]
            if f[0] == "f1":
                so = df.floor.sort_order
                nv = len(so)
                fr["f1_ys"][t, c, :nv] = np.asarray(df.final_y)[so]
                fr["f1_flags"][t, c, :nv] = np.asarray(df.step2_flag)[so]
            else:
                fr["f0_cosc"][t, c, : len(df.cos_coefficients)] = \
                    df.cos_coefficients
                fr["f0_amp"][t, c] = df.amplitude
    return fr


def compact_invalid_frames(fr: dict) -> None:
    """Make each stream's valid frames a chunk prefix, in place (leaves
    [S, T, ...] numpy). The overlap-add takes invalid slots as a chunk
    suffix, so compacting the good frames to the front gives the
    per-packet semantics: a bad packet emits no PCM and leaves the window
    state untouched."""
    valid = fr["valid"]
    n = valid.sum(axis=1)
    prefix = np.arange(valid.shape[1]) < n[:, None]
    for s in np.flatnonzero((valid != prefix).any(axis=1)):
        good = np.flatnonzero(valid[s])
        for arr in fr.values():
            arr[s, :n[s]] = arr[s][good]
            arr[s, n[s]:] = 0


def predict_out_lens(cs: CompiledSetup, fr: dict, started):
    """Per-packet output lengths from host-known frame fields (numpy,
    exact), so callers size a compacted output before the device runs.
    ``fr`` leaves may have a leading stream axis; ``started`` is the
    per-stream (or scalar) carry-in. Returns (out_lens i64 [..., T],
    started_out)."""
    bf_tab = cs.mode_blockflag
    if isinstance(bf_tab, torch.Tensor):
        bf_tab = bf_tab.cpu().numpy()
    bf = np.asarray(bf_tab)[np.asarray(fr["mode"])]
    long_blk = bf == 1
    pf = np.asarray(fr["prev_flag"])
    nf = np.asarray(fr["next_flag"])
    valid = np.asarray(fr["valid"])
    n0, n1 = cs.n0, cs.n1
    left = np.where(long_blk & ~pf, (n1 - n0) >> 2, 0)
    right = np.where(long_blk & ~nf, (3 * n1 - n0) >> 2,
                     np.where(long_blk, n1 >> 1, n0 >> 1))
    before = np.cumsum(valid, axis=-1) - valid
    started_seq = np.logical_or(np.asarray(started)[..., None], before > 0)
    lens = np.where(valid & started_seq, right - left, 0).astype(np.int64)
    started_out = np.logical_or(np.asarray(started), valid.any(axis=-1))
    return lens, started_out


def frames_to_device(fr: dict, device) -> dict:
    """numpy frames -> tensors on ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in fr.items()}


# --------------------------------------------------------------------------- #
# Host-facing stream decoder
# --------------------------------------------------------------------------- #


def host_threads() -> int:
    """The host worker threads of a batch's host stages (the native
    front-end's, the compaction's): the cores, at most 8."""
    return min(8, os.cpu_count() or 1)


#: the stages of :attr:`StreamDecoder.stage_s`
STAGES = ("compile_setup", "frontend", "device", "d2h")


class StreamDecoder:
    """Per-stream chunked decode (lewton_tpu.models.decoder.StreamDecoder):
    entropy-decode packets on the host, run the chunk core on ``device``
    (the card unless the caller names another) in fixed-size chunks, and
    carry the window state across chunks.

    ``frontend``: "auto" (the default) and "native" entropy-decode with the
    port's C++ library (``native/``), which parses the raw header packets
    and so needs ``raw_headers=(ident packet, setup packet)``; "auto"
    without them, and "python", take the Python front-end. A library that
    fails to build or load raises: nothing falls back to the Python
    front-end."""

    def __init__(self, ident: IdentHeader, setup: SetupHeader,
                 chunk: int = DEFAULT_CHUNK,
                 raw_headers: tuple[bytes, bytes] | None = None,
                 frontend: str = "auto", device="cuda"):
        if frontend not in ("auto", "native", "python"):
            raise ValueError(f"frontend {frontend!r}: 'auto', 'native' or "
                             "'python'")
        if frontend == "native" and raw_headers is None:
            raise ValueError(
                "frontend='native' requires raw_headers=(ident, setup): the "
                "C++ parser reads the raw header packets")
        self.ident = ident
        self.setup = setup
        self.chunk = chunk
        self.device = torch.device(device)
        #: host seconds by stage: compile_setup (here), the front-end
        #: (entropy decode into frames), the device call (the program's
        #: copies in and its replay or eager enqueue, the carry's copy) and
        #: the copies out, which wait for the device
        self.stage_s = dict.fromkeys(STAGES, 0.0)
        t0 = time.perf_counter()
        self.cs = compile_setup(ident, setup, device=self.device)
        self.stage_s["compile_setup"] = time.perf_counter() - t0
        self._native = None
        if frontend != "python" and raw_headers is not None:
            self._native = NativeStream(*raw_headers)
            self._native.frame_width = self.cs.w_eff
            self.set_residue_transport("default")
        self.reset()

    def reset(self) -> None:
        pwr, plen, started = init_window_carry(
            self.cs.channels, self.cs.n1 // 2, 1, self.device)
        self.carry = (pwr[0], plen[0], started[0])

    def set_residue_transport(self, kind: str) -> None:
        """The native front-end's residue emit: "default" (i16 when the
        setup's static bound allows it, else f32) or "p12" (the 12-bit
        planes, packed as the packets are decoded: one write of the
        dominant buffer instead of decode then pack; needs
        parallel.pack12.pack12_supported). A no-op on the Python front-end,
        whose callers pack its i16/f32 frames."""
        if kind not in ("default", "p12"):
            raise ValueError(f"residue transport {kind!r}: 'default' or "
                             "'p12'")
        if self._native is None:
            return
        if kind == "p12":
            from ..parallel.pack12 import pack12_supported

            if not pack12_supported(self.cs):
                raise ValueError("p12 emit needs the setup's static bound "
                                 "< 2048 and a row width divisible by 8")
            self._native.residue_dtype = np.uint32
        else:
            self._native.residue_dtype = (
                np.int16 if self.cs.residue_i16 else np.float32)

    def save_state(self):
        """The window carry as host numpy (pwr [C, n1/2] f32, plen i32,
        started bool), the reference's save_state layout."""
        return tuple(c.cpu().numpy() for c in self.carry)

    def load_state(self, state) -> None:
        """Load a carry saved by :meth:`save_state` (this package's or the
        reference's) onto the decoder's device."""
        self.carry = tuple(torch.as_tensor(np.array(c), device=self.device)
                           for c in state)

    @property
    def frame_layout(self) -> dict | None:
        """name -> (shape after the lead axes, dtype) of the native
        front-end's frames at this decoder's chunk, under its residue emit
        (:meth:`set_residue_transport`); None on the Python front-end."""
        if self._native is None:
            return None
        return self._native.frame_layout(self.chunk)

    def _native_chunk(self, streams: list, out: dict,
                      threads: int) -> np.ndarray:
        """The native front-end on one chunk of a stream batch into ``out``
        (lead (S,)): the span tables of ``streams`` (lists of bytes joined
        into one blob, or a ``native.PacketSpans`` each) through one
        native call. Returns the status [S, T]."""
        # ``held``, the bytes the tables point into, lives until the call
        # returns
        bufs, offs, lens, counts, held = span_tables(streams, self.chunk)
        return self._native.decode_spans(bufs, offs, lens, counts, out,
                                         threads)

    def entropy_chunk(self, packets: list[bytes]) -> dict:
        """Host half for one chunk: packets -> dense frames (numpy dict).
        Strict: raises on any non-audio or undecodable packet (the Python
        front-end's exception classes, whichever front-end runs), so
        ``valid`` is a chunk prefix."""
        if self._native is not None:
            fr, status = self.entropy_chunk_status(packets)
            st = status[: len(packets)]
            if st.any():
                bad = int(np.argmax(st != 0))
                if st[bad] == 1:
                    raise AudioIsHeader(f"header packet at chunk index {bad}")
                raise AudioBadFormat(f"undecodable packet at chunk index {bad}")
            return fr
        plans = [decode_packet_entropy(self.ident, self.setup, p)
                 for p in packets]
        return pack_frames(self.cs, plans, self.chunk)

    def entropy_chunk_status(self, packets: list[bytes],
                             out: dict | None = None):
        """Like :meth:`entropy_chunk` but tolerant: returns (frames, status)
        with per-slot status 0 ok / 1 header packet / 2 bad; bad slots stay
        ``valid=False``."""
        if self._native is not None:
            if len(packets) > self.chunk:
                raise ValueError(f"{len(packets)} packets for a chunk of "
                                 f"{self.chunk}")
            fr = out if out is not None else self._native.frame_buffers(
                self.chunk)
            status = self._native_chunk(
                [packets], {k: v[None] for k, v in fr.items()}, threads=1)
            return fr, status[0]
        plans: list = []
        status = np.zeros(self.chunk, np.uint8)
        for t, p in enumerate(packets):
            try:
                plans.append(decode_packet_entropy(self.ident, self.setup, p))
            except AudioIsHeader:
                plans.append(None)
                status[t] = 1
            except VorbisError:
                plans.append(None)
                status[t] = 2
        fr = pack_frames(self.cs, plans, self.chunk)
        if out is not None:
            for k in out:
                out[k][...] = fr[k]
            fr = out
        return fr, status

    def entropy_chunk_batch(self, streams: list, threads: int | None = None,
                            out: dict | None = None):
        """Host half for one chunk of a stream batch: [S][<=T] packets (each
        stream a list of bytes or a ``native.PacketSpans``) -> (frames with
        a leading stream axis, into ``out`` when given; the status [S, T],
        0 ok / 1 header packet / 2 bad, 0 past a stream's packets).
        Tolerant: bad packets are skipped by compacting each stream's good
        frames to a chunk prefix (:func:`compact_invalid_frames`). The
        native front-end decodes the whole batch in one call on ``threads``
        worker threads (default: the cores, at most 8); the Python
        front-end decodes on the calling thread."""
        if self._native is None:
            res = [self.entropy_chunk_status(pcks) for pcks in streams]
            fr = {k: np.stack([f[k] for f, _ in res]) for k in res[0][0]}
            status = np.stack([st for _, st in res])
            compact_invalid_frames(fr)
            if out is not None:
                for k in out:
                    out[k][...] = fr[k]
                fr = out
            return fr, status
        if threads is None:
            threads = host_threads()
        fr = out if out is not None else self._native.frame_buffers(
            self.chunk, lead=(len(streams),))
        status = self._native_chunk(streams, fr, threads)
        compact_invalid_frames(fr)
        return fr, status

    def _decode(self, packets: list[bytes], with_i16: bool):
        """Each chunk of ``packets`` through this device's single-stream
        programs (``graphs.stream_programs``; one program per setup
        geometry, shared with every decoder there): the host frames are
        copied straight into the program's inputs, and the carry it
        returns, the owner's, is copied into fresh tensors of this
        decoder's own before anything else runs there (the carry rule;
        fresh, so a state taken from the old ones stays as it was)."""
        from ..parallel import graphs

        owner = graphs.stream_programs(self.cs.device)
        outs: list[np.ndarray] = []
        C = self.cs.channels
        st = self.stage_s
        for i in range(0, len(packets), self.chunk):
            t0 = time.perf_counter()
            batch = packets[i: i + self.chunk]
            fr = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in self.entropy_chunk(batch).items()}
            t1 = time.perf_counter()
            (out, out_len), carry = decode_frames(
                self.cs, fr, self.carry, with_i16=with_i16, programs=owner)
            self.carry = tuple(c.clone() for c in carry)
            t2 = time.perf_counter()
            # a copy on the CPU too: the program's next run rewrites out
            out = out.to("cpu", copy=True).numpy()
            if with_i16:
                out = out.reshape(len(out), C, -1)
            out_len = out_len.cpu().numpy()
            st["frontend"] += t1 - t0
            st["device"] += t2 - t1
            st["d2h"] += time.perf_counter() - t2
            for t in range(len(batch)):
                outs.append(out[t, :, : int(out_len[t])])
        return outs

    def decode_packets(self, packets: list[bytes]) -> list[np.ndarray]:
        """Decode audio packets -> planar f32 [C, out_len] per packet (the
        first packet of a stream yields length 0)."""
        return self._decode(packets, with_i16=False)

    def decode_packets_i16(self, packets: list[bytes]) -> list[np.ndarray]:
        """Like :meth:`decode_packets` through the device i16 path (K1 and
        K2 on the card): planar i16 [C, out_len] per packet."""
        return self._decode(packets, with_i16=True)
