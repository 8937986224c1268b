#!/usr/bin/env python3
"""Smoke run of lewton_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``lewton_tpu_torch/csrc/`` with nvcc
(one process per source, in parallel) and holds each kernel form -- K1
channel-major, flat and ``cd_n`` (the Wang split's rotated pair), K2 on
DCT-IV X, on the split halves (U, V) and on IMDCT audio (un-selected or
pre-selected, channel-major or not), K3 -- against its plain torch version
on the card, bit for bit, at the headline shapes (S=256 streams x T=128
packets, flagship stereo 44.1 kHz setup), at an odd T, at T = 1 and with
K2 rows that mix nothing or end inside a group of 8 samples, at the
crafted geometries the port sends to its kernels and the reference never
did (the split forms at those with n1 >= 512), K1 at every channel count
1..8 it instantiates (odd and unaligned widths, modes out of range), and
(K3) at 10 channels. It prints each kernel's registers, spill bytes and
resident warps (``registers:``). Then it
drives each path of ``decode_chunks_scan`` with the launch counts set to 0
just before and read just after, and requires the kernels of that path,
and only those, to have run once per chunk:

- the i16 main path (N=16 chunks): K1 channel-major, DCT-IV GEMM, K2;
- the f32 path (N=4): K1 flat, IMDCT GEMM, f32 overlap-add;
- the generic i16 path for a per-mode-coupling and a floor-0 setup (N=4):
  generic stages, DCT-IV GEMM, K2;
- the opt-in K3 path (``USE_FUSED_SYNTH_KERNEL``, N=4): precompute_brackets,
  K3, DCT-IV GEMM, K2; and at 10 channels (N=2), past K1's gate, where
  K3's wide form runs on brackets contracted inside the chunk;
- the Wang-split i16 path (``USE_DCT4_SPLIT``, N=4): K1 cd_n, the two
  half-size GEMMs and the short one, K2 split_in; and with per-mode
  coupling (generic stages, the rotation in torch, K2 split_in);
- a caller-supplied IMDCT (N=4): generic stages, the caller's transform,
  K2's audio form.

Each path's first chunks are anchored to the port's plain path on the CPU.
It times the kernels against their plain versions (with each kernel's
bound: the larger of its bytes over the card's memory rate and its
operations over the FP32 peak), each stage of a main path chunk and each
path on its kernels and on its plain versions, and profiles one call of
each path (device busy share, device time per op).

Last, the host-facing path. The frames phase: every audio packet of the
committed streams of ``tests/data/torch_gate/`` through the port's native
front-end (its C++ library, built here by the host compiler) and its Python
one, the frames and status codes the same in f32, i16 and p12 emit, with
the known exceptions named in FRAMES_RESIDUE_DIVERGES, and both
front-ends' packets/s. The conformance gate on the native front-end: every
committed stream (corpus, crafted floor-1 and floor-0 streams, with their
libvorbis goldens) through ``OggStreamReader.read_all_i16()`` on the card,
exact length and 0 samples over +/-2 LSB; the reference's three production
permutations of ``BatchDecoder.decode_streams_i16`` on four of them (the
flagship's p12 from the native emit); the whole set again with the Wang
split (recorded). Then file-to-PCM lines of ``BatchDecoder`` split by
stage: 32 copies of a stereo stream on the Python front-end and on the
native one (medians of calls in turn), and the reference's ``bench.py
--e2e`` shape (256 streams of about 30 s). Every failed check raises, so the
exit code is nonzero. The last stdout line is
``{"ok": true, "device": {...}}``; the line before it lists the kernels as
JSON. Needs torch, numpy, nvcc and a C++ compiler.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from lewton_tpu_torch import _build, native
from lewton_tpu_torch.header import Mode
from lewton_tpu_torch.inside_ogg import OggStreamReader, read_headers
from lewton_tpu_torch.models import decoder
from lewton_tpu_torch.models.decoder import (StreamDecoder, compile_setup,
                                             floor_kernel_inputs, floor_stage,
                                             precompute_brackets, split_ok,
                                             synthesize_spectra_tapped)
from lewton_tpu_torch.ops import (floor_kernel, imdct, overlap_kernel,
                                  synth_kernel)
from lewton_tpu_torch.ops.imdct import (dct4_batch_parts_ct,
                                        dct4_split_uv_from_cd,
                                        imdct_batch_parts_ct, split_butterfly,
                                        split_cd_head, sum_order_bound)
from lewton_tpu_torch.ops.windowing import init_window_carry, overlap_table
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.parallel.batch import BatchDecoder, decode_chunks_scan
from lewton_tpu_torch.parallel.pack12 import (pack12_np, pack12_supported,
                                             probed_h2d_mb_s)
from lewton_tpu_torch.testing import (synthetic_floor0_frames,
                                      synthetic_frames, synthetic_headers)

S, T, N = 256, 128, 16  # headline: streams, packets per chunk, chunks
N_NEW = 4  # chunks of each further path (an f32 chunk is 403 MB of PCM)
WIDE_C, N_WIDE = 10, 2  # channels and chunks of the wide K3 path
ODD_T, ODD_S = 144, 64  # T not a multiple of the kernels' row blocks
ANCHOR_S, ANCHOR_N = 4, 2  # streams/chunks re-run on the CPU
#: (n0, n1, C, w_eff) the port sends to its kernels and the reference's
#: kernel gates never admitted (crafted streams f1_bs64, f1_bs64_8192,
#: f1_bs8192, a 512-sample setup, and 8 channels)
GEOMETRIES = ((64, 64, 1, 32), (64, 8192, 1, 512), (8192, 8192, 1, 512),
              (512, 512, 1, 256), (256, 2048, 8, 896))
GEO_S, GEO_T = 4, 37
#: card vs CPU plain path, i16 LSB: floor 1 is exact up to the GEMM's sum
#: order (1 LSB); floor 0 also goes through exp and sqrt, whose last ulp
#: differs between CUDA and the CPU library, so it is held to the +/-2 LSB
#: budget of the conformance contract
MAX_LSB = {"floor1": 1, "floor0": 2}
FLOOR0_RTOL = 2.0 ** -16  # floor-0 curve, relative (tests/test_torch_generic.py)
#: the card's published rates (H100 SXM data sheet, at 700 W): device
#: memory, and FP32 outside the tensor cores
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12
#: arithmetic per output element of each kernel, for its operations bound:
#: K1 -- the bracket lookup (prefix sums and the segment's Bresenham terms
#: are formed once per row, channel and segment; a bin reads its seg from
#: a table, ~2), the Bresenham index from the segment's terms (~10),
#: inverse dB (a table read, 1), the mask and the product (2), 2 per
#: coupling step (~2); K1 cd_n adds the rotation (3 per value); K3 forms
#: the Bresenham terms per bin and evaluates the 4-factor inverse dB: 17;
#: K2 -- the window mix (3), x32768, clamp and truncation (4), the split
#: form one add more
OPS = {"floor": 17, "floor_flat": 17, "floor_cd": 20, "synth": 17,
       "overlap": 7, "overlap_split": 8, "overlap_audio": 7}
#: K1 at every channel count it instantiates (frames GEO_S x GEO_T of the
#: setup synthetic_headers(C)): (C, residue dtype, w_eff cut to (None: the
#: setup's), residue stored one element past an aligned start, modes out of
#: [0, M) on some rows, modes M). Odd and unaligned widths take the
#: kernel's scalar, masked accesses; 10 modes make the seg table (M C W
#: bytes) exceed its budget, so that setup takes the binary search.
K1_VARIANTS = ((1, torch.int16, None, False, False, 2),
               (2, torch.int16, None, False, True, 10),
               (3, torch.int16, 333, True, False, 2),
               (4, torch.float32, None, True, False, 2),
               (5, torch.int16, 381, False, True, 2),
               (6, torch.float32, 337, False, True, 2),
               (7, torch.int16, None, True, True, 2),
               (8, torch.float32, 253, True, False, 2))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def kernel_registers(cs) -> str:
    """Each kernel's registers a thread, local (spill) bytes a thread and
    resident warps a multiprocessor at the headline's launch, as
    cudaFuncGetAttributes and the occupancy calculator report them: K1's
    two kernels at every channel count and residue type, K2's three
    forms."""
    lib = _build.load_library()
    out = (ctypes.c_int * 8)()
    parts = []
    M = cs.mode_blockflag.shape[0]
    for cd, form in ((0, "floor"), (1, "floor_cd")):
        for dtype, i16 in (("i16", 1), ("f32", 0)):
            cells = []
            for C in range(1, 9):
                e = lib.lt_floor_kernel_attrs(cd, C, i16, cs.w_eff,
                                              cs.n1 // 2, cs.max_posts, M,
                                              out)
                if e != 0:
                    raise RuntimeError(f"lt_floor_kernel_attrs: cudaError {e}")
                cells.append(f"C={C} {out[0]}r/{out[1]}B/{8 * out[4]}w")
            parts.append(f"{form} {dtype} " + " ".join(cells))
    for form, name in enumerate(("overlap", "overlap_split", "overlap_audio")):
        e = lib.lt_overlap_kernel_attrs(form, out)
        if e != 0:
            raise RuntimeError(f"lt_overlap_kernel_attrs: cudaError {e}")
        parts.append(f"{name} {out[0]}r/{out[1]}B/{8 * out[4]}w")
    return ("registers (registers/spill bytes a thread/resident warps a "
            "multiprocessor): " + "; ".join(parts))


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device milliseconds per call of fn, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def to_dev(fr: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in fr.items()}


def expand(fr: dict, n: int) -> dict:
    """Frames [S, T, ...] as n identical chunks [n, S, T, ...] (views)."""
    def e(v):
        return v.expand((n,) + tuple(v.shape))
    return {k: tuple(map(e, v)) if isinstance(v, tuple) else e(v)
            for k, v in fr.items()}


def table_args(cs, fr, plen0, started0) -> tuple:
    """Arguments of ``overlap_table`` for frames [S, T, ...]."""
    return (cs.mode_blockflag[fr["mode"].long()], fr["prev_flag"],
            fr["next_flag"], fr["valid"], cs.slope0, cs.slope1, cs.n0,
            cs.n1, plen0, started0)


def stage_operands(cs, fr):
    """Each stage's operands for one chunk of frames [S, T, ...] and a
    fresh carry, computed once (the floor stage on its kernel)."""
    pwr0, plen0, started0 = init_window_carry(
        cs.channels, cs.n1 // 2, fr["mode"].shape[0], cs.device)
    k1 = floor_kernel_inputs(cs, fr)
    spectra = floor_stage(cs, fr)
    table = table_args(cs, fr, plen0, started0)
    scal13, slopes, _, _ = overlap_table(*table)
    k2 = (*dct4_batch_parts_ct(spectra, cs.dct4_m0, cs.dct4_m1), scal13,
          slopes, pwr0, cs.n0, cs.n1)
    return k1, spectra, table, k2


def k3_operands(cs, fr):
    """K3's operands for frames [S, T, ...]: (brackets [S*T, 4, C, W],
    residue f32 [S*T, C, W], used [S*T, C], steps)."""
    rows, C, W = fr["mode"].numel(), cs.channels, cs.w_eff
    br = precompute_brackets(cs, fr)["f1_brackets"]
    return (torch.stack(br, 2).reshape(rows, 4, C, W),
            fr["residue"].reshape(rows, C, W).to(torch.float32),
            fr["f_used"].reshape(rows, C), cs.static_coupling)


def bound_of(ops: int, inputs, outputs) -> tuple[float, str]:
    """(bound_ms, bound_by) of a kernel: the larger of the bytes it must
    move (each input read once, each output written once) over the card's
    memory rate and its operations over the FP32 peak. inputs and outputs
    are tensors, moved whole, or byte counts (what this run's data needs of
    a tensor); None is skipped."""
    moved = sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
                else t for t in (*inputs, *outputs) if t is not None)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k2_row_bytes(cs, scal13, audio: bool) -> int:
    """Bytes of K2's row input that this run's packets need, all channels.
    In the X and split forms a packet reads the X row (or the U, V halves)
    of its own blocksize only: n1/2 floats for a long block, n0/2 for a
    short one (every block reads its whole row). Of a pre-selected audio
    row [n1] a packet reads the samples its output takes (3n1/4 from the
    lapped start) and its right region."""
    n0, n1, C = cs.n0, cs.n1, cs.channels
    M, m = n1 // 2, n0 // 2
    col = scal13.reshape(-1, scal13.shape[-1])
    if not audio:
        long_ = (col[:, 8] > 0) | (n0 == n1)
        floats = torch.where(long_, M, m)
    else:
        a_lo = torch.where(col[:, 2] > 0, (n1 - n0) // 4, 0)
        a_hi = a_lo + 3 * n1 // 4
        is_l, is_m = col[:, 10] > 0, col[:, 11] > 0
        r_lo = torch.where(is_l, M, torch.where(is_m, (3 * n1 - n0) // 4, m))
        r_hi = r_lo + torch.where(is_l, M, m)
        both = (torch.minimum(a_hi, r_hi) - torch.maximum(a_lo, r_lo)).clamp(
            min=0)
        floats = (a_hi - a_lo) + (r_hi - r_lo) - both
    return int(floats.sum()) * C * 4


def _same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def audio_forms(cs, spectra, bf):
    """The IMDCT audio of channel-major spectra [C, rows, w_eff] in the
    four input forms of K2's audio form: (label, long, short, ct_in), long
    [C, rows, n1] or [rows, C, n1], short likewise with n0 or None
    (pre-selected: short rows hold their n0 samples, then zeros)."""
    long_a, short_a = imdct_batch_parts_ct(spectra, cs.imdct_m0, cs.imdct_m1)
    sel = long_a
    if short_a is not None:
        pad = torch.nn.functional.pad(short_a, (0, cs.n1 - cs.n0))
        sel = torch.where((bf == 1).reshape(1, -1, 1), long_a, pad)

    def rows(a):
        return None if a is None else a.permute(1, 0, 2).contiguous()

    return (("ct", long_a, short_a, True), ("ct selected", sel, None, True),
            ("rows", rows(long_a), rows(short_a), False),
            ("rows selected", rows(sel), None, False))


def check_at(cs, s_, t_, seed, rng, err: dict, what: str,
             edges: bool = False) -> None:
    """Every kernel form against its plain version on the card, bit for
    bit, for frames [s_, t_] with random valid prefixes and a random carry:
    K1 (channel-major, flat, and cd_n where n1 >= 512), K3, K2 (X form,
    split form where n1 >= 512, the four audio forms); K1 flat also
    against K1 channel-major transposed. With ``edges`` K2's table has
    rows with ov_len = 0 (no mix) and rows whose out_len ends inside a
    group of 8 samples."""
    dev = cs.device
    W = cs.n1 // 2
    fr = synthetic_frames(cs, T=t_, S=s_, seed=seed)
    for s in range(s_):
        fr["valid"][s, rng.integers(0, t_ + 1):] = False
    fr = to_dev(fr, dev)
    k1 = floor_kernel_inputs(cs, fr)
    args, ref_args = (cs.f1_xs, cs.f1_step, cs.static_coupling), \
        (cs.f1_step, cs.static_coupling)
    pairs = {
        "floor": (floor_kernel.floor_spectra(*k1, *args),
                  floor_kernel.floor_spectra_ref(*k1, *ref_args)),
        "floor_flat": (floor_kernel.floor_spectra(*k1, *args, ct_out=False),
                       floor_kernel.floor_spectra_ref(*k1, *ref_args,
                                                      ct_out=False)),
    }
    split = cs.n1 >= 512
    if split:
        pairs["floor_cd"] = (
            floor_kernel.floor_spectra(*k1, *args, cd_n=W),
            floor_kernel.floor_spectra_ref(*k1, *ref_args, cd_n=W))
    k3 = k3_operands(cs, fr)
    pairs["synth"] = (synth_kernel.fused_floor_couple(*k3),
                      synth_kernel.fused_floor_couple_ref(*k3))
    want = pairs["floor"][1]
    x_long, x_short = dct4_batch_parts_ct(want, cs.dct4_m0, cs.dct4_m1)
    pwr0 = torch.from_numpy(
        rng.standard_normal((s_, cs.channels, W)).astype("float32")).to(dev)
    plen0 = torch.from_numpy(
        rng.choice([0, cs.n0 // 2, W], s_).astype("int32")).to(dev)
    started0 = torch.from_numpy(rng.integers(0, 2, s_).astype(bool)).to(dev)
    table = table_args(cs, fr, plen0, started0)
    scal13, slopes, _, _ = overlap_table(*table)
    if edges:
        scal13 = scal13.clone()
        scal13[:, ::3, 6] = 0.0
        part = scal13[:, 1::4, 7]
        scal13[:, 1::4, 7] = torch.from_numpy(rng.integers(
            1, 3 * cs.n1 // 4, tuple(part.shape)).astype("float32")).to(dev)
    tail = (scal13, slopes, pwr0, cs.n0, cs.n1)
    ok = overlap_kernel
    k2 = {"overlap": (ok.overlap_i16(x_long, x_short, *tail),
                      ok.overlap_i16_ref(x_long, x_short, *tail))}
    if split:
        u, v = dct4_split_uv_from_cd(pairs["floor_cd"][1], cs.n1)
        k2["overlap_split"] = (ok.overlap_i16_split(u, v, x_short, *tail),
                               ok.overlap_i16_split_ref(u, v, x_short, *tail))
    for label, la, sa, ct_in in audio_forms(cs, want, table[0].reshape(-1)):
        k2[f"overlap_audio {label}"] = (
            ok.overlap_i16_audio(la, sa, *tail, ct_in),
            ok.overlap_i16_audio_ref(la, sa, *tail, ct_in))
    torch.cuda.synchronize()
    if not _same_bits(pairs["floor_flat"][0], pairs["floor"][0].permute(1, 0, 2)):
        raise AssertionError(f"K1 flat != K1 channel-major transposed ({what})")
    line = []
    for name, (got, ref) in pairs.items():
        d = float((got - ref).abs().max())
        if not _same_bits(got, ref):
            raise AssertionError(f"{name} kernel != plain ({what}): max |d| {d}")
        err[name] = max(err[name], d)
        line.append(f"{name} {d}")
    for name, ((o_k, p_k), (o_r, p_r)) in k2.items():
        d2 = max(float((o_k.int() - o_r.int()).abs().max()),
                 float((p_k - p_r).abs().max()))
        if not (torch.equal(o_k, o_r) and _same_bits(p_k, p_r)):
            raise AssertionError(f"{name} kernel != plain ({what}): "
                                 f"max |d| {d2}")
        key = name.split(" ")[0]
        err[key] = max(err[key], d2)
        line.append(f"{name} {d2}")
    print(f"kernel vs plain, {what}: max|d| " + ", ".join(line)
          + " (bit-identical)")


def geometry_setup(n0, n1, C, w_eff, dev):
    """The synthetic setup at blocksizes n0/n1 with C channels, its residue
    end moved so that w_eff comes out as asked."""
    ident, setup = synthetic_headers(C, n0.bit_length() - 1,
                                     n1.bit_length() - 1)
    setup.residues[0].end = C * w_eff
    cs = compile_setup(ident, setup, device=dev)
    if (cs.n0, cs.n1, cs.channels, cs.w_eff) != (n0, n1, C, w_eff):
        raise AssertionError(f"geometry {(n0, n1, C, w_eff)}: setup gives "
                             f"{(cs.n0, cs.n1, cs.channels, cs.w_eff)}")
    return cs


def k1_variant(C, dtype, w, offset, bad_modes, modes, dev):
    """K1's operands for one of K1_VARIANTS: (tele, residue, scal, xs, step,
    steps, cd_n)."""
    ident, setup = synthetic_headers(C)
    setup.modes += [Mode(i % 2, 0) for i in range(modes - 2)]
    cs = compile_setup(ident, setup, device=dev)
    fr = synthetic_frames(cs, T=GEO_T, S=GEO_S, seed=20 + C)
    fr["mode"] = np.random.default_rng(C).integers(
        0, modes, fr["mode"].shape).astype(np.int32)
    fr = to_dev(fr, dev)
    tele, residue, scal = floor_kernel_inputs(cs, fr)
    rows, W, step = tele.shape[0], cs.w_eff, cs.f1_step
    if w is not None:
        residue = residue.reshape(rows, C, W)[:, :, :w].reshape(rows, C * w)
        step, W = step[:, :, :w].contiguous(), w
    residue = residue.to(dtype)
    if offset:  # one element past an aligned allocation
        buf = torch.empty(residue.numel() + 1, dtype=dtype, device=dev)
        residue = buf[1:].view(rows, C * W).copy_(residue)
    if bad_modes:
        M = cs.mode_blockflag.shape[0]
        scal = scal.clone()
        scal[::5, 0] = -1.0
        scal[2::7, 0] = float(M)
        scal[3::11, 0] = float(M + 5)
    return (tele, residue, scal, cs.f1_xs, step, cs.static_coupling,
            cs.n1 // 2)


def check_k1_channels(dev, err: dict) -> None:
    """K1's three forms against their plain versions, bit for bit, at every
    channel count 1..8 (K1_VARIANTS)."""
    for C, dtype, w, offset, bad_modes, modes in K1_VARIANTS:
        tele, res, scal, xs, step, steps, cd_n = k1_variant(
            C, dtype, w, offset, bad_modes, modes, dev)
        ops = (tele, res, scal)
        got = {"floor": floor_kernel.floor_spectra(*ops, xs, step, steps),
               "floor_flat": floor_kernel.floor_spectra(
                   *ops, xs, step, steps, ct_out=False),
               "floor_cd": floor_kernel.floor_spectra(
                   *ops, xs, step, steps, cd_n=cd_n)}
        want = {"floor": floor_kernel.floor_spectra_ref(*ops, step, steps),
                "floor_flat": floor_kernel.floor_spectra_ref(
                    *ops, step, steps, ct_out=False),
                "floor_cd": floor_kernel.floor_spectra_ref(
                    *ops, step, steps, cd_n=cd_n)}
        torch.cuda.synchronize()
        what = (f"C={C} {str(dtype)[6:]} w_eff={step.shape[-1]} residue "
                f"at +{int(offset)} M={modes}"
                f"{', modes out of range' * bad_modes}")
        line = []
        for name, g in got.items():
            d = float((g - want[name]).abs().max())
            if not _same_bits(g, want[name]):
                raise AssertionError(f"{name} kernel != plain ({what}): "
                                     f"max |d| {d}")
            err[name] = max(err[name], d)
            line.append(f"{name} {d}")
        print(f"kernel vs plain, K1 {what}: max|d| " + ", ".join(line)
              + " (bit-identical)")


def check_kernels(cs, dev, rng) -> dict:
    """Every kernel vs its plain version on the card: headline shapes, an
    odd T, T = 1 and K2's edge rows, the crafted geometries, K1 at every
    channel count it instantiates, and K3 at WIDE_C channels."""
    err = dict.fromkeys(("floor", "floor_flat", "floor_cd", "synth", "overlap",
                         "overlap_split", "overlap_audio"), 0.0)
    check_at(cs, S, T, 3, rng, err, f"S={S} T={T}")
    check_at(cs, ODD_S, ODD_T, 5, rng, err, f"S={ODD_S} T={ODD_T}")
    check_at(cs, GEO_S, 1, 6, rng, err, f"S={GEO_S} T=1, K2 edge rows",
             edges=True)
    check_at(cs, GEO_S, GEO_T, 4, rng, err,
             f"S={GEO_S} T={GEO_T}, K2 edge rows", edges=True)
    check_k1_channels(dev, err)
    for i, geo in enumerate(GEOMETRIES):
        check_at(geometry_setup(*geo, dev), GEO_S, GEO_T, 7 + i, rng, err,
                 "(n0, n1, C, w_eff)=" + str(geo))
    # K3's wide form: more channels than K1 (and K3's registers) take
    cs_w = compile_setup(*synthetic_headers(WIDE_C), device=dev)
    k3 = k3_operands(cs_w, to_dev(synthetic_frames(cs_w, T=GEO_T, S=GEO_S,
                                                   seed=13), dev))
    got, ref = (synth_kernel.fused_floor_couple(*k3),
                synth_kernel.fused_floor_couple_ref(*k3))
    torch.cuda.synchronize()
    d = float((got - ref).abs().max())
    if not _same_bits(got, ref):
        raise AssertionError(f"synth kernel != plain (C={WIDE_C}): max |d| {d}")
    err["synth"] = max(err["synth"], d)
    print(f"kernel vs plain, K3 C={WIDE_C} S={GEO_S} T={GEO_T}: max|d| synth "
          f"{d} (bit-identical)")
    return err


#: each kernel form's launch count: (module, attribute)
COUNTERS = {"floor": (floor_kernel, "LAUNCHES"),
            "floor_flat": (floor_kernel, "LAUNCHES_FLAT"),
            "floor_cd": (floor_kernel, "LAUNCHES_CD"),
            "overlap": (overlap_kernel, "LAUNCHES"),
            "overlap_split": (overlap_kernel, "LAUNCHES_SPLIT"),
            "overlap_audio": (overlap_kernel, "LAUNCHES_AUDIO"),
            "synth": (synth_kernel, "LAUNCHES")}


def launches() -> dict:
    return {k: getattr(m, a) for k, (m, a) in COUNTERS.items()}


def no_prep(cs, frs):
    return frs


@contextlib.contextmanager
def split_transform(on: bool = True):
    """``USE_DCT4_SPLIT`` set for the block (for the card's run and the
    CPU anchor alike)."""
    old = imdct.USE_DCT4_SPLIT
    imdct.USE_DCT4_SPLIT = on
    try:
        yield
    finally:
        imdct.USE_DCT4_SPLIT = old


def caller_imdct(spectra, bf, m0, m1):
    """A caller-supplied IMDCT, as the reference's tensor-parallel decode
    passes one: the stock transform through another function, so the
    chunk takes the caller-IMDCT route (generic stages, K2's audio form)."""
    return imdct.imdct_batch(spectra, bf, m0, m1)


def run_path(label, cs, frs, carry0, with_i16, expect: dict, prep=no_prep,
             **kw):
    """Drive one path -- ``prep`` (e.g. ``precompute_brackets``), then
    ``decode_chunks_scan`` (``kw``: e.g. a caller's ``imdct``) -- with
    every launch count set to 0 just before and read just after; the
    counts must equal ``expect`` (kernel -> launches, the others 0)."""
    torch.cuda.synchronize()
    for m, a in COUNTERS.values():
        setattr(m, a, 0)
    (outs, lens), carry = decode_chunks_scan(cs, prep(cs, frs), carry0,
                                             with_i16=with_i16, **kw)
    got = launches()
    torch.cuda.synchronize()
    want = dict.fromkeys(got, 0) | expect
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    n_ = frs["mode"].shape[0]
    outw = 3 * cs.n1 // 4
    shape = ((n_, S, T, cs.channels * outw) if with_i16
             else (n_, S, T, cs.channels, outw))
    if tuple(outs.shape) != shape:
        raise AssertionError(f"{label}: output shape {tuple(outs.shape)}")
    if not bool(torch.isfinite(carry[0]).all()) or (
            not with_i16 and not bool(torch.isfinite(outs).all())):
        raise AssertionError(f"{label}: non-finite output or carry")
    print(f"path {label}: decode_chunks_scan S={S} T={T} N={n_} "
          f"with_i16={with_i16}: launches {got}")
    return outs, lens, got


def spectra_bound(cs, fr) -> float:
    """How far two evaluations of a chunk's GEMM output may differ: the
    fp32 sum-order bound of its spectra (with the split also of the split
    GEMMs' input (c || d), bit-identical on the card and the CPU), plus for
    floor 0 FLOOR0_RTOL of their largest row sum (the curves differ by
    that much)."""
    spectra, _, _ = synthesize_spectra_tapped(cs, fr)
    bound = sum_order_bound(spectra)
    if split_ok(cs):
        cd = torch.cat(split_butterfly(spectra.permute(1, 0, 2), cs.n1), -1)
        bound = max(bound, sum_order_bound(cd))
    if cs.has_floor0:
        bound += FLOOR0_RTOL * float(spectra.abs().to(torch.float64)
                                     .sum(-1).max())
    return bound


def anchor(label, cs, headers, fr_np, outs, out_lens, with_i16,
           max_lsb: int = 1, prep=None, **kw) -> None:
    """The card's first chunks of a few streams against the port's plain
    path on the CPU: i16 within ``max_lsb`` or f32 within 2 x the GEMM
    bound + 2 ulp, out_len exact, the carry within the GEMM bound and
    plen/started exact. ``prep`` adds per-setup entries to the frames;
    ``kw`` goes to both decodes."""
    prep = prep or no_prep
    cs_cpu = compile_setup(*headers, device="cpu")
    sub = {k: torch.from_numpy(np.ascontiguousarray(
        np.broadcast_to(v[:ANCHOR_S], (ANCHOR_N,) + v[:ANCHOR_S].shape)))
        for k, v in fr_np.items()}
    C, W = cs.channels, cs.n1 // 2
    (c_out, c_len), c_carry = decode_chunks_scan(
        cs_cpu, prep(cs_cpu, sub), init_window_carry(C, W, ANCHOR_S, "cpu"),
        with_i16=with_i16, **kw)
    bound = spectra_bound(cs_cpu, {k: v[0] for k, v in sub.items()})
    g_out = outs[:ANCHOR_N, :ANCHOR_S].cpu()
    if with_i16:
        lsb = int((g_out.int() - c_out.int()).abs().max())
        res = f"i16 max {lsb} LSB (bound {max_lsb})"
        ok = lsb <= max_lsb
    else:
        d = (g_out.double() - c_out.double()).abs()
        tol = 2 * bound + 2 * torch.from_numpy(
            np.spacing(c_out.abs().numpy())).double()
        res = f"f32 max |d| {float(d.max()):.3g} (2 x bound {2 * bound:.3g})"
        ok = bool((d <= tol).all())
    if not ok or not torch.equal(out_lens[:ANCHOR_N, :ANCHOR_S].cpu(), c_len):
        raise AssertionError(f"{label}: card vs CPU plain path: {res}, or "
                             f"out_len differs")
    (_, _), g_carry = decode_chunks_scan(
        cs, prep(cs, {k: v.to(cs.device) for k, v in sub.items()}),
        init_window_carry(C, W, ANCHOR_S, cs.device), with_i16=with_i16,
        **kw)
    dpwr = float((g_carry[0].cpu() - c_carry[0]).abs().max())
    if dpwr > bound or not all(torch.equal(g.cpu(), c)
                               for g, c in zip(g_carry[1:], c_carry[1:])):
        raise AssertionError(f"{label} carry: pwr |d| {dpwr} > bound {bound} "
                             f"or plen/started differ")
    print(f"anchor {label} vs CPU plain path ({ANCHOR_S} streams x "
          f"{ANCHOR_N} chunks): {res}, out_len exact, carry |d| {dpwr:.3g} "
          f"<= fp32 sum-order bound {bound:.3g}")


def path_rate(cs, frs, carry0, with_i16, plain: bool, reps: int,
              prep=no_prep, **kw):
    """(x_realtime, packets/s, ms per chunk) of ``prep`` then
    decode_chunks_scan (frames in, PCM out), median of ``reps`` timed
    calls after one warm-up call."""
    (_, lens), _ = decode_chunks_scan(cs, prep(cs, frs), carry0,
                                      with_i16=with_i16, plain=plain, **kw)
    torch.cuda.synchronize()
    samples = int(lens.sum())  # per-channel samples of the call
    n_, s_, t_ = frs["mode"].shape
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        decode_chunks_scan(cs, prep(cs, frs), carry0, with_i16=with_i16,
                           plain=plain, **kw)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    dt = statistics.median(dts)
    return samples / cs.sample_rate / dt, s_ * t_ * n_ / dt, dt / n_ * 1e3


def host_enqueue_ms(cs, fr1, carry0, reps: int = 5) -> float:
    """Median host milliseconds to enqueue one i16 main-path chunk (frames
    [1, S, T, ...]): the call returns before the device finishes, and the
    stream is idle before each call, so the launch queue never fills and
    the time is the host's alone. Where it nears the device time per
    chunk, the host sets the chunk's wall time."""
    dts = []
    for _ in range(reps + 1):  # the first call warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_chunks_scan(cs, fr1, carry0, with_i16=True)
        dts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(dts[1:]) * 1e3


RANGE = "chip_smoke_range"  # the profiled calls' record_function name


def device_profile(fn, reps: int = 1):
    """torch.profiler over ``reps`` calls of fn (after one call that warms
    the profiler up and is not recorded). Returns the host range of the
    calls (start, end in us) and the device activities in it (start, end,
    name): kernels, copies and fills, not annotations."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    cycles = []  # the recorded cycle's events (a cycle's end clears them)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(p.events())) as prof:
        for _ in range(2):
            with record_function(RANGE):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            prof.step()
    events = cycles[-1]
    call = next(e for e in events if e.name == RANGE
                and e.device_type == torch.autograd.DeviceType.CPU)
    t0, t1 = call.time_range.start, call.time_range.end
    dev = sorted(
        (max(e.time_range.start, t0), min(e.time_range.end, t1), e.name)
        for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.name != RANGE and not e.is_user_annotation
        and not e.name.startswith("ProfilerStep"))
    return (t0, t1), dev


def stage_device_ms(fn, reps: int = 5) -> float | None:
    """Device-busy milliseconds per call of fn (profiler), None when the
    profiler recorded no device activity."""
    _, dev = device_profile(fn, reps)
    return sum(b - a for a, b, _ in dev) / reps / 1e3 if dev else None


def profile_path(label, cs, frs, carry0, with_i16, top: int = 8,
                 prep=no_prep, **kw) -> None:
    """One call of a path under the profiler: the device's busy share of
    the call's wall time (union of device activity intervals) and device
    ms per chunk of the largest ops."""
    n_ = frs["mode"].shape[0]
    (t0, t1), dev = device_profile(
        lambda: decode_chunks_scan(cs, prep(cs, frs), carry0,
                                   with_i16=with_i16, **kw))
    if not dev:
        print(f"profile {label}: the profiler recorded no device activity "
              "(busy share not measured)")
        return
    busy, end = 0.0, t0
    per_op: dict[str, float] = {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        per_op[name] = per_op.get(name, 0.0) + max(0.0, b - a)
    wall = t1 - t0
    print(f"profile {label}: one {n_}-chunk call {wall / 1e3:.3f} ms wall, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%, {len(dev)} device activities")
    for name, us in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]:
        print(f"profile {label}: {us / 1e3 / n_:.4f} ms/chunk  {name[:110]}")


GATE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "data", "torch_gate")
GATE_LSB = 2  # the conformance contract: within +/-2 i16 LSB of libvorbis
#: the reference's production permutations (bench.py's conformance check):
#: (label, scan, transport, compact), each on 2 copies of PERM_STREAMS
PERMUTATIONS = (("scan8_p12_device", 8, "p12", "device"),
                ("scan16_p12_device", 16, "p12", "device"),
                ("scan16_i16_host", 16, "i16", "host"))
PERM_STREAMS = ("stereo_44k_q3", "ch6_44k_q3", "f1_bs8192",
                "f0_coupled_stereo")
E2E_STREAM, E2E_S, E2E_SCAN = "stereo_44k_q3", 32, 8
E2E_REPS = 3  # native-front-end calls of each kind at E2E_S
#: the reference's bench.py --e2e shape: streams, and copies of the 3 s
#: stream's audio packets in each (about 30 s)
BENCH_S, BENCH_TILE = 256, 10
FRAME_EMITS = ("f32", "i16", "p12")
#: first-link audio packets whose residue the native library decodes
#: differently from the Python front-end: their bits run out in the
#: residue section, where the library adds a vector the Python front-end
#: does not (tests/test_torch_native.py holds the same set on the CPU)
FRAMES_RESIDUE_DIVERGES = {"f1_two_submaps": {16, 20, 28, 32}}
#: K1/K2 forms the gate must launch: the i16 path (read_all_i16, host
#: compaction), the f32 path (device compaction) and the split pass
GATE_KERNELS = ("floor", "floor_flat", "overlap", "floor_cd",
                "overlap_split")


def gate_streams() -> dict:
    """name -> (ogg bytes, golden i16 [samples, C], kind) of the committed
    gate streams, each file held to its sha256 in the manifest."""
    with open(os.path.join(GATE_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, e in manifest["streams"].items():
        blobs = []
        for key in ("ogg", "golden"):
            with open(os.path.join(GATE_DIR, e[key]), "rb") as f:
                blob = f.read()
            if hashlib.sha256(blob).hexdigest() != e[key + "_sha256"]:
                raise AssertionError(f"gate {name}: {e[key]} sha256 differs "
                                     "from the manifest")
            blobs.append(blob)
        with np.load(os.path.join(GATE_DIR, e["golden"])) as z:
            golden = z["pcm"]
        out[name] = (blobs[0], golden, e["kind"])
    return out


def lsb_diff(out: np.ndarray, golden: np.ndarray) -> tuple[int, int, int]:
    """(max |out - golden| in i16 LSB, samples over GATE_LSB, samples that
    differ at all)."""
    if not golden.size:
        return 0, 0, 0
    d = np.abs(out.astype(np.int32) - golden.astype(np.int32))
    return int(d.max()), int((d > GATE_LSB).sum()), int((d > 0).sum())


def gate_pass(streams: dict, dev, label: str) -> dict:
    """Every gate stream through OggStreamReader.read_all_i16() on ``dev``:
    exact length, per-stream max diff and samples over the contract."""
    res = {}
    for name, (data, golden, kind) in streams.items():
        out = OggStreamReader(data, device=dev).read_all_i16()
        if out.shape != golden.shape:
            raise AssertionError(f"gate {label} {name}: shape {out.shape}, "
                                 f"golden {golden.shape}")
        res[name] = lsb_diff(out, golden)
        print(f"gate {label} {name} ({kind}): {out.shape[0]} samples x "
              f"{out.shape[1]} ch, maxdiff {res[name][0]} LSB, "
              f"{res[name][1]} over +/-{GATE_LSB}, {res[name][2]} differ")
    return res


def stream_packets(data: bytes):
    """(headers, audio packets) of a single-link stream; the headers carry
    the raw header packets (``raw_ident``, ``raw_setup``)."""
    rdr = PacketReader(data)
    headers, serial = read_headers(rdr)
    pcks = []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial == serial:
            pcks.append(p.data)
    return headers, pcks


def stream_links(data: bytes) -> list:
    """[(ident, setup, raw header packets, audio packets)] of each chain
    link, as OggStreamReader splits a stream into links."""
    rdr = OggStreamReader(data, device="cpu")
    links = []
    while (p := rdr.read_next_audio_packet()) is not None:
        if not links or rdr._fresh_link:
            rdr._fresh_link = False
            links.append((rdr.ident_hdr, rdr.setup_hdr, rdr._raw_headers, []))
        links[-1][3].append(p.data)
    return links


def frames_diff(fr: dict, want: dict, label: str) -> set:
    """Native frames against the Python front-end's: bit for bit, f0_cosc
    within 1 f32 ulp; returns the packet rows whose residue differs (held
    to FRAMES_RESIDUE_DIVERGES by the caller), raises on anything else."""
    rows = set()
    for k, a in fr.items():
        b = want[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"frames {label} {k}: {a.dtype}{a.shape} "
                                 f"against {b.dtype}{b.shape}")
        if a.tobytes() == b.tobytes():
            continue
        if k == "f0_cosc" and (np.abs(a - b) <= np.spacing(np.abs(b))).all():
            continue
        if k != "residue":
            raise AssertionError(f"frames {label}: {k} differs")
        rows |= {int(t) for t in np.flatnonzero((a != b).any(axis=-1))}
    return rows


def frames_phase(streams: dict, dev, card: str) -> dict:
    """Every audio packet of every gate stream (each chain link) through
    StreamDecoder(frontend="native") and (frontend="python") in chunks of
    64: the status codes and frames the same, in every residue emit the
    setup allows (f32; i16 where the static bound allows it; p12 where
    pack12_supported), with the known exceptions of
    FRAMES_RESIDUE_DIVERGES. Raises on a mismatch; prints the packet count
    and both front-ends' packets/s (one-stream entry, the setup's default
    emit)."""
    n_pck = n_links = 0
    secs = {"native": 0.0, "python": 0.0}
    emits_run = dict.fromkeys(FRAME_EMITS, 0)
    for name, (data, _, _) in streams.items():
        for li, (ident, setup, raw, pcks) in enumerate(stream_links(data)):
            dec = {fe: StreamDecoder(ident, setup, chunk=64, raw_headers=raw,
                                     frontend=fe, device=dev)
                   for fe in secs}
            ns = dec["native"]._native
            default = ns.residue_dtype
            emits = {"f32": np.float32}
            if dec["native"].cs.residue_i16:
                emits["i16"] = np.int16
            if pack12_supported(dec["native"].cs):
                emits["p12"] = np.uint32
            diverged = set()
            for i in range(0, len(pcks), 64):
                chunk = pcks[i: i + 64]
                t0 = time.perf_counter()
                py_fr, py_st = dec["python"].entropy_chunk_status(chunk)
                secs["python"] += time.perf_counter() - t0
                for emit, dt in emits.items():
                    ns.residue_dtype = dt
                    t0 = time.perf_counter()
                    fr, st = dec["native"].entropy_chunk_status(chunk)
                    if np.dtype(dt) == default:
                        secs["native"] += time.perf_counter() - t0
                    label = f"{name} link {li} {emit} chunk {i // 64}"
                    if st.tobytes() != py_st.tobytes():
                        raise AssertionError(f"frames {label}: status "
                                             f"{st} against {py_st}")
                    res = py_fr["residue"]
                    want = dict(py_fr, residue=pack12_np(res)
                                if dt == np.uint32 else res.astype(dt))
                    diverged |= {i + t for t in frames_diff(fr, want, label)}
                    emits_run[emit] += len(chunk)
            expect = FRAMES_RESIDUE_DIVERGES.get(name, set()) if li == 0 \
                else set()
            if diverged != expect:
                raise AssertionError(f"frames {name} link {li}: residue "
                                     f"differs at packets {sorted(diverged)},"
                                     f" expected {sorted(expect)}")
            n_pck += len(pcks)
            n_links += 1
    rates = {fe: n_pck / t for fe, t in secs.items()}
    print(f"frames: {n_pck} audio packets of {len(streams)} gate streams "
          f"({n_links} links), native = python in "
          + ", ".join(f"{e} ({n} packets)" for e, n in emits_run.items())
          + " (f0_cosc within 1 f32 ulp; residue of "
          + ", ".join(f"{k} packets {sorted(v)}"
                      for k, v in FRAMES_RESIDUE_DIVERGES.items())
          + " as known); one-stream entry, default emit: native "
          f"{rates['native']:.1f} packets/s, python {rates['python']:.1f} "
          f"packets/s | card: {card}")
    return rates


def gate_permutations(streams: dict, dev) -> dict:
    """The production permutations of decode_streams_i16 on 2 copies of
    each PERM_STREAMS stream, on the native front-end. The batch decode
    applies no granule truncation, so its output holds the golden as a
    prefix and at most one long block more."""
    res = {}
    for label, scan, transport, compact in PERMUTATIONS:
        for name in PERM_STREAMS:
            data, golden, _ = streams[name]
            headers, pcks = stream_packets(data)
            dec = BatchDecoder(headers.ident, headers.setup, chunk=64,
                               scan=scan, device=dev,
                               raw_headers=(headers.raw_ident,
                                            headers.raw_setup))
            if dec._sd._native is None:
                raise AssertionError("the batch decoder is not on the "
                                     "native front-end")
            outs = dec.decode_streams_i16([pcks, pcks], compact=compact,
                                          transport=transport)
            if name == "stereo_44k_q3" and transport == "p12" and not (
                    pack12_supported(dec.cs)
                    and dec.last_stats["transport"] == "p12"
                    and dec._sd._native.residue_dtype == np.uint32):
                raise AssertionError("the flagship did not take p12 from "
                                     "the native emit")
            if not np.array_equal(outs[0], outs[1]):
                raise AssertionError(f"perm {label} {name}: the two copies "
                                     "differ")
            extra = outs[0].shape[0] - golden.shape[0]
            if not 0 <= extra <= dec.cs.n1:
                raise AssertionError(f"perm {label} {name}: {outs[0].shape} "
                                     f"against golden {golden.shape}")
            r = lsb_diff(outs[0][: golden.shape[0]], golden)
            res[f"{label}/{name}"] = r
            print(f"perm {label} {name}: transport "
                  f"{dec.last_stats['transport']}, residue emit "
                  f"{np.dtype(dec._sd._native.residue_dtype).name}, maxdiff "
                  f"{r[0]} LSB, {r[1]} over +/-{GATE_LSB}, {r[2]} differ")
    return res


STAGES = ("frontend", "h2d", "device", "d2h", "compact", "other")


def e2e_call(dec, streams: list, sync: bool):
    """One decode_streams_i16 call (compact host), pipelined or with every
    device stage closed by a synchronize: (outputs, last_stats)."""
    dec.stage_sync = sync
    outs = dec.decode_streams_i16(streams, compact="host")
    return outs, dict(dec.last_stats)


def e2e_print(label: str, dec, n_pck: int, audio_s: float, piped: list,
              synced: list, card: str) -> None:
    """One e2e line: the median pipelined and synchronized walls, and the
    stage split of the synchronized call whose wall is the median (its
    stages sum to its wall)."""
    walls = {k: [st["stages"]["wall"] for st in v]
             for k, v in (("pipelined", piped), ("synchronized", synced))}
    med = {k: statistics.median(v) for k, v in walls.items()}
    st = min(synced, key=lambda x: abs(x["stages"]["wall"]
                                       - med["synchronized"]))
    sg = st["stages"]
    print(f"e2e file->PCM {label}: {n_pck} packets, chunk {dec.chunk}, scan "
          f"{dec.scan}, compact host, transport {st['transport']} at a "
          f"probed {probed_h2d_mb_s(dec.device):.0f} MB/s H2D; pipelined "
          f"wall median {med['pipelined']:.4f} s of "
          f"{['%.4f' % w for w in walls['pipelined']]} "
          f"({audio_s / med['pipelined']:.1f} x_realtime); synchronized "
          f"median {med['synchronized']:.4f} s of "
          f"{['%.4f' % w for w in walls['synchronized']]} "
          f"({audio_s / med['synchronized']:.1f} x_realtime), its stage "
          "split (s): " + ", ".join(f"{k} {sg[k]:.4f}" for k in STAGES)
          + f", sum {sum(sg[k] for k in STAGES):.4f} = wall {sg['wall']:.4f}"
          f"; front-end {n_pck / sg['frontend']:.0f} packets/s; H2D "
          f"{st['h2d_bytes']} B, D2H {st['d2h_bytes']} B | card: {card}")


def e2e_lines(streams: dict, dev, card: str) -> dict:
    """File to PCM through BatchDecoder.decode_streams_i16 (compact host,
    entropy decode included): E2E_S copies of one stream on the Python
    front-end (one pipelined and one synchronized call), the same on the
    native front-end (warmed once, then E2E_REPS pipelined and E2E_REPS
    synchronized calls in turn), and the reference's bench.py --e2e shape:
    BENCH_S streams of the stream's audio packet spans tiled BENCH_TILE
    times (native demux_spans, PacketSpans), warmed once, then one
    pipelined and one synchronized call. Returns the medians."""
    data, golden, _ = streams[E2E_STREAM]
    headers, pcks = stream_packets(data)
    raw = (headers.raw_ident, headers.raw_setup)
    rate = headers.ident.sample_rate
    n1 = headers.ident.bs1

    def check(outs, copies: int) -> float:
        """All outputs alike, the first copy of the audio within the
        contract (the samples before the last block of the copy; the next
        copy's first packet overlaps that one); returns the audio seconds."""
        cut = golden.shape[0] - n1
        for o in (outs[0], outs[-1]):
            if o.shape[0] < copies * cut or lsb_diff(o[:cut], golden[:cut])[1]:
                raise AssertionError("e2e: output over the contract")
        if not np.array_equal(outs[0], outs[-1]):
            raise AssertionError("e2e: copies of one stream differ")
        return sum(o.shape[0] for o in outs) / rate

    res = {}
    for frontend, reps in (("python", 1), ("native", E2E_REPS)):
        dec = BatchDecoder(headers.ident, headers.setup, chunk=64,
                           scan=E2E_SCAN, raw_headers=raw, frontend=frontend,
                           device=dev)
        batch = [pcks] * E2E_S
        if frontend == "native":
            e2e_call(dec, batch, False)  # warm: buffers, link probe
        runs = {False: [], True: []}
        for _ in range(reps):
            for sync in (False, True):
                outs, st = e2e_call(dec, batch, sync)
                runs[sync].append(st)
        audio_s = check(outs, 1)
        e2e_print(f"{frontend} front-end ({E2E_STREAM} x {E2E_S} streams, "
                  f"{'warm, ' if frontend == 'native' else ''}{reps} "
                  "pipelined and synchronized calls in turn)", dec,
                  E2E_S * len(pcks), audio_s, runs[False], runs[True], card)
        res[frontend] = {k: statistics.median(st["stages"]["wall"]
                                              for st in v)
                         for k, v in (("pipelined", runs[False]),
                                      ("synchronized", runs[True]))}
    spans = native.demux_spans(data)[0]
    first = len(spans) - len(pcks)
    tiled = native.PacketSpans(spans.data,
                               np.tile(spans.offs[first:], BENCH_TILE),
                               np.tile(spans.lens[first:], BENCH_TILE))
    dec = BatchDecoder(headers.ident, headers.setup, chunk=64, scan=E2E_SCAN,
                       raw_headers=raw, device=dev)
    batch = [tiled] * BENCH_S
    e2e_call(dec, batch, False)  # warm
    piped = e2e_call(dec, batch, False)[1]
    outs, synced = e2e_call(dec, batch, True)
    audio_s = check(outs, BENCH_TILE)
    runs = {False: [piped], True: [synced]}
    e2e_print(f"bench.py --e2e shape (native front-end, {E2E_STREAM} audio "
              f"spans tiled {BENCH_TILE}x = {outs[0].shape[0] / rate:.1f} s "
              f"x {BENCH_S} streams, warm, one pipelined and one "
              "synchronized call)", dec, BENCH_S * len(tiled), audio_s,
              runs[False], runs[True], card)
    res["bench"] = {"pipelined": runs[False][0]["stages"]["wall"],
                    "synchronized": runs[True][0]["stages"]["wall"]}
    return res


def conformance(dev, card: str) -> dict:
    """The conformance phase: the frames phase, then the gate on every
    committed stream, the production permutations and the split pass (all
    on the native front-end, the default with raw headers), then the e2e
    lines. K1/K2 launch counts are set to 0 before the gate and must be
    nonzero after. Raises if any stream of the gate or the permutations is
    over the contract; the split pass (opt-in, not the default) is
    recorded."""
    streams = gate_streams()
    frames_phase(streams, dev, card)
    torch.cuda.synchronize()
    for m, a in COUNTERS.values():
        setattr(m, a, 0)
    t0 = time.perf_counter()
    direct = gate_pass(streams, dev, "read_all_i16")
    perms = gate_permutations(streams, dev)
    with split_transform():
        split = gate_pass(streams, dev, "read_all_i16 split")
    got = launches()
    if not all(got[k] for k in GATE_KERNELS):
        raise AssertionError(f"conformance: launches {got}, expected "
                             f"nonzero {GATE_KERNELS}")
    summary = {}
    for label, res in (("read_all_i16", direct), ("permutations", perms),
                       ("split", split)):
        summary[label] = {
            "streams": len(res),
            "maxdiff": max(r[0] for r in res.values()),
            "samples_over_2lsb": sum(r[1] for r in res.values()),
            "samples_differ": sum(r[2] for r in res.values())}
    print(f"conformance on the native front-end "
          f"({time.perf_counter() - t0:.1f} s, launches {got}): "
          f"{json.dumps(summary)} | card: {card}")
    bad = {k: v for k, v in summary.items()
           if k != "split" and v["samples_over_2lsb"]}
    if bad:
        raise AssertionError(f"conformance: samples over +/-{GATE_LSB} LSB "
                             f"in {bad}")
    e2e_lines(streams, dev, card)
    return summary


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- 1. build: the kernels (nvcc) and the host front-end (c++) ----
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(_build.load_host_library)
        _build.load_library()
        host.result()
    if _build.build_info is not None:
        secs, log = _build.build_info
        print(f"build: nvcc {secs:.1f} s -> {_build.library_path()}")
        print(log.strip())
    else:
        print(f"build: library already present ({time.perf_counter() - t0:.2f} s)")
    print("build: host front-end " + (
        f"{_build.host_build_seconds:.1f} s" if _build.host_build_seconds
        is not None else "already present") + f" -> {_build._host_lib._name}")

    headers = synthetic_headers(channels=2, bs0_exp=8, bs1_exp=11)
    cs = compile_setup(*headers, device=dev)
    print(f"setup: C={cs.channels} n0={cs.n0} n1={cs.n1} w_eff={cs.w_eff} "
          f"P={cs.max_posts} M={cs.mode_blockflag.shape[0]} "
          f"coupling={cs.static_coupling} residue_i16={cs.residue_i16}")
    print(kernel_registers(cs) + f" | card: {card}")

    # ---- 2. kernel vs plain on the card (bit-identical) ----
    err = check_kernels(cs, dev, np.random.default_rng(0))

    # ---- 3. the main path through K1 and K2 ----
    fr_np = synthetic_frames(cs, T=T, S=S, seed=3)
    fr0 = to_dev(fr_np, dev)
    frs = expand(fr0, N)
    carry0 = init_window_carry(cs.channels, cs.n1 // 2, S, dev)
    outs, out_lens, main_launches = run_path(
        "i16 main", cs, frs, carry0, True, {"floor": N, "overlap": N})
    anchor("i16 main", cs, headers, fr_np, outs, out_lens, True)
    del outs

    # ---- 4. the further paths ----
    new_launches = {}
    new_paths = {}  # label -> (cs, frames, with_i16) for the rate lines
    frs_new = expand(fr0, N_NEW)
    outs, lens, got = run_path("f32", cs, frs_new, carry0, False,
                               {"floor_flat": N_NEW})
    anchor("f32", cs, headers, fr_np, outs, lens, False)
    new_launches["floor_flat"] = got["floor_flat"]
    new_paths["f32"] = (cs, frs_new, False)
    del outs
    for label, kw, make, bound in (
            ("per-mode coupling i16", {"per_mode_coupling": True},
             synthetic_frames, MAX_LSB["floor1"]),
            ("floor-0 i16", {"floor0": True}, synthetic_floor0_frames,
             MAX_LSB["floor0"])):
        hdr = synthetic_headers(**kw)
        cs_g = compile_setup(*hdr, device=dev)
        g_np = make(cs_g, T=T, S=S, seed=3)
        g0 = to_dev(g_np, dev)
        spectra, _, _ = synthesize_spectra_tapped(cs_g, g0)
        if not bool(torch.isfinite(spectra).all()):
            raise AssertionError(f"{label}: non-finite spectra")
        del spectra
        g_frs = expand(g0, N_NEW)
        outs, lens, _ = run_path(label, cs_g, g_frs, carry0, True,
                                 {"overlap": N_NEW})
        anchor(label, cs_g, hdr, g_np, outs, lens, True, max_lsb=bound)
        new_paths[label] = (cs_g, g_frs, True)
        del outs
    decoder.USE_FUSED_SYNTH_KERNEL = True
    try:
        # precompute_brackets runs inside every drive and timed call, so
        # the path's rate is frames in, PCM out
        outs, lens, got = run_path("K3 i16", cs, frs_new, carry0, True,
                                   {"synth": N_NEW, "overlap": N_NEW},
                                   prep=precompute_brackets)
        anchor("K3 i16", cs, headers, fr_np, outs, lens, True,
               prep=precompute_brackets)
        new_launches["synth"] = got["synth"]
        del outs
        k3_rate = (path_rate(cs, frs_new, carry0, True, False, 3,
                             precompute_brackets),
                   path_rate(cs, frs_new, carry0, True, True, 2,
                             precompute_brackets))
        profile_path("K3 i16", cs, frs_new, carry0, True, top=5,
                     prep=precompute_brackets)
        # more channels than K1 takes: K3's wide form, brackets contracted
        # inside the chunk (the reference's fused branch)
        hdr = synthetic_headers(channels=WIDE_C)
        cs_w = compile_setup(*hdr, device=dev)
        w_np = synthetic_frames(cs_w, T=T, S=S, seed=3)
        outs, lens, got = run_path(
            f"K3 {WIDE_C}ch i16", cs_w, expand(to_dev(w_np, dev), N_WIDE),
            init_window_carry(WIDE_C, cs_w.n1 // 2, S, dev), True,
            {"synth": N_WIDE, "overlap": N_WIDE})
        anchor(f"K3 {WIDE_C}ch i16", cs_w, hdr, w_np, outs, lens, True)
        del outs, cs_w
    finally:
        decoder.USE_FUSED_SYNTH_KERNEL = False
    torch.cuda.empty_cache()

    # ---- 4b. the Wang-split paths and a caller-supplied IMDCT ----
    late_rates = {}  # label -> (kernels, plain) path rates
    with split_transform():
        if not split_ok(cs):
            raise AssertionError("the flagship setup fails the split's "
                                 "conditions")
        outs, lens, got = run_path("i16 split", cs, frs_new, carry0, True,
                                   {"floor_cd": N_NEW,
                                    "overlap_split": N_NEW})
        anchor("i16 split", cs, headers, fr_np, outs, lens, True)
        new_launches |= {k: got[k] for k in ("floor_cd", "overlap_split")}
        del outs
        hdr = synthetic_headers(per_mode_coupling=True)
        cs_g = compile_setup(*hdr, device=dev)
        g_np = synthetic_frames(cs_g, T=T, S=S, seed=3)
        g_frs = expand(to_dev(g_np, dev), N_NEW)
        outs, lens, _ = run_path("i16 split, generic", cs_g, g_frs, carry0,
                                 True, {"overlap_split": N_NEW})
        anchor("i16 split, generic", cs_g, hdr, g_np, outs, lens, True)
        del outs
        for label, cs_p, frs_p in (("i16 split", cs, frs_new),
                                   ("i16 split, generic", cs_g, g_frs)):
            late_rates[label] = (
                path_rate(cs_p, frs_p, carry0, True, False, 3),
                path_rate(cs_p, frs_p, carry0, True, True, 2))
            profile_path(label, cs_p, frs_p, carry0, True)
    own = {"imdct": caller_imdct}
    outs, lens, got = run_path("i16 caller IMDCT", cs, frs_new, carry0, True,
                               {"overlap_audio": N_NEW}, **own)
    anchor("i16 caller IMDCT", cs, headers, fr_np, outs, lens, True, **own)
    new_launches["overlap_audio"] = got["overlap_audio"]
    del outs
    late_rates["i16 caller IMDCT"] = (
        path_rate(cs, frs_new, carry0, True, False, 3, **own),
        path_rate(cs, frs_new, carry0, True, True, 2, **own))
    profile_path("i16 caller IMDCT", cs, frs_new, carry0, True, **own)
    torch.cuda.empty_cache()

    # ---- 5. timing: kernels, stages, paths ----
    k1, spectra, table, k2 = stage_operands(cs, fr0)
    k3 = k3_operands(cs, fr0)
    xs_args = (cs.f1_xs, cs.f1_step, cs.static_coupling)
    ref_args = (cs.f1_step, cs.static_coupling)
    times = {
        "floor": cuda_ms(lambda: floor_kernel.floor_spectra(*k1, *xs_args), 20),
        "floor_plain": cuda_ms(
            lambda: floor_kernel.floor_spectra_ref(*k1, *ref_args), 5),
        "floor_flat": cuda_ms(lambda: floor_kernel.floor_spectra(
            *k1, *xs_args, ct_out=False), 20),
        "floor_flat_plain": cuda_ms(lambda: floor_kernel.floor_spectra_ref(
            *k1, *ref_args, ct_out=False), 5),
        "synth": cuda_ms(lambda: synth_kernel.fused_floor_couple(*k3), 20),
        "synth_plain": cuda_ms(
            lambda: synth_kernel.fused_floor_couple_ref(*k3), 5),
        "overlap": cuda_ms(lambda: overlap_kernel.overlap_i16(*k2), 20),
        "overlap_plain": cuda_ms(lambda: overlap_kernel.overlap_i16_ref(*k2), 5),
    }
    # the new forms on their paths' operands: K1 cd_n, K2 on the split
    # GEMMs' (U, V), K2 on a caller's (pre-selected [rows, C, n1]) audio
    cd_n = cs.n1 // 2
    cd = floor_kernel.floor_spectra(*k1, *xs_args, cd_n=cd_n)
    k2_split = (*dct4_split_uv_from_cd(cd, cs.n1), *k2[1:])
    bf = table[0].reshape(-1)
    k2_audio = (caller_imdct(spectra.permute(1, 0, 2), bf, cs.imdct_m0,
                             cs.imdct_m1), None, *k2[2:], False)
    times |= {
        "floor_cd": cuda_ms(lambda: floor_kernel.floor_spectra(
            *k1, *xs_args, cd_n=cd_n), 20),
        "floor_cd_plain": cuda_ms(lambda: floor_kernel.floor_spectra_ref(
            *k1, *ref_args, cd_n=cd_n), 5),
        "overlap_split": cuda_ms(
            lambda: overlap_kernel.overlap_i16_split(*k2_split), 20),
        "overlap_split_plain": cuda_ms(
            lambda: overlap_kernel.overlap_i16_split_ref(*k2_split), 5),
        "overlap_audio": cuda_ms(
            lambda: overlap_kernel.overlap_i16_audio(*k2_audio), 20),
        "overlap_audio_plain": cuda_ms(
            lambda: overlap_kernel.overlap_i16_audio_ref(*k2_audio), 5),
    }
    # each kernel's bound from this run's operands: (ops, inputs, outputs)
    o_i16, o_pwr = overlap_kernel.overlap_i16(*k2)
    spec_flat = floor_kernel.floor_spectra(*k1, *xs_args, ct_out=False)
    work = {
        "floor": (spectra, k1 + (cs.f1_xs,), (spectra,)),
        "floor_flat": (spec_flat, k1 + (cs.f1_xs,), (spec_flat,)),
        "floor_cd": (cd, k1 + (cs.f1_xs,), (cd,)),
        "synth": (spectra, k3[:3], (spectra,)),
        "overlap": (o_i16, (*k2[2:5], k2_row_bytes(cs, k2[2], False)),
                    (o_i16, o_pwr)),
        "overlap_split": (o_i16, (*k2[2:5], k2_row_bytes(cs, k2[2], False)),
                          (o_i16, o_pwr)),
        "overlap_audio": (o_i16, (*k2[2:5], k2_row_bytes(cs, k2[2], True)),
                          (o_i16, o_pwr)),
    }
    bounds = {k: bound_of(OPS[k] * e.numel(), ins, outs)
              for k, (e, ins, outs) in work.items()}
    del k3, work, spec_flat
    print("bounds (ms at {:.2e} B/s, {:.2e} FLOP/s FP32): ".format(
        HBM_BYTES_PER_S, FP32_FLOP_PER_S) + ", ".join(
        f"{k} {b:.4f} ({by})" for k, (b, by) in bounds.items())
        + f" | card: {card}")
    stages = {
        "floor_prep": lambda: floor_kernel_inputs(cs, fr0),
        "floor_kernel": lambda: floor_kernel.floor_spectra(*k1, *xs_args),
        "dct4_gemm": lambda: dct4_batch_parts_ct(spectra, cs.dct4_m0,
                                                 cs.dct4_m1),
        "overlap_table": lambda: overlap_table(*table),
        "overlap_kernel": lambda: overlap_kernel.overlap_i16(*k2),
    }
    head_k = cs.dct4_m0.shape[0]
    split_stages = {
        "floor_kernel_cd": lambda: floor_kernel.floor_spectra(
            *k1, *xs_args, cd_n=cd_n),
        "split_gemms": lambda: dct4_split_uv_from_cd(cd, cs.n1),
        "short_gemm": lambda: torch.matmul(
            split_cd_head(cd, cs.n1, head_k), cs.dct4_m0),
        "overlap_kernel_split": lambda: overlap_kernel.overlap_i16_split(
            *k2_split),
    }
    stages = {k: stage_device_ms(fn) for k, fn in stages.items()}
    split_stages = {k: stage_device_ms(fn) for k, fn in split_stages.items()}
    fast = path_rate(cs, frs, carry0, True, False, 5)
    host = host_enqueue_ms(cs, expand(fr0, 1), carry0)
    plain = path_rate(cs, frs, carry0, True, True, 3)
    print("timing (ms per call, headline shapes): " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()) + f" | card: {card}")
    for label, st in (("stages", stages), ("split stages", split_stages)):
        if None in st.values():
            print(f"{label}: the profiler recorded no device activity (not "
                  "measured)")
        else:
            print(f"{label} (device ms per chunk, torch.profiler): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in st.items())
                  + f", sum {sum(st.values()):.4f} | card: {card}")
    print(f"main path chunk: {fast[2]:.4f} ms, host enqueue of one chunk "
          f"{host:.4f} ms (median of 5, stream idle before each) | card: "
          f"{card}")

    def rate_line(label, kern, pl, n_):
        print(f"{label}: kernels {kern[0]:.1f} x_realtime ({kern[1]:.1f} "
              f"packets/s, {kern[2]:.3f} ms/chunk), plain {pl[0]:.1f} "
              f"x_realtime ({pl[1]:.1f} packets/s, {pl[2]:.3f} ms/chunk), "
              f"S={S} T={T} N={n_} | card: {card}")

    rate_line("slice aggregate_realtime_synthesis_44k1_stereo", fast, plain, N)
    for label, (cs_p, frs_p, with_i16) in new_paths.items():
        rate_line(f"path {label}", path_rate(cs_p, frs_p, carry0, with_i16,
                                             False, 3),
                  path_rate(cs_p, frs_p, carry0, with_i16, True, 2), N_NEW)
    rate_line("path K3 i16 (precompute_brackets timed in)", *k3_rate, N_NEW)
    for label, rates in late_rates.items():
        rate_line(f"path {label}", *rates, N_NEW)

    # ---- 6. profile of one call of each path ----
    profile_path("i16 main", cs, frs, carry0, True)
    for label, (cs_p, frs_p, with_i16) in new_paths.items():
        profile_path(label, cs_p, frs_p, carry0, with_i16, top=5)

    # ---- 7. the conformance gate on the committed streams ----
    conformance(dev, card)

    kernels = []
    for key, kname, src, replaces, n_launch in (
            ("floor", "floor_spectra", "floor_kernel.cu", "floor_kernel.py:88",
             main_launches["floor"]),
            ("overlap", "overlap_i16", "overlap_kernel.cu",
             "overlap_kernel.py:323", main_launches["overlap"]),
            ("floor_flat", "floor_spectra_flat", "floor_kernel.cu",
             "floor_kernel.py:194", new_launches["floor_flat"]),
            ("synth", "fused_floor_couple", "synth_kernel.cu",
             "synth_kernel.py:36", new_launches["synth"]),
            ("floor_cd", "floor_spectra_cd", "floor_kernel.cu",
             "floor_kernel.py:167", new_launches["floor_cd"]),
            ("overlap_split", "overlap_i16_split", "overlap_kernel.cu",
             "overlap_kernel.py:353", new_launches["overlap_split"]),
            ("overlap_audio", "overlap_i16_audio", "overlap_kernel.cu",
             "overlap_kernel.py:110", new_launches["overlap_audio"])):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"lewton_tpu_torch/csrc/{src}",
            "replaces": f"lewton_tpu/ops/{replaces}",
            "launches": n_launch, "max_abs_err": err[key],
            "ms": times[key], "plain_ms": times[f"{key}_plain"],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            # no single PyTorch call computes any of these functions
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
