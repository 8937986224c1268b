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
path on its kernels and on its plain versions (the main path as one
chunk program, ``parallel.graphs``, its CUDA graph replayed), and
profiles one call of each path (device busy share, device time per op).

The graphs phase (``graphs_phase``): the i16 main path (N=16) and the f32
path (N=4) each as one chunk program, its replay bit for bit against the
eager decode (PCM, out_len, carry) and inside ``graphs.eager()``, its
replay's launches against those recorded at capture and against a
profile of one replay (K1 and K2 N times each, one graph launch, no
kernel launch on the host), graph against eager alternated (host ms a
call, wall ms a chunk, busy share), the capture's seconds and the pool's
MB; then ``BatchDecoder.decode_streams_i16`` at ``compact="device"``
(256 x 30 s, bench.py --e2e's shape) and ``"host"`` (32 streams), graph
against eager bit for bit, the programs captured, the pool's MB, the
card's memory, each way's stage split and a profile of one replay of its
deepest program. Every later phase runs with graphs on. A replay's
launches do not pass through the wrappers: they are counted apart
(``launch.REPLAYED``, :func:`replayed`) from the wrappers' own.

Last, the host-facing path. The frames phase: every audio packet of the
committed streams of ``tests/data/torch_gate/`` through the port's native
front-end (its C++ library, built here by the host compiler) and its Python
one, the frames and status codes the same in f32, i16 and p12 emit (the
exceptions named in FRAMES_RESIDUE_DIVERGES: none), and both front-ends'
packets/s. The conformance gate on the native front-end: every
committed stream (corpus, crafted floor-1 and floor-0 streams, with their
libvorbis goldens) through ``OggStreamReader.read_all_i16()`` on the card,
exact length and 0 samples over +/-2 LSB; the reference's three production
permutations of ``BatchDecoder.decode_streams_i16`` on four of them (the
flagship's p12 from the native emit); the whole set again with the Wang
split (recorded). Then file-to-PCM lines of ``BatchDecoder`` split by
stage: 32 copies of a stereo stream on the Python front-end and on the
native one (medians of calls in turn), and the reference's ``bench.py
--e2e`` shape (256 streams of about 30 s). Then the serving scheduler
(``serve.StreamingScheduler``) on the native front-end: every committed
stream through the reference's ``serve_scan8`` permutation (capacity 4,
chunk 64, scan 8; exact length, 0 samples over +/-2 LSB; the chained stream
held to its first link, the one the scheduler follows) and four of them
again with the 12-bit transport, K1 flat's launches counted there and
each launch held bit for bit against its plain version on the same
inputs, and both again with the plain versions in the kernels' place,
every output bit for bit as the kernel run's (``serve gate`` lines);
``python -m lewton_tpu_torch.bench --serve --scan 8`` in-process
(``serve_bench``: 256 streams over three setups; the bench's line grown
by launches, a StageTimer split and one untimed wave again on the plain
versions, bit for bit, the timed wave's program first uses apart from
its replays, and the card's memory; the ``serve`` line); and 30 waves of
24 streams through one scheduler with the host RSS, the card's memory and
the programs made after each, failing if the card's memory grows after
the middle third (``serve soak``). Last, the ``mesh`` phase (``mesh_phase``): ranks of a (dp, tp)
mesh started by ``lewton_tpu_torch/parallel/launch.py``, gloo ranks that
share card 0 at (2, 1), (2, 2) and (1, 3) and, on a machine with two or
more cards, NCCL ranks one per card: ``decode_chunk_sharded`` at the
headline width (S = 256, T = 64, two chunks, i16; K1 channel-major and K2
X at tp = 1, K2's audio form after the tensor-parallel IMDCT at tp > 1)
and ``BatchDecoder(mesh=).decode_streams_i16`` on PERM_STREAMS, held to
the unsharded decode on this process's card (1 LSB; lengths exact) and
to libvorbis (0 samples over +/-2 LSB), the tp ranks of each block bit
for bit, each rank's launches counted; each case run again on the same
inputs with every kernel launch held against its plain version (bit for
bit) and the run going on on the plain versions' outputs, equal to the
kernel run bit for bit; every case through programs (at tp > 1 two
captured segments a chunk, the tp all-reduce eagerly between their
replays), bit for bit each rank's eager rerun; ms per chunk of every rank
through programs and eagerly (``mesh ... timing`` lines). Then the
reader's backends (``backends_phase``), whose taps line holds
``decode_frames(with_taps=True)`` through a program bit for bit against
the eager taps, with a profile of one replay. Last, the bench
phase (``bench_phase``): the five surfaces of ``python -m
lewton_tpu_torch.bench`` in-process at the reference's defaults (the
synthesis headline, ``--check``, ``--e2e``, ``--serve``, ``--frontend``),
each surface's JSON line beside the card's name and power limit, its
launches counted (the headline's K1 channel-major and K2 X scan times
through the wrappers in the warm-up call that captures its program, and
scan x iters times in its replays, held to a profile of one replay;
``--check`` within +/-2 LSB with every launch held bit for bit against
its plain version; ``--serve`` at scan 1 through ``serve_bench``), the
headline's shape timed four ways just after it (the carry chained or
fresh, one synchronize or one a call), and the
``--frontend`` CLI once in a subprocess. Every failed check raises, so the exit code
is nonzero. The last
stdout line is ``{"ok": true, "device": {...}}``; the line before it lists
the kernels as JSON. Needs torch, numpy, nvcc and a C++ compiler.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import os
import platform
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from lewton_tpu_torch import _build, bench, debug, native, serve
from lewton_tpu_torch.audio import decode_packet_entropy
from lewton_tpu_torch.bench import (GATE_DIR, GATE_LSB, SERVE_FILES, gate_pass,
                                    gate_streams, lsb_diff, permutation_pass,
                                    serve_gate, stream_packets)
from lewton_tpu_torch.header import Mode
from lewton_tpu_torch.inside_ogg import OggStreamReader
from lewton_tpu_torch.models import decoder
from lewton_tpu_torch.models.decoder import (StreamDecoder, compile_setup,
                                             decode_frames, decode_frames_core,
                                             floor_kernel_inputs, floor_stage,
                                             frames_to_device, pack_frames,
                                             precompute_brackets, split_ok,
                                             synthesize_spectra_tapped)
from lewton_tpu_torch.ops import (floor_kernel, imdct, overlap_kernel,
                                  synth_kernel)
from lewton_tpu_torch.ops.floor_curve import (floor1_curve_batch,
                                              floor1_curve_mxu)
from lewton_tpu_torch.ops.imdct import (dct4_batch_parts_ct,
                                        dct4_split_uv_from_cd,
                                        imdct_batch_parts_ct, split_butterfly,
                                        split_cd_head, sum_order_bound)
from lewton_tpu_torch.ops.windowing import init_window_carry, overlap_table
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.parallel import graphs, launch
from lewton_tpu_torch.parallel.batch import BatchDecoder, decode_chunks_scan
from lewton_tpu_torch.parallel.launch import held_kernels, plain_kernels
from lewton_tpu_torch.parallel.pack12 import (pack12_np, pack12_supported,
                                             probed_h2d_mb_s)
from lewton_tpu_torch.profiling import StageTimer
from lewton_tpu_torch.samples import to_i16
from lewton_tpu_torch.serve import StreamingScheduler
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
    """Each kernel form's launches made by its wrapper since the counts were
    last set to 0."""
    return {k: getattr(m, a) for k, (m, a) in COUNTERS.items()}


def replayed() -> dict:
    """Each kernel form's launches made by replayed CUDA graphs since the
    counts were last set to 0 (``launch.REPLAYED``: the launches each
    program recorded at its capture, once a replay; ``replay_profile``
    holds them against a profile)."""
    return dict(launch.REPLAYED)


def ran() -> dict:
    """:func:`launches` + :func:`replayed`: what ran on the card."""
    rep = replayed()
    return {k: n + rep[k] for k, n in launches().items()}


def device_mb() -> dict:
    """MB of the card's memory that tensors hold and that the caching
    allocator has reserved (graph pools included)."""
    return {"allocated": torch.cuda.memory_allocated() / 2**20,
            "reserved": torch.cuda.memory_reserved() / 2**20}


def zero_launches() -> None:
    """Every count set to 0: the wrappers' and the replayed graphs'."""
    for m, a in COUNTERS.values():
        setattr(m, a, 0)
    launch.REPLAYED.update(dict.fromkeys(launch.REPLAYED, 0))


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
    zero_launches()
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
    calls after one warm-up call; ``kw`` goes to decode_chunks_scan (a
    caller's ``imdct``, or ``programs``: the calls through one program,
    which the warm-up call captures)."""
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
    calls (start, end in us), the device activities in it (start, end,
    name): kernels, copies and fills, not annotations, and the names of the
    host's CUDA runtime calls in it (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ...)."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    cycles = []  # the recorded cycle's events (a cycle's end clears them)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: cycles.append(p.events())) as prof:
        for _ in range(2):
            # some ms of an idle card on both sides of the calls inside the
            # window: the profiler has dropped device records of a replay
            # (see replay_profile)
            time.sleep(0.005)
            with record_function(RANGE):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            time.sleep(0.005)
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
    runtime = [e.name for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith("cuda") and t0 <= e.time_range.start <= t1]
    return (t0, t1), dev, runtime


def stage_device_ms(fn, reps: int = 5) -> float | None:
    """Device-busy milliseconds per call of fn (profiler), None when the
    profiler recorded no device activity."""
    _, dev, _ = device_profile(fn, reps)
    return sum(b - a for a, b, _ in dev) / reps / 1e3 if dev else None


def busy_us(span, dev) -> tuple[float, dict]:
    """The union of the device activities ``dev`` inside ``span`` (us) and
    each op's summed time."""
    busy, end = 0.0, span[0]
    per_op: dict[str, float] = {}
    for a, b, name in dev:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        per_op[name] = per_op.get(name, 0.0) + max(0.0, b - a)
    return busy, per_op


def profile_path(label, cs, frs, carry0, with_i16, top: int = 8,
                 prep=no_prep, **kw) -> None:
    """One call of a path under the profiler: the device's busy share of
    the call's wall time (union of device activity intervals) and device
    ms per chunk of the largest ops."""
    n_ = frs["mode"].shape[0]
    (t0, t1), dev, _ = device_profile(
        lambda: decode_chunks_scan(cs, prep(cs, frs), carry0,
                                   with_i16=with_i16, **kw))
    if not dev:
        print(f"profile {label}: the profiler recorded no device activity "
              "(busy share not measured)")
        return
    busy, per_op = busy_us((t0, t1), dev)
    wall = t1 - t0
    print(f"profile {label}: one {n_}-chunk call {wall / 1e3:.3f} ms wall, "
          f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%, {len(dev)} device activities")
    for name, us in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]:
        print(f"profile {label}: {us / 1e3 / n_:.4f} ms/chunk  {name[:110]}")


#: the graphs phase: ABAB rounds, calls per wall timing, calls per host
#: timing; BatchDecoder streams at compact "device" (bench.py --e2e's
#: shape) and "host" (host compaction takes ~50 ms a stream)
GRAPH_ROUNDS, GRAPH_WALL_CALLS, GRAPH_HOST_CALLS = 2, 5, 3
GRAPH_BATCH = {"device": 256, "host": 32}
#: each kernel form's kernel, by the name the profiler records
KERNEL_NAMES = {"floor": "floor_spectra_kernel",
                "floor_flat": "floor_spectra_kernel",
                "floor_cd": "floor_cd_kernel", "overlap": "overlap_i16_kernel",
                "overlap_split": "overlap_i16_kernel",
                "overlap_audio": "overlap_i16_kernel",
                "synth": "fused_floor_couple"}


def same_bits(got, want, label: str) -> None:
    """Raise unless the tensors (or arrays) of ``got`` equal ``want``'s bit
    for bit."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        if isinstance(g, torch.Tensor):
            ok = g.shape == w.shape and _same_bits(g, w)
        else:
            ok = g.shape == w.shape and np.array_equal(g, w)
        if not ok:
            raise AssertionError(f"{label}: output {i} differs between the "
                                 "graph and the eager run")


#: profiles of one replay taken before replay_profile fails: the profiler
#: has dropped device records of a replay on an H100 (2 of 8 K1 and K2
#: launches of an 8-chunk replay in one run, 93 of a one-chunk replay's
#: 179 activities in another, the outputs bit for bit the eager run's)
PROFILE_TRIES = 3


def replay_profile(label, prog, n_: int, card: str) -> dict:
    """One replay of ``prog`` (its own inputs and carry: no copy) under the
    profiler: the kernels in it by name, held to the launches the program
    recorded at capture, and the host's CUDA runtime calls (one graph
    launch, no kernel launch). Every profile must show those runtime calls
    and no kernel beyond the recorded ones; one that shows fewer (device
    records the profiler dropped) is taken again, up to PROFILE_TRIES
    profiles, and every profile's count is printed."""
    want: dict[str, int] = {}
    for form, n in prog.launches.items():
        want[KERNEL_NAMES[form]] = want.get(KERNEL_NAMES[form], 0) + n
    tries = []
    for _ in range(PROFILE_TRIES):
        (t0, t1), dev, runtime = device_profile(
            lambda: prog(prog.inputs, prog.carry))
        if not dev:
            print(f"graphs profile {label}: the profiler recorded no device "
                  f"activity (not measured) | card: {card}")
            return {}
        seen = {k: sum(k in name for _, _, name in dev)
                for k in KERNEL_NAMES.values()}
        calls = {k: runtime.count(k) for k in set(runtime)}
        tries.append({"device_activities": len(dev), "kernels": seen})
        if any(seen[k] > want.get(k, 0) for k in seen) or \
                calls.get("cudaGraphLaunch", 0) != 1 or \
                calls.get("cudaLaunchKernel", 0):
            raise AssertionError(f"graphs profile {label}: kernels {seen}, "
                                 f"recorded {prog.launches}, runtime {calls}")
        if all(seen[k] == want.get(k, 0) for k in seen):
            break
    else:
        raise AssertionError(f"graphs profile {label}: recorded "
                             f"{prog.launches}, profiles {tries}")
    busy, _ = busy_us((t0, t1), dev)
    res = {"device_activities": len(dev), "kernels": {k: v for k, v in
                                                      seen.items() if v},
           "runtime_calls": calls, "wall_ms": (t1 - t0) / 1e3,
           "device_busy_ms": busy / 1e3,
           "profiles_taken": len(tries),
           "activities_of_each": [t["device_activities"] for t in tries]}
    print(f"graphs profile {label}: one replay of {n_} chunks, "
          f"{json.dumps(res)} | card: {card}")
    return res


def graph_ab(label, prog, frs, carry0, n_: int, card: str) -> dict:
    """Graph against eager (``graphs.eager()``) on one program, alternated
    ABAB in GRAPH_ROUNDS rounds: host ms per call (the call's return with
    the stream idle before it: the enqueue), wall ms per chunk
    (GRAPH_WALL_CALLS calls, the carry chained, one synchronize), and in
    the first round the device's busy share of one profiled call."""
    res = {"graph": {"host_ms": [], "wall_ms_per_chunk": []},
           "eager": {"host_ms": [], "wall_ms_per_chunk": []}}
    for r in range(GRAPH_ROUNDS):
        for way in ("graph", "eager"):
            ctx = graphs.eager if way == "eager" else contextlib.nullcontext
            with ctx():
                hosts = []
                for _ in range(GRAPH_HOST_CALLS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    prog(frs, carry0)
                    hosts.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                c = carry0
                t0 = time.perf_counter()
                for _ in range(GRAPH_WALL_CALLS):
                    _, c = prog(frs, c)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                res[way]["host_ms"].append(statistics.median(hosts) * 1e3)
                res[way]["wall_ms_per_chunk"].append(
                    wall / (GRAPH_WALL_CALLS * n_) * 1e3)
                if r == 0:
                    (t0, t1), dev, _ = device_profile(
                        lambda: prog(frs, carry0))
                    busy, _ = busy_us((t0, t1), dev)
                    res[way]["device_busy_share"] = (
                        busy / (t1 - t0) if dev else None)
    print(f"graphs timing {label} (ABAB, {GRAPH_ROUNDS} rounds; host: median "
          f"of {GRAPH_HOST_CALLS} calls, stream idle before each; wall: "
          f"{GRAPH_WALL_CALLS} calls, carry chained): {json.dumps(res)} | "
          f"card: {card}")
    return res


def graphs_phase(dev, card: str, cs, fr0, carry0) -> dict:
    """The chunk programs (``parallel.graphs``) on the card: the i16 main
    path (N chunks) and the f32 path (N_NEW) each as one program, its
    replay held bit for bit (outputs, out_len, carry) against the eager
    decode_chunks_scan, its replay's launches against those it recorded
    and against a profile of one replay, graph against eager timed ABAB
    (``graph_ab``), the capture's seconds and the pool's MB; then
    BatchDecoder.decode_streams_i16 at compact "device" (bench.py --e2e's
    shape) and "host", graph against eager (``graphs.eager()``) bit for
    bit, with the programs it made and captured, the pool's MB and the
    stage split of one synchronized call each way."""
    t_phase = time.perf_counter()
    summary = {}
    for label, n_, with_i16, want in (
            ("i16 main", N, True, {"floor": N, "overlap": N}),
            ("f32", N_NEW, False, {"floor_flat": N_NEW})):
        frs = expand(fr0, n_)
        programs = graphs.Programs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_chunks_scan(cs, frs, carry0, with_i16=with_i16,
                           programs=programs)  # eager warm-up, capture
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        (prog,) = programs.programs.values()
        zero_launches()
        (g_out, g_len), g_carry = prog(frs, carry0)
        got, rep = launches(), replayed()
        torch.cuda.synchronize()
        if any(got.values()) or rep != dict.fromkeys(rep, 0) | want or \
                prog.launches != want:
            raise AssertionError(f"graphs {label}: one replay counted "
                                 f"{rep} (wrappers {got}), recorded "
                                 f"{prog.launches}, expected {want}")
        (e_out, e_len), e_carry = decode_chunks_scan(cs, frs, carry0,
                                                     with_i16=with_i16)
        same_bits((g_out, g_len) + g_carry, (e_out, e_len) + e_carry,
                  f"graphs {label}")
        with graphs.eager():  # the same program's body on its buffers
            (p_out, p_len), p_carry = prog(frs, carry0)
        same_bits((p_out, p_len) + p_carry, (e_out, e_len) + e_carry,
                  f"graphs {label} (eager())")
        del e_out
        print(f"graphs {label}: one program of {n_} chunks (S={S} T={T} "
              f"with_i16={with_i16}), replay == eager bit for bit (PCM, "
              f"out_len, carry); launches of one replay {json.dumps(rep)} "
              f"= recorded {json.dumps(prog.launches)}, none through the "
              f"wrappers; first call "
              f"(warm-up + capture) {first_s:.3f} s, capture "
              f"{prog.capture_s:.3f} s, pool {prog.pool_mb:.1f} MB, outputs "
              f"{sum(o.numel() * o.element_size() for o in prog.outputs) / 2**20:.1f}"
              f" MB | card: {card}")
        rec = {"capture_s": prog.capture_s, "pool_mb": prog.pool_mb,
               "first_call_s": first_s}
        if label == "i16 main":
            rec["profile"] = replay_profile(label, prog, n_, card)
        rec["ab"] = graph_ab(label, prog, frs, carry0, n_, card)
        summary[label] = rec
        del prog, programs, g_out, p_out
        torch.cuda.empty_cache()

    data, _, _ = gate_streams([bench.E2E_STREAM])[bench.E2E_STREAM]
    headers, spans = bench.audio_spans(data, max(1, bench.E2E_SECONDS // 3))
    raw = (headers.raw_ident, headers.raw_setup)
    for compact, n_streams in GRAPH_BATCH.items():
        dec = BatchDecoder(headers.ident, headers.setup, chunk=64, scan=8,
                           raw_headers=raw, device=dev)
        batch = [spans] * n_streams
        t0 = time.perf_counter()
        dec.decode_streams_i16(batch, compact=compact)  # warm-up, captures
        first_s = time.perf_counter() - t0
        rec = {"first_call_s": first_s}
        outs = {}
        for way in ("graph", "eager", "graph", "eager"):
            ctx = graphs.eager if way == "eager" else contextlib.nullcontext
            with ctx():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = dec.decode_streams_i16(batch, compact=compact)
                rec.setdefault(f"{way}_wall_s", []).append(
                    time.perf_counter() - t0)
            outs.setdefault(way, out)
        same_bits(outs["graph"], outs["eager"], f"graphs batch {compact}")
        dec.stage_sync = True
        for way in ("graph", "eager"):
            ctx = graphs.eager if way == "eager" else contextlib.nullcontext
            with ctx():
                dec.decode_streams_i16(batch, compact=compact)
            rec[f"{way}_stages_s"] = dec.last_stats["stages"]
        progs = dec._slots.programs.programs
        rec |= {"programs": dec._slots.programs.stats(),
                # a TransferSlots program's key: cap third, slot and N last
                "keys (slot, N, cap)": sorted(
                    (k[-2], k[-1], k[2] or 0) for k in progs),
                "pcm_buffers_mb": sum(b.numel() * b.element_size() for b in
                                      dec._slots.pcm.values()) / 2**20,
                "device_mb": device_mb()}
        # the deepest captured program's launches against a profile
        prog = max((p for p in progs.values() if p.graph is not None),
                   key=lambda p: p.outputs[0].shape[0])
        rec["profile"] = replay_profile(f"batch {compact}", prog,
                                        prog.outputs[0].shape[0], card)
        audio_s = sum(o.shape[0] for o in outs["graph"]) / \
            headers.ident.sample_rate
        print(f"graphs batch compact={compact}: BatchDecoder."
              f"decode_streams_i16 on {n_streams} x {audio_s / n_streams:.1f}"
              f" s ({bench.E2E_STREAM}, chunk 64, scan 8, native front-end), graph "
              f"== eager bit for bit; {json.dumps(rec)} | card: {card}")
        summary[f"batch {compact}"] = rec
        del dec, outs, out
        torch.cuda.empty_cache()
    summary["stream"], stream_launches = graphs_stream(dev, card)
    print(f"graphs phase ({time.perf_counter() - t_phase:.1f} s)")
    return summary, stream_launches


#: graphs stream: ABAB rounds of the timings, the packets of the
#: per-packet timing
STREAM_ROUNDS, STREAM_PACKETS = 2, 200


def owner_programs(owner) -> dict:
    """key -> (captured, replays) of each program of a ``graphs.Programs``."""
    return {k: (p.graph is not None, p.replays)
            for k, p in owner.programs.items()}


def keep_decoders(rdr: OggStreamReader, into: list) -> OggStreamReader:
    """``rdr`` with every StreamDecoder it makes appended to ``into`` (for
    their ``stage_s``), each with ``made_s``: the host seconds of its
    making (the setup header's Python parse, the native stream's and
    compile_setup)."""
    make = rdr._stream_decoder

    def kept(**kw):
        t0 = time.perf_counter()
        into.append(make(**kw))
        into[-1].made_s = time.perf_counter() - t0
        return into[-1]
    rdr._stream_decoder = kept
    return rdr


def stream_stages(decs: list, wall: float) -> dict:
    """The host seconds of ``decs``' stages summed, their making less
    compile_setup (``header_parse``: the setup header parsed in Python and
    by the native stream), the reader's own rest (demux, granules,
    concatenation: wall less the others) and the wall."""
    st = {k: sum(d.stage_s[k] for d in decs) for k in decoder.STAGES}
    st["header_parse"] = sum(getattr(d, "made_s", d.stage_s["compile_setup"])
                             for d in decs) - st["compile_setup"]
    return st | {"reader_rest": wall - sum(st.values()), "wall": wall}


def stream_read(data: bytes, dev, fmt: str = "i16") -> tuple:
    """read_all_i16 (or read_all_planar_f32) of a fresh reader on ``dev``:
    (output, stages)."""
    decs: list = []
    rdr = keep_decoders(OggStreamReader(data, device=dev), decs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = rdr.read_all_i16() if fmt == "i16" else rdr.read_all_planar_f32()
    return out, stream_stages(decs, time.perf_counter() - t0)


def frames_key(prog) -> tuple:
    """(T, with_i16) of a single-stream program."""
    return prog.inputs["mode"].shape[0], prog.key[3]


def graphs_stream(dev, card: str) -> dict:
    """The single-stream programs (``graphs.stream_programs``) on the card:
    every gate stream's read_all_i16 and read_all_planar_f32 through them
    bit for bit against the same calls under ``graphs.eager()``, the gate
    at 0 samples over +/-2 LSB, the programs each stream made and whether
    it replayed one an earlier stream captured; the per-packet loop on
    PERM_STREAMS the same way; two readers of one setup interleaved packet
    by packet, each its solo decode; a replay profile of a per-packet and
    a 64-packet program; graph against eager ABAB on RATE_STREAM: a fresh
    reader's read_all_i16 split by stage, a warm decoder's (one
    StreamDecoder reset, no demux or compile_setup) and read_dec_packet's
    host and wall us a packet; the owner's captures, capture seconds and
    pool MB. Returns the summary and the gate's launches (wrappers and
    replays)."""
    t_phase = time.perf_counter()
    owner = graphs.stream_programs(dev)
    streams = gate_streams()
    res: dict = {}
    zero_launches()
    for name, (data, golden, kind) in streams.items():
        before = owner_programs(owner)
        g16, _ = stream_read(data, dev)
        g32, _ = stream_read(data, dev, "f32")
        after = owner_programs(owner)
        with graphs.eager():
            e16, _ = stream_read(data, dev)
            e32, _ = stream_read(data, dev, "f32")
        same_bits((g16, g32), (e16, e32), f"graphs stream {name}")
        new = [k for k in after if k not in before]
        earlier = any(after[k][1] > before[k][1] for k in before)
        if any(not after[k][0] for k in after):
            raise AssertionError(f"graphs stream {name}: a program of the "
                                 "owner was not captured")
        if g16.shape != golden.shape:
            raise AssertionError(f"graphs stream {name}: {g16.shape}, "
                                 f"golden {golden.shape}")
        d = lsb_diff(g16, golden)
        if d[1]:
            raise AssertionError(f"graphs stream {name}: {d[1]} samples "
                                 f"over +/-{GATE_LSB}")
        res[name] = {"maxdiff": d[0], "over": d[1], "new_programs": len(new),
                     "replayed_earlier": earlier}
        print(f"graphs stream {name} ({kind}): read_all_i16 and "
              f"read_all_planar_f32 through programs == graphs.eager() bit "
              f"for bit; gate maxdiff {d[0]} LSB, {d[1]} over "
              f"+/-{GATE_LSB}; programs made {len(new)} "
              f"{sorted(frames_key(owner.programs[k]) for k in new)} "
              "(T, with_i16), replayed a program an earlier stream "
              f"captured: {earlier}")
    gate_launches = ran()
    print(f"graphs stream gate: {len(streams)} streams, 0 over "
          f"+/-{GATE_LSB}, launches (wrappers + replays) "
          f"{json.dumps(gate_launches)}, owner {json.dumps(owner.stats())}"
          f" | card: {card}")

    # the per-packet loop, and two readers of one setup interleaved
    for name in PERM_STREAMS:
        data = streams[name][0]
        before = owner_programs(owner)
        got = packet_loop(data, "torch", dev)
        with graphs.eager():
            want = packet_loop(data, "torch", dev)
        same_bits((got,), (want,), f"graphs stream packets {name}")
        new = [k for k in owner.programs if k not in before]
        print(f"graphs stream packets {name}: read_dec_packet loop "
              f"({got.shape[0]} samples) through programs == graphs.eager()"
              f" bit for bit; programs made {len(new)}")
    data = streams[RATE_STREAM][0]
    solo = packet_loop(data, "torch", dev)
    rdrs = [OggStreamReader(data, device=dev) for _ in range(2)]
    got = [[], []]
    for _ in range(7):
        got[1].append(rdrs[1].read_dec_packet())
    while True:
        ps = [r.read_dec_packet() for r in rdrs]
        for j, p in enumerate(ps):
            if p is not None:
                got[j].append(p)
        if all(p is None for p in ps):
            break
    for j in (0, 1):
        same_bits((np.concatenate(got[j], axis=1).T,), (solo,),
                  f"graphs stream interleaved reader {j}")
    print(f"graphs stream interleaved: two readers of {RATE_STREAM}, the "
          "second 7 packets ahead, packet by packet in turn: each == its "
          "solo decode bit for bit (the carry rule)")

    # one replay of the per-packet program (f32, as read_dec_packet
    # decodes) and of the 64-packet i16 program of RATE_STREAM's setup
    headers, pcks = stream_packets(data)
    sd = StreamDecoder(headers.ident, headers.setup, device=dev,
                       raw_headers=(headers.raw_ident, headers.raw_setup))
    static = tuple(getattr(sd.cs, k) for k in sd.cs._static_names)
    progs = {frames_key(p): p for p in owner.programs.values()
             if p.key[1] == static}
    profiles = {}
    for (t_, i16) in ((1, False), (64, True)):
        profiles[f"T={t_}"] = replay_profile(
            f"stream T={t_} with_i16={i16}", progs[(t_, i16)], 1, card)

    # graph against eager, ABAB
    audio_s = streams[RATE_STREAM][1].shape[0] / headers.ident.sample_rate
    ab: dict = {"graph": {}, "eager": {}}
    for _ in range(STREAM_ROUNDS):
        for way in ("graph", "eager"):
            ctx = graphs.eager if way == "eager" else contextlib.nullcontext
            rec = ab[way]
            with ctx():
                _, st = stream_read(data, dev)
                rec.setdefault("fresh_read_all_i16_s", []).append(st)
                sd.reset()
                sd.stage_s = dict.fromkeys(decoder.STAGES, 0.0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sd.decode_packets_i16(pcks)
                rec.setdefault("warm_decode_s", []).append(stream_stages(
                    [sd], time.perf_counter() - t0))
                decs: list = []
                rdr = keep_decoders(OggStreamReader(data, device=dev), decs)
                rdr.read_dec_packet()  # the reader's decoder made, untimed
                decs[0].stage_s = dict.fromkeys(decoder.STAGES, 0.0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = 0
                while n < STREAM_PACKETS and rdr.read_dec_packet() is not None:
                    n += 1
                wall = time.perf_counter() - t0
                rec.setdefault("packet_us", []).append({
                    "host_device_call": 1e6 * decs[0].stage_s["device"] / n,
                    "frontend": 1e6 * decs[0].stage_s["frontend"] / n,
                    "d2h": 1e6 * decs[0].stage_s["d2h"] / n,
                    "wall": 1e6 * wall / n, "packets": n})
    for way, rec in ab.items():
        rec["x_realtime_fresh"] = [audio_s / st["wall"]
                                   for st in rec["fresh_read_all_i16_s"]]
    st = owner.stats()
    print(f"graphs stream timing ({RATE_STREAM}, {audio_s:.2f} s of audio;"
          f" ABAB, {STREAM_ROUNDS} rounds; seconds a call by stage: "
          "compile_setup, frontend, device = the program's copies in and "
          "replay or eager enqueue, d2h = the copies out waiting for the "
          "device, header_parse = the decoder's making less compile_setup,"
          f" reader_rest = demux and the rest): {json.dumps(ab)} | card: "
          f"{card}")
    print(f"graphs stream owner: {len(owner.programs)} programs, captured "
          f"{st['captured']}, capture {st['capture_s']:.3f} s, first uses "
          f"{st['first_use_s']:.3f} s, replays {st['replays']}, pool "
          f"{st['pool_mb']:.1f} MB, card {json.dumps(device_mb())} | card: "
          f"{card}")
    print(f"graphs stream phase ({time.perf_counter() - t_phase:.1f} s)")
    return {"streams": res, "profiles": profiles, "ab": ab,
            "owner": st}, gate_launches


#: the streams of the reference's production permutations (bench.PERMUTATIONS,
#: each on 2 copies of a stream), and of the other phases' per-stream checks
PERM_STREAMS = ("stereo_44k_q3", "ch6_44k_q3", "f1_bs8192",
                "f0_coupled_stereo")
E2E_STREAM, E2E_S, E2E_SCAN = "stereo_44k_q3", 32, 8
E2E_REPS = 3  # native-front-end calls of each kind at E2E_S
#: the reference's bench.py --e2e shape: streams, and copies of the 3 s
#: stream's audio packets in each (about 30 s)
BENCH_S, BENCH_TILE = 256, 10
FRAME_EMITS = ("f32", "i16", "p12")
#: first-link audio packets whose residue the native library decodes
#: differently from the Python front-end (stream -> packet indices). Empty:
#: the library spends a codeword's bits at end-of-packet as the Python
#: front-end does (tests/test_torch_native.py holds the same on the CPU)
FRAMES_RESIDUE_DIVERGES: dict = {}
#: K1/K2 forms the gate must launch: the i16 path (read_all_i16, host
#: compaction), the f32 path (device compaction) and the split pass
GATE_KERNELS = ("floor", "floor_flat", "overlap", "floor_cd",
                "overlap_split")
#: the serve phase's run of bench.py --serve at another scan depth than
#: the bench phase's (the reference's default, 1)
SERVE_ARGV = ("--serve", "--scan", "8")
#: tools/soak_serve.py's shape: waves of streams through one scheduler,
#: and the most the median RSS of the last third of the waves may exceed
#: that of the middle third
SOAK_WAVES, SOAK_S, SOAK_RSS_MB = 30, 24, 32.0


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
          + " (f0_cosc within 1 f32 ulp; residue differs at "
          + (", ".join(f"{k} packets {sorted(v)}"
                       for k, v in FRAMES_RESIDUE_DIVERGES.items())
             or "no packet") + "); one-stream entry, default emit: native "
          f"{rates['native']:.1f} packets/s, python {rates['python']:.1f} "
          f"packets/s | card: {card}")
    return rates


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
    zero_launches()
    t0 = time.perf_counter()
    direct = gate_pass(streams, dev, "read_all_i16")
    perms = permutation_pass(streams, dev, PERM_STREAMS)
    with split_transform():
        split = gate_pass(streams, dev, "read_all_i16 split")
    got = ran()  # the permutations' BatchDecoder replays its programs
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
          f"({time.perf_counter() - t0:.1f} s, launches {launches()}, by "
          f"replayed graphs {replayed()}): "
          f"{json.dumps(summary)} | card: {card}")
    bad = {k: v for k, v in summary.items()
           if k != "split" and v["samples_over_2lsb"]}
    if bad:
        raise AssertionError(f"conformance: samples over +/-{GATE_LSB} LSB "
                             f"in {bad}")
    e2e_lines(streams, dev, card)
    return summary


@contextlib.contextmanager
def p12_wherever_allowed():
    """The scheduler's transport probe answers "p12" for every setup that
    allows the 12-bit residue (as on a slow link)."""
    old = serve.p12_auto
    serve.p12_auto = lambda cs, device=None: pack12_supported(cs)
    try:
        yield
    finally:
        serve.p12_auto = old


def same_outputs(got: list, want: list, label: str) -> int:
    """Outputs of a run on the kernels' plain versions against the kernel
    run's: bit for bit. Returns the largest difference in LSB (0)."""
    worst = 0
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if a.shape != b.shape:
            raise AssertionError(f"{label} output {i}: shape {a.shape} on "
                                 f"the plain versions, {b.shape} on the "
                                 "kernels")
        if a.size:
            worst = max(worst, int(np.abs(a.astype(np.int32)
                                          - b.astype(np.int32)).max()))
    if worst:
        raise AssertionError(f"{label}: the plain versions differ from the "
                             f"kernels by up to {worst} LSB")
    return worst


def rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 1024.0
    raise AssertionError("no VmRSS in /proc/self/status")


#: the scheduler's methods the serve lines time: (class, method, stage)
SERVE_STAGES = ((StreamingScheduler, "add_stream", "register"),
                (serve._Group, "_entropy", "entropy"),
                (serve._Group, "step_dispatch", "dispatch"),
                (serve._Group, "collect", "collect"))


@contextlib.contextmanager
def serve_stages(timer: StageTimer):
    """``timer`` around the scheduler's registration of a stream (the
    Python Ogg demux of its bytes, the header parse, a new group's setup),
    the groups' host entropy decode, their whole dispatch (entropy
    included) and their collect."""
    orig = [(cls, n, getattr(cls, n)) for cls, n, _ in SERVE_STAGES]

    def timed(label, fn):
        def call(self, *a, **kw):
            with timer.stage(label):
                return fn(self, *a, **kw)
        return call

    for (cls, n, fn), (_, _, label) in zip(orig, SERVE_STAGES):
        setattr(cls, n, timed(label, fn))
    try:
        yield
    finally:
        for cls, n, fn in orig:
            setattr(cls, n, fn)


def serve_wave(sched, datas: list, n: int, tag) -> tuple[list, float]:
    """Register n streams (datas in turn), step to the end, poll and
    remove each: (PCM per stream, audio seconds)."""
    for i in range(n):
        sched.add_stream((tag, i), datas[i % len(datas)])
    while sched.step():
        pass
    outs, audio = [], 0.0
    for i in range(n):
        pcm = sched.poll((tag, i))
        audio += pcm.shape[0] / sched.streams[(tag, i)][0].cs.sample_rate
        outs.append(pcm)
        sched.remove_stream((tag, i))
    return outs, audio


def serve_bench(dev, argv) -> dict:
    """``python -m lewton_tpu_torch.bench`` ``argv`` (a --serve run) through
    ``bench.bench_serve``, with the launch counts set to 0 and
    ``serve_stages`` around its timed part; every output checked against
    its golden, and against an untimed second wave on the kernels' plain
    versions, bit for bit. Returns the bench's line, its detail grown by
    the scan, the groups, the launches, the stage seconds and the plain
    wave's largest difference."""
    args = bench.parse_args(argv)
    streams = gate_streams(SERVE_FILES)
    datas = [streams[n][0] for n in SERVE_FILES]
    goldens = [streams[n][1] for n in SERVE_FILES]
    timer = StageTimer()

    programs = {}

    @contextlib.contextmanager
    def timed(sched):
        torch.cuda.synchronize()
        programs["before"] = serve_programs(sched)
        zero_launches()
        with serve_stages(timer):
            yield
        torch.cuda.synchronize()
        programs["after"] = serve_programs(sched)

    line, outs, sched = bench.bench_serve(args, dev, timed)
    got, rep = launches(), replayed()
    for i, out in enumerate(outs):
        g = goldens[i % len(datas)]
        if out.shape != g.shape or lsb_diff(out, g)[1]:
            raise AssertionError(f"serve scan {args.scan} stream {i}: shape "
                                 f"{out.shape} against {g.shape} or samples "
                                 "over the contract")
    if not got["floor_flat"] + rep["floor_flat"]:
        raise AssertionError(f"serve scan {args.scan}: K1 flat never "
                             f"launched ({got}, replayed {rep})")
    d = line["detail"]
    t = timer.totals
    stages = {"register": t["register"], "entropy": t["entropy"],
              "dispatch_rest": t["dispatch"] - t["entropy"],
              "collect": t["collect"]}
    stages["other"] = d["wall_s"] - sum(stages.values())
    d |= {"scan": args.scan, "capacity": sched.capacity,
          "chunk": sched.chunk,
          "groups": sum(len(v) for v in sched.groups.values()),
          "launches": got, "launches_replayed": rep,
          "device_steps": timer.counts["entropy"], "stages_s": stages,
          # the timed wave's chunk programs: its first uses (warm-up and
          # capture, host seconds) apart from its replays
          "programs": wave_programs(programs["before"], programs["after"]),
          "device_mb": device_mb()}
    # the same wave again on the plain versions (not timed): bit for bit
    with plain_kernels():
        plain, _ = serve_wave(sched, datas, args.streams, "plain")
    if (launches(), replayed()) != (got, rep):
        raise AssertionError(f"serve scan {args.scan}: the plain wave "
                             f"launched kernels ({launches()}, replayed "
                             f"{replayed()}, against {got}, {rep})")
    d["kernel_vs_plain_maxdiff"] = same_outputs(plain, outs,
                                                f"serve scan {args.scan}")
    return line


def serve_programs(sched) -> dict:
    """``graphs.Programs.stats()`` summed over the scheduler's groups."""
    total: dict = {}
    for grps in sched.groups.values():
        for grp in grps:
            for k, v in grp._slots.programs.stats().items():
                total[k] = total.get(k, 0) + (v or 0)
    return total


def wave_programs(before: dict, after: dict) -> dict:
    """What a wave added to ``serve_programs``: programs made and captured,
    the host seconds of their first uses (warm-up and capture) and of the
    replays, and the programs in all after it."""
    d = {k: after.get(k, 0) - before.get(k, 0)
         for k in ("programs", "captured", "first_use_s", "replays",
                   "replay_s")}
    return d | {"programs_total": after.get("programs", 0),
                "pool_mb_total": after.get("pool_mb", 0)}


def serve_soak(streams: dict, dev, card: str) -> list:
    """tools/soak_serve.py's shape: SOAK_WAVES waves of SOAK_S streams
    (register -> step to the end -> poll -> remove) through one scheduler
    after a warm-up wave; after each wave the host RSS, the card's memory
    (``device_mb``) and what the wave added to the groups' chunk programs
    (``wave_programs``). Fails if the median RSS of the last third of the
    waves exceeds the middle third's by more than SOAK_RSS_MB, or if the
    card's allocated or reserved memory in the last third exceeds its
    largest in the middle third."""
    datas = [streams[n][0] for n in SERVE_FILES]
    sched = StreamingScheduler(capacity=max(8, SOAK_S // len(datas) + 1),
                               chunk=64, scan=1, device=dev)
    serve_wave(sched, datas, SOAK_S, "warm")
    rss, mem, progs, t0 = [], [], [], time.perf_counter()
    first = None
    for wave in range(SOAK_WAVES):
        before = serve_programs(sched)
        outs, _ = serve_wave(sched, datas, SOAK_S, wave)
        if first is None:
            first = outs
        elif not all(np.array_equal(a, b) for a, b in zip(outs, first)):
            raise AssertionError(f"serve soak: wave {wave} decoded "
                                 "differently from wave 0")
        torch.cuda.synchronize()
        rss.append(rss_mb())
        mem.append(device_mb())
        progs.append(wave_programs(before, serve_programs(sched)))
    k = SOAK_WAVES // 3
    mid = statistics.median(rss[k: 2 * k])
    last = statistics.median(rss[2 * k:])
    grew = {m: max(r[m] for r in mem[2 * k:]) - max(r[m] for r in
                                                     mem[k: 2 * k])
            for m in ("allocated", "reserved")}
    print(f"serve soak: {SOAK_WAVES} waves x {SOAK_S} streams in "
          f"{time.perf_counter() - t0:.2f} s, RSS first wave {rss[0]:.1f} MB, "
          f"last {rss[-1]:.1f} MB, median middle third {mid:.1f} MB, last "
          f"third {last:.1f} MB (bound +{SOAK_RSS_MB:.0f} MB); groups "
          f"{sum(len(v) for v in sched.groups.values())}, RSS per wave "
          f"{['%.1f' % r for r in rss]}; card MB allocated per wave "
          f"{['%.1f' % r['allocated'] for r in mem]}, reserved "
          f"{['%.1f' % r['reserved'] for r in mem]} (last third over the "
          f"middle's largest: {json.dumps(grew)}); programs per wave "
          f"{json.dumps(progs)} | card: {card}")
    if last - mid > SOAK_RSS_MB:
        raise AssertionError(f"serve soak: RSS grew {last - mid:.1f} MB "
                             "from the middle third to the last")
    if any(v > 0 for v in grew.values()):
        raise AssertionError(f"serve soak: the card's memory grew after the "
                             f"middle third: {grew}")
    return rss


def serve_phase(dev, card: str) -> None:
    """The serving scheduler on the card, on the native front-end: every
    gate stream through StreamingScheduler(**SERVE_GATE), the flagship
    streams again with the 12-bit transport, K1 flat's launches counted
    across both (set to 0 before, nonzero after), each launch held against
    its plain version on the same inputs (``held_kernels``), and both gates
    again on the plain versions (``plain_kernels``), every poll bit for bit
    as the kernels'; then ``bench --serve`` at SERVE_ARGV's scan depth
    (``serve_bench``; the bench phase runs the default, scan 1), and the
    soak."""
    streams = gate_streams()
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    held: dict = {}
    with held_kernels(held):
        direct, direct_outs, _ = serve_gate(streams, list(streams), dev, "")
        with p12_wherever_allowed():
            p12, p12_outs, sched = serve_gate(streams, PERM_STREAMS, dev,
                                              " p12")
    grp = sched.streams["stereo_44k_q3"][0]
    if not (grp._p12 and grp.sd._native.residue_dtype == np.uint32):
        raise AssertionError("serve gate p12: the flagship did not take p12 "
                             "from the native emit")
    got = launches()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    # both gates again on the plain versions on the same card inputs, at
    # the shapes the serve path gives K1 (capacity x chunk rows of every
    # group's own P, M, W and C): every poll bit for bit as the kernel's
    with plain_kernels():
        _, plain_outs, _ = serve_gate(streams, list(streams), dev, "", False)
        with p12_wherever_allowed():
            _, plain_p12, _ = serve_gate(streams, PERM_STREAMS, dev, "",
                                         False)
    if launches() != got:
        raise AssertionError("serve gate: the plain run launched kernels "
                             f"({launches()} against {got})")
    plain_diff = max(same_outputs(plain_outs, direct_outs, "serve gate"),
                     same_outputs(plain_p12, p12_outs, "serve gate p12"))
    summary = {label: {"streams": len(res),
                       "maxdiff": max(r[0] for r in res.values()),
                       "samples_over_2lsb": sum(r[1] for r in res.values()),
                       "samples_differ": sum(r[2] for r in res.values())}
               for label, res in (("serve_scan8", direct),
                                  ("serve_scan8_p12", p12))}
    k1 = held.get("floor_flat", {"calls": 0, "shapes": [],
                                 "max_abs_err": 0.0})
    print(f"serve gate ({seconds:.1f} s, launches {got}; K1 flat against "
          f"its plain version on the same inputs at {k1['calls']} calls, "
          f"{len(k1['shapes'])} shapes: max_abs_err {k1['max_abs_err']}; "
          f"held {sorted(held)}; the polls on the plain versions against "
          f"the kernels' on "
          f"{len(plain_outs) + len(plain_p12)} streams: maxdiff {plain_diff} "
          f"LSB): {json.dumps(summary)} | card: {card}")
    if not got["floor_flat"] or any(
            held.get(k, {}).get("calls", 0) != n for k, n in got.items()):
        raise AssertionError(f"serve gate: launches {got}, held {held}")
    bad = {k: v for k, v in summary.items() if v["samples_over_2lsb"]}
    if bad:
        raise AssertionError(f"serve gate: samples over +/-{GATE_LSB} LSB "
                             f"in {bad}")
    print(f"serve gate p12 scheduler's programs (run eagerly under "
          f"held_kernels and plain_kernels, so none captured): "
          f"{json.dumps(serve_programs(sched))}, card MB "
          f"{json.dumps(device_mb())} | card: {card}")
    print("serve: " + json.dumps(serve_bench(dev, SERVE_ARGV))
          + f" | card: {card}")
    serve_soak(streams, dev, card)


#: the mesh phase: gloo ranks sharing card 0 at each (dp, tp), and NCCL at
#: one rank per card where the machine has two or more cards
MESH_GLOO = ((2, 1), (2, 2), (1, 3))
MESH_S, MESH_T, MESH_N = 256, 64, 2  # decode_chunk_sharded: headline width
MESH_TIMEOUT = 300.0  # seconds for each mesh's ranks, and each collective
MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "lewton_tpu_torch", "mesh_run")


def mesh_spec(copies: int, tp: int) -> list:
    """The cases every rank runs (parallel/launch.py ``cases``): the
    headline setup's chunks through decode_chunk_sharded (i16, one untimed
    warm-up run) through programs (at tp > 1 two segments a chunk around
    the tp all-reduce), captured in the warm-up, and run again eagerly
    (timed) after the timed run; then ``copies`` copies of each
    PERM_STREAMS stream through BatchDecoder(mesh=).decode_streams_i16 on
    the native front-end (its transfer slots' programs), run again under
    graphs.eager(); each case ``held``: run again after the timed run,
    every kernel launch held against its plain version on the same
    inputs."""
    return ([{"name": "chunk", "kind": "chunk", "setup": [2, 8, 11],
              "S": MESH_S, "T": MESH_T, "N": MESH_N, "seed": 3,
              "with_i16": True, "warmup": 1, "held": True,
              "programs": True}]
            + [{"name": f"perm_{n}", "kind": "streams",
                "file": os.path.join(GATE_DIR, f"{n}.ogg"),
                "lengths": [None] * copies, "chunk": 64, "i16": True,
                "held": True, "eager": True}
               for n in PERM_STREAMS])


def mesh_reference(dev, streams: dict) -> dict:
    """What each mesh is held to, on this process's card: the headline
    chunks unsharded (outputs on the host, the carry, ms per chunk), the
    f32 bound of the carry, and the unsharded BatchDecoder's PCM and
    launches on 2 copies of each PERM_STREAMS stream."""
    cs = compile_setup(*synthetic_headers(2, 8, 11), device=dev)
    frs = [to_dev(synthetic_frames(cs, T=MESH_T, S=MESH_S, seed=3 + i), dev)
           for i in range(MESH_N)]

    def run():
        carry = init_window_carry(cs.channels, cs.n1 // 2, MESH_S, dev)
        res = []
        for fr in frs:
            out, carry = decode_frames_core(cs, fr, carry, with_i16=True)
            res.append(out)
        return res, carry

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, carry = run()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / MESH_N
    bound = max(sum_order_bound(synthesize_spectra_tapped(cs, fr)[0])
                for fr in frs)
    perm = {}
    for name in PERM_STREAMS:
        headers, pcks = stream_packets(streams[name][0])
        dec = BatchDecoder(headers.ident, headers.setup, chunk=64,
                           device=dev, raw_headers=(headers.raw_ident,
                                                    headers.raw_setup))
        torch.cuda.synchronize()
        zero_launches()
        outs = dec.decode_streams_i16([pcks, pcks], transport="i16")
        if not np.array_equal(outs[0], outs[1]):
            raise AssertionError(f"mesh reference {name}: the two copies "
                                 "differ")
        perm[name] = (outs, ran(), dec.cs.n1)  # graphs on: replays too
    return {"chunks": [[x.cpu().numpy() for x in out] for out in res],
            "carry": [c.cpu().numpy() for c in carry], "ms": ms,
            "bound": 2.0 * bound, "perm": perm}


def mesh_check(label, dp, tp, out_dir, ref: dict, streams: dict) -> dict:
    """Hold one mesh's ranks to the unsharded decode: rank 0's gathered
    chunks within 1 LSB (out_len exact, the carry's pwr within 2 x the
    sum-order bound, plen/started exact); the tp ranks of each dp block,
    and every rank's gathered arrays, bit for bit (sha256); each rank's
    launches (K1 channel-major and K2 X once per chunk at tp = 1, K2's
    audio form at tp > 1); each PERM_STREAMS stream the unsharded decode's
    length, within 1 LSB of it and 0 samples over +/-2 LSB of libvorbis;
    every case's held run (the kernels held against their plain versions
    at the mesh's shapes, the run going on on the plain outputs) with the
    timed run's launches and the timed run's outputs bit for bit. Returns
    the launches of every rank summed by kernel form, and per form the
    held calls and largest difference."""
    recs = [json.load(open(os.path.join(out_dir, f"rank{r}.json")))
            for r in range(dp * tp)]
    with np.load(os.path.join(out_dir, "rank0.npz")) as z:
        got = {k: z[k] for k in z.files}
    worst = 0
    for i, (pcm, lens) in enumerate(ref["chunks"]):
        worst = max(worst, lsb_diff(got[f"chunk__out{i}_0"], pcm)[0])
        if got[f"chunk__out{i}_0"].shape != pcm.shape or worst > 1 or \
                not np.array_equal(got[f"chunk__out{i}_1"], lens):
            raise AssertionError(f"{label} chunk {i}: {worst} LSB from the "
                                 "unsharded decode, or out_len differs")
    dpwr = float(np.abs(got["chunk__carry_0"] - ref["carry"][0]).max())
    if dpwr > ref["bound"] or not all(
            np.array_equal(got[f"chunk__carry_{j}"], ref["carry"][j])
            for j in (1, 2)):
        raise AssertionError(f"{label}: carry pwr |d| {dpwr} > "
                             f"{ref['bound']} or plen/started differ")
    for name, rec0 in recs[0]["cases"].items():
        for r in recs:
            peer = next(q for q in recs if q["dp_rank"] == r["dp_rank"])
            if (r["cases"][name]["digest_block"]
                    != peer["cases"][name]["digest_block"]
                    or r["cases"][name]["digest_gathered"]
                    != rec0["digest_gathered"]):
                raise AssertionError(f"{label} {name}: rank {r['rank']} "
                                     "differs from its tp peers")
    # every case through programs (at tp > 1 two captured segments a chunk
    # around the tp all-reduce): the chunks one program a rank, and every
    # case bit for bit the rank's eager rerun
    for r in recs:
        c = r["cases"]["chunk"]
        for name, case in r["cases"].items():
            e = case["eager"]
            if not case["graphed"] or e["eager_maxdiff"] or any(
                    e[d] != case[d] for d in ("digest_block",
                                              "digest_gathered")):
                raise AssertionError(f"{label} {name} rank {r['rank']}: "
                                     f"programs {case['programs']}, eager "
                                     f"maxdiff {e['eager_maxdiff']}")
        if c["programs"]["captured"] != 1:
            raise AssertionError(f"{label} rank {r['rank']}: chunk programs "
                                 f"{c['programs']}")
    c = recs[0]["cases"]["chunk"]["programs"]
    graphed = (f"; decode_chunk_sharded through programs ({c['captured']} "
               f"captured a rank{' in two segments a chunk' if tp > 1 else ''}"
               f", {c['replays']} replays, pool {c['pool_mb']} MB) == the "
               "rank's eager run bit for bit; BatchDecoder(mesh=) through "
               "programs (" + ", ".join(
                   str(recs[0]["cases"][f"perm_{n}"]["programs"]["captured"])
                   for n in PERM_STREAMS)
               + " captured) == its run under graphs.eager() bit for bit")
    held = {}
    plain_diff = 0.0
    for r in recs:
        for name, case in r["cases"].items():
            h = case["held"]
            plain_diff = max(plain_diff, h["plain_maxdiff"])
            if h["plain_maxdiff"] or h["launches"] != case["launches"] or any(
                    h[d] != case[d] for d in ("digest_block",
                                              "digest_gathered")):
                raise AssertionError(
                    f"{label} {name} rank {r['rank']}: the run on the "
                    f"plain versions differs from the kernels' by "
                    f"{h['plain_maxdiff']}, or launched {h['launches']} "
                    f"against {case['launches']}")
            for form, c in h["calls"].items():
                if c["max_abs_err"]:
                    raise AssertionError(f"{label} {name} rank {r['rank']}:"
                                         f" {form} held at {c}")
                t = held.setdefault(form, {"calls": 0, "shapes": [],
                                           "max_abs_err": 0.0})
                t["calls"] += c["calls"]
                t["max_abs_err"] = max(t["max_abs_err"], c["max_abs_err"])
                t["shapes"] += [x for x in c["shapes"]
                                if x not in t["shapes"]]
    want = dict.fromkeys(COUNTERS, 0) | (
        {"floor": MESH_N, "overlap": MESH_N} if tp == 1
        else {"overlap_audio": MESH_N})
    total = dict.fromkeys(COUNTERS, 0)
    for r in recs:
        if r["cases"]["chunk"]["launches"] != want:
            raise AssertionError(f"{label} rank {r['rank']}: launches "
                                 f"{r['cases']['chunk']['launches']}, "
                                 f"expected {want}")
        for case in r["cases"].values():
            for k, v in case["launches"].items():
                total[k] += v
    perm = {}
    for name in PERM_STREAMS:
        want_outs, want_l, n1 = ref["perm"][name]
        golden = streams[name][1]
        outs = [v for k, v in sorted(got.items())
                if k.startswith(f"perm_{name}__stream")]
        # every copy against the unsharded decode's first (its copies
        # are bit for bit the same)
        lsb = max(lsb_diff(o, want_outs[0])[0] for o in outs)
        r = lsb_diff(outs[0][: golden.shape[0]], golden)
        perm[name] = {"maxdiff_golden": r[0], "over_2lsb": r[1],
                      "lsb_vs_unsharded": lsb}
        if len(outs) < 2 or any(o.shape != want_outs[0].shape for o in outs) \
                or lsb > 1 or r[1] or not 0 <= \
                outs[0].shape[0] - golden.shape[0] <= n1:
            raise AssertionError(f"{label} perm {name}: {perm[name]}, "
                                 f"lengths {[o.shape for o in outs]}")
        # tp = 1 runs the unsharded route on each block (K1 flat once a
        # chunk); at tp > 1 the tp IMDCT takes the generic stages, the f32
        # overlap-add and compact_i16: no kernel
        lw = dict.fromkeys(COUNTERS, 0) if tp > 1 else want_l
        for rr in recs:
            if rr["cases"][f"perm_{name}"]["launches"] != lw:
                raise AssertionError(
                    f"{label} perm {name} rank {rr['rank']}: launches "
                    f"{rr['cases'][f'perm_{name}']['launches']}, expected "
                    f"{lw}")
    ms = {"graph": [r["cases"]["chunk"]["ms_per_chunk"] for r in recs],
          "eager": [r["cases"]["chunk"]["eager"]["ms_per_chunk"]
                    for r in recs]}
    print(f"mesh {label}: decode_chunk_sharded S={MESH_S} T={MESH_T} "
          f"N={MESH_N} i16: {worst} LSB from the unsharded decode, carry "
          f"|d| {dpwr:.3g} <= {ref['bound']:.3g}, tp peers bit for bit; "
          f"launches per rank {recs[0]['cases']['chunk']['launches']}; "
          f"BatchDecoder(mesh=).decode_streams_i16 on PERM_STREAMS x "
          f"{max(2, dp)}: "
          f"{json.dumps(perm)}; every case again on the plain versions: "
          f"maxdiff {plain_diff} from the kernels' run, launches held "
          f"against their plain versions on the same inputs (all ranks): "
          f"{json.dumps(held)}{graphed}")
    return {"launches": total, "ms": ms, "held": held}


def mesh_phase(dev, card: str) -> dict:
    """decode_chunk_sharded and BatchDecoder(mesh=) on ranks started by
    parallel/launch.py: gloo ranks sharing card 0 at each MESH_GLOO (dp,
    tp), and NCCL at one rank per card (dp = cards, and (cards / 2, 2))
    where there are two or more cards. Each mesh is held to the unsharded
    decode on this process's card (mesh_check); prints ms per chunk of
    every rank beside the unsharded decode's. Returns the launches of every
    mesh summed by kernel form, and the largest difference of any held
    launch from its plain version, by form. Any rank's failure or timeout
    raises."""
    from lewton_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    streams = gate_streams()
    ref = mesh_reference(dev, streams)
    runs = [("gloo", dp, tp) for dp, tp in MESH_GLOO]
    n = torch.cuda.device_count()
    if n >= 2:
        runs += [("nccl", n, 1)] + ([("nccl", n // 2, 2)] if n % 2 == 0
                                    else [])
    total = dict.fromkeys(COUNTERS, 0)
    held = {}
    for backend, dp, tp in runs:
        label = f"{backend} dp={dp} tp={tp}"
        out = os.path.join(MESH_DIR, f"{backend}_{dp}x{tp}")
        os.makedirs(out, exist_ok=True)
        spec = os.path.join(out, "spec.json")
        with open(spec, "w") as f:
            json.dump({"cases": mesh_spec(max(2, dp), tp)}, f)
        ts = time.perf_counter()
        spawn(dp, tp, "cases", out, backend, dev.type, spec,
              timeout=MESH_TIMEOUT)
        secs = time.perf_counter() - ts
        res = mesh_check(label, dp, tp, out, ref, streams)
        for k, v in res["launches"].items():
            total[k] += v
        for k, c in res["held"].items():
            held[k] = max(held.get(k, 0.0), c["max_abs_err"])
        shared = ("ranks sharing one card" if backend == "gloo"
                  else "one rank per card")
        print(f"mesh {label} timing ({shared}; overhead, not scaling): "
              f"decode_chunk_sharded ms/chunk per rank through programs "
              f"{[round(m, 4) for m in res['ms']['graph']]}, eager "
              f"{[round(m, 4) for m in res['ms']['eager']]}, unsharded in "
              f"this process {ref['ms']:.4f}; ranks' run {secs:.1f} s | "
              f"card: {card}")
        for fn in os.listdir(out):
            os.remove(os.path.join(out, fn))
    if n < 2:
        print(f"mesh nccl: not run: this machine has {n} card(s); NCCL "
              "takes one rank per card, so a multi-card run needs two or "
              "more")
    print(f"mesh phase ({time.perf_counter() - t0:.1f} s): launches "
          f"{total}, held against the plain versions: max_abs_err {held}")
    if any(total[k] and k not in held for k in total):
        raise AssertionError(f"mesh: launched {total}, held only {held}")
    return total, held


#: the backends phase: the CPU decoders against the card's
CPU_BACKENDS = ("numpy", "native")
CAPI_STREAMS = ("stereo_44k_q3", "ch6_44k_q3")
TAP_STREAM, TAP_PACKETS = "tiny_44k", 8
#: tests/test_debug_taps.py's tolerances: residue and pre-MDCT taps, and
#: post-MDCT
TAP_ATOL, TAP_ATOL_POST = 2e-6, 1e-4
#: rows of the floor-curve check: floor1_curve_batch materialises four
#: [rows, C, P, W] compare-select tensors (bool and i32) at once, about
#: 0.75 GB at 1024 rows of the flagship (C 2, P 26, W 896)
CURVE_ROWS = 1024
RATE_STREAM, RATE_REPS = "stereo_44k_q3", 3
BACKENDS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "lewton_tpu_torch", "backends_run")


def cpu_name() -> str:
    """The host CPU's model (``/proc/cpuinfo``, else ``lscpu``, which also
    names Arm cores), its architecture and the cores this process sees."""
    name = None
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    if name is None:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=10).stdout
        except OSError:
            out = ""
        fields = dict(line.split(":", 1) for line in out.splitlines()
                      if ":" in line)
        name = " ".join(fields[k].strip() for k in ("Vendor ID", "Model name")
                        if k in fields) or "model not reported"
    return (f"{name}, {platform.machine()}, "
            f"{len(os.sched_getaffinity(0))} cores")


def backend_read(data: bytes, backend: str, dev) -> tuple:
    """read_all_i16 of a fresh reader: (interleaved i16, route)."""
    if backend == "native-packets":
        # the per-link loop (decode_many), which the one call hands back
        # its streams to
        r = OggStreamReader(data, backend="native")
        out = to_i16(r.read_all_planar_f32()).T
        return out, "packets"
    r = OggStreamReader(data, backend=backend, device=dev)
    out = r.read_all_i16()
    return out, r.native_route


def packet_loop(data: bytes, backend: str, dev) -> np.ndarray:
    """read_dec_packet to the end: interleaved i16 [samples, C]."""
    r = OggStreamReader(data, backend=backend, device=dev)
    outs = []
    while (p := r.read_dec_packet()) is not None:
        outs.append(p)
    return np.concatenate(outs, axis=1).T


def save_restore(data: bytes, backend: str, dev, at: int = 10,
                 n: int = 5) -> None:
    """A state saved after ``at`` packets and restored in a fresh reader
    positioned by packet count: the next ``n`` packets bit for bit."""
    r = OggStreamReader(data, backend=backend, device=dev)
    for _ in range(at):
        r.read_dec_packet()
    state = r.save_decode_state()
    want = [r.read_dec_packet() for _ in range(n)]
    r2 = OggStreamReader(data, backend=backend, device=dev)
    for _ in range(at):
        r2.read_next_audio_packet()
    r2.restore_decode_state(state)
    for i, w in enumerate(want):
        got = r2.read_dec_packet()
        if got.shape != w.shape or not np.array_equal(got, w):
            raise AssertionError(f"save/restore {backend}: packet {at + i} "
                                 "differs after the restore")


def capi_lib():
    """The port's C ABI (lewton_tpu.h) through ctypes, on the stable link
    C clients link against."""
    lib = ctypes.CDLL(str(_build.capi_library()))
    u8p, vp = ctypes.POINTER(ctypes.c_uint8), ctypes.c_void_p
    sz = ctypes.c_size_t
    for name, res, args in (
            ("lewton_context_from_extradata", vp, [u8p, sz]),
            ("lewton_context_reset", None, [vp]),
            ("lewton_decode_packet", ctypes.c_int,
             [vp, u8p, sz, ctypes.POINTER(vp)]),
            ("lewton_samples_count", sz, [vp]),
            ("lewton_samples_channels", sz, [vp]),
            ("lewton_samples_f32", ctypes.POINTER(ctypes.c_float), [vp, sz]),
            ("lewton_samples_drop", None, [vp]),
            ("lewton_context_drop", None, [vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def xiph_extradata(ident: bytes, comment: bytes, setup: bytes) -> bytes:
    def lace(n):
        return b"\xff" * (n // 255) + bytes([n % 255])
    return (bytes([2]) + lace(len(ident)) + lace(len(comment)) + ident
            + comment + setup)


def capi_packets(lib, ctx, pcks) -> np.ndarray:
    """Packets through lewton_decode_packet: planar f32 [C, n]."""
    chunks = []
    for p in pcks:
        buf = (ctypes.c_uint8 * len(p)).from_buffer_copy(p)
        out = ctypes.c_void_p()
        if lib.lewton_decode_packet(ctx, buf, len(p), ctypes.byref(out)):
            raise AssertionError("lewton_decode_packet refused an audio "
                                 "packet")
        n = lib.lewton_samples_count(out)
        if n:
            chunks.append(np.stack([np.ctypeslib.as_array(
                lib.lewton_samples_f32(out, c), (n,)).copy()
                for c in range(lib.lewton_samples_channels(out))]))
        lib.lewton_samples_drop(out)
    return np.concatenate(chunks, axis=1)


def capi_check(streams: dict, card: str) -> dict:
    """examples/capi_demo.c built by cc against the port's header and
    library, run on CAPI_STREAMS, its WAV within +/-2 LSB of the golden
    over the granule-trimmed range; through ctypes: lewton_context_reset
    gives the same PCM again, malformed extradata gives no context."""
    import wave

    root = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(BACKENDS_DIR, exist_ok=True)
    link = _build.capi_library()
    exe = os.path.join(BACKENDS_DIR, "capi_demo")
    subprocess.run(["cc", "-O2", os.path.join(root, "examples", "capi_demo.c"),
                    "-I", os.path.join(root, "lewton_tpu_torch", "native"),
                    "-L", str(link.parent), "-llewton_host", "-lm", "-o",
                    exe], check=True)
    res = {}
    for name in CAPI_STREAMS:
        data, golden, _ = streams[name]
        src = os.path.join(BACKENDS_DIR, name + ".ogg")
        wav = os.path.join(BACKENDS_DIR, name + ".wav")
        with open(src, "wb") as f:
            f.write(data)
        subprocess.run([exe, src, wav], check=True, timeout=120,
                       capture_output=True,
                       env=dict(os.environ, LD_LIBRARY_PATH=str(link.parent)))
        with wave.open(wav) as w:
            pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
            pcm = pcm.reshape(-1, w.getnchannels())
        if pcm.shape[0] < golden.shape[0] or pcm.shape[1] != golden.shape[1]:
            raise AssertionError(f"capi_demo {name}: {pcm.shape}, golden "
                                 f"{golden.shape}")
        res[name] = lsb_diff(pcm[:golden.shape[0]], golden)
        for f in (src, wav):
            os.remove(f)
    lib = capi_lib()
    headers, pcks = stream_packets(streams["tiny_44k"][0])
    rdr = PacketReader(streams["tiny_44k"][0])
    comment = [rdr.read_packet() for _ in range(2)][1].data
    ext = xiph_extradata(headers.raw_ident, comment, headers.raw_setup)
    ctx = lib.lewton_context_from_extradata(
        (ctypes.c_uint8 * len(ext)).from_buffer_copy(ext), len(ext))
    if not ctx:
        raise AssertionError("lewton_context_from_extradata refused good "
                             "extradata")
    first = capi_packets(lib, ctx, pcks[:4])
    lib.lewton_context_reset(ctx)
    again = capi_packets(lib, ctx, pcks[:4])
    lib.lewton_context_drop(ctx)
    if first.tobytes() != again.tobytes():
        raise AssertionError("lewton_context_reset: the same packets decode "
                             "differently after the reset")
    bad = bytes([3, 1, 1, 0, 0, 0])
    if lib.lewton_context_from_extradata(
            (ctypes.c_uint8 * len(bad)).from_buffer_copy(bad), len(bad)):
        raise AssertionError("lewton_context_from_extradata took malformed "
                             "extradata")
    print(f"backends capi: capi_demo.c built by cc against "
          f"lewton_tpu_torch/native/lewton_tpu.h and {link.name}; "
          + ", ".join(f"{k} maxdiff {v[0]} LSB, {v[1]} over +/-{GATE_LSB}"
                      for k, v in res.items())
          + "; reset and malformed extradata as expected | CPU: "
          + cpu_name())
    return res


def taps_check(streams: dict, dev, card: str) -> dict:
    """The numpy backend's debug taps on TAP_PACKETS packets of TAP_STREAM
    against decode_frames(with_taps=True) on the card; the same call
    through the device's single-stream program (the reference jits it with
    ``with_taps`` static), its capture and a replay each bit for bit the
    eager taps, PCM, out_len and carry, a profile of one replay (one
    ``cudaGraphLaunch``, no ``cudaLaunchKernel``) and its host and wall ms
    against ``graphs.eager()`` (``graphs timing taps``)."""
    data = streams[TAP_STREAM][0]
    with debug.taps() as t:
        r = OggStreamReader(data, backend="numpy")
        for _ in range(TAP_PACKETS):
            r.read_dec_packet()
    headers, pcks = stream_packets(data)
    pcks = pcks[:TAP_PACKETS]
    cs = compile_setup(headers.ident, headers.setup, device=dev)
    plans = [decode_packet_entropy(headers.ident, headers.setup, p)
             for p in pcks]
    fr = frames_to_device(pack_frames(cs, plans, len(pcks)), dev)
    carry = tuple(c[0] for c in init_window_carry(cs.channels, cs.n1 // 2, 1,
                                                  dev))
    eager = decode_frames(cs, fr, carry, with_taps=True)
    (_, _, taps), _ = eager
    owner = graphs.stream_programs(dev)
    for call in ("capture", "replay"):
        (pcm, lens, ptaps), pcarry = decode_frames(
            cs, fr, carry, with_taps=True, programs=owner)
        same_bits([pcm, lens, *ptaps.values(), *pcarry],
                  [*eager[0][:2], *taps.values(), *eager[1]],
                  f"taps program ({call})")
    prog = decoder.frames_program(owner, cs, fr, carry, with_taps=True)
    if prog.graph is None or prog.replays != 1:
        raise AssertionError(f"taps program: captured {prog.graph is not None}"
                             f", {prog.replays} replays")
    profile = replay_profile("taps", prog, 1, card)
    if not profile:
        raise AssertionError("taps program: no profile of its replay")
    graph_ab("taps", prog, fr, carry, 1, card)
    err = {}
    for k in debug.TAP_NAMES:
        got = taps[k].cpu().numpy()
        if len(t[k]) != len(pcks):
            raise AssertionError(f"taps {k}: {len(t[k])} records for "
                                 f"{len(pcks)} packets")
        e = 0.0
        for i, ref in enumerate(t[k]):
            n = ref.shape[1] if k == "post_mdct" else min(ref.shape[1],
                                                          cs.w_eff)
            e = max(e, float(np.abs(got[i, :, :n] - ref[:, :n]).max()))
            if k != "post_mdct" and np.any(ref[:, cs.w_eff:]):
                raise AssertionError(f"taps {k}[{i}]: values past w_eff")
        err[k] = e
        tol = TAP_ATOL_POST if k == "post_mdct" else TAP_ATOL
        if e > tol:
            raise AssertionError(f"taps {k}: max abs err {e} > {tol}")
    print(f"backends taps ({TAP_STREAM}, {len(pcks)} packets, numpy "
          f"backend vs decode_frames(with_taps=True) on the card): "
          + ", ".join(f"{k} {v:.3g}" for k, v in err.items())
          + f" (tolerances {TAP_ATOL} / {TAP_ATOL_POST} post-MDCT); through "
          f"a program (capture {prog.capture_s:.3f} s, pool "
          f"{prog.pool_mb:.1f} MB): the capture and a replay bit for bit the "
          f"eager taps, PCM and carry | card: {card}")
    return err


def curves_check(dev, card: str) -> dict:
    """floor1_curve_batch and floor1_curve_mxu on the card at the flagship
    width (CURVE_ROWS rows of synthetic frames): bit for bit equal to each
    other and to their CPU results; ms of each."""
    cs = compile_setup(*synthetic_headers(2, 8, 11), device=dev)
    fr = {k: v[0] for k, v in
          synthetic_frames(cs, T=CURVE_ROWS, S=1, seed=7).items()}
    mode = torch.from_numpy(fr["mode"].astype(np.int32))
    args = [cs.f1_xs.cpu()[mode.long()], torch.from_numpy(fr["f1_ys"]),
            torch.from_numpy(fr["f1_flags"]),
            cs.f1_mult.cpu()[mode.long()]]
    W = cs.w_eff
    step = cs.f1_step.cpu()
    on = [a.to(dev) for a in args]
    mode_d = mode.to(dev)

    def batch(a):
        return floor1_curve_batch(*a, W)

    def mxu(a, m, st):
        return floor1_curve_mxu(*a, m, st, W)

    got = {"batch": batch(on), "mxu": mxu(on, mode_d, cs.f1_step)}
    want = {"batch": batch(args), "mxu": mxu(args, mode, step)}
    ref = want["batch"]
    for k in got:
        for label, t in (("card", got[k].cpu()), ("cpu", want[k])):
            if not _same_bits(t, ref):
                raise AssertionError(f"floor curve {k} on the {label} "
                                     f"differs from floor1_curve_batch on "
                                     "the CPU")
    ms = {"batch": cuda_ms(lambda: batch(on), 5),
          "mxu": cuda_ms(lambda: mxu(on, mode_d, cs.f1_step), 20)}
    rows, C, P = args[0].shape
    print(f"backends floor curves: floor1_curve_batch and floor1_curve_mxu "
          f"at rows={rows} C={C} P={P} W={W} (synthetic_headers(2, 8, 11)) "
          f"bit for bit on the card, with each other and with the CPU; ms "
          f"per call batch {ms['batch']:.4f}, mxu {ms['mxu']:.4f} | card: "
          f"{card}")
    return ms


def host_rates(streams: dict, dev, card: str) -> dict:
    """x_realtime of read_all_i16 on RATE_STREAM: the numpy and native
    backends on the CPU, the torch backend on the card (medians of
    RATE_REPS after one warm-up)."""
    data, golden, _ = streams[RATE_STREAM]
    rate = OggStreamReader(data, backend="numpy").ident_hdr.sample_rate
    audio_s = golden.shape[0] / rate
    res = {}
    for backend in ("numpy", "native", "torch"):
        backend_read(data, backend, dev)
        secs = []
        for _ in range(RATE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            backend_read(data, backend, dev)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        res[backend] = audio_s / statistics.median(secs)
    print(f"backends host rates ({RATE_STREAM}, {audio_s:.2f} s of audio, "
          f"read_all_i16 of a fresh reader, median of {RATE_REPS}): numpy "
          f"{res['numpy']:.1f} x_realtime, native {res['native']:.1f} "
          f"x_realtime (CPU: {cpu_name()}), torch {res['torch']:.1f} "
          f"x_realtime (card: {card})")
    return res


def backends_phase(dev, card: str) -> tuple[dict, dict]:
    """The reader's three backends on the 38 gate streams: numpy and native
    (one call, and the per-link loop) on the CPU, torch on the card with
    every K1 and K2 launch held bit for bit against its plain version
    (``launch.held_kernels``); each output exact in length with 0 samples
    over +/-2 LSB of libvorbis, and the largest difference of each pair of
    backends. On PERM_STREAMS also read_dec_packet to the end and a
    mid-stream save/restore on each backend. Then the C ABI, the debug
    taps, the floor curves and the host rates. Returns the torch backend's
    launches and the held calls' largest error by kernel form."""
    t0 = time.perf_counter()
    streams = gate_streams()
    names = ("numpy", "native", "native-packets", "torch")
    routes = {"one-call": [], "packets": []}
    pair_max = {}
    torch.cuda.synchronize()
    zero_launches()
    held: dict = {}
    torch_s = 0.0
    for name, (data, golden, kind) in streams.items():
        outs = {}
        for b in names:
            ts = time.perf_counter()
            if b == "torch":
                with held_kernels(held):
                    out, _ = backend_read(data, b, dev)
                torch_s += time.perf_counter() - ts
            else:
                out, route = backend_read(data, b, dev)
                if b == "native":
                    routes[route].append(name)
            if out.shape != golden.shape:
                raise AssertionError(f"backends {b} {name}: shape "
                                     f"{out.shape}, golden {golden.shape}")
            outs[b] = out
        diffs = {b: lsb_diff(o, golden) for b, o in outs.items()}
        pairs = {f"{a}-{b}": lsb_diff(outs[a], outs[b])[0]
                 for i, a in enumerate(names) for b in names[i + 1:]}
        for k, v in pairs.items():
            pair_max[k] = max(pair_max.get(k, 0), v)
        print(f"backends {name} ({kind}): {golden.shape[0]} samples x "
              f"{golden.shape[1]} ch; vs libvorbis maxdiff/over +/-"
              f"{GATE_LSB}: " + ", ".join(f"{b} {d[0]}/{d[1]}"
                                          for b, d in diffs.items())
              + "; pairs maxdiff: " + ", ".join(f"{k} {v}"
                                                for k, v in pairs.items()))
        bad = {b: d for b, d in diffs.items() if d[1]}
        if bad:
            raise AssertionError(f"backends {name}: samples over "
                                 f"+/-{GATE_LSB} LSB: {bad}")
    for name in PERM_STREAMS:
        data, golden, _ = streams[name]
        for b in ("numpy", "native", "torch"):
            with held_kernels(held):
                out = packet_loop(data, b, dev)
                save_restore(data, b, dev)
            d = lsb_diff(out, golden)
            if out.shape != golden.shape or d[1]:
                raise AssertionError(f"backends packets {b} {name}: shape "
                                     f"{out.shape}, {d[1]} samples over "
                                     f"+/-{GATE_LSB}")
        print(f"backends packets {name}: read_dec_packet to the end on "
              f"numpy, native and torch exact in length, 0 over +/-"
              f"{GATE_LSB}; save/restore after 10 packets bit for bit on "
              "each")
    torch.cuda.synchronize()
    got = launches()
    for k in ("floor", "overlap"):
        if not got[k] or held.get(k, {}).get("calls") != got[k]:
            raise AssertionError(f"backends: {k} launched {got[k]} times, "
                                 f"held {held.get(k, {}).get('calls')}")
    err = {k: c["max_abs_err"] for k, c in held.items()}
    if any(err.values()):
        raise AssertionError(f"backends: held launches differ from the "
                             f"plain versions: {err}")
    print(f"backends gate ({len(streams)} streams, torch backend "
          f"{torch_s:.1f} s with every launch held): launches {got}, held "
          f"against the plain versions (calls, max_abs_err): "
          + ", ".join(f"{k} {c['calls']}, {c['max_abs_err']}"
                      for k, c in held.items())
          + f"; pairs maxdiff {json.dumps(pair_max)}; native routes: "
          f"one-call {len(routes['one-call'])} streams, packets "
          f"{len(routes['packets'])} {routes['packets']} | card: {card}")
    summary = {"streams": len(streams), "launches": got,
               "native_routes": {k: len(v) for k, v in routes.items()},
               "pairs_maxdiff": pair_max}
    summary["capi"] = capi_check(streams, card)
    summary["taps"] = taps_check(streams, dev, card)
    summary["floor_curves_ms"] = curves_check(dev, card)
    summary["x_realtime"] = host_rates(streams, dev, card)
    print(f"backends phase ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps(summary)}")
    return got, err


#: the bench surfaces (``python -m lewton_tpu_torch.bench``) at the
#: reference's defaults, in-process: (label, argv)
BENCH_SURFACES = (("synthesis", []), ("check", ["--check"]),
                  ("e2e", ["--e2e"]), ("serve", ["--serve"]),
                  ("frontend", ["--frontend"]))
BENCH_CLI_TIMEOUT = 300.0  # seconds for the bench's CLI run in a subprocess


def bench_launch_check(label: str, line: dict, got: dict, rep: dict,
                       held: dict) -> None:
    """Raise unless a bench surface launched what its path launches
    (``got`` through the wrappers, ``rep`` by replayed graphs): the
    synthesis K1 channel-major and K2 X scan times in the warm-up call
    through the wrappers, which also captures the call's program, and scan
    x iters times in its replays, nothing else; the check within the
    contract, every launch held bit for bit against its plain version (so
    none replayed); e2e (device compaction) and serve K1 flat; the
    host-only front-end nothing."""
    d = line["detail"]
    if label == "synthesis":
        n = d["scan"]
        zero = dict.fromkeys(got, 0)
        want = (zero | {"floor": n, "overlap": n},
                zero | {"floor": n * d["iters"], "overlap": n * d["iters"]})
        if (got, rep) != want:
            raise AssertionError(f"bench {label}: launches {got}, replayed "
                                 f"{rep}, expected {want}")
    elif label == "check":
        if any(rep.values()):
            raise AssertionError(f"bench check: a graph replayed {rep} "
                                 "where every launch is held")
        if line["value"] > GATE_LSB or d["samples_over_2lsb"] or any(
                r["samples_over_2lsb"]
                for r in d["production_permutations"].values()):
            raise AssertionError(f"bench check over the contract: {line}")
        for k, n in got.items():
            if held.get(k, {}).get("calls", 0) != n:
                raise AssertionError(f"bench check: {k} launched {n} times, "
                                     f"held {held.get(k)}")
        if not (got["floor"] and got["floor_flat"] and got["overlap"]):
            raise AssertionError(f"bench check: launches {got}")
        if any(c["max_abs_err"] for c in held.values()):
            raise AssertionError(f"bench check: held launches differ from "
                                 f"the plain versions: {held}")
    elif label in ("e2e", "serve"):
        if not got["floor_flat"] + rep["floor_flat"]:
            raise AssertionError(f"bench {label}: K1 flat never launched "
                                 f"({got}, replayed {rep})")
    elif any(got.values()) or any(rep.values()):
        raise AssertionError(f"bench {label}: the host-only surface "
                             f"launched {got}, replayed {rep}")


@contextlib.contextmanager
def card_samples(into: dict):
    """nvidia-smi sampling the card's SM clock (MHz) and power draw (W)
    every 100 ms for the block; ``into`` gets the median clock and the
    largest draw. The sampler is stopped in a ``finally``."""
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        yield into
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    rows = [tuple(map(float, r.split(","))) for r in out.splitlines()
            if r.count(",") == 1 and "[" not in r]
    into["sm_mhz_median"] = (statistics.median(r[0] for r in rows)
                             if rows else None)
    into["power_w_max"] = max((r[1] for r in rows), default=None)


def synthesis_methods(line: dict, cs, fr0, carry0, card: str) -> None:
    """Just after the bench's headline, its shape (the main path's frames
    ``fr0``) timed four ways: the carry chained from call to call (as the
    bench) or ``carry0`` each call (as ``path_rate``), one synchronize
    after the --iters calls (as the bench) or one after each (as
    ``path_rate``), one warm-up call each. Each way: wall ms per chunk over
    all calls, device ms per chunk from CUDA events around each call
    (median, first, last), the card's SM clock and power draw while it
    ran; and the host's enqueue of one chunk. Where the ways' device ms
    differ, the card ran the same work slower; where only the wall
    differs, the host did."""
    d = line["detail"]
    n, iters = d["scan"], d["iters"]
    frs = expand(fr0, n)
    ways = {}
    for chained, each in ((True, False), (False, True), (False, False),
                          (True, True)):
        decode_chunks_scan(cs, frs, carry0, with_i16=True)
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        c, way = carry0, {}
        with card_samples(way):
            t0 = time.perf_counter()
            for start, end in events:
                start.record()
                _, out_carry = decode_chunks_scan(cs, frs, c, with_i16=True)
                end.record()
                c = out_carry if chained else carry0
                if each:
                    torch.cuda.synchronize()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev_ms = [a.elapsed_time(b) / n for a, b in events]
        ways[f"{'chained' if chained else 'fresh'} carry, synchronize "
             f"{'each call' if each else 'once'}"] = way | {
            "wall_ms_per_chunk": wall / (iters * n) * 1e3,
            "device_ms_per_chunk": statistics.median(dev_ms),
            "device_ms_first": dev_ms[0], "device_ms_last": dev_ms[-1]}
    host = host_enqueue_ms(cs, expand(fr0, 1), carry0)
    print(f"bench synthesis four ways (same shape, just after: {iters} "
          f"calls of {n} chunks each; the bench line read "
          f"{d['wall_s'] / (iters * n) * 1e3:.4f} ms/chunk): "
          f"{json.dumps(ways)}; host enqueue of one chunk {host:.4f} ms | "
          f"card: {card}")


def bench_phase(dev, card: str, cs, fr0, carry0) -> tuple[dict, dict, dict]:
    """The five bench surfaces in-process at the reference's defaults, the
    launch counts set to 0 before each and read after
    (``bench_launch_check``): the check's launches each held against
    their plain version (``launch.held_kernels``), the serve surface
    through ``serve_bench`` (counted over its timed wave, every output
    held to its golden and to a wave on the plain versions), the headline
    followed by ``synthesis_methods`` on the main path's frames (``cs``,
    ``fr0``, ``carry0``). Then ``python -m lewton_tpu_torch.bench
    --frontend`` once in a subprocess: the CLI stands alone. Returns the
    launches summed over the surfaces and the held calls' largest error by
    kernel form."""
    t0 = time.perf_counter()
    total = dict.fromkeys(COUNTERS, 0)
    total_rep = dict.fromkeys(COUNTERS, 0)
    held: dict = {}
    for label, argv in BENCH_SURFACES:
        torch.cuda.synchronize()
        zero_launches()
        ts = time.perf_counter()
        programs = graphs.Programs()  # the headline's
        if label == "serve":
            line = serve_bench(dev, argv)
        else:
            with held_kernels(held) if label == "check" else \
                    contextlib.nullcontext():
                line = bench.main(argv, programs=programs)
        torch.cuda.synchronize()
        got, rep = launches(), replayed()
        print(f"bench {label} (python -m lewton_tpu_torch.bench "
              f"{' '.join(argv)}; {time.perf_counter() - ts:.1f} s, launches "
              f"{json.dumps({k: v for k, v in got.items() if v})}, replayed "
              f"{json.dumps({k: v for k, v in rep.items() if v})}): "
              f"{json.dumps(line)} | card: {card}")
        bench_launch_check(label, line, got, rep, held)
        total = {k: total[k] + got[k] for k in total}
        total_rep = {k: total_rep[k] + rep[k] for k in total_rep}
        if label == "synthesis":
            # the headline's own program: its recorded launches against a
            # profile of one replay
            (prog,) = programs.programs.values()
            replay_profile("bench headline", prog, line["detail"]["scan"],
                           card)
            del prog, programs
            synthesis_methods(line, cs, fr0, carry0, card)
    ts = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "lewton_tpu_torch.bench", "--frontend"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=BENCH_CLI_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError("python -m lewton_tpu_torch.bench --frontend "
                             f"exited {proc.returncode}: {proc.stderr[-3000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if line["metric"] != "entropy_frontend_packets_per_s":
        raise AssertionError(f"bench CLI: {line}")
    print(f"bench frontend CLI (python -m lewton_tpu_torch.bench --frontend "
          f"in a subprocess, {time.perf_counter() - ts:.1f} s): "
          f"{json.dumps(line)} | card: {card}")
    print(f"bench phase ({time.perf_counter() - t0:.1f} s): launches "
          f"{json.dumps(total)}, replayed {json.dumps(total_rep)}; the "
          f"check's held (calls, max_abs_err): "
          + ", ".join(f"{k} {c['calls']}, {c['max_abs_err']}"
                      for k, c in held.items()))
    return total, total_rep, {k: c["max_abs_err"] for k, c in held.items()}


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
    # the main path's N chunks as one program, as the bench's headline
    fast = path_rate(cs, frs, carry0, True, False, 5,
                     programs=graphs.Programs())
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
    print(f"main path chunk: {fast[2]:.4f} ms (N={N} chunks as one "
          f"program, its graph replayed), eager host enqueue of one chunk "
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

    # ---- 6b. the chunk programs: graph against eager ----
    _, stream_launches = graphs_phase(dev, card, cs, fr0, carry0)

    # ---- 7. the conformance gate on the committed streams ----
    conformance(dev, card)

    # ---- 8. the serving scheduler ----
    serve_phase(dev, card)

    # ---- 9. multi-device sharding: ranks of a (dp, tp) mesh ----
    mesh_launches, mesh_err = mesh_phase(dev, card)

    # ---- 10. the reader's backends: numpy and native (CPU), torch ----
    backends_launches, backends_err = backends_phase(dev, card)

    # ---- 11. the bench surfaces: python -m lewton_tpu_torch.bench ----
    bench_launches, bench_replayed, bench_err = bench_phase(dev, card, cs,
                                                            fr0, carry0)

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
            # launches: the path's own drive; launches_mesh: the mesh
            # phase's, summed over its ranks; launches_stream: the gate's
            # single-stream reads through programs (wrappers and
            # replays; graphs_stream); launches_backends: the
            # backends phase's torch backend; launches_bench: the bench
            # surfaces', summed, through the wrappers, and
            # launches_bench_replayed by their replayed graphs (the
            # launches each recorded at capture, held to a profile of one
            # replay of the headline's program)
            "launches": n_launch, "launches_mesh": mesh_launches[key],
            "launches_stream": stream_launches[key],
            "launches_backends": backends_launches[key],
            "launches_bench": bench_launches[key],
            "launches_bench_replayed": bench_replayed[key],
            "max_abs_err": max(err[key], mesh_err.get(key, 0.0),
                               backends_err.get(key, 0.0),
                               bench_err.get(key, 0.0)),
            "ms": times[key], "plain_ms": times[f"{key}_plain"],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            # no single PyTorch call computes any of these functions
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
