"""Multi-stream batching and multi-device sharding
(lewton_tpu/parallel/batch.py).

Streams are independent and decoded in lockstep by one call per chunk
(the stream axis is explicit in the core, no ``vmap``). Packet time is
sequential through the window carry, so N chunks run in order, the carry
chained from each to the next. The reference makes each of its chunk
programs (``decode_chunk_batch``, ``decode_chunks_scan`` and the packed
forms) one ``jax.jit``-compiled device dispatch, a ``lax.scan`` over the N
chunks: the host pays one dispatch for N chunks. The port's counterpart is
a captured CUDA graph replayed per call (``graphs.ChunkProgram``): pass
``programs=`` (a ``graphs.Programs``, the owner's cache) to
:func:`decode_chunks_scan`, :func:`decode_chunk_batch` or the packed
functions. Without it they run eagerly and return fresh outputs; with it,
the outputs are the program's own buffers, valid until its next run, and
the carry is the owner's, valid until the next run of any of its programs
with that carry layout (``graphs``' lifetime).

The transport is the reference's: the nine small frame arrays travel as
three flat buffers (one per dtype) beside the residue, which may be 12-bit
packed (``pack12.py``), and are re-viewed on the device
(:func:`unpack_frame_buffers`). :class:`BatchDecoder` is the serving-shaped
entry: each stream's packets in, PCM per stream out, its host front-end
pipelined against the device through pinned double buffers (the native
front-end writes its frames into them, already packed), non-blocking
copies and a side stream for the device-to-host copies
(:class:`TransferSlots`, which ``serve.StreamingScheduler``'s groups use
too). Each group of chunks goes through a program of the transfer slots:
the host-to-device copies land in its static inputs, and its graph replays.
:class:`MixedBatchDecoder` takes a batch whose streams have different
setups: a ``BatchDecoder`` per setup, kept across calls, all driven by the
one group loop (:func:`_decode_groups`), so the pipeline runs on across a
switch of setup as between two groups of one setup.

Sharding follows the reference's (dp, tp) mesh in PyTorch's idiom: one
process per rank under ``torch.distributed`` and a ``DeviceMesh`` with dims
("dp", "tp") (:func:`make_mesh`), in place of JAX's single-controller
``shard_map``. dp shards the stream batch (each rank decodes its block of
S / dp streams, no collective inside a chunk); tp shards the IMDCT's
contraction axis, and an all-reduce over the tp group rebuilds each block
(:func:`_imdct_tp`). :func:`decode_chunk_sharded` returns the global
outputs on every rank (an all-gather over dp); ``BatchDecoder(mesh=)``
entropy-decodes only the rank's block and gathers the host PCM at the end.
``parallel/launch.py`` starts the ranks. The mesh's chunks run as programs
like any other (``decode_chunk_sharded(programs=)``, and
``BatchDecoder(mesh=)``'s transfer slots), the all-gather over dp outside
them. At tp > 1 the tp all-reduce sits inside the chunk, and gloo's
collectives cannot be captured: a chunk runs as two captured segments
around it (``graphs.SegmentedProgram``, :func:`_tp_steps`), the
all-reduce eagerly between their replays.
"""

from __future__ import annotations

import functools
import os
import time
from concurrent import futures
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from .. import native, profiling
from ..errors import BadHeader, VorbisError
from ..header import read_header_ident, read_header_setup
from ..models.decoder import (CompiledSetup, StreamDecoder,
                              decode_frames_core, finish_stream,
                              frames_to_device, host_threads,
                              predict_out_lens, routing_flags,
                              synthesize_local)
from ..ops.imdct import imdct_batch
from ..ops.windowing import init_window_carry
from . import graphs
from .pack12 import p12_auto, pack12_np, pack12_supported, unpack12

__all__ = ["make_mesh", "mesh_device", "decode_chunk_batch",
           "decode_chunks_scan", "scan_program", "decode_chunk_sharded",
           "pack_frame_buffers", "unpack_frame_buffers", "packed_program",
           "decode_chunk_batch_packed", "decode_chunk_batch_packed_i16",
           "decode_chunks_scan_packed", "decode_chunks_scan_packed_i16",
           "TransferSlots", "BatchDecoder", "MixedBatchDecoder"]


def _chunk(frs: dict, i: int) -> dict:
    """Chunk i of frames with leaves [N, ...] (``f1_brackets`` is a tuple)."""
    return {k: tuple(b[i] for b in v) if isinstance(v, tuple) else v[i]
            for k, v in frs.items()}


def _scan_outputs(cs: CompiledSetup, N: int, S: int, T: int, with_i16: bool,
                  compact_cap, device, pcm=None) -> tuple:
    """The outputs of N chunks: (out, lens i32 [N, S, T]), out i16
    [N, S, T, C*3n1/4] with ``with_i16``, else f32 [N, S, T, C, 3n1/4]; with
    ``compact_cap``, (pcm i16 [N, S, cap, C], totals i32 [N, S], lens).
    ``pcm``: a buffer of the first output's dtype whose leading elements
    hold it (a view), in place of a fresh one."""
    def first(shape, dtype):
        if pcm is None:
            return torch.empty(shape, dtype=dtype, device=device)
        return pcm.view(-1)[: int(np.prod(shape))].view(shape)
    lens = torch.empty((N, S, T), dtype=torch.int32, device=device)
    if compact_cap is not None:
        return (first((N, S, compact_cap, cs.channels), torch.int16),
                torch.empty((N, S), dtype=torch.int32, device=device), lens)
    outw = 3 * cs.n1 // 4
    out = (first((N, S, T, cs.channels * outw), torch.int16) if with_i16
           else first((N, S, T, cs.channels, outw), torch.float32))
    return out, lens


def _scan_into(cs: CompiledSetup, frs: dict, carry, outs: tuple,
               with_i16: bool = False, compact_cap=None, plain: bool = False,
               imdct=imdct_batch):
    """Decode the N chunks of ``frs`` (leaves [N, S, T, ...]) in order,
    chunk i into ``outs``' slices i (:func:`_scan_outputs`' layout), the
    carry chained; returns the final carry."""
    for i in range(frs["mode"].shape[0]):
        fr = _chunk(frs, i)
        if compact_cap is None:
            (_, out_len), carry = decode_frames_core(
                cs, fr, carry, with_i16=with_i16, plain=plain, out=outs[0][i],
                imdct=imdct)
        else:
            (outs[0][i], outs[1][i], out_len), carry = decode_frames_core(
                cs, fr, carry, compact_cap=compact_cap, plain=plain,
                imdct=imdct)
        outs[-1][i] = out_len
    return carry


def _tp_steps(cs: CompiledSetup, frames, N: int, S: int, T: int, carry,
              outs: tuple, with_i16: bool, compact_cap, plain: bool, imdct):
    """The steps of a ``graphs.SegmentedProgram`` that decodes N chunks
    through ``imdct``, a transform with a collective (:class:`_TPImdct`),
    into ``outs`` (:func:`_scan_outputs`' layout) from the static
    ``carry``: per chunk, the segment before the collective
    (``synthesize_local``, its audio and blockflag copied into static
    buffers), the collective on that audio, and the segment after it
    (``finish_stream`` into the chunk's outputs, the new carry copied into
    ``carry``); the ops of :func:`_scan_into` with that ``imdct``, in its
    order. ``frames(i)``: chunk i's frames, made from the static inputs
    inside each segment."""
    rows, dev = S * T, cs.device
    mid = (torch.empty((rows, cs.channels, cs.n1), dtype=torch.float32,
                       device=dev),
           torch.empty(rows, dtype=cs.mode_blockflag.dtype, device=dev))

    def pre(i):
        audio, bf = synthesize_local(cs, frames(i), imdct.local, plain)
        mid[0].copy_(audio)
        mid[1].copy_(bf)

    def post(i):
        fr = frames(i)
        if compact_cap is None:
            (_, out_len), new = finish_stream(cs, *mid, fr, carry, with_i16,
                                              plain=plain, out=outs[0][i])
        else:
            (outs[0][i], outs[1][i], out_len), new = finish_stream(
                cs, *mid, fr, carry, compact_cap=compact_cap, plain=plain)
        outs[-1][i] = out_len
        for st, c in zip(carry, new):
            st.copy_(c)
    return [step for i in range(N) for step in (
        (True, functools.partial(pre, i)),
        (False, functools.partial(imdct.collective, mid[0])),
        (True, functools.partial(post, i)))]


def _program(programs: graphs.Programs, cs: CompiledSetup, frames, inputs,
             carry, outs: tuple, with_i16: bool, compact_cap, plain: bool,
             imdct, key):
    """The program of ``key`` over ``inputs`` (its static inputs' layout)
    that decodes the chunks ``frames(static inputs)`` (leaves [N, S, T,
    ...]) into ``outs``: one graph (:func:`_scan_into`), or, when
    ``imdct`` holds a collective, two segments a chunk around it
    (:func:`_tp_steps`)."""
    if getattr(imdct, "collective", None) is None:
        def body(ins, c, o):
            return _scan_into(cs, frames(ins), c, o, with_i16, compact_cap,
                              plain, imdct)
        return graphs.ChunkProgram(programs, body, inputs, carry, outs, key)
    N, S, T = outs[-1].shape

    def steps(ins, c, o):
        return _tp_steps(cs, lambda i: _chunk(frames(ins), i), N, S, T, c,
                         o, with_i16, compact_cap, plain, imdct)
    return graphs.SegmentedProgram(programs, steps, inputs, carry, outs, key)


def scan_program(programs: graphs.Programs, cs: CompiledSetup, frs: dict,
                 carry, with_i16: bool = False, compact_cap=None,
                 plain: bool = False, imdct=imdct_batch):
    """The program of ``programs`` that decodes N chunks of frames with
    ``frs``' layout (leaves [N, S, T, ...]) from ``carry``'s layout, made
    at its first use: the counterpart of the reference's jitted
    ``decode_chunks_scan``, keyed as ``graphs`` says (a mesh's tp
    transform by the tp size and the rank's place in its group). Call it
    as ``prog(frs, carry)`` -> ((out, lens) or (pcm, totals, lens),
    carry)."""
    key = ("scan", id(cs), bool(with_i16), compact_cap, plain, imdct,
           graphs.signature(frs), routing_flags())

    def make():
        N, S, T = frs["mode"].shape
        outs = _scan_outputs(cs, N, S, T, with_i16, compact_cap, cs.device)
        return _program(programs, cs, lambda ins: ins, frs, carry, outs,
                        with_i16, compact_cap, plain, imdct, key)
    return programs.get(key, make)


def decode_chunk_batch(cs: CompiledSetup, fr: dict, carry,
                       with_i16: bool = False, compact_cap=None,
                       programs: graphs.Programs | None = None, **kw):
    """One chunk for S streams (the reference's jitted
    ``decode_chunk_batch``): :func:`decode_frames_core`'s results, ``kw``
    its ``with_taps``, ``plain``, ``out`` and ``imdct``. With ``programs``
    the chunk runs as a one-chunk program of that cache (neither
    ``with_taps`` nor ``out`` taken): its outputs are the program's own
    buffers, valid until its next run, and its carry the owner's, valid
    until the next run of any of its programs with that carry layout."""
    if programs is None:
        return decode_frames_core(cs, fr, carry, with_i16, compact_cap, **kw)
    if kw.get("with_taps") or kw.get("out") is not None:
        raise ValueError("a program takes neither with_taps nor out")
    frs = {k: tuple(b[None] for b in v) if isinstance(v, tuple) else v[None]
           for k, v in fr.items()}
    outs, carry = scan_program(programs, cs, frs, carry, with_i16,
                               compact_cap, **kw)(frs, carry)
    return tuple(o[0] for o in outs), carry


def decode_chunks_scan(cs: CompiledSetup, frs: dict, carry,
                       with_i16: bool = False, plain: bool = False,
                       imdct=imdct_batch,
                       programs: graphs.Programs | None = None):
    """Decode N chunks in one dispatch, the reference's contract: frs
    leaves [N, S, T, ...], the window carry chained chunk to chunk. Returns
    ((out, out_len i32 [N, S, T]), final carry), out i16 [N, S, T,
    C*3n1/4] with ``with_i16``, else f32 [N, S, T, C, 3n1/4]; each chunk's
    samples are written into its slice of ``out``. ``imdct``: passed to
    every chunk's :func:`decode_frames_core` (a caller's transform, as the
    reference's ``_batch_core`` passes it).

    With ``programs`` (a ``graphs.Programs``) the N chunks run as one
    program of that cache (:func:`scan_program`): captured as a CUDA graph
    at the first call on a card and replayed, one host dispatch for all N
    chunks, as the reference's ``jax.jit`` over ``lax.scan``. Its outputs
    are then the program's own buffers, valid until its next run, and its
    carry the owner's, valid until the next run of any of its programs
    with that carry layout. Without it the chunks are enqueued one op at a
    time into fresh outputs."""
    if programs is not None:
        return scan_program(programs, cs, frs, carry, with_i16, plain=plain,
                            imdct=imdct)(frs, carry)
    N, S, T = frs["mode"].shape
    outs = _scan_outputs(cs, N, S, T, with_i16, None, frs["mode"].device)
    return outs, _scan_into(cs, frs, carry, outs, with_i16, plain=plain,
                            imdct=imdct)


# ---------------------------------------------------------------------------
# Multi-device sharding: a (dp, tp) DeviceMesh over torch.distributed, one
# process per rank.
# ---------------------------------------------------------------------------

MESH_DIMS = ("dp", "tp")


def make_mesh(n_dp: int, n_tp: int = 1, device_type: str = "cuda"):
    """The (dp, tp) ``DeviceMesh`` over the initialized process group: dp
    shards the stream batch, tp the IMDCT's contraction.

    The caller's ``init_process_group(backend=...)`` picks the transport:
    "nccl" with one rank per card, "gloo" on the CPU or for ranks that share
    a card. The group's world size must be ``n_dp * n_tp``; otherwise this
    raises ValueError. It never initializes a group itself. With
    ``device_type="cuda"`` the rank's card (:func:`mesh_device`) becomes its
    current device, and without a card this raises: nothing runs on the
    CPU in its place."""
    n = n_dp * n_tp
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"need a process group of {n} ranks (dp {n_dp} x "
                         f"tp {n_tp}); none is initialized (call "
                         "torch.distributed.init_process_group first)")
    have = dist.get_world_size()
    if have != n:
        raise ValueError(f"need {n} ranks (dp {n_dp} x tp {n_tp}), the "
                         f"process group has {have}")
    if device_type == "cuda":
        # before the mesh: DeviceMesh would set LOCAL_RANK's card itself,
        # which does not exist when ranks share one card
        torch.cuda.set_device(_rank_card())
        torch.cuda.init()
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (n_dp, n_tp),
                            mesh_dim_names=MESH_DIMS)


def _rank_card() -> torch.device:
    """cuda:{LOCAL_RANK % cards} (the global rank when LOCAL_RANK is not
    set): the rank's own card under NCCL, the shared card when gloo ranks
    outnumber the cards."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA card; none is available "
                           "(nothing falls back to the CPU)")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def mesh_device(mesh) -> torch.device:
    """The device this rank decodes on: the CPU for a "cpu" mesh, else the
    rank's card (``_rank_card``)."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type != "cuda":
        raise ValueError(f"mesh device type {mesh.device_type!r}: 'cuda' or "
                         "'cpu'")
    return _rank_card()


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.mesh_dim_names != MESH_DIMS:
        raise TypeError(f"mesh: a DeviceMesh with dims {MESH_DIMS} "
                        f"(make_mesh), not {type(mesh).__name__}")


def _imdct_tp_local(spectra, bf, m0, m1, ti: int, ntp: int):
    """Rank ``ti``'s part of the tensor-parallel IMDCT of :func:`_imdct_tp`
    over ``ntp`` ranks: its slice of the contraction, the long/short
    select, no all-reduce."""
    def part(mat, spec):
        w = mat.shape[0]
        wk = -(-w // ntp)
        lo, hi = min(ti * wk, w), min((ti + 1) * wk, w)
        sl, mk = spec[..., lo:hi], mat[lo:hi]
        if hi - lo < wk:  # this rank's slice reaches into the zero pad
            sl = torch.nn.functional.pad(sl, (0, wk - (hi - lo)))
            mk = torch.nn.functional.pad(mk, (0, 0, 0, wk - (hi - lo)))
        return torch.matmul(sl, mk)

    n0, n1 = m0.shape[1], m1.shape[1]
    out = part(m1, spectra)
    if n0 != n1:
        short = torch.nn.functional.pad(part(m0, spectra), (0, n1 - n0))
        out = torch.where((bf == 1)[:, None, None], out, short)
    return out


def _imdct_tp(spectra, bf, m0, m1, group=None, ntp: int = 1):
    """Tensor-parallel IMDCT (reference ``_imdct_tp``): the signature of
    :func:`imdct_batch` once ``group`` (the mesh's tp group) and ``ntp``
    (its size) are bound, so it plugs into ``decode_frames_core(imdct=)``.

    The contraction axis (the spectral width, rows of m0/m1) is zero-padded
    to a multiple of ntp and split into ntp slices; this rank multiplies
    its slice of the spectra by its rows of each matrix (fp32
    ``torch.matmul``, TF32 off), selects long/short per blockflag with the
    short output padded to n1 (:func:`_imdct_tp_local`), and an all-reduce
    (sum) over ``group`` rebuilds the block. Zero rows add nothing, so
    padding (never a floor-divided slice, which drops the tail rows) keeps
    every term: the same sum as :func:`imdct_batch` in another order. Every
    rank of the group must end with the same bits, or the ranks of a dp
    block drift apart chunk by chunk: tests/test_torch_parallel.py and
    chip_smoke.py hold them bit for bit. The port makes no host copy here:
    gloo reduces a CUDA tensor through host memory inside
    ProcessGroupGloo; NCCL keeps it on the cards."""
    ti = dist.get_rank(group) if ntp > 1 else 0
    out = _imdct_tp_local(spectra, bf, m0, m1, ti, ntp)
    if ntp > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _TPImdct:
    """A rank's tp IMDCT (:func:`_imdct_tp` on its mesh's tp group), split
    where its all-reduce sits: ``local`` (:func:`_imdct_tp_local`) and
    ``collective`` (the all-reduce, in place), so that a chunk program
    captures the work on either side of it (:func:`_tp_steps`). Calling it
    runs both. Programs key it by the tp size and the rank's place in its
    tp group (and the group)."""

    def __init__(self, group, ntp: int):
        self.group, self.ntp, self.ti = group, ntp, dist.get_rank(group)

    def __call__(self, spectra, bf, m0, m1):
        return _imdct_tp(spectra, bf, m0, m1, self.group, self.ntp)

    def local(self, spectra, bf, m0, m1):
        return _imdct_tp_local(spectra, bf, m0, m1, self.ti, self.ntp)

    def collective(self, audio) -> None:
        dist.all_reduce(audio, op=dist.ReduceOp.SUM, group=self.group)

    def _key(self) -> tuple:
        return self.ntp, self.ti, self.group.group_name

    def __eq__(self, other) -> bool:
        return isinstance(other, _TPImdct) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())


def _mesh_imdct(mesh):
    """The IMDCT a rank of ``mesh`` runs: the stock one at tp = 1 (as the
    reference passes no transform there), else :class:`_TPImdct` on the
    mesh's tp group."""
    ntp = mesh["tp"].size()
    if ntp == 1:
        return imdct_batch
    return _TPImdct(mesh["tp"].get_group(), ntp)


def _dp_block(mesh, S: int) -> tuple[int, int]:
    """[lo, hi) of this rank's block of the S streams; raises ValueError
    unless the mesh's dp size divides S."""
    dp = mesh["dp"].size()
    if S % dp:
        raise ValueError(f"the stream batch S={S} is not divisible by the "
                         f"mesh's dp size {dp}")
    b = S // dp
    r = mesh.get_local_rank("dp")
    return r * b, (r + 1) * b


def _gather_dp(mesh, x: torch.Tensor) -> torch.Tensor:
    """The dp blocks of ``x`` (leading axis) of every rank of this rank's
    dp group, concatenated in dp order. Gathered as bytes: neither gloo nor
    NCCL takes every dtype (int16, bool)."""
    dp = mesh["dp"].size()
    if dp == 1:
        return x
    b = x.contiguous().view(-1).view(torch.uint8)
    full = torch.empty(dp * b.numel(), dtype=torch.uint8, device=x.device)
    dist.all_gather_into_tensor(full, b, group=mesh["dp"].get_group())
    return full.view(x.dtype).view((dp * x.shape[0],) + tuple(x.shape[1:]))


def decode_chunk_sharded(mesh, cs: CompiledSetup, fr: dict, carry,
                         with_i16: bool = False, compact_cap=None,
                         programs: graphs.Programs | None = None):
    """Chunk decode over a (dp, tp) mesh (reference
    ``decode_chunk_sharded``), called by every rank with the same global
    inputs: frames leaves [S, T, ...] and carry leaves [S, ...], S
    divisible by the mesh's dp size (else ValueError), setup tables
    replicated. The rank decodes its dp block through
    :func:`decode_frames_core` with the mesh's IMDCT (``_mesh_imdct``: at
    tp > 1 the tp IMDCT and its all-reduce), and an all-gather over dp
    returns the global outputs and carry on every rank, as the reference's
    ``out_specs=P("dp")``. ``compact_cap`` must be the same on every rank.

    With ``programs`` (the counterpart of the jit over the reference's
    ``shard_map``) the block runs as a one-chunk program of that owner
    (:func:`decode_chunk_batch`), then the all-gather over dp runs outside
    it. On a card the program is captured and replayed: at tp = 1 as one
    graph; at tp > 1, where the tp all-reduce sits inside the chunk and
    gloo's collectives cannot be captured, as two graphs with the
    all-reduce between their replays (:func:`_tp_steps`), keyed by the tp
    size and the rank's place in its tp group. At dp = 1 the outputs and
    carry returned are then the program's and the owner's (``graphs``'
    lifetime); at dp > 1 the gathered tensors are fresh."""
    lo, hi = _dp_block(mesh, fr["mode"].shape[0])
    imdct = _mesh_imdct(mesh)

    def blk(v):
        return tuple(b[lo:hi] for b in v) if isinstance(v, tuple) \
            else v[lo:hi]

    res, carry = decode_chunk_batch(
        cs, {k: blk(v) for k, v in fr.items()}, blk(carry),
        with_i16=with_i16, compact_cap=compact_cap, programs=programs,
        imdct=imdct)
    return (tuple(_gather_dp(mesh, x) for x in res),
            tuple(_gather_dp(mesh, c) for c in carry))


# ---------------------------------------------------------------------------
# Coalesced frame transfer: the nine small frame arrays ship as three flat
# buffers (one per dtype) beside the residue and are re-viewed on device.
# ---------------------------------------------------------------------------

_MISC_BOOL = ("prev_flag", "next_flag", "valid", "f_used", "f1_flags")
_MISC_I32 = ("mode", "f1_ys")
_MISC_F32 = ("f0_cosc", "f0_amp")


#: the leaves of each packed buffer, in the order they lie in it
_PACKED = (("residue",), _MISC_BOOL, _MISC_I32, _MISC_F32)


def _frame_shapes(fr_np: dict) -> tuple:
    """(name, shape) of every leaf in the packed buffers' order."""
    return tuple((k, tuple(fr_np[k].shape)) for keys in _PACKED
                 for k in keys)


def pack_frame_buffers(fr_np: dict):
    """(residue, u8 buf, i32 buf, f32 buf, shapes) of numpy frames; shapes
    carries every leaf's shape, the residue's true one included, so a
    12-bit packed residue can be restored on the device."""
    shapes = _frame_shapes(fr_np)
    b = np.concatenate([fr_np[k].reshape(-1).view(np.uint8)
                        for k in _MISC_BOOL])
    i = np.concatenate([fr_np[k].reshape(-1) for k in _MISC_I32])
    f = np.concatenate([fr_np[k].reshape(-1) for k in _MISC_F32])
    return fr_np["residue"], b, i, f, shapes


def unpack_frame_buffers(residue, bbuf, ibuf, fbuf, shapes) -> dict:
    """Frames (tensors on the buffers' device) from the coalesced buffers:
    views of the flat buffers, the bool leaves converted, and a 12-bit
    packed residue (int32 words) unpacked to i16."""
    d = dict(shapes)
    if residue.dtype == torch.int32:
        rs = d["residue"]
        residue = unpack12(residue, rs[-1]).reshape(rs)
    fr = {"residue": residue}
    for keys, buf in ((_MISC_BOOL, bbuf), (_MISC_I32, ibuf),
                      (_MISC_F32, fbuf)):
        off = 0
        for k in keys:
            n = int(np.prod(d[k]))
            v = buf[off: off + n].reshape(d[k])
            fr[k] = v.to(torch.bool) if buf is bbuf else v
            off += n
    return fr


def _unpacked(inputs: tuple, shapes) -> dict:
    """The packed buffers ``inputs`` (residue, bbuf, ibuf, fbuf) re-viewed
    as frames through ``shapes``: leaves [N, S, T, ...] (one chunk's
    [S, T, ...] given a chunk axis of 1)."""
    fr = unpack_frame_buffers(*inputs, shapes)
    if fr["mode"].dim() == 2:
        fr = {k: v[None] for k, v in fr.items()}
    return fr


def _packed_outputs(cs: CompiledSetup, shapes, compact_cap, device) -> tuple:
    """Fresh outputs of the packed frames of ``shapes`` (a chunk axis of 1
    for one chunk's), :func:`_scan_outputs`' layout."""
    mode = dict(shapes)["mode"]
    N, (S, T) = (mode[0] if len(mode) == 3 else 1), mode[-2:]
    return _scan_outputs(cs, N, S, T, compact_cap is None, compact_cap,
                         device)


def packed_program(programs: graphs.Programs, cs: CompiledSetup,
                   inputs: tuple, shapes, carry, compact_cap=None,
                   imdct=imdct_batch, outputs=None, key: tuple = ()):
    """The program of ``programs`` that decodes packed buffers of
    ``inputs``' layout (tensors or arrays; :func:`_unpacked`) from
    ``carry``'s layout, made at its first use: device-compacted at
    ``compact_cap`` samples a stream, else the i16 kernel path's padded
    chunk; the counterpart of the reference's jitted packed programs.
    ``outputs``: a function that returns the buffers it writes (default:
    its own, :func:`_scan_outputs`); ``key``: the caller's part of its key
    (``TransferSlots``: the slot and N). Call it as ``prog(inputs, carry)``
    -> ((out, lens) or (pcm, totals, lens), carry), the outputs with a
    chunk axis."""
    inputs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                   for a in inputs)
    full = ("packed", id(cs), compact_cap, imdct, shapes,
            graphs.signature(inputs), routing_flags()) + tuple(key)

    def make():
        outs = (outputs() if outputs is not None else
                _packed_outputs(cs, shapes, compact_cap, cs.device))
        return _program(programs, cs, lambda ins: _unpacked(ins, shapes),
                        inputs, carry, outs, compact_cap is None, compact_cap,
                        False, imdct, full)
    return programs.get(full, make)


def _packed(programs, cs, inputs: tuple, shapes, carry, compact_cap=None,
            imdct=imdct_batch):
    """The packed functions' one route: eagerly into fresh outputs, or as a
    program of ``programs`` (:func:`packed_program`)."""
    if programs is not None:
        return packed_program(programs, cs, inputs, shapes, carry,
                              compact_cap, imdct)(inputs, carry)
    outs = _packed_outputs(cs, shapes, compact_cap, inputs[0].device)
    return outs, _scan_into(cs, _unpacked(inputs, shapes), carry, outs,
                            compact_cap is None, compact_cap, imdct=imdct)


def decode_chunk_batch_packed(cs, residue, bbuf, ibuf, fbuf, shapes, carry,
                              compact_cap, imdct=imdct_batch,
                              programs: graphs.Programs | None = None):
    """One chunk over packed buffers, device-compacted output: ((pcm i16
    [S, cap, C], total [S], out_len [S, T]), carry). ``imdct`` as
    :func:`decode_frames_core`'s (a mesh's tp transform). With
    ``programs``, a program of that cache (:func:`packed_program`): its
    outputs and carry are static buffers, with ``graphs``' lifetime."""
    (pcm, totals, lens), carry = _packed(
        programs, cs, (residue, bbuf, ibuf, fbuf), shapes, carry,
        compact_cap, imdct)
    return (pcm[0], totals[0], lens[0]), carry


def decode_chunk_batch_packed_i16(cs, residue, bbuf, ibuf, fbuf, shapes,
                                  carry,
                                  programs: graphs.Programs | None = None):
    """One chunk over packed buffers through the i16 kernel path: ((i16
    [S, T, C*outw], out_len), carry); the host compacts. ``programs`` as
    :func:`decode_chunk_batch_packed`'s."""
    (out, lens), carry = _packed(programs, cs, (residue, bbuf, ibuf, fbuf),
                                 shapes, carry)
    return (out[0], lens[0]), carry


def decode_chunks_scan_packed_i16(cs, residue, bbuf, ibuf, fbuf, shapes,
                                  carry,
                                  programs: graphs.Programs | None = None):
    """N chunks over packed buffers whose leaves re-view to [N, S, T, ...],
    i16 kernel path: ((i16 [N, S, T, C*outw], lens [N, S, T]), carry).
    ``programs`` as :func:`decode_chunk_batch_packed`'s."""
    return _packed(programs, cs, (residue, bbuf, ibuf, fbuf), shapes, carry)


def decode_chunks_scan_packed(cs, residue, bbuf, ibuf, fbuf, shapes, carry,
                              compact_cap,
                              programs: graphs.Programs | None = None):
    """N chunks over packed buffers, device-compacted output: ((pcm i16
    [N, S, cap, C], totals [N, S]), carry). One cap covers all N chunks.
    ``programs`` as :func:`decode_chunk_batch_packed`'s."""
    (pcm, totals, _), carry = _packed(
        programs, cs, (residue, bbuf, ibuf, fbuf), shapes, carry,
        compact_cap)
    return (pcm, totals), carry


def _stream_carry(cs: CompiledSetup, S: int):
    return init_window_carry(cs.channels, cs.n1 // 2, S, cs.device)


class _Stages:
    """Host seconds spent in each stage of a decode call; with ``sync``
    every device stage ends with a synchronize, so each stage holds its own
    device time and the stages with ``other`` sum to the wall time."""

    NAMES = ("frontend", "h2d", "device", "d2h", "compact")

    def __init__(self, device, sync: bool):
        self.sync = sync and device.type == "cuda"
        self.device = device
        self.s = dict.fromkeys(self.NAMES, 0.0)
        self.t0 = self.t = time.perf_counter()

    def lap(self, name: str, device_work: bool = False) -> None:
        if device_work and self.sync:
            with profiling.span("batch.stage_sync"):
                torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.s[name] += now - self.t
        self.t = now

    def result(self) -> dict:
        wall = time.perf_counter() - self.t0
        out = dict(self.s)
        out["other"] = wall - sum(self.s.values())
        out["wall"] = wall
        return out


class TransferSlots:
    """The host buffers of a decode pipelined against ``sd``'s device, kept
    per slot of a double buffer and reused: the native frame buffers per
    (slot, N), views into four flat blocks laid out as the packed buffers
    and pinned on a card, so that the front-end writes the bytes the
    host-to-device copies read (other frames are staged through pinned
    buffers of the slot); an event after each slot's last copies in,
    pinned device-to-host buffers copied into on a side stream with an
    event per copy, and the decode programs
    (``programs``, a ``graphs.Programs``): one per (slot, N, output
    length, layout). The programs of one
    slot and N write their PCM into one device buffer, sized for the
    largest output length a chunk can need, which no program of another
    slot writes: a group never rewrites PCM that the other slot's copy out
    still reads, and device memory does not grow with the output lengths
    that serving meets. The programs share their static inputs, one set a
    layout (``graphs.Programs``): all run in order on one stream. A slot's
    buffers are rewritten only after the event of the copies that last
    read or wrote them. On the CPU the device works synchronously, so the
    arrays go in and out as they are."""

    def __init__(self, sd: StreamDecoder):
        self.sd = sd
        self.device = sd.device
        self.pinned: dict = {}  # (slot, array index) -> pinned staging
        self.put_done: dict = {}  # slot -> event after its last copies
        self.frames: dict = {}  # (slot, N) -> native frame buffers
        self.blocks: dict = {}  # (slot, N) -> the frames' four flat blocks
        self.pinned_d2h: dict = {}  # slot -> pinned bytes of the PCM
        self.d2h_done: dict = {}  # slot -> event after its last copy
        self.d2h_stream = None
        self.programs = graphs.Programs()
        self.pcm: dict = {}  # (slot, N, S, T, route) -> device PCM buffer

    def put(self, slot: int, arrays, into: tuple) -> tuple:
        """Host-to-device copies of ``arrays`` through slot ``slot`` straight
        into ``into`` (a program's static inputs, of the arrays' shapes and
        dtypes), which it returns: an array that is a whole block of the
        slot's frame buffers is sent from it, any other is first copied
        into the slot's pinned staging. The slot's memory is rewritten only
        after the copies that last read it have finished (their event), and
        the copies do not block the host."""
        if self.device.type != "cuda":
            for d, a in zip(into, arrays):
                d.copy_(torch.from_numpy(a))
            return into
        self.wait_put(slot)
        for j, a in enumerate(arrays):
            host = block = self._block(slot, a)
            if host is None:
                host = self.pinned.get((slot, j))
                if host is None or host.numel() < a.nbytes:
                    host = torch.empty(a.nbytes, dtype=torch.uint8,
                                       pin_memory=True)
                    self.pinned[(slot, j)] = host
            view = host[: a.nbytes].view(
                torch.from_numpy(a[:0]).dtype).reshape(a.shape)
            if block is None:
                view.numpy()[...] = a
            into[j].copy_(view, non_blocking=True)
        self.put_done[slot] = torch.cuda.Event()
        self.put_done[slot].record()
        return into

    def wait_put(self, slot: int) -> None:
        """Block until the host-to-device copies that last read ``slot``
        have finished."""
        if slot in self.put_done:
            with profiling.span("wait"):
                self.put_done[slot].synchronize()

    def frame_slot(self, slot: int, N: int, S: int) -> dict:
        """The host frame buffers [N, S, T, ...] of ``slot``, kept per
        (slot, N) and rewritten only after the slot's last host-to-device
        copies have finished. On the Python front-end the group gets fresh
        buffers."""
        layout = self.sd.frame_layout
        if layout is None:
            zero = self.sd.entropy_chunk([])
            return {k: np.zeros((N, S) + v.shape, v.dtype)
                    for k, v in zero.items()}
        self.wait_put(slot)
        buf = self.frames.get((slot, N))
        if (buf is None or buf["mode"].shape[1] != S
                or buf["residue"].dtype != layout["residue"][1]):
            buf = self._frame_blocks(slot, N, S, layout)
        return buf

    def _frame_blocks(self, slot: int, N: int, S: int, layout: dict) -> dict:
        """Zeroed native frame buffers [N, S, T, ...] of ``layout`` for
        (slot, N): views into four flat byte blocks (pinned on a card), the
        residue, then the bool, i32 and f32 leaves, each leaf after the one
        before in :func:`pack_frame_buffers`' order, so that each block
        holds the bytes of one packed buffer."""
        views, blocks = {}, []
        for keys in _PACKED:
            sizes = [int(np.prod((N, S) + layout[k][0]))
                     * np.dtype(layout[k][1]).itemsize for k in keys]
            block = torch.zeros(sum(sizes), dtype=torch.uint8,
                                pin_memory=self.device.type == "cuda")
            raw, off = block.numpy(), 0
            for k, n in zip(keys, sizes):
                shape, dt = layout[k]
                views[k] = raw[off: off + n].view(dt).reshape((N, S) + shape)
                off += n
            blocks.append(block)
        buf = {k: views[k] for k in layout}
        self.frames[(slot, N)] = buf
        self.blocks[(slot, N)] = tuple(blocks)
        return buf

    def _block(self, slot: int, a: np.ndarray) -> torch.Tensor | None:
        """The block of ``slot``'s frame buffers that ``a`` spans whole (the
        same first byte and size), or None."""
        p = a.ctypes.data
        return next((b for (s, _), blocks in self.blocks.items() if s == slot
                     for b in blocks
                     if b.data_ptr() == p and b.numel() == a.nbytes), None)

    def to_host_async(self, pcm: torch.Tensor, slot: int):
        """Start the device-to-host copy of ``pcm`` into the pinned buffer
        of ``slot`` on a side stream, ordered after the kernels that write
        it; returns (host tensor, event that marks the copy done). The
        buffer is rewritten only after that event has fired: the caller
        reads what it needs out of it before it reuses the slot."""
        if self.device.type != "cuda":
            return pcm, None
        if self.d2h_stream is None:
            self.d2h_stream = torch.cuda.Stream(self.device)
        if slot in self.d2h_done:
            with profiling.span("wait"):
                self.d2h_done.pop(slot).synchronize()
        nbytes = pcm.numel() * pcm.element_size()
        host = self.pinned_d2h.get(slot)
        if host is None or host.numel() < nbytes:
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self.pinned_d2h[slot] = host
        host = host[:nbytes].view(pcm.dtype).reshape(pcm.shape)
        done = torch.cuda.Event()
        done.record()
        with torch.cuda.stream(self.d2h_stream):
            self.d2h_stream.wait_event(done)
            host.copy_(pcm, non_blocking=True)
            pcm.record_stream(self.d2h_stream)
            copied = torch.cuda.Event()
            copied.record(self.d2h_stream)
        self.d2h_done[slot] = copied
        return host, copied

    def dispatch(self, slot: int, fr: dict, lens: np.ndarray, carry,
                 p12: bool, compact: str = "device", lap=None,
                 imdct=imdct_batch) -> tuple:
        """One group of N chunks through ``slot``: pack the host frames
        ``fr`` [N, S, T, ...] (the residue's 12-bit planes travel as int32
        with ``p12``), copy them in, enqueue the decode and start the PCM's
        copy out. The slot's own frame buffers (:meth:`frame_slot` on the
        native front-end) are packed already: their blocks are sent as they
        are. ``compact="device"`` decodes with ``compact_cap``, one
        output length bucketed from the packet lengths ``lens`` [N, S, T];
        ``compact="host"`` takes the i16 path's padded chunk. ``lap(stage,
        device_work)`` marks the ends of packing, the copy in and the
        decode. ``imdct`` (a mesh's tp transform) is taken at N = 1 with
        ``compact="device"``. Returns (host PCM, copy event, carry, H2D
        bytes, D2H bytes); the PCM has no leading N when N is 1."""
        cs = self.sd.cs
        N = lens.shape[0]
        if imdct is not imdct_batch and (N > 1 or compact != "device"):
            raise ValueError("a caller's imdct is taken at N = 1 with "
                             "compact='device' only")
        pack = profiling.begin("transfer.pack")
        if pack is not None:
            profiling.count("transfer.slots", lens.size)
            profiling.count("transfer.packets", np.count_nonzero(fr["valid"]))
        blocks = (self.blocks[(slot, N)] if fr is self.frames.get((slot, N))
                  else None)
        if N == 1:
            fr = {k: v[0] for k, v in fr.items()}
        if blocks is None:
            residue, bb, ib, fb, shapes = pack_frame_buffers(fr)
        else:
            residue, shapes = fr["residue"], _frame_shapes(fr)
            bb, ib, fb = (b.numpy().view(dt) for b, dt in zip(
                blocks[1:], (np.uint8, np.int32, np.float32)))
        if p12:
            if residue.dtype == np.uint32:
                # the native front-end emitted the planes: the device
                # unpacks to the logical residue width
                logical = residue.shape[:-1] + (residue.shape[-1] * 8 // 3,)
                shapes = (("residue", logical),) + shapes[1:]
            else:
                residue = pack12_np(residue)
            residue = residue.view(np.int32)
        arrays = (residue, bb, ib, fb)
        if pack is not None:
            direct = sum(a.nbytes for a in arrays
                         if self._block(slot, a) is not None)
            profiling.count("transfer.direct_bytes", direct)
            profiling.count("transfer.staged_bytes",
                            sum(a.nbytes for a in arrays) - direct)
        # "host": the i16 path's padded chunk; "device": a host int, one
        # bucketed output length for all N chunks, keeps the output
        # shapes (and so the programs) few
        cap = (None if compact == "host" else
               _bucket(int(lens.sum(-1).max()) + cs.n1))
        S, T = lens.shape[1:]
        prog = packed_program(
            self.programs, cs, arrays, shapes, carry, cap, imdct,
            lambda: self._outputs(slot, N, S, T, cap), key=(slot, N))
        if lap:
            lap("frontend")
        dev = self.put(slot, arrays, prog.inputs)
        profiling.end(pack)
        if lap:
            lap("h2d", device_work=True)
        if slot in self.d2h_done:
            # the program's outputs are what the slot's last device-to-host
            # copy reads (the fresh allocation per call used to hide this)
            torch.cuda.current_stream(self.device).wait_event(
                self.d2h_done[slot])
        outs, carry = prog(dev, carry)
        pcm = outs[0] if N > 1 else outs[0][0]
        if lap:
            lap("device", device_work=True)
        with profiling.span("transfer.d2h"):
            host, copied = self.to_host_async(pcm, slot)
        return (host, copied, carry,
                sum(int(a.numel() * a.element_size()) for a in dev),
                int(pcm.numel() * pcm.element_size()))

    def _outputs(self, slot: int, N: int, S: int, T: int, cap) -> tuple:
        """The buffers a program of ``slot`` writes: the PCM a view of the
        slot's buffer for (N, S, T, route), which the programs of every
        ``cap`` share, sized for the largest cap of T packets (a packet
        returns at most n1/2 samples); the lengths (and totals) its own."""
        cs = self.sd.cs
        full = None if cap is None else _bucket(T * cs.n1 // 2 + cs.n1)
        key = (slot, N, S, T, full)
        if key not in self.pcm:
            self.pcm[key] = _scan_outputs(cs, N, S, T, cap is None, full,
                                          self.device)[0]
        return _scan_outputs(cs, N, S, T, cap is None, cap, self.device,
                             pcm=self.pcm[key])


def _bucket(samples: int) -> int:
    """``compact_cap`` for ``samples``: the next multiple of 8,192, so that
    the output lengths (and so the programs) are few."""
    return -(-samples // 8192) * 8192


#: the bytes of a group's compaction for each part it splits into: a group
#: below this is copied by the calling thread alone, so small decodes and
#: serving-sized batches pay no hand-off to the pool
_COMPACT_PART_BYTES = 8 << 20


def _byte_ranges(nbytes: np.ndarray, parts: int) -> list[tuple[int, int]]:
    """At most ``parts`` non-empty ranges [lo, hi) of the streams, in order
    and covering each once, cut where the running sum of ``nbytes`` (each
    stream's bytes) passes each multiple of the total over ``parts``: a
    range holds that mean within one stream's bytes. Streams differ in
    length by up to 10x, so equal stream counts would not balance."""
    cum = np.cumsum(nbytes)
    cuts = np.searchsorted(cum, cum[-1] * np.arange(1, parts) / parts,
                           side="right")
    edges = np.unique(np.concatenate(([0], cuts, [len(nbytes)])))
    return [(int(lo), int(hi)) for lo, hi in zip(edges[:-1], edges[1:])]


def _compact_part(a: np.ndarray, totals: np.ndarray, starts: np.ndarray,
                  dst: tuple, lo: int, hi: int) -> None:
    """Streams [lo, hi) of a group's device-compacted chunks ``a`` [N, S,
    cap, C]: each stream's first ``totals`` [N, S] samples into its output
    at ``starts`` [N, S], one native call a chunk
    (``native.compact_rows``: the interpreter's lock is released once a
    chunk, not once a stream, which a part's threads would otherwise queue
    for). ``dst``: the outputs' :func:`_addresses`."""
    for n in range(totals.shape[0]):
        native.compact_rows(a[n], totals[n], starts[n], *dst, lo, hi)


def _addresses(outs: list) -> tuple:
    """The outputs' addresses and rows, for :func:`_compact_part`."""
    return (np.fromiter((o.ctypes.data for o in outs), np.uintp, len(outs)),
            np.fromiter((len(o) for o in outs), np.int64, len(outs)))


class _CompactPool:
    """The threads a group's compaction splits over (``host_threads()``)
    and their pool, made at first use; it runs while the front-end's
    workers wait. The decoders of a :class:`MixedBatchDecoder` share
    one."""

    def __init__(self):
        self.threads = host_threads()
        self.pool = None

    def run(self, fn, ranges: list, *args) -> None:
        """``fn(*args, lo, hi)`` for each range [lo, hi) on the pool;
        returns once every range has ended, then raises the first error."""
        if self.pool is None:
            self.pool = futures.ThreadPoolExecutor(
                self.threads, thread_name_prefix="lt-compact")
        done = [self.pool.submit(fn, *args, lo, hi) for lo, hi in ranges]
        futures.wait(done)  # every part ends before an error raises
        for f in done:
            f.result()


class BatchDecoder:
    """Decode a batch of independent streams sharing one setup geometry on
    ``device`` (the card unless the caller names another).

    The serving-shaped API: feed each stream's packets, get PCM per stream.
    Streams are padded to a common packet count; per-packet lengths recover
    the ragged output. The host front-end is :class:`StreamDecoder`'s
    (``raw_headers`` and ``frontend`` as there: the native library unless
    the caller asks for the Python one). Whatever the front-end,
    ``decode_streams_i16``'s device-compacted PCM is copied into the
    outputs by the native host library (``native.compact_rows``), which
    must build.

    ``mesh=`` (a :func:`make_mesh` DeviceMesh; every rank of the group
    constructs the decoder and makes the same calls, as under ``torchrun``)
    shards the streams: the rank decodes on :func:`mesh_device` (its card,
    or the CPU for a "cpu" mesh; ``device`` is not read), entropy-decodes
    only its dp block of the S streams (S divisible by the dp size; the tp
    ranks of a block decode the same block, the IMDCT split between them
    by :func:`_imdct_tp`), runs the chunk count of the longest of all S
    streams so every rank makes the same collectives, and returns all S
    streams, gathered over dp as host arrays."""

    def __init__(self, ident, setup, chunk: int = 64, mesh=None,
                 raw_headers=None, frontend: str = "auto", scan: int = 1,
                 device="cuda"):
        self.mesh = mesh
        self._imdct = imdct_batch
        if mesh is not None:
            _check_mesh(mesh)
            device = mesh_device(mesh)
            self._imdct = _mesh_imdct(mesh)
        self.ident, self.setup = ident, setup
        self._sd = StreamDecoder(ident, setup, chunk, raw_headers, frontend,
                                 device)
        self.cs = self._sd.cs
        self.device = self._sd.device
        self.chunk = chunk
        #: chunks per group in decode_streams_i16: groups descend in powers
        #: of two (scan=3 runs groups of 2), see decode_streams_i16
        self.scan = scan
        #: decode_streams_i16 ends each device stage with a synchronize,
        #: so ``last_stats["stages"]`` splits the wall time by stage
        #: (and the front-end no longer overlaps the device)
        self.stage_sync = False
        self._bf_host = self.cs.mode_blockflag.cpu().numpy()
        # a mesh's groups run as programs too: at tp > 1 two segments a
        # chunk around the tp all-reduce; the dp gather runs after them
        self._slots = TransferSlots(self._sd)
        #: accounting of the last decode_streams* call: bytes shipped
        #: host->device and device->host (with a mesh, this rank's), the
        #: residue transport, and the host seconds per stage
        #: (decode_streams_i16)
        self.last_stats = {"h2d_bytes": 0, "d2h_bytes": 0}
        #: decode_streams_i16 calls made (the ``batch.decode`` span's rid)
        self._calls = 0
        #: the compaction's threads (a MixedBatchDecoder's decoders share
        #: its one)
        self._compact = _CompactPool()

    def _mine(self, streams: list) -> list:
        """This rank's dp block of ``streams`` (all of them without a
        mesh)."""
        if self.mesh is None:
            return streams
        lo, hi = _dp_block(self.mesh, len(streams))
        return streams[lo:hi]

    def _gathered(self, outs: list) -> list:
        """Every rank's block of outputs in dp order (``outs`` itself
        without a mesh or at dp = 1)."""
        if self.mesh is None or self.mesh["dp"].size() == 1:
            return outs
        blocks = [None] * self.mesh["dp"].size()
        dist.all_gather_object(blocks, outs,
                               group=self.mesh["dp"].get_group())
        return [o for b in blocks for o in b]

    def decode_streams(self, streams: list[list[bytes]]) -> list[np.ndarray]:
        """streams: per stream, its audio packets. Returns planar f32 PCM
        [C, total] per stream."""
        max_t = max(len(p) for p in streams)
        streams = self._mine(streams)
        S = len(streams)
        C = self.cs.channels
        # the frames go to the core as they are (no packed transport), so
        # the native emit is the plain i16/f32 residue
        self._sd.set_residue_transport("default")
        carry = _stream_carry(self.cs, S)
        self.last_stats = {"h2d_bytes": 0, "d2h_bytes": 0}
        outs: list[list[np.ndarray]] = [[] for _ in range(S)]
        for t0 in range(0, max_t, self.chunk):
            fr_np, _ = self._sd.entropy_chunk_batch(
                [pks[t0: t0 + self.chunk] for pks in streams])
            self.last_stats["h2d_bytes"] += sum(v.nbytes
                                                for v in fr_np.values())
            fr = frames_to_device(fr_np, self.device)
            (out, out_len), carry = decode_chunk_batch(
                self.cs, fr, carry, imdct=self._imdct)
            out = out.cpu().numpy()
            out_len = out_len.cpu().numpy()
            self.last_stats["d2h_bytes"] += out.nbytes + out_len.nbytes
            for s in range(S):
                for t in range(min(self.chunk, len(streams[s]) - t0)):
                    outs[s].append(out[s, t, :, : out_len[s, t]])
        return self._gathered([
            np.concatenate(o, axis=1) if o else np.zeros((C, 0), np.float32)
            for o in outs
        ])

    def decode_streams_i16(self, streams: list,
                           compact: str = "device",
                           scan: int | None = None,
                           transport: str = "auto") -> list[np.ndarray]:
        """Serving path: returns interleaved i16 PCM [total, C] per stream.
        A stream is a list of packets (bytes) or, on the native front-end,
        a ``native.PacketSpans``.

        ``compact="device"``: PCM is compacted and converted to i16 on the
        device (the f32 path and ``compact_i16``), so the device-to-host
        copy is the exact audio. ``compact="host"``: the i16 kernel path
        emits the padded flat chunk and the host slices it.

        ``scan=N`` decodes N chunks per group (one transfer each way per
        group): N is rounded down to a power of two, and a short tail takes
        smaller power-of-two groups rather than padding.

        ``transport``: the residue's host-to-device encoding, "i16", "p12"
        (12-bit packed when the setup's static bound allows it; see
        pack12.py; the native front-end emits the packed planes as it
        decodes) or "auto" (p12 on a slow measured link, i16 on the CPU).

        With a mesh, as in the reference: one chunk per group, the i16
        transport, and the device-compacted path whatever ``compact`` says;
        each rank bounds its ``compact_cap`` by its own block's packets.

        Pipelined: each group's device work and device-to-host copy run
        while the host entropy-decodes the next group; the previous group's
        PCM is copied into the outputs once the next group is enqueued,
        split over the host threads when it is large. The
        host frame buffers and the pinned buffers of both directions are
        kept per slot of a double buffer and reused across groups and
        calls."""
        self._calls += 1
        with profiling.span("batch.decode", self._calls):
            st = _Stages(self.device, self.stage_sync)
            (part,) = _decode_groups([(self, streams)], compact, scan,
                                     transport, st)
            self.last_stats = part.stats() | {"stages": st.result()}
            return self._gathered(part.pcm())

    def _finish(self, entry: list, outs: list, offs: np.ndarray,
                st: _Stages, dst: tuple) -> None:
        """Wait for a group's device-to-host copy, then copy its samples
        into the outputs at ``offs`` (advanced here). A device-compacted
        group is copied in one part for each ``_COMPACT_PART_BYTES`` begun
        (at least one, at most the compaction's threads): contiguous stream
        ranges of about equal bytes (:func:`_byte_ranges`), each a
        :func:`_compact_part`, over the pool when there are two or more and
        on the calling thread otherwise. A padded group is copied on the
        calling thread: NumPy's per-stream copies on pool threads lose to
        one thread. ``dst``: the outputs' :func:`_addresses`."""
        host, copied, totals, lens = entry
        if copied is not None:
            with profiling.span("wait"):
                copied.synchronize()
        a = host.numpy() if isinstance(host, torch.Tensor) else host
        st.lap("d2h")
        compact = profiling.begin("batch.compact")
        if a.ndim == len(totals.shape) + 1:  # single chunk: add N=1
            a = a[None]
        S, C = len(outs), self.cs.channels
        nbytes = totals.sum(axis=0) * (C * 2)  # i16 samples
        starts = offs + np.cumsum(totals, axis=0) - totals
        ranges = [(0, S)]
        if lens is not None:  # padded flat [S, T, C*outw]: slice + interleave
            for n in range(totals.shape[0]):
                an = a[n].reshape(S, a.shape[2], C, -1)
                keep = (np.arange(an.shape[3])[None, :]
                        < lens[n][:, :, None])  # [S, T, w]
                for s in range(S):
                    m, o = int(totals[n, s]), int(starts[n, s])
                    outs[s][o: o + m] = an[s].transpose(0, 2, 1)[keep[s]]
        else:
            ranges = _byte_ranges(nbytes, max(1, min(
                self._compact.threads,
                -(-int(nbytes.sum()) // _COMPACT_PART_BYTES))))
            if len(ranges) == 1:
                _compact_part(a, totals, starts, dst, *ranges[0])
            else:
                self._compact.run(_compact_part, ranges, a, totals, starts,
                                  dst)
        offs += totals.sum(axis=0)
        if compact is not None:
            profiling.count("batch.compact_bytes", nbytes.sum())
            profiling.count("batch.compact_parts", len(ranges))
        profiling.end(compact)
        st.lap("compact")


class _Part:
    """One decoder's streams in a ``decode_streams_i16`` call, and what the
    group loop keeps for them: this rank's block of the streams, their
    groups of chunks, the residue transport, the window carry, the outputs
    with the samples written so far (``offs``) and the bytes each way.

    A group is N chunks, N the largest power of two at most ``scan``, a
    short tail taking smaller powers of two rather than padding. The
    outputs are sized by each stream's most samples (3 n1/4 a packet) and
    cut to the decoded length at the end: ``np.empty`` leaves the pages
    past the audio untouched."""

    def __init__(self, dec: BatchDecoder, streams: list, compact: str, scan,
                 transport: str):
        self.dec = dec
        cs = dec.cs
        max_t = max(len(p) for p in streams)
        self.streams = dec._mine(streams)
        S = self.S = len(self.streams)
        scan = max(1, int(dec.scan if scan is None else scan))
        if dec.mesh is not None:
            scan, transport, compact = 1, "i16", "device"
        if transport == "auto":
            transport = "p12" if p12_auto(cs, dec.device) else "i16"
        self.use_p12 = transport == "p12" and pack12_supported(cs)
        dec._sd.set_residue_transport("p12" if self.use_p12 else "default")
        self.compact = compact
        self.carry = _stream_carry(cs, S)
        self.bf_host = SimpleNamespace(mode_blockflag=dec._bf_host,
                                       n0=cs.n0, n1=cs.n1)
        self.started = np.zeros(S, bool)
        n_chunks = -(-max_t // dec.chunk)
        self.groups: list[list[int]] = []
        ci = 0
        while ci < n_chunks:
            n = 1 << (scan.bit_length() - 1)  # largest pow2 <= scan
            while n > 1 and ci + n > n_chunks:
                n //= 2
            self.groups.append(list(range(ci, ci + n)))
            ci += n
        self.outs = [np.empty((len(p) * (3 * cs.n1 // 4), cs.channels),
                              np.int16) for p in self.streams]
        self.offs = np.zeros(S, np.int64)
        self.dst = _addresses(self.outs)
        self.h2d = self.d2h = 0

    def finish(self, entry: list, st: _Stages) -> None:
        self.dec._finish(entry, self.outs, self.offs, st, self.dst)

    def stats(self) -> dict:
        return {"h2d_bytes": self.h2d, "d2h_bytes": self.d2h,
                "transport": "p12" if self.use_p12 else "i16"}

    def pcm(self) -> list:
        return [o[: int(self.offs[s])] for s, o in enumerate(self.outs)]


def _decode_groups(jobs: list, compact: str, scan, transport: str,
                   st: _Stages) -> list[_Part]:
    """The group loop of ``decode_streams_i16``: ``jobs``, (BatchDecoder,
    streams) pairs, each made a :class:`_Part` and decoded in turn, its
    groups through its decoder's transfer slots, all in one pipeline. Each
    group's device work and device-to-host copy run while the host
    entropy-decodes the next group, whichever part that is of; the group
    is finished (copied into its part's outputs) once the next is
    enqueued. So a switch of part does not drain the pipeline. A part
    after the first is entered in a ``batch.setup_switch`` span (rid: its
    index), from the last dispatch before it to its first front-end
    call."""
    parts = []
    #: the group whose device-to-host copy is in flight: its part and
    #: [host pcm, copy event, totals [N, S], lens [N, S, T] | None]
    pending = None
    for j, (dec, streams) in enumerate(jobs):
        switch = profiling.begin("batch.setup_switch", j) if j else None
        part = _Part(dec, streams, compact, scan, transport)
        parts.append(part)
        st.lap("frontend")
        for gi, group in enumerate(part.groups):
            N, slot = len(group), gi % 2
            buf = dec._slots.frame_slot(slot, N, part.S)
            profiling.end(switch)
            switch = None
            lens_all = np.zeros((N, part.S, dec.chunk), np.int64)
            for n, ci in enumerate(group):
                t0 = ci * dec.chunk
                view = {k: v[n] for k, v in buf.items()}
                dec._sd.entropy_chunk_batch(
                    [pks[t0: t0 + dec.chunk] for pks in part.streams],
                    out=view)
                lens_all[n], part.started = predict_out_lens(
                    part.bf_host, view, part.started)
            host, copied, part.carry, h2d, d2h = dec._slots.dispatch(
                slot, buf, lens_all, part.carry, part.use_p12, part.compact,
                st.lap, dec._imdct)
            part.h2d += h2d
            part.d2h += d2h
            # finish the previous group: its copy had this group's
            # front-end time to drain
            if pending is not None:
                pending[0].finish(pending[1], st)
            pending = (part, [host, copied, lens_all.sum(axis=-1),
                              lens_all if part.compact == "host" else None])
            st.lap("d2h", device_work=True)
        profiling.end(switch)
    if pending is not None:
        pending[0].finish(pending[1], st)
    return parts


class MixedBatchDecoder:
    """Decode a batch of independent streams of any setups on ``device``
    (the card unless the caller names another): the batch path of a corpus
    encoded at several setups.

    It keeps a :class:`BatchDecoder` per distinct (ident packet, setup
    packet) pair, keyed by both as ``serve.StreamingScheduler`` keys its
    groups (byte-identical setups under other ident headers must not share
    a compiled geometry), made at the pair's first sight (the header parse
    and ``compile_setup``) and kept across calls: a call with the setups
    of an earlier one parses and compiles nothing. ``chunk`` and ``scan``
    are each decoder's, as in ``BatchDecoder``; the decoders share one
    compaction pool, and each keeps its own transfer slots, programs, carry
    and outputs.

    A decoder's programs, static inputs and frame blocks are sized by its
    setup's stream count in a call, so shapes repeat, and nothing is
    captured, only where each setup's count repeats from call to call. A
    new count captures new programs beside the old, kept as long as the
    decoder: batches whose per-setup counts vary grow the card's memory by
    about as much as a decoder of that count holds, for each count met."""

    def __init__(self, chunk: int = 64, scan: int = 1, device="cuda"):
        self.chunk, self.scan = chunk, scan
        self.device = torch.device(device)
        #: (ident packet, setup packet) -> its decoder
        self.decoders: dict[tuple[bytes, bytes], BatchDecoder] = {}
        #: as BatchDecoder.stage_sync, over the whole call
        self.stage_sync = False
        #: accounting of the last call: the decoders' ``last_stats`` bytes
        #: summed over its setups, the transport (a list in the setups'
        #: order where they differ) and the host seconds per stage
        self.last_stats = {"h2d_bytes": 0, "d2h_bytes": 0}
        self._compact = _CompactPool()
        #: decode_streams_i16 calls made (the ``batch.mixed`` span's rid)
        self._calls = 0

    def _decoder(self, ident_pck: bytes, setup_pck: bytes) -> BatchDecoder:
        """The decoder of a header pair, made at the pair's first sight
        (counted by ``batch.setup_compiles``); a pair that does not parse
        raises ``BadHeader``."""
        key = (bytes(ident_pck), bytes(setup_pck))
        dec = self.decoders.get(key)
        if dec is None:
            try:
                ident = read_header_ident(key[0])
                setup = read_header_setup(key[1], ident)
            except VorbisError as e:
                raise BadHeader(f"a stream's headers do not parse: {e}") from e
            dec = BatchDecoder(ident, setup, self.chunk, raw_headers=key,
                               scan=self.scan, device=self.device)
            dec._compact = self._compact
            self.decoders[key] = dec
            profiling.count("batch.setup_compiles", 1)
        return dec

    def decode_streams_i16(self, streams: list, headers: list,
                           compact: str = "device",
                           transport: str = "auto") -> list[np.ndarray]:
        """Interleaved i16 PCM [total, C] of each stream (C its own), in
        the caller's order. ``headers[i]`` is stream i's (ident packet,
        setup packet); a stream, ``compact`` and ``transport`` are as in
        ``BatchDecoder.decode_streams_i16`` ("auto" resolved per setup).

        Every stream's decoder is found, or made, before anything decodes.
        The setups run in the order of their first streams, each setup's
        streams in the caller's order, so a batch of the same files in
        another order repeats each setup's shapes. One pipeline runs across
        the setups (:func:`_decode_groups`): a setup's first group is
        entropy-decoded and dispatched before the previous setup's last
        group is finished."""
        if len(headers) != len(streams):
            raise ValueError(f"{len(headers)} header pairs for "
                             f"{len(streams)} streams")
        self._calls += 1
        with profiling.span("batch.mixed", self._calls):
            order: dict[tuple[bytes, bytes], list[int]] = {}
            for i, (ident_pck, setup_pck) in enumerate(headers):
                order.setdefault((bytes(ident_pck), bytes(setup_pck)),
                                 []).append(i)
            profiling.count("batch.setups", len(order))
            jobs = [(self._decoder(*key), [streams[i] for i in idx])
                    for key, idx in order.items()]
            st = _Stages(self.device, self.stage_sync)
            parts = _decode_groups(jobs, compact, None, transport, st)
            stats = [p.stats() for p in parts]
            kinds = [s["transport"] for s in stats]
            self.last_stats = {
                "h2d_bytes": sum(s["h2d_bytes"] for s in stats),
                "d2h_bytes": sum(s["d2h_bytes"] for s in stats),
                "transport": kinds[0] if len(set(kinds)) == 1 else kinds,
                "stages": st.result()}
            out: list = [None] * len(streams)
            for idx, part in zip(order.values(), parts):
                for i, pcm in zip(idx, part.pcm()):
                    out[i] = pcm
            return out
