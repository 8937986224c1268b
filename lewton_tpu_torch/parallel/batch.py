"""Multi-stream batching (lewton_tpu/parallel/batch.py).

Streams are independent and decoded in lockstep by one call per chunk
(the stream axis is explicit in the core, no ``vmap``). Packet time is
sequential through the window carry, so N chunks run as a Python loop that
chains the carry; the reference's ``lax.scan`` only amortized dispatch
latency, and PyTorch dispatches eagerly.

The transport is the reference's: the nine small frame arrays travel as
three flat buffers (one per dtype) beside the residue, which may be 12-bit
packed (``pack12.py``), and are re-viewed on the device
(:func:`unpack_frame_buffers`). :class:`BatchDecoder` is the serving-shaped
entry: each stream's packets in, PCM per stream out, its host front-end
pipelined against the device through pinned double buffers, non-blocking
copies and a side stream for the device-to-host copies. Multi-device
sharding (the reference's ``mesh=``) is not ported yet.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from ..models.decoder import (CompiledSetup, StreamDecoder,
                              decode_frames_core, frames_to_device,
                              predict_out_lens)
from ..ops.imdct import imdct_batch
from ..ops.windowing import init_window_carry
from .pack12 import p12_auto, pack12_np, pack12_supported, unpack12

__all__ = ["decode_chunk_batch", "decode_chunks_scan", "pack_frame_buffers",
           "unpack_frame_buffers", "decode_chunk_batch_packed",
           "decode_chunk_batch_packed_i16", "decode_chunks_scan_packed",
           "decode_chunks_scan_packed_i16", "BatchDecoder"]


#: one chunk for S streams (``with_i16``, ``compact_cap`` as the
#: reference's), under the reference's name
decode_chunk_batch = decode_frames_core


def _chunk(frs: dict, i: int) -> dict:
    """Chunk i of frames with leaves [N, ...] (``f1_brackets`` is a tuple)."""
    return {k: tuple(b[i] for b in v) if isinstance(v, tuple) else v[i]
            for k, v in frs.items()}


def decode_chunks_scan(cs: CompiledSetup, frs: dict, carry,
                       with_i16: bool = False, plain: bool = False,
                       imdct=imdct_batch):
    """N chunks in order: frs leaves [N, S, T, ...]. Returns ((out, out_len
    i32 [N, S, T]), final carry), out i16 [N, S, T, C*3n1/4] with
    ``with_i16``, else f32 [N, S, T, C, 3n1/4]. Each chunk's samples are
    written into its slice of ``out``. ``imdct``: passed to every chunk's
    :func:`decode_frames_core` (a caller's transform, as the reference's
    ``_batch_core`` passes it)."""
    N, S, T = frs["mode"].shape
    dev = frs["mode"].device
    outw = 3 * cs.n1 // 4
    out = (torch.empty((N, S, T, cs.channels * outw), dtype=torch.int16,
                       device=dev) if with_i16 else
           torch.empty((N, S, T, cs.channels, outw), dtype=torch.float32,
                       device=dev))
    lens = torch.empty((N, S, T), dtype=torch.int32, device=dev)
    for i in range(N):
        (_, out_len), carry = decode_frames_core(
            cs, _chunk(frs, i), carry, with_i16=with_i16, plain=plain,
            out=out[i], imdct=imdct)
        lens[i] = out_len
    return (out, lens), carry


# ---------------------------------------------------------------------------
# Coalesced frame transfer: the nine small frame arrays ship as three flat
# buffers (one per dtype) beside the residue and are re-viewed on device.
# ---------------------------------------------------------------------------

_MISC_BOOL = ("prev_flag", "next_flag", "valid", "f_used", "f1_flags")
_MISC_I32 = ("mode", "f1_ys")
_MISC_F32 = ("f0_cosc", "f0_amp")


def pack_frame_buffers(fr_np: dict):
    """(residue, u8 buf, i32 buf, f32 buf, shapes) of numpy frames; shapes
    carries every leaf's shape, the residue's true one included, so a
    12-bit packed residue can be restored on the device."""
    shapes = tuple(
        (k, tuple(fr_np[k].shape))
        for k in ("residue",) + _MISC_BOOL + _MISC_I32 + _MISC_F32
    )
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


def decode_chunk_batch_packed(cs, residue, bbuf, ibuf, fbuf, shapes, carry,
                              compact_cap):
    """One chunk over packed buffers, device-compacted output: ((pcm i16
    [S, cap, C], total [S], out_len [S, T]), carry)."""
    fr = unpack_frame_buffers(residue, bbuf, ibuf, fbuf, shapes)
    return decode_frames_core(cs, fr, carry, compact_cap=compact_cap)


def decode_chunk_batch_packed_i16(cs, residue, bbuf, ibuf, fbuf, shapes,
                                  carry):
    """One chunk over packed buffers through the i16 kernel path: ((i16
    [S, T, C*outw], out_len), carry); the host compacts."""
    fr = unpack_frame_buffers(residue, bbuf, ibuf, fbuf, shapes)
    return decode_frames_core(cs, fr, carry, with_i16=True)


def decode_chunks_scan_packed_i16(cs, residue, bbuf, ibuf, fbuf, shapes,
                                  carry):
    """N chunks over packed buffers whose leaves re-view to [N, S, T, ...],
    i16 kernel path: ((i16 [N, S, T, C*outw], lens [N, S, T]), carry)."""
    fr = unpack_frame_buffers(residue, bbuf, ibuf, fbuf, shapes)
    return decode_chunks_scan(cs, fr, carry, with_i16=True)


def decode_chunks_scan_packed(cs, residue, bbuf, ibuf, fbuf, shapes, carry,
                              compact_cap):
    """N chunks over packed buffers, device-compacted output: ((pcm i16
    [N, S, cap, C], totals [N, S]), carry). One cap covers all N chunks."""
    fr = unpack_frame_buffers(residue, bbuf, ibuf, fbuf, shapes)
    N, S = fr["mode"].shape[:2]
    dev = fr["mode"].device
    pcm = torch.empty((N, S, compact_cap, cs.channels), dtype=torch.int16,
                      device=dev)
    totals = torch.empty((N, S), dtype=torch.int32, device=dev)
    for i in range(N):
        (pcm[i], totals[i], _), carry = decode_frames_core(
            cs, _chunk(fr, i), carry, compact_cap=compact_cap)
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


class BatchDecoder:
    """Decode a batch of independent streams sharing one setup geometry on
    ``device`` (the card unless the caller names another).

    The serving-shaped API: feed each stream's packets, get PCM per stream.
    Streams are padded to a common packet count; per-packet lengths recover
    the ragged output. The host front-end is :class:`StreamDecoder`'s
    (``raw_headers`` and ``frontend`` as there: the native library unless
    the caller asks for the Python one). ``mesh=`` (multi-device sharding)
    is not in the port yet and raises."""

    def __init__(self, ident, setup, chunk: int = 64, mesh=None,
                 raw_headers=None, frontend: str = "auto", scan: int = 1,
                 device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-device sharding) is not in lewton_tpu_torch")
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
        self._pinned: dict = {}  # (slot, array index) -> pinned bytes
        self._put_done: dict = {}  # slot -> event after its last copies
        self._frames: dict = {}  # (slot, N) -> native frame buffers
        self._pinned_d2h: dict = {}  # slot -> pinned bytes of the PCM
        self._d2h_done: dict = {}  # slot -> event after its last copy
        self._d2h_stream = None
        #: accounting of the last decode_streams* call: bytes shipped
        #: host->device and device->host, the residue transport, and the
        #: host seconds per stage (decode_streams_i16)
        self.last_stats = {"h2d_bytes": 0, "d2h_bytes": 0}

    def decode_streams(self, streams: list[list[bytes]]) -> list[np.ndarray]:
        """streams: per stream, its audio packets. Returns planar f32 PCM
        [C, total] per stream."""
        S = len(streams)
        max_t = max(len(p) for p in streams)
        C = self.cs.channels
        # the frames go to the core as they are (no packed transport), so
        # the native emit is the plain i16/f32 residue
        self._sd.set_residue_transport("default")
        carry = _stream_carry(self.cs, S)
        self.last_stats = {"h2d_bytes": 0, "d2h_bytes": 0}
        outs: list[list[np.ndarray]] = [[] for _ in range(S)]
        for t0 in range(0, max_t, self.chunk):
            fr_np = self._sd.entropy_chunk_batch(
                [pks[t0: t0 + self.chunk] for pks in streams])
            self.last_stats["h2d_bytes"] += sum(v.nbytes
                                                for v in fr_np.values())
            fr = frames_to_device(fr_np, self.device)
            (out, out_len), carry = decode_chunk_batch(self.cs, fr, carry)
            out = out.cpu().numpy()
            out_len = out_len.cpu().numpy()
            self.last_stats["d2h_bytes"] += out.nbytes + out_len.nbytes
            for s in range(S):
                for t in range(min(self.chunk, len(streams[s]) - t0)):
                    outs[s].append(out[s, t, :, : out_len[s, t]])
        return [
            np.concatenate(o, axis=1) if o else np.zeros((C, 0), np.float32)
            for o in outs
        ]

    def _put(self, slot: int, arrays) -> tuple:
        """Host-to-device copies of ``arrays`` through slot ``slot`` of the
        pinned double buffer: the slot is rewritten only after the copies
        that last read it have finished (their event), and the copies do
        not block the host."""
        if self.device.type != "cuda":
            return tuple(torch.from_numpy(a) for a in arrays)
        self._wait_put(slot)
        dev = []
        for j, a in enumerate(arrays):
            key = (slot, j)
            host = self._pinned.get(key)
            if host is None or host.numel() * host.element_size() < a.nbytes:
                host = torch.empty(a.nbytes, dtype=torch.uint8,
                                   pin_memory=True)
                self._pinned[key] = host
            view = host[: a.nbytes].view(
                torch.from_numpy(a[:0]).dtype).reshape(a.shape)
            view.numpy()[...] = a
            dev.append(view.to(self.device, non_blocking=True))
        self._put_done[slot] = torch.cuda.Event()
        self._put_done[slot].record()
        return tuple(dev)

    def _wait_put(self, slot: int) -> None:
        """Block until the host-to-device copies that last read ``slot``
        have finished."""
        if slot in self._put_done:
            self._put_done[slot].synchronize()

    def _frame_slot(self, slot: int, N: int, S: int) -> dict:
        """The host frame buffers [N, S, T, ...] of ``slot``, kept per
        (slot, N) and rewritten only after the slot's last host-to-device
        copies have finished. On the Python front-end the group gets fresh
        buffers."""
        if self._sd._native is None:
            zero = self._sd.entropy_chunk([])
            return {k: np.zeros((N, S) + v.shape, v.dtype)
                    for k, v in zero.items()}
        self._wait_put(slot)
        buf = self._frames.get((slot, N))
        if (buf is None or buf["mode"].shape[1] != S
                or buf["residue"].dtype != self._sd._native.residue_dtype):
            buf = self._sd._native.frame_buffers(self.chunk, lead=(N, S))
            self._frames[(slot, N)] = buf
        return buf

    def _to_host_async(self, pcm: torch.Tensor, slot: int):
        """Start the device-to-host copy of ``pcm`` into the pinned buffer
        of ``slot`` on a side stream, ordered after the kernels that write
        it; returns (host tensor, event that marks the copy done). The
        buffer is rewritten only after that event has fired and the caller
        has read the group out of it (:meth:`_finish`)."""
        if self.device.type != "cuda":
            return pcm, None
        if self._d2h_stream is None:
            self._d2h_stream = torch.cuda.Stream(self.device)
        if slot in self._d2h_done:
            self._d2h_done.pop(slot).synchronize()
        nbytes = pcm.numel() * pcm.element_size()
        host = self._pinned_d2h.get(slot)
        if host is None or host.numel() < nbytes:
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            self._pinned_d2h[slot] = host
        host = host[:nbytes].view(pcm.dtype).reshape(pcm.shape)
        done = torch.cuda.Event()
        done.record()
        with torch.cuda.stream(self._d2h_stream):
            self._d2h_stream.wait_event(done)
            host.copy_(pcm, non_blocking=True)
            pcm.record_stream(self._d2h_stream)
            copied = torch.cuda.Event()
            copied.record(self._d2h_stream)
        self._d2h_done[slot] = copied
        return host, copied

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

        Pipelined: each group's device work and device-to-host copy run
        while the host entropy-decodes the next group; the previous group's
        PCM is copied into the outputs once the next group is enqueued. The
        host frame buffers and the pinned buffers of both directions are
        kept per slot of a double buffer and reused across groups and
        calls."""
        S = len(streams)
        max_t = max(len(p) for p in streams)
        C, n1 = self.cs.channels, self.cs.n1
        st = _Stages(self.device, self.stage_sync)
        scan = max(1, int(self.scan if scan is None else scan))
        if transport == "auto":
            transport = "p12" if p12_auto(self.cs, self.device) else "i16"
        use_p12 = transport == "p12" and pack12_supported(self.cs)
        self._sd.set_residue_transport("p12" if use_p12 else "default")
        self.last_stats = {"h2d_bytes": 0, "d2h_bytes": 0,
                           "transport": "p12" if use_p12 else "i16"}
        carry = _stream_carry(self.cs, S)
        bf_host = SimpleNamespace(mode_blockflag=self._bf_host,
                                  n0=self.cs.n0, n1=n1)
        started = np.zeros(S, bool)
        n_chunks = -(-max_t // self.chunk)
        groups: list[list[int]] = []
        ci = 0
        while ci < n_chunks:
            n = 1 << (scan.bit_length() - 1)  # largest pow2 <= scan
            while n > 1 and ci + n > n_chunks:
                n //= 2
            groups.append(list(range(ci, ci + n)))
            ci += n
        # outputs sized by each stream's most samples (3 n1/4 a packet) and
        # cut to the decoded length at the end: np.empty leaves the pages
        # past the audio untouched
        outs = [np.empty((len(p) * (3 * n1 // 4), C), np.int16)
                for p in streams]
        offs = np.zeros(S, np.int64)
        #: the group whose device-to-host copy is in flight: [host pcm,
        #: copy event, totals [N, S], lens [N, S, T] | None]
        pending = None
        st.lap("frontend")
        for gi, group in enumerate(groups):
            N, slot = len(group), gi % 2
            buf = self._frame_slot(slot, N, S)
            lens_all = np.zeros((N, S, self.chunk), np.int64)
            for n, ci in enumerate(group):
                t0 = ci * self.chunk
                view = {k: v[n] for k, v in buf.items()}
                self._sd.entropy_chunk_batch(
                    [pks[t0: t0 + self.chunk] for pks in streams], out=view)
                lens_all[n], started = predict_out_lens(bf_host, view,
                                                        started)
            fr_np = buf if N > 1 else {k: v[0] for k, v in buf.items()}
            lens = lens_all if N > 1 else lens_all[0]
            totals = lens.sum(axis=-1)  # [N, S] or [S]
            # one bucketed cap for the batch: few distinct output shapes
            cap = int(-(-(int(totals.max()) + n1) // 8192) * 8192)
            residue, bb, ib, fb, shapes = pack_frame_buffers(fr_np)
            if use_p12:  # the words travel as int32 (see pack12.py)
                if residue.dtype == np.uint32:
                    # the native front-end emitted the planes: the device
                    # unpacks to the logical residue width
                    logical = residue.shape[:-1] + (residue.shape[-1] * 8 // 3,)
                    shapes = (("residue", logical),) + shapes[1:]
                else:
                    residue = pack12_np(residue)
                residue = residue.view(np.int32)
            st.lap("frontend")
            dev = self._put(slot, (residue, bb, ib, fb))
            self.last_stats["h2d_bytes"] += sum(
                int(a.numel() * a.element_size()) for a in dev)
            st.lap("h2d", device_work=True)
            if compact == "host":
                fn = (decode_chunks_scan_packed_i16 if N > 1
                      else decode_chunk_batch_packed_i16)
                (pcm, _), carry = fn(self.cs, *dev, shapes, carry)
            elif N > 1:
                (pcm, _), carry = decode_chunks_scan_packed(
                    self.cs, *dev, shapes, carry, cap)
            else:
                (pcm, _, _), carry = decode_chunk_batch_packed(
                    self.cs, *dev, shapes, carry, cap)
            st.lap("device", device_work=True)
            self.last_stats["d2h_bytes"] += int(pcm.numel()
                                                * pcm.element_size())
            host, copied = self._to_host_async(pcm, slot)
            # finish the previous group: its copy had this group's
            # front-end time to drain
            if pending is not None:
                self._finish(pending, outs, offs, st)
            pending = [host, copied, totals.reshape(N, S),
                       lens.reshape(N, S, -1) if compact == "host" else None]
            st.lap("d2h", device_work=True)
        if pending is not None:
            self._finish(pending, outs, offs, st)
        self.last_stats["stages"] = st.result()
        return [o[: int(offs[s])] for s, o in enumerate(outs)]

    def _finish(self, entry: list, outs: list, offs: np.ndarray,
                st: _Stages) -> None:
        """Wait for a group's device-to-host copy, then copy its samples
        into the outputs at ``offs`` (advanced here)."""
        host, copied, totals, lens = entry
        if copied is not None:
            copied.synchronize()
        a = host.numpy() if isinstance(host, torch.Tensor) else host
        st.lap("d2h")
        S, C = len(outs), self.cs.channels
        if a.ndim == len(totals.shape) + 1:  # single chunk: add N=1
            a = a[None]
        for n in range(totals.shape[0]):
            an = a[n]
            if lens is None:  # device-compacted [S, cap, C]
                for s in range(S):
                    m = int(totals[n, s])
                    outs[s][int(offs[s]): int(offs[s]) + m] = an[s, :m]
            else:  # padded flat [S, T, C*outw]: slice + interleave
                T = an.shape[1]
                an = an.reshape(S, T, C, -1)
                keep = (np.arange(an.shape[3])[None, :]
                        < lens[n][:, :, None])  # [S, T, w]
                for s in range(S):
                    m = int(totals[n, s])
                    outs[s][int(offs[s]): int(offs[s]) + m] = \
                        an[s].transpose(0, 2, 1)[keep[s]]
            offs += totals[n]
        st.lap("compact")

