"""Streaming batch scheduler: continuous many-stream decode serving.

The port of lewton_tpu/serve.py. The reference's async API (lewton
src/inside_ogg.rs:316-451) adapts one stream to an event loop; this
scheduler keeps the card busy across MANY concurrent streams: streams
register and retire at any time, each device step decodes up to `chunk`
packets from every active stream of a setup group in one batched call, and
PCM is polled per stream as it becomes available.

Streams are grouped by their (ident, setup) header packet bytes (one
``CompiledSetup`` and one native front-end per group); each group keeps
fixed-capacity slot state (a window carry row per slot) so step shapes stay
stable. Idle slots ride along as ``valid=False`` packets, which the
pipeline treats as no-ops.

A step runs the reference's route: the native front-end entropy-decodes the
group's packets (one call per sub-chunk) into the transfer slot's pinned
blocks, which hold the frames packed (``parallel.batch.pack_frame_buffers``'
layout, the residue 12-bit packed on a slow link), the group's chunk
program decodes them with ``compact_cap`` (K1's flat form, the IMDCT GEMM,
the f32 overlap-add, ``compact_i16``; the
reference's ``decode_chunk_batch_packed`` / ``decode_chunks_scan_packed``,
here one CUDA graph per (buffer slot, N, output length), ``parallel.graphs``)
and the compacted i16 PCM comes back. The packing, the copies and the
decode are :meth:`~lewton_tpu_torch.parallel.batch.TransferSlots.dispatch`,
shared with ``BatchDecoder``, over its pinned, event-guarded double buffer;
the device-to-host copy runs on a side stream, and collecting a step waits
for that step's copy only. The group's window carry is its programs'
static carry: retiring a stream resets its row in place.
"""

from __future__ import annotations

import os as _os
import time as _time
from collections import deque
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np

from . import profiling
from .header import read_header_ident, read_header_setup
from .models.decoder import StreamDecoder, predict_out_lens
from .native import NativeIncrementalReader
from .ops.windowing import init_window_carry
from .parallel.batch import TransferSlots
from .parallel.pack12 import p12_auto

__all__ = ["StreamingScheduler"]


@dataclass
class _StreamState:
    sid: object
    slot: int
    packets: list  # pending Packet objects (with metadata)
    fed: int = 0  # packets consumed so far
    out: list = field(default_factory=list)  # decoded np arrays [n, C] i16
    cur_absgp: int | None = 0
    done: bool = False
    #: (absolute packet index, message) for undecodable packets — the
    #: stream keeps going (bad packets emit no PCM and leave the window
    #: state untouched, the reference's per-packet semantics)
    errors: list = field(default_factory=list)
    reader: object = None  # the stream's NativeIncrementalReader
    serial: int | None = None
    #: dispatched-but-uncollected PCM slices referencing this stream —
    #: is_done must stay False while any are in flight (the pipeline keeps
    #: the newest step uncollected, so `done and not out` alone can drop
    #: the final chunk's audio)
    inflight: int = 0
    #: latency stamps (perf_counter): registration, first/last PCM
    #: materialized into `out` — the serving SLO surface
    t_added: float = 0.0
    t_first_pcm: float | None = None
    t_last_pcm: float | None = None


class _Group:
    """All streams sharing one setup: one batch on ``device``, slotted
    state."""

    def __init__(self, ident_pck: bytes, setup_pck: bytes, capacity: int,
                 chunk: int, scan: int = 1, device="cuda"):
        ident = read_header_ident(ident_pck)
        setup = read_header_setup(setup_pck, ident)
        self.sd = StreamDecoder(ident, setup, chunk,
                                raw_headers=(ident_pck, setup_pck),
                                device=device)
        self.cs = self.sd.cs
        self.device = self.sd.device
        self.chunk = chunk
        self.scan = max(1, scan)
        self.capacity = capacity
        C, W = self.cs.channels, self.cs.n1 // 2
        self.carry = init_window_carry(C, W, capacity, self.device)
        self.started = np.zeros(capacity, bool)
        #: the block flags on the host: predict_out_lens reads them every
        #: sub-chunk, and a read of the device table would synchronise
        self._bf = SimpleNamespace(
            mode_blockflag=self.cs.mode_blockflag.cpu().numpy(),
            n0=self.cs.n0, n1=self.cs.n1)
        self.streams: dict[int, _StreamState] = {}  # slot -> state
        self.free = list(range(capacity))
        #: frame buffers per (slot, N) and pinned buffers per slot of a
        #: double buffer; step k uses slot k % 2, and step k - 2, the
        #: slot's last user, has been collected before step k dispatches
        self._slots = TransferSlots(self.sd)
        self._steps = 0
        #: dispatched-but-uncollected device steps: (host pcm, copy event,
        #: slice plan)
        self._inflight: list[tuple] = []
        #: lossless 12-bit residue H2D when the setup's bound allows and
        #: the MEASURED link rate makes 25% fewer bytes a win (one-shot
        #: probe; false on the CPU and on a fast link, see
        #: parallel/pack12.p12_auto). The native front-end then emits the
        #: p12 planes directly.
        self._p12 = p12_auto(self.cs)
        self.sd.set_residue_transport("p12" if self._p12 else "default")
        #: cumulative transfer accounting (bytes H2D / D2H)
        self.stats = {"h2d_bytes": 0, "d2h_bytes": 0}

    def add(self, st: _StreamState) -> None:
        st.slot = self.free.pop()
        self.streams[st.slot] = st

    def remove(self, st: _StreamState) -> None:
        del self.streams[st.slot]
        self.free.append(st.slot)
        # reset the slot's carry row for reuse, in place
        fresh = init_window_carry(self.cs.channels, self.cs.n1 // 2, 1,
                                  self.device)
        for c, f in zip(self.carry, fresh):
            c[st.slot] = f[0]
        self.started[st.slot] = False

    def pending(self) -> bool:
        return any(s.fed < len(s.packets) for s in self.streams.values())

    def _entropy(self, batches: dict, N: int, slot: int):
        """Host entropy decode of one step into the slot's frame buffers
        [N, S, T, ...] (idle slots stay invalid): ONE native call per
        sub-chunk over the whole group, worker threads across the slots.
        Returns (frames, statuses {(n, slot): status of its packets})."""
        S, T = self.capacity, self.chunk
        fr = self._slots.frame_slot(slot, N, S)
        threads = min(8, _os.cpu_count() or 1)
        statuses: dict[tuple[int, int], np.ndarray] = {}
        for n in range(N):
            by_slot = [[p.data for p in batches[(n, s)]]
                       if (n, s) in batches else [] for s in range(S)]
            view = {k: v[n] for k, v in fr.items()}
            status_all = self.sd._native.decode_chunk_batch(
                by_slot, T, view, threads=threads)
            for s in range(S):
                if (n, s) in batches:
                    statuses[(n, s)] = status_all[s, : len(batches[(n, s)])]
        for (n, s), status in statuses.items():
            if (status != 0).any():
                # The device overlap-add treats invalid slots as a chunk
                # SUFFIX (ops/windowing.py pwr shift); compact good frames
                # to the front so a mid-chunk bad packet doesn't feed the
                # next packet garbage carry.
                good = np.flatnonzero(status == 0)
                for v in fr.values():
                    v[n, s, : len(good)] = v[n, s][good]
                    v[n, s, len(good):] = 0
        return fr, statuses

    def step_dispatch(self) -> None:
        """Host half of one device step: entropy-decode up to `chunk`
        pending packets per stream, enqueue the host-to-device copies, the
        device work and the device-to-host copy, and do ALL bookkeeping
        that doesn't need the PCM bytes (status/errors, granule tracking,
        fed/done flags). The PCM slice plan goes on the inflight queue for
        :meth:`collect`.

        While the card runs step k and its PCM streams back, the host
        entropy-decodes step k+1: wall time per step approaches
        max(host, device+transfer) instead of their sum.
        """
        if not self.pending():
            return
        S, T = self.capacity, self.chunk
        # scan depth: dispatch N sub-chunks in one call, N sized to the
        # ACTUAL backlog (largest power of two <= min(scan, deepest stream
        # backlog in chunks)). A fixed N would pay N x cap-padded PCM D2H
        # even when streams hold one chunk of work.
        backlog = max((len(s.packets) - s.fed for s in
                       self.streams.values()), default=0)
        N = 1
        while N * 2 <= self.scan and N * 2 <= -(-backlog // T):
            N *= 2
        batches: dict[tuple[int, int], list] = {}  # (n, slot) -> packets
        for slot, st in self.streams.items():
            for n in range(N):
                batch = st.packets[st.fed + n * T : st.fed + (n + 1) * T]
                if batch:
                    batches[(n, slot)] = batch
        buf_slot = self._steps % 2
        self._steps += 1
        fr, statuses = self._entropy(batches, N, buf_slot)
        lens = np.zeros((N, S, T), np.int64)
        for n in range(N):
            lens[n], self.started = predict_out_lens(
                self._bf, {k: v[n] for k, v in fr.items()}, self.started)
        # the D2H copy starts now and drains while later steps dispatch
        host, copied, self.carry, h2d, d2h = self._slots.dispatch(
            buf_slot, fr, lens, self.carry, self._p12)
        self.stats["h2d_bytes"] += h2d
        self.stats["d2h_bytes"] += d2h
        # bookkeeping + PCM slice plan (needs only lengths, not bytes).
        # Sub-chunks advance a stream's packets in time order (n outer).
        plan: list[tuple] = []  # (stream, slot, n, pos, keep)
        for slot, st in list(self.streams.items()):
            consumed = 0
            for n in range(N):
                batch = batches.get((n, slot))
                if not batch:
                    continue
                status = statuses[(n, slot)]
                pos = 0
                j = 0  # compacted frame position (valid frames only)
                for t, pck in enumerate(batch):
                    if status[t] != 0:
                        st.errors.append((
                            st.fed + consumed + t,
                            "header packet in audio stream"
                            if status[t] == 1
                            else "undecodable audio packet",
                        ))
                        continue  # no PCM; window state untouched
                    m = int(lens[n, slot, j])
                    j += 1
                    keep = self._apply_absgp(st, pck, m)
                    if keep:
                        plan.append((st, slot, n, pos, keep))
                    pos += m
                consumed += len(batch)
            st.fed += consumed
            if st.fed >= len(st.packets) and st.packets and \
                    st.packets[-1].last_in_stream:
                st.done = True
        for st_, _, _, _, _ in plan:
            st_.inflight += 1
        self._inflight.append((host, copied, plan))

    def collect(self, drain: bool = False) -> None:
        """Materialize dispatched PCM. Keeps the newest step in flight
        (the pipeline depth) unless ``drain`` is set. Waits for each
        collected step's own device-to-host copy, and copies every slice
        out of the pinned buffer, which a later step rewrites."""
        with profiling.span("serve.collect"):
            while self._inflight and (drain or len(self._inflight) > 1):
                host, copied, plan = self._inflight.pop(0)
                if copied is not None:
                    with profiling.span("wait"):
                        copied.synchronize()
                pcm = host.numpy()  # [S, cap, C] or [N, S, cap, C] i16
                if pcm.ndim == 3:
                    pcm = pcm[None]
                now = _time.perf_counter()
                for st, slot, n, pos, keep in plan:
                    st.out.append(pcm[n, slot, pos : pos + keep].copy())
                    st.inflight -= 1
                    # plan entries always carry keep > 0 (step_dispatch
                    # skips zero-keep packets), so every entry stamps
                    if st.t_first_pcm is None:
                        st.t_first_pcm = now
                    st.t_last_pcm = now

    @staticmethod
    def _apply_absgp(st: _StreamState, pck, n: int) -> int:
        """End-of-stream truncation + granule bookkeeping (same rules as
        OggStreamReader._apply_absgp). Takes the packet's decoded length,
        returns how many samples to keep."""
        keep = n
        if st.cur_absgp is not None and pck.last_in_stream:
            keep = min(n, max(0, (pck.absgp_page or 0) - st.cur_absgp))
        if pck.last_in_page and pck.absgp_page is not None:
            st.cur_absgp = pck.absgp_page
        elif st.cur_absgp is not None:
            st.cur_absgp += keep
        return keep


def _read_packets(sid, rdr, data: bytes, serial, packets: list) -> None:
    """Feed ``data`` to stream ``sid``'s reader and append every packet of
    ``serial`` it completes to ``packets`` (an ``ogg.read`` span, with the
    bytes and pages it read)."""
    with profiling.span("ogg.read", sid) as sp:
        pages = rdr.pages_read
        if data:
            rdr.feed(data)
        while (p := rdr.read_packet()) is not None:
            if p.stream_serial == serial:
                packets.append(p)
        if sp is not None:
            profiling.count("ogg.bytes", len(data))
            profiling.count("ogg.pages", rdr.pages_read - pages)


class StreamingScheduler:
    """Register Ogg Vorbis streams, step the device, poll PCM per stream.

    ``device``: where the groups decode (the card unless the caller names
    another). Each group's host front-end is the port's native library,
    built at first use; a failed build raises.
    """

    def __init__(self, capacity: int = 16, chunk: int = 16, scan: int = 1,
                 device="cuda"):
        self.capacity = capacity
        self.chunk = chunk
        #: sub-chunks per device dispatch when backlogs allow
        self.scan = scan
        self.device = device
        #: (ident-bytes, setup-bytes) -> list of groups (a new group spins
        #: up when all are full). Keyed by BOTH header packets:
        #: byte-identical setups with different ident headers
        #: (blocksizes/rate/channels) must not share a compiled geometry.
        self.groups: dict[tuple[bytes, bytes], list[_Group]] = {}
        self.streams: dict[object, tuple[_Group, _StreamState]] = {}
        #: streams still waiting for their three header packets
        self.pending: dict[object, list] = {}
        #: (first_pcm_latency_s, turnaround_s) of retired completed
        #: streams — bounded so a long-lived server's metrics stay O(1)
        self._completed: deque = deque(maxlen=4096)
        #: steps run (the ``serve.step`` span's rid)
        self._step_count = 0

    def _group_with_room(self, ident_pck: bytes, setup_pck: bytes) -> _Group:
        lst = self.groups.setdefault((ident_pck, setup_pck), [])
        for grp in lst:
            if grp.free:
                return grp
        grp = _Group(ident_pck, setup_pck, self.capacity, self.chunk,
                     self.scan, self.device)
        lst.append(grp)
        return grp

    def add_stream(self, sid, ogg_bytes: bytes | None = None) -> None:
        """Register a stream. With ``ogg_bytes`` the whole stream is queued
        at once; without, feed it incrementally via :meth:`feed` — packets
        become decodable as soon as their pages are complete."""
        if sid in self.streams or sid in self.pending:
            raise ValueError(f"stream id {sid!r} already registered")
        with profiling.span("serve.register", sid) as sp:
            if sp is not None:
                profiling.count("serve.requests", 1)
            rdr = NativeIncrementalReader()
            # reader, serial, header packets, registration stamp
            self.pending[sid] = [rdr, None, [], _time.perf_counter()]
            if ogg_bytes is not None:
                self.feed(sid, ogg_bytes)

    def feed(self, sid, data: bytes) -> None:
        """Append bytes to an incrementally-fed stream."""
        if sid in self.streams:
            _, st = self.streams[sid]
            _read_packets(sid, st.reader, data, st.serial, st.packets)
            return
        if sid not in self.pending:
            raise KeyError(f"unknown stream id {sid!r}")
        rdr, serial, headers, t_added = self.pending[sid]
        with profiling.span("ogg.read", sid) as sp:
            pages = rdr.pages_read
            rdr.feed(data)
            while len(headers) < 3 and (p := rdr.read_packet()) is not None:
                if serial is None:
                    serial = p.stream_serial
                    self.pending[sid][1] = serial
                if p.stream_serial == serial:
                    headers.append(p)
            if sp is not None:
                profiling.count("ogg.bytes", len(data))
                profiling.count("ogg.pages", rdr.pages_read - pages)
        if len(headers) < 3:
            return
        # headers complete: assign a group and promote to active
        with profiling.span("serve.enter", sid):
            grp = self._group_with_room(headers[0].data, headers[2].data)
            st = _StreamState(sid=sid, slot=-1, packets=[], t_added=t_added)
            st.reader = rdr
            st.serial = serial
            grp.add(st)
        _read_packets(sid, rdr, b"", serial, st.packets)
        self.streams[sid] = (grp, st)
        del self.pending[sid]

    def step(self) -> bool:
        """One device step over every group with pending work. Returns
        whether any work remains.

        Pipelined: each group's newest dispatched step stays in flight
        (device compute + D2H overlap the NEXT step's host entropy), so a
        step's PCM becomes pollable after the following step() call — or
        immediately once step() returns False (the final call drains).
        """
        self._step_count += 1
        with profiling.span("serve.step", self._step_count):
            groups = [g for lst in self.groups.values() for g in lst]
            for grp in groups:
                grp.step_dispatch()
            more = any(g.pending() for g in groups)
            for grp in groups:
                grp.collect(drain=not more)
        return more

    def poll(self, sid) -> np.ndarray:
        """Drain decoded PCM for a stream: interleaved i16 [n, C]."""
        sp = profiling.begin("serve.poll", sid)  # called for every stream
        try:
            if sid in self.pending:  # headers not complete yet
                return np.zeros((0, 0), np.int16)
            grp, st = self.streams[sid]
            if not st.out:
                return np.zeros((0, grp.cs.channels), np.int16)
            out = np.concatenate(st.out, axis=0)
            st.out.clear()
            return out
        finally:
            profiling.end(sp)

    def stream_errors(self, sid) -> list:
        """(packet index, message) for every undecodable packet so far.
        Bad packets are skipped (no PCM, window state untouched); the
        stream itself keeps decoding — per-packet reference semantics."""
        if sid in self.pending:
            return []
        _, st = self.streams[sid]
        return list(st.errors)

    def transfer_stats(self, reset: bool = False) -> dict:
        """Aggregate bytes shipped over the host<->device link across all
        groups since construction (or the last ``reset=True`` call)."""
        agg = {"h2d_bytes": 0, "d2h_bytes": 0}
        for lst in self.groups.values():
            for g in lst:
                for k in agg:
                    agg[k] += g.stats[k]
                if reset:
                    g.stats = {"h2d_bytes": 0, "d2h_bytes": 0}
        return agg

    def is_done(self, sid) -> bool:
        if sid in self.pending:
            return False
        _, st = self.streams[sid]
        return st.done and not st.out and st.inflight == 0

    def remove_stream(self, sid) -> None:
        if sid in self.pending:  # headers never completed: just unregister
            del self.pending[sid]
            return
        grp, st = self.streams.pop(sid)
        if st.done and st.t_first_pcm is not None:
            # t_last_pcm is set whenever t_first_pcm is (same stamp site)
            self._completed.append((st.t_first_pcm - st.t_added,
                                    st.t_last_pcm - st.t_added))
        grp.remove(st)

    def latency_stats(self) -> dict:
        """Serving SLO metrics over retired completed streams (last 4096):
        seconds from registration to the FIRST PCM materialized
        (time-to-first-audio) and to the LAST (turnaround), as
        p50/p95/p99/max percentiles. Streams are stamped when collect()
        materializes their PCM, so the numbers include device + transfer
        + pipeline-depth delay — what a caller actually waits. Empty
        dict until a completed stream has been removed."""
        if not self._completed:
            return {}
        first = np.array([c[0] for c in self._completed])
        total = np.array([c[1] for c in self._completed])
        pct = (50, 95, 99)

        def row(a):
            d = {f"p{p}_s": float(np.percentile(a, p)) for p in pct}
            d["max_s"] = float(a.max())
            return d

        return {"streams": len(self._completed),
                "first_pcm": row(first), "turnaround": row(total)}
