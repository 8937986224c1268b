"""ctypes binding of the port's host library.

The C++ sources beside this file are the port's copy of the reference's
host library (lewton_tpu/native/): Ogg demux, header parse and Huffman/VQ
entropy decode into the same dense frames as the Python front-end
(``audio.decode_packet_entropy`` + ``models.decoder.pack_frames``), bit for
bit (``lt_bits``, ``lt_header``, ``lt_entropy``, ``lt_ogg``; the Ogg page
loop also reads fed bytes, :class:`NativeIncrementalReader`); the CPU
synthesis decoder of the reader's ``"native"`` backend (``lt_synth``,
:class:`NativeDecoder`), the one-call whole-file decode (``lt_file``,
:func:`decode_ogg_i16`) and the lewton-compatible C ABI of
``lewton_tpu.h`` (``lt_capi``; ``_build.capi_library`` gives C clients
the library's path). ``_build.load_host_library`` compiles them with the
host's C++ compiler into ``build/lewton_tpu_torch/`` at first use; a
failed build raises, and nothing here falls back to the Python front-end.
"""

from __future__ import annotations

import ctypes as C
from collections import deque

import numpy as np

from .. import _build, profiling
from ..errors import AudioBadFormat, AudioIsHeader, BadHeader, OggError

__all__ = ["available", "NativeStream", "NativeDecoder", "PacketSpans",
           "NativePacket", "NativePacketReader", "NativeIncrementalReader",
           "demux", "demux_spans", "span_tables",
           "decode_ogg_i16", "pack12", "compact_rows"]

_lib = None

_u8p, _u32p, _u64p = (C.POINTER(C.c_uint8), C.POINTER(C.c_uint32),
                      C.POINTER(C.c_uint64))
_i16p, _i32p, _f32p = (C.POINTER(C.c_int16), C.POINTER(C.c_int32),
                       C.POINTER(C.c_float))
_i64p = C.POINTER(C.c_int64)
#: lt_decode_chunk's arguments: the stream; the span tables (base pointer
#: a stream, offsets and lengths [S, T], counts [S], S, T); the frame
#: outputs (mode, prev, next, status, the residue's emit code and buffer,
#: f_used, f1_ys, f1_flags, f0_cosc, f0_amp, row width); worker threads,
#: then the workers' busy ns (one slot a worker), the call's wall ns x
#: workers and the workers' stage slots ([workers, len(_STAGE_COUNTERS)]
#: ns: a row a worker, a column a stage), or nulls
_CHUNK_ARGS = [C.c_void_p, C.POINTER(C.c_void_p), _u64p, _u64p, _i32p,
               C.c_int, C.c_int, _i32p, _u8p, _u8p, _u8p, C.c_int,
               C.c_void_p, _u8p, _i32p, _u8p, _f32p, _f32p, C.c_int,
               C.c_int, _u64p, _u64p, _u64p]
#: the counter of each column of the entry's stage slots, in the order of
#: lt_decode.h's LT_NS_* constants: clearing and deinterleaving the type-2
#: residue scratch of submaps off the stereo direct write; the per-channel
#: residue (formats 0 and 1)
_STAGE_COUNTERS = ("frontend.deinterleave_ns", "frontend.residue01_ns")
#: residue dtype -> the entry's emit code (LT_EMIT_* of lt_decode.h)
_EMIT = {np.dtype(np.float32): 0, np.dtype(np.int16): 1,
         np.dtype(np.uint32): 2}


def _load():
    """Build (if needed) and load the library and declare its entry points;
    raises when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _build.load_host_library()
    lib.lt_stream_new.restype = C.c_void_p
    lib.lt_stream_new.argtypes = [_u8p, C.c_size_t, _u8p, C.c_size_t,
                                  C.c_char_p, C.c_size_t]
    lib.lt_stream_free.argtypes = [C.c_void_p]
    for name in ("channels", "n0", "n1", "rate", "max_posts",
                 "f0_order_max", "n_modes"):
        fn = getattr(lib, f"lt_stream_{name}")
        fn.restype = C.c_int
        fn.argtypes = [C.c_void_p]
    lib.lt_stream_mode_blockflag.restype = C.c_int
    lib.lt_stream_mode_blockflag.argtypes = [C.c_void_p, C.c_int]
    lib.lt_decode_chunk.restype = C.c_int
    lib.lt_decode_chunk.argtypes = _CHUNK_ARGS
    lib.lt_chunk_pool_stats.restype = None
    lib.lt_chunk_pool_stats.argtypes = [_u64p, _u64p]
    lib.lt_ogg_new.restype = C.c_void_p
    lib.lt_ogg_new.argtypes = [_u8p, C.c_size_t]
    lib.lt_ogg_new_into.restype = C.c_void_p
    lib.lt_ogg_new_into.argtypes = [_u8p, C.c_size_t, _u8p]
    lib.lt_ogg_free.argtypes = [C.c_void_p]
    lib.lt_ogg_packet_count.restype = C.c_int64
    lib.lt_ogg_packet_count.argtypes = [C.c_void_p]
    lib.lt_ogg_packet_meta.argtypes = [C.c_void_p, _u64p, _u32p, _u8p,
                                       _u64p, _u64p]
    lib.lt_ogg_packet_data.argtypes = [C.c_void_p, _u8p]
    lib.lt_ogg_stream_new.restype = C.c_void_p
    lib.lt_ogg_stream_new.argtypes = []
    lib.lt_ogg_stream_feed.restype = C.c_int64
    lib.lt_ogg_stream_feed.argtypes = [C.c_void_p, _u8p, C.c_size_t]
    for name in ("pages", "held_bytes"):
        fn = getattr(lib, f"lt_ogg_{name}")
        fn.restype = C.c_int64
        fn.argtypes = [C.c_void_p]
    lib.lt_pack12.restype = C.c_int64
    lib.lt_pack12.argtypes = [_i16p, _u32p, C.c_int64, C.c_int64]
    lib.lt_compact_rows.restype = None
    lib.lt_compact_rows.argtypes = [_i16p, C.c_int64, C.c_int64,
                                    C.POINTER(C.c_void_p), _i64p, _i64p,
                                    C.c_int64, C.c_int64]
    # the CPU synthesis decoder (lt_synth.cc) and the whole-file decode
    lib.lt_decoder_new.restype = C.c_void_p
    lib.lt_decoder_new.argtypes = [_u8p, C.c_size_t, _u8p, C.c_size_t,
                                   C.c_char_p, C.c_size_t]
    for name in ("free", "reset"):
        fn = getattr(lib, f"lt_decoder_{name}")
        fn.restype = None
        fn.argtypes = [C.c_void_p]
    for name in ("channels", "rate", "n1", "state_plen", "state_started"):
        fn = getattr(lib, f"lt_decoder_{name}")
        fn.restype = C.c_int
        fn.argtypes = [C.c_void_p]
    lib.lt_decoder_decode.restype = C.c_int
    lib.lt_decoder_decode.argtypes = [C.c_void_p, _u8p, C.c_size_t, _f32p]
    lib.lt_decoder_decode_many.restype = None
    lib.lt_decoder_decode_many.argtypes = [C.c_void_p, _u8p, _u64p, _u64p,
                                           C.c_int, _f32p, _i32p]
    lib.lt_decoder_save_state.restype = None
    lib.lt_decoder_save_state.argtypes = [C.c_void_p, _f32p]
    lib.lt_decoder_load_state.restype = None
    lib.lt_decoder_load_state.argtypes = [C.c_void_p, _f32p, C.c_int,
                                          C.c_int]
    lib.lt_decode_ogg_i16.restype = C.c_int64
    lib.lt_decode_ogg_i16.argtypes = [C.c_void_p, _i16p, C.c_int64, _i64p]
    _lib = lib
    return lib


def available() -> bool:
    """True once this process has loaded the library. Callers that can
    use it without needing it (``parallel.pack12.pack12_np``) ask this, so
    they never start a build."""
    return _lib is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(C.POINTER(ctype))


def _u8(arr: np.ndarray):
    return _ptr(arr.view(np.uint8), C.c_uint8)


def pack12(arr: np.ndarray) -> np.ndarray:
    """The C loop of ``parallel.pack12.pack12_np``: [..., 8K] i16 ->
    [..., 3K] u32. Raises on a value outside [-2048, 2047]."""
    lib = _load()
    if arr.dtype != np.int16 or arr.shape[-1] % 8:
        raise ValueError("pack12 takes i16 rows of a multiple of 8 values")
    arr = np.ascontiguousarray(arr)
    n = arr.shape[-1]
    rows = arr.size // n if n else 0
    out = np.empty(arr.shape[:-1] + (n * 3 // 8,), np.uint32)
    if lib.lt_pack12(_ptr(arr, C.c_int16), _ptr(out, C.c_uint32),
                     C.c_int64(rows), C.c_int64(n)):
        raise ValueError("pack12: residue value outside [-2048, 2047]")
    return out


def compact_rows(src: np.ndarray, totals: np.ndarray, starts: np.ndarray,
                 dst: np.ndarray, rows: np.ndarray, lo: int, hi: int) -> None:
    """The C loop of a part of ``BatchDecoder``'s compaction: for each
    stream s in [lo, hi), ``src[s, :totals[s]]`` (i16 [S, cap, C]) into the
    output at address ``dst[s]`` (i16 [rows[s], C], C-contiguous) from row
    ``starts[s]``; the interpreter's lock is released once for the part.
    Raises, copying nothing, when a row named lies outside ``src`` or its
    output."""
    lib = _load()
    if (src.dtype != np.int16 or not src.flags.c_contiguous
            or src.ndim != 3 or dst.dtype != np.uintp
            or not dst.flags.c_contiguous):
        raise ValueError("compact_rows takes C-contiguous i16 [S, cap, C] "
                         "and output addresses")
    totals, starts = (np.ascontiguousarray(v, np.int64)
                      for v in (totals, starts))
    S = src.shape[0]
    if not (len(totals) == len(starts) == len(dst) == len(rows) == S
            and 0 <= lo <= hi <= S):
        raise ValueError("compact_rows: a table or the part does not fit "
                         "the chunk's streams")
    part = slice(lo, hi)
    if ((totals[part] < 0).any() or (totals[part] > src.shape[1]).any()
            or (starts[part] < 0).any()
            or (starts[part] + totals[part] > rows[part]).any()):
        raise ValueError("compact_rows: rows outside the chunk or the output")
    lib.lt_compact_rows(
        _ptr(src, C.c_int16), C.c_int64(src.shape[1] * src.shape[2]),
        C.c_int64(src.shape[2]), dst.ctypes.data_as(C.POINTER(C.c_void_p)),
        _ptr(starts, C.c_int64), _ptr(totals, C.c_int64), C.c_int64(lo),
        C.c_int64(hi))


class NativeStream:
    """Per-stream entropy front-end: packets -> dense frames."""

    def __init__(self, ident_packet: bytes, setup_packet: bytes):
        lib = _load()
        self._lib = lib
        err = C.create_string_buffer(256)
        ib = np.frombuffer(ident_packet, dtype=np.uint8)
        sb = np.frombuffer(setup_packet, dtype=np.uint8)
        self._h = lib.lt_stream_new(_u8(ib), len(ident_packet), _u8(sb),
                                    len(setup_packet), err, 256)
        if not self._h:
            raise BadHeader(err.value.decode() or "native header parse failed")
        self.channels = lib.lt_stream_channels(self._h)
        self.n0 = lib.lt_stream_n0(self._h)
        self.n1 = lib.lt_stream_n1(self._h)
        self.sample_rate = lib.lt_stream_rate(self._h)
        self.max_posts = lib.lt_stream_max_posts(self._h)
        self.f0_order_max = lib.lt_stream_f0_order_max(self._h)
        self.n_modes = lib.lt_stream_n_modes(self._h)
        self.mode_blockflag = np.array(
            [lib.lt_stream_mode_blockflag(self._h, m)
             for m in range(self.n_modes)], dtype=np.int32)
        #: residue frame width; callers with a compiled setup narrow it to
        #: the effective spectral extent (CompiledSetup.w_eff)
        self.frame_width = self.n1 // 2
        self._residue_dtype = np.dtype(np.float32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lt_stream_free(self._h)
            self._h = None

    @property
    def residue_dtype(self) -> np.dtype:
        """Residue frame dtype: float32 (the default), int16 (exact when the
        setup passes the static integer-lattice check, residue_i16_bound) or
        uint32, the 12-bit transport planes packed at emit time (needs
        pack12_supported: static bound < 2048, row width divisible by 8)."""
        return self._residue_dtype

    @residue_dtype.setter
    def residue_dtype(self, value) -> None:
        value = np.dtype(value)
        if value not in (np.float32, np.int16, np.uint32):
            raise ValueError(f"residue dtype {value}: float32, int16 or "
                             "uint32 (p12)")
        self._residue_dtype = value

    def _residue_row_width(self) -> int:
        """Residue row width in elements of residue_dtype (the p12 planes
        are 3/8 of the logical i16 row)."""
        n = self.channels * self.frame_width
        if self.residue_dtype == np.uint32:
            if n % 8:
                raise ValueError("p12 emit needs a row width divisible by 8")
            return 3 * n // 8
        return n

    def frame_layout(self, T: int) -> dict:
        """name -> (shape after the lead axes, dtype) of the frames."""
        Cn, P = self.channels, self.max_posts
        Om = max(self.f0_order_max, 1)
        return {
            "mode": ((T,), np.int32),
            "prev_flag": ((T,), bool),
            "next_flag": ((T,), bool),
            "valid": ((T,), bool),
            # flat rows: [T, C*W] logical, [T, 3*C*W/8] u32 for p12
            "residue": ((T, self._residue_row_width()), self.residue_dtype),
            "f_used": ((T, Cn), bool),
            "f1_ys": ((T, Cn, P), np.int32),
            "f1_flags": ((T, Cn, P), bool),
            "f0_cosc": ((T, Cn, Om), np.float32),
            "f0_amp": ((T, Cn), np.float32),
        }

    def frame_buffers(self, T: int, lead: tuple = ()) -> dict:
        """Zeroed frame arrays of shape [*lead, T, ...] (the layout of
        models.decoder.pack_frames)."""
        return {k: np.zeros(lead + shape, dt)
                for k, (shape, dt) in self.frame_layout(T).items()}

    def chunk_args(self, bufs: np.ndarray, offs: np.ndarray,
                   lens: np.ndarray, counts: np.ndarray, out: dict,
                   status: np.ndarray) -> tuple:
        """lt_decode_chunk's arguments up to the worker threads, after
        checking that each table and frame buffer is what the C side reads
        or writes: contiguous, of its dtype and of the [S, T] lead of
        ``offs`` (``status`` too). numpy bools are one byte, so uint8 views
        alias them (the C side writes 0/1)."""
        S, T = offs.shape
        want = {"bufs": ((S,), np.uint64), "offs": ((S, T), np.uint64),
                "lens": ((S, T), np.uint64), "counts": ((S,), np.int32),
                "status": ((S, T), np.uint8)}
        want.update((k, ((S,) + shape, dt))
                    for k, (shape, dt) in self.frame_layout(T).items())
        got = dict(out, bufs=bufs, offs=offs, lens=lens, counts=counts,
                   status=status)
        for k, (shape, dt) in want.items():
            a = got[k]
            if (a.shape != shape or a.dtype != dt
                    or not a.flags.c_contiguous):
                raise ValueError(f"{k}: {a.dtype}{a.shape} (contiguous "
                                 f"{a.flags.c_contiguous}), expected "
                                 f"{np.dtype(dt)}{shape}")
        if (counts < 0).any() or (counts > T).any():
            raise ValueError(f"counts outside [0, {T}]")
        return (self._h, bufs.ctypes.data_as(C.POINTER(C.c_void_p)),
                _ptr(offs, C.c_uint64), _ptr(lens, C.c_uint64),
                _ptr(counts, C.c_int32), S, T,
                _ptr(out["mode"], C.c_int32), _u8(out["prev_flag"]),
                _u8(out["next_flag"]), _u8(status),
                _EMIT[out["residue"].dtype], out["residue"].ctypes.data,
                _u8(out["f_used"]), _ptr(out["f1_ys"], C.c_int32),
                _u8(out["f1_flags"]), _ptr(out["f0_cosc"], C.c_float),
                _ptr(out["f0_amp"], C.c_float), int(self.frame_width))

    def decode_spans(self, bufs: np.ndarray, offs: np.ndarray,
                     lens: np.ndarray, counts: np.ndarray, out: dict,
                     threads: int = 1) -> np.ndarray:
        """Entropy-decode a stream batch in one native call, ``threads``
        worker threads over the streams. The span tables
        (:func:`span_tables`): ``bufs`` uint64 [S], the base address of
        each stream's blob (the caller keeps them alive; streams may share
        one); ``offs``/``lens`` uint64 [S, T], each packet's bytes in its
        stream's blob; ``counts`` int32 [S], the packets of each stream.
        ``out``: frame buffers with lead (S,), of the residue emit of
        :attr:`residue_dtype`. Returns the status [S, T] (0 ok, 1 header
        packet, 2 bad; 0 past a stream's packets). Slots past a stream's
        packets keep stale contents; ``valid`` (set here) masks them."""
        status = np.zeros(offs.shape, np.uint8)
        _run_batch(self._lib.lt_decode_chunk,
                   self.chunk_args(bufs, offs, lens, counts, out, status),
                   threads)
        valid = status == 0
        valid[np.arange(offs.shape[1])[None, :] >= counts[:, None]] = False
        out["valid"][...] = valid
        return status


def span_tables(streams: list, T: int) -> tuple:
    """The span tables of :meth:`NativeStream.decode_spans` for one chunk
    of a stream batch: [S][<=T] packets, each stream a list of bytes or a
    :class:`PacketSpans` (all streams of one kind); packets past T are not
    read. Lists of bytes are joined into one blob, every stream's base;
    PacketSpans keep their own blobs. Returns (bufs, offs, lens, counts,
    held): the caller keeps ``held`` (the joined bytes, or the streams)
    alive until the call returns."""
    S = len(streams)
    offs = np.zeros((S, T), np.uint64)
    lens = np.zeros((S, T), np.uint64)
    counts = np.zeros(S, np.int32)
    bufs = np.zeros(S, np.uint64)
    if S and isinstance(streams[0], PacketSpans):
        # zero-copy: the packets stay in their demux blobs
        for s, sp in enumerate(streams):
            n = min(len(sp), T)
            counts[s] = n
            offs[s, :n] = sp.offs[:n]
            lens[s, :n] = sp.lens[:n]
            bufs[s] = sp.data.ctypes.data
        return bufs, offs, lens, counts, streams
    chunks: list[bytes] = []
    pos = 0
    for s, packets in enumerate(streams):
        n = min(len(packets), T)
        counts[s] = n
        if not n:
            continue
        chunks.extend(packets[:n])
        ln = np.fromiter(map(len, packets[:n]), np.uint64, n)
        lens[s, :n] = ln
        offs[s, :n] = pos + np.cumsum(ln) - ln
        pos += int(ln.sum())
    blob = (np.frombuffer(b"".join(chunks), dtype=np.uint8) if pos
            else np.zeros(1, np.uint8))
    bufs[:] = blob.ctypes.data
    return bufs, offs, lens, counts, blob


def _run_batch(fn, args: tuple, threads: int) -> None:
    """Call the chunk entry ``fn(*args, threads, busy, wall, stages)`` in a
    ``frontend.entropy`` span. While the tracer records, the workers' busy
    ns, the call's wall ns x workers and each column of the workers' stage
    slots (a row a worker: ns clearing and deinterleaving the type-2
    residue scratch of submaps off the stereo direct write, ns in the
    per-channel residue) go to the counters ``frontend.busy_ns``,
    ``frontend.wall_ns`` and :data:`_STAGE_COUNTERS`, and the call's pool
    counters (``lt_chunk_pool_stats``: threads started for it, ns from the
    first worker finding no stream left to the last worker's end) to
    ``frontend.spawned`` and ``frontend.tail_ns``; else the entry gets
    nulls and times nothing."""
    sp = profiling.begin("frontend.entropy")
    if sp is None:
        fn(*args, int(threads), None, None, None)
        return
    try:
        busy = np.zeros(max(1, int(threads)), np.uint64)
        wall = np.zeros(1, np.uint64)
        stages = np.zeros((len(busy), len(_STAGE_COUNTERS)), np.uint64)
        fn(*args, int(threads), _ptr(busy, C.c_uint64),
           _ptr(wall, C.c_uint64), _ptr(stages, C.c_uint64))
        spawned, tail = np.zeros(1, np.uint64), np.zeros(1, np.uint64)
        _load().lt_chunk_pool_stats(_ptr(spawned, C.c_uint64),
                                    _ptr(tail, C.c_uint64))
        profiling.count("frontend.busy_ns", int(busy.sum()))
        profiling.count("frontend.wall_ns", int(wall[0]))
        for name, ns in zip(_STAGE_COUNTERS, stages.sum(0)):
            profiling.count(name, int(ns))
        profiling.count("frontend.spawned", int(spawned[0]))
        profiling.count("frontend.tail_ns", int(tail[0]))
    finally:
        profiling.end(sp)


class PacketSpans:
    """A stream's audio packets as spans into one shared blob: ``data``
    uint8 [bytes], ``offs``/``lens`` uint64 [packets]. The zero-copy
    front-end (:func:`span_tables`) slices these per chunk instead of
    joining packet bytes."""

    __slots__ = ("data", "offs", "lens")

    def __init__(self, data, offs, lens):
        self.data = np.ascontiguousarray(data, dtype=np.uint8)
        self.offs = np.ascontiguousarray(offs, dtype=np.uint64)
        self.lens = np.ascontiguousarray(lens, dtype=np.uint64)

    def __len__(self):
        return len(self.offs)

    def __getitem__(self, key):
        if isinstance(key, slice):  # chunk loops slice streams uniformly
            return PacketSpans(self.data, self.offs[key], self.lens[key])
        o, ln = int(self.offs[key]), int(self.lens[key])
        return self.data[o: o + ln].tobytes()

    @staticmethod
    def from_bytes(packets: list) -> "PacketSpans":
        lens = np.fromiter(map(len, packets), np.uint64, len(packets))
        blob = (np.frombuffer(b"".join(packets), dtype=np.uint8) if packets
                else np.zeros(1, np.uint8))
        return PacketSpans(blob, np.cumsum(lens) - lens, lens)


def _packet_meta(lib, h, count: int):
    """(lens, serials, flags, absgp, page granules) of the ``count``
    packets a native Ogg handle holds."""
    lens = np.empty(count, np.uint64)
    serials = np.empty(count, np.uint32)
    flags = np.empty(count, np.uint8)
    absgp = np.empty(count, np.uint64)
    pgran = np.empty(count, np.uint64)
    lib.lt_ogg_packet_meta(h, _ptr(lens, C.c_uint64),
                           _ptr(serials, C.c_uint32), _u8(flags),
                           _ptr(absgp, C.c_uint64), _ptr(pgran, C.c_uint64))
    return lens, serials, flags, absgp, pgran


def _packet_arrays(lib, h, count: int):
    """(blob, lens, serials, flags, absgp, page granules) of the ``count``
    packets a native Ogg handle holds."""
    meta = _packet_meta(lib, h, count)
    blob = np.empty(max(int(meta[0].sum()), 1), np.uint8)
    lib.lt_ogg_packet_data(h, _u8(blob))
    return (blob, *meta)


def _demux(data: bytes):
    """(blob, lens, serials, flags, absgp, page granules) of every packet
    of an Ogg byte stream, from one native demux, which writes the packets'
    bytes straight into the blob (a stream's packets never outgrow it)."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8)
    blob = np.empty(max(len(data), 1), np.uint8)
    h = lib.lt_ogg_new_into(_u8(src), len(data), _u8(blob))
    if not h:
        raise OggError("native ogg demux failed (allocation)")
    try:
        meta = _packet_meta(lib, h, lib.lt_ogg_packet_count(h))
    finally:
        lib.lt_ogg_free(h)
    return (blob[:max(int(meta[0].sum()), 1)], *meta)


def decode_ogg_i16_rc(data: bytes, channels: int, n1: int):
    """``lt_decode_ogg_i16`` on a whole Ogg byte stream: (return code,
    planar i16 [channels, max(rc, 0)], final granule). The code is the
    samples per channel, or -1 (undecodable audio packet), -2 (a chain
    link's headers do not parse), -3 (output past the capacity) or -4 (a
    chain link changes the channel count); lt_file.cc."""
    lib = _load()
    src = np.frombuffer(data, dtype=np.uint8)
    h = lib.lt_ogg_new(_u8(src), len(data))
    if not h:
        raise OggError("native ogg demux failed (allocation)")
    try:
        count = int(lib.lt_ogg_packet_count(h))
        # every audio packet emits at most 3*n1/4 samples per channel
        cap = max(count, 1) * (3 * n1 // 4) + 8
        pcm = np.zeros((channels, cap), np.int16)
        absgp = C.c_int64(0)
        n = int(lib.lt_decode_ogg_i16(h, _ptr(pcm, C.c_int16), cap,
                                      C.byref(absgp)))
    finally:
        lib.lt_ogg_free(h)
    # copy: a view would pin the worst-case-sized buffer
    return n, np.ascontiguousarray(pcm[:, :max(n, 0)]), int(absgp.value)


def decode_ogg_i16(data: bytes, channels: int, n1: int):
    """Whole-file decode in ONE native call: Ogg bytes -> (planar i16
    [channels, total], final granule). Returns None when the stream needs
    the reader's packet loop (return codes -2, -3 and -4 of
    :func:`decode_ogg_i16_rc`: a chain link whose headers the library does
    not parse, a chain link with more channels or a larger blocksize);
    raises AudioBadFormat on an undecodable audio packet, as the loop
    does."""
    n, pcm, absgp = decode_ogg_i16_rc(data, channels, n1)
    if n == -1:
        raise AudioBadFormat("undecodable packet")
    if n < 0:
        return None
    return pcm, absgp


class NativeDecoder:
    """The CPU decoder of ``lt_synth.cc``: packets -> planar f32 PCM
    (entropy decode, floor curves, coupling, an FFT IMDCT and the
    overlap-add in C++), within +/-2 i16 LSB of libvorbis."""

    def __init__(self, ident_packet: bytes, setup_packet: bytes):
        lib = _load()
        self._lib = lib
        err = C.create_string_buffer(256)
        ib = np.frombuffer(ident_packet, dtype=np.uint8)
        sb = np.frombuffer(setup_packet, dtype=np.uint8)
        self._h = lib.lt_decoder_new(_u8(ib), len(ident_packet), _u8(sb),
                                     len(setup_packet), err, 256)
        if not self._h:
            raise BadHeader(err.value.decode() or "native header parse failed")
        self.channels = lib.lt_decoder_channels(self._h)
        self.sample_rate = lib.lt_decoder_rate(self._h)
        self.n1 = lib.lt_decoder_n1(self._h)
        # one packet's output: at most 3*n1/4 samples per channel
        self._buf = np.zeros(self.channels * (3 * self.n1 // 4), np.float32)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lt_decoder_free(self._h)
            self._h = None

    def reset(self) -> None:
        self._lib.lt_decoder_reset(self._h)

    def save_state(self) -> dict:
        """The resumable decode state: {"pwr": the window carry, f32 [C *
        plen], "plen", "started"}."""
        plen = self._lib.lt_decoder_state_plen(self._h)
        started = bool(self._lib.lt_decoder_state_started(self._h))
        pwr = np.zeros(self.channels * plen, np.float32)
        if plen:
            self._lib.lt_decoder_save_state(self._h, _ptr(pwr, C.c_float))
        return {"pwr": pwr, "plen": plen, "started": started}

    def load_state(self, state: dict) -> None:
        plen = int(state["plen"])
        pwr = np.ascontiguousarray(state["pwr"], np.float32)
        if pwr.size != self.channels * plen:
            raise ValueError(f"state: {pwr.size} carry values for "
                             f"{self.channels} channels x plen {plen}")
        self._lib.lt_decoder_load_state(self._h, _ptr(pwr, C.c_float), plen,
                                        int(state["started"]))

    def decode_many(self, packets: list[bytes]):
        """Decode a packet run in one native call (runs of 8 or more on up
        to 8 threads, the overlap-add in order). Returns (pcm [n, C,
        3*n1/4] f32, out_lens [n] i32): out_lens[i] is the packet's samples
        per channel, its row packed [C, out_lens[i]] at the start, or -1
        (bad packet) / -2 (header packet)."""
        n = len(packets)
        row = np.zeros((n, self.channels, 3 * self.n1 // 4), np.float32)
        out_lens = np.zeros(n, np.int32)
        if n == 0:
            return row, out_lens
        buf = np.frombuffer(b"".join(packets), dtype=np.uint8)
        lens = np.array([len(p) for p in packets], dtype=np.uint64)
        offs = (np.cumsum(lens) - lens).astype(np.uint64)
        self._lib.lt_decoder_decode_many(
            self._h, _u8(buf), _ptr(offs, C.c_uint64), _ptr(lens, C.c_uint64),
            n, _ptr(row, C.c_float), _ptr(out_lens, C.c_int32))
        return row, out_lens

    def decode(self, packet: bytes) -> np.ndarray:
        """One packet -> planar f32 [C, out_len]. Raises AudioIsHeader or
        AudioBadFormat on a header or undecodable packet."""
        pb = np.frombuffer(packet, dtype=np.uint8)
        n = self._lib.lt_decoder_decode(self._h, _u8(pb), len(packet),
                                        _ptr(self._buf, C.c_float))
        if n < 0:
            raise (AudioIsHeader() if n == -2
                   else AudioBadFormat("undecodable packet"))
        return self._buf[: self.channels * n].reshape(self.channels, n).copy()


def demux_spans(data: bytes):
    """Demux a whole Ogg byte stream -> (PacketSpans over all packets,
    serials u32 [n], flags u8 [n], absgp u64 [n], page granules u64 [n]);
    the packet bytes stay in one blob. Flags: bit 0 first in stream, 1 last
    in stream, 2 first in page, 3 last in page, 4 has absgp, 5 has a page
    granule, 6 began on an earlier page. Traced, it counts the bytes and
    the packets it demuxed (``native.demux_bytes``,
    ``native.demux_packets``)."""
    sp = profiling.begin("native.demux")  # called for every file
    try:
        if sp is not None:
            profiling.count("native.demux_bytes", len(data))
        blob, lens, serials, flags, absgp, pgran = _demux(data)
        if sp is not None:
            profiling.count("native.demux_packets", len(lens))
    finally:
        profiling.end(sp)
    return (PacketSpans(blob, np.cumsum(lens) - lens, lens), serials, flags,
            absgp, pgran)


class NativePacket:
    """One demuxed packet, with the fields of ``ogg.Packet``."""

    __slots__ = ("data", "stream_serial", "first_in_stream", "last_in_stream",
                 "absgp_page", "first_in_page", "last_in_page",
                 "page_granule", "spans_pages")

    def __init__(self, data: bytes, serial: int, flags: int, absgp: int,
                 pgran: int):
        self.data = data
        self.stream_serial = serial
        (self.first_in_stream, self.last_in_stream, self.first_in_page,
         self.last_in_page, self.spans_pages) = _FLAG_BITS[flags]
        self.absgp_page = absgp if flags & 16 else None
        self.page_granule = pgran if flags & 32 else None


#: flags -> (first_in_stream, last_in_stream, first_in_page, last_in_page,
#: spans_pages)
_FLAG_BITS = [tuple(bool(f >> b & 1) for b in (0, 1, 2, 3, 6))
              for f in range(128)]


def _packet_list(blob, lens, serials, flags, absgp, pgran) -> list:
    """NativePackets from the arrays of :func:`_packet_arrays`: the bytes
    sliced from one blob, the fields from Python ints."""
    raw = blob.tobytes()
    ends = np.cumsum(lens).tolist()
    datas = map(raw.__getitem__, map(slice, [0, *ends[:-1]], ends))
    return list(map(NativePacket, datas, serials.tolist(), flags.tolist(),
                    absgp.tolist(), pgran.tolist()))


def demux(data: bytes) -> list[NativePacket]:
    """Demux a whole Ogg byte stream -> its packets."""
    return _packet_list(*_demux(data))


class NativeIncrementalReader:
    """``ogg.IncrementalPacketReader``'s surface (``feed``, ``read_packet``,
    ``pages_read``) over the native page loop. Each feed parses every page
    it completes and queues their packets; the library holds only the
    bytes it could not parse yet: a partial page, or the last 3 bytes when
    no capture pattern is left."""

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.lt_ogg_stream_new()
        if not self._h:
            raise OggError("native ogg reader failed (allocation)")
        self._queue: deque = deque()
        #: CRC-checked pages parsed so far
        self.pages_read = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lt_ogg_free(self._h)
            self._h = None

    def feed(self, data: bytes) -> None:
        """Append ``data`` and queue the packets of the pages it
        completes (counted as ``ogg.native_bytes``)."""
        profiling.count("ogg.native_bytes", len(data))
        if not data:  # no new bytes complete no page
            return
        lib = self._lib
        n = lib.lt_ogg_stream_feed(
            self._h, _u8(np.frombuffer(data, dtype=np.uint8)), len(data))
        if n < 0:
            raise OggError("native ogg reader failed (allocation)")
        self.pages_read = lib.lt_ogg_pages(self._h)
        if n:
            self._queue.extend(_packet_list(*_packet_arrays(lib, self._h, n)))

    def read_packet(self) -> NativePacket | None:
        """The next queued packet, or None until a feed completes one."""
        return self._queue.popleft() if self._queue else None

    @property
    def held_bytes(self) -> int:
        """Bytes held for a later feed."""
        return self._lib.lt_ogg_held_bytes(self._h)


class NativePacketReader:
    """``ogg.PacketReader``'s surface (read_packet, read_packet_expected,
    delete_unread_packets, seek_absgp) over the native demuxer, which
    parses the whole stream up front."""

    def __init__(self, data: bytes):
        #: the Ogg bytes (the one-call whole-file decode reads them)
        self.data = data
        self._pcks = demux(data)
        self._i = 0

    def consume_all(self) -> None:
        """Position at the end (the stream was decoded in one call)."""
        self._i = len(self._pcks)

    def read_packet(self) -> NativePacket | None:
        if self._i >= len(self._pcks):
            return None
        p = self._pcks[self._i]
        self._i += 1
        return p

    def read_packet_expected(self) -> NativePacket:
        p = self.read_packet()
        if p is None:
            raise OggError("unexpected end of ogg stream")
        return p

    def delete_unread_packets(self) -> None:
        """Nothing to drop: the packets are reassembled up front, and
        header pages never share a page with audio in valid streams."""

    def seek_absgp(self, absgp: int, serial: int | None = None) -> None:
        """Position at the start of the earliest page whose granule is
        >= absgp (the ogg crate's seek_absgp)."""
        target = None
        last_match = 0
        for i, p in enumerate(self._pcks):
            if p.page_granule is None:
                continue
            if serial is not None and p.stream_serial != serial:
                continue
            if p.page_granule >= absgp:
                target = i
                break
            last_match = i
        if target is None:
            target = last_match
        # back to the first packet of that page
        while target > 0 and not self._pcks[target - 1].last_in_page:
            target -= 1
        # a reader positioned at this page cannot reassemble a packet that
        # began on an earlier page and drops that head (the ogg crate's
        # semantics); later spanning packets begin at or after the
        # position and reassemble, so exactly one is skipped
        if target < len(self._pcks) and self._pcks[target].spans_pages:
            target += 1
        self._i = target
