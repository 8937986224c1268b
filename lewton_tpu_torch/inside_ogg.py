"""High-level Ogg/Vorbis stream API.

`OggStreamReader` mirrors the reference's `inside_ogg::OggStreamReader`
surface (lewton src/inside_ogg.rs:66-314): header reading with serial
filtering, per-packet decode, chained-stream re-initialization, end-of-stream
truncation to the page granule, linear sample skip and page-granularity seek.

The port's copy of lewton_tpu/inside_ogg.py. The decode backend is
pluggable:

- ``backend="torch"`` (the default; the reference's ``"jax"``): the numeric
  half on ``device`` (the card unless the caller names another) through
  ``models.decoder.StreamDecoder``, whose default front-end is the port's
  C++ library (the reader passes it the raw header packets);
- ``backend="numpy"``: the numpy synthesis (``audio.read_audio_packet_generic``,
  an f64 IMDCT), packet by packet, on the CPU;
- ``backend="native"``: the C++ CPU decoder (``native.NativeDecoder``, one
  call per chain link), and on a fresh reader ``read_all_i16`` in one call
  (``native.decode_ogg_i16``).

``"numpy"`` and ``"native"`` are CPU decoders by design, as in the
reference: ``device`` does not apply to them. A byte source is demuxed by
the port's C++ library (``native.NativePacketReader``, the same packets as
``ogg.PacketReader``) on every backend.
"""

from __future__ import annotations

import io

import numpy as np

from . import samples as samples_mod
from . import native
from .audio import (
    PreviousWindowRight,
    get_decoded_sample_count,
    read_audio_packet_generic,
)
from .errors import AudioBadFormat, OggError
from .header import (
    HeaderSet,
    read_header_comment,
    read_header_ident,
    read_header_setup,
)
from .models.decoder import StreamDecoder
from .native import NativePacketReader
from .ogg import Packet, PacketReader

__all__ = ["read_headers", "OggStreamReader", "BACKENDS"]

BACKENDS = ("torch", "numpy", "native")


def read_headers(rdr: PacketReader) -> tuple[HeaderSet, int]:
    """Read the three Vorbis headers; skips packets of other serials
    (ref: lewton src/inside_ogg.rs:30-51)."""
    pck = rdr.read_packet_expected()
    ident = read_header_ident(pck.data)
    serial = pck.stream_serial
    raw_ident = pck.data

    pck = rdr.read_packet_expected()
    while pck.stream_serial != serial:
        pck = rdr.read_packet_expected()
    comment = read_header_comment(pck.data)

    pck = rdr.read_packet_expected()
    while pck.stream_serial != serial:
        pck = rdr.read_packet_expected()
    setup = read_header_setup(pck.data, ident)

    rdr.delete_unread_packets()
    hs = HeaderSet(ident, comment, setup)
    hs.raw_ident = raw_ident
    hs.raw_setup = pck.data
    return hs, serial


class OggStreamReader:
    """Reads and decodes a (possibly chained) Ogg Vorbis stream."""

    def __init__(self, source, backend: str = "torch", device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        if isinstance(source, (str, bytes, bytearray, memoryview)):
            if isinstance(source, str):
                with open(source, "rb") as f:
                    source = f.read()
            self.rdr = NativePacketReader(bytes(source))
        elif hasattr(source, "read_packet"):
            self.rdr = source
        else:
            self.rdr = NativePacketReader(source.read())
        self.device = device
        # Light header read: ident + comment parse eagerly, setup lazily
        # (the codebook/Huffman build is the expensive part). `setup_hdr`
        # is a property.
        pck = self.rdr.read_packet_expected()
        self.ident_hdr = read_header_ident(pck.data)
        serial = pck.stream_serial
        raw_ident = pck.data
        pck = self.rdr.read_packet_expected()
        while pck.stream_serial != serial:
            pck = self.rdr.read_packet_expected()
        self.comment_hdr = read_header_comment(pck.data)
        pck = self.rdr.read_packet_expected()
        while pck.stream_serial != serial:
            pck = self.rdr.read_packet_expected()
        self.rdr.delete_unread_packets()
        self._setup_hdr = None
        self._raw_headers = (raw_ident, pck.data)
        self.stream_serial = serial
        self.pwr = PreviousWindowRight()  # the numpy backend's carry
        self._native_dec = None
        self._dec = None  # the torch backend's per-packet StreamDecoder
        self._decode_started = False
        # Deliberate improvement over the reference: start granule tracking
        # at 0 so end-of-stream truncation works even when all audio sits on
        # a single page (the reference only learns absgp at the first page
        # boundary and would emit the encoder's padding samples there;
        # libvorbis truncates — we match libvorbis).
        self.cur_absgp: int | None = 0
        self.backend = backend
        #: set by read_next_audio_packet when a chained-stream re-init just
        #: happened; the whole-stream path uses it to restart its decoder.
        self._fresh_link = False
        #: True until any audio packet is consumed or the reader seeks:
        #: gates the one-call native whole-stream path (read_all_i16)
        self._pristine = True
        #: how the last read_all_i16 of the "native" backend ran:
        #: "one-call" (native.decode_ogg_i16) or "packets" (the per-link
        #: loop, on a stream the one call hands back, or a reader that has
        #: read or seeked)
        self.native_route: str | None = None
        #: incremental-feed support for chained streams: when the packet
        #: source can temporarily run dry (async feed), a chain link's
        #: comment/setup packets may not have been fed yet. With
        #: `_resumable_chain` set (aio.AsyncOggStreamReader does), the
        #: re-init pushes the consumed packets back onto `_chain_pending`
        #: and surfaces None ("need more data") instead of raising; the
        #: retry re-runs the re-init from the pushed-back BOS packet.
        self._chain_pending: list = []
        self._resumable_chain = False

    # ------------------------------------------------------------------ #

    @property
    def setup_hdr(self) -> "SetupHeader":
        if self._setup_hdr is None:
            self._setup_hdr = read_header_setup(
                self._raw_headers[1], self.ident_hdr
            )
        return self._setup_hdr

    @setup_hdr.setter
    def setup_hdr(self, value) -> None:
        self._setup_hdr = value

    def _decode(self, packet: bytes) -> np.ndarray:
        """Decode one packet to planar f32 [ch, out].

        On the torch backend a persistent 1-packet-chunk StreamDecoder
        carries the window state across calls; each packet is one replay
        of the device's single-stream program for this setup geometry (a
        CUDA graph on a card, ``parallel.graphs.stream_programs``), plus
        the frames' copies in, the carry's copy and two copies out. PERF.md
        gives its host and wall time a packet on an H100 against the eager
        path's; for throughput use read_all_* / BatchDecoder, which decode
        whole chunks a call."""
        self._decode_started = True
        if self.backend == "native":
            if self._native_dec is None:
                self._native_dec = native.NativeDecoder(*self._raw_headers)
            return self._native_dec.decode(packet)
        if self.backend == "numpy":
            return read_audio_packet_generic(
                self.ident_hdr, self.setup_hdr, packet, self.pwr,
                fmt="planar_f32")
        if self._dec is None:
            self._dec = self._stream_decoder(chunk=1)
        return self._dec.decode_packets([packet])[0]

    def _stream_decoder(self, **kw) -> StreamDecoder:
        return StreamDecoder(self.ident_hdr, self.setup_hdr,
                             raw_headers=self._raw_headers,
                             device=self.device, **kw)

    def _clear_backend_decoders(self) -> None:
        """Drop per-setup decoder instances (chained-stream re-init)."""
        self._native_dec = None
        self._dec = None

    def _reset_decode_state(self) -> None:
        """Reset the inter-packet window state (all backends)."""
        self.pwr = PreviousWindowRight()
        if self._native_dec is not None:
            self._native_dec.reset()
        if self._dec is not None:
            self._dec.reset()
        self._decode_started = False

    def _next_raw_packet(self) -> Packet | None:
        if self._chain_pending:
            return self._chain_pending.pop(0)
        return self.rdr.read_packet()

    def _chain_starved(self, consumed: list) -> None:
        """A chain link's header packets are split across input that has
        not been fed yet. Resumable (async) readers push the consumed
        packets back and report 'need more data'; on a complete stream
        this is truncation mid-chain-headers, an error (ref parity:
        read_packet_expected, lewton src/inside_ogg.rs:129-137)."""
        if self._resumable_chain:
            self._chain_pending = consumed + self._chain_pending
            return None
        raise OggError("unexpected end of ogg stream")

    def read_next_audio_packet(self) -> Packet | None:
        """Next audio packet of the current stream; handles chained-ogg
        re-init (ref: lewton src/inside_ogg.rs:114-158)."""
        self._pristine = False
        while True:
            pck = self._next_raw_packet()
            if pck is None:
                return None
            if pck.stream_serial == self.stream_serial:
                return pck
            if pck.first_in_stream:
                # Chained ogg: re-read headers, reset state. The first audio
                # packet of the new link is returned as a normal packet; with
                # an empty window it decodes to 0 samples, which is exactly
                # the reference's "prime and discard" behavior
                # (lewton src/inside_ogg.rs:121-154) without a special path.
                # State only mutates once all three header packets are in
                # hand, so a starved re-init is safely retryable.
                ident = read_header_ident(pck.data)
                pck2 = self._next_raw_packet()
                if pck2 is None:
                    return self._chain_starved([pck])
                comment = read_header_comment(pck2.data)
                pck3 = self._next_raw_packet()
                if pck3 is None:
                    return self._chain_starved([pck, pck2])
                self.ident_hdr = ident
                self.comment_hdr = comment
                self._setup_hdr = None  # lazy parse (see setup_hdr property)
                self._raw_headers = (pck.data, pck3.data)
                self._clear_backend_decoders()  # new link, new setup tables
                self._reset_decode_state()
                self.stream_serial = pck3.stream_serial
                # granule positions restart at 0 in each chain link
                self.cur_absgp = 0
                self._fresh_link = True
                return self.rdr.read_packet()
            # else: ignore packets of unrelated multiplexed streams

    def _apply_absgp(self, pck: Packet, decoded: np.ndarray) -> np.ndarray:
        """End-of-stream truncation + absgp bookkeeping on a decoded packet
        (ref: lewton src/inside_ogg.rs:209-229)."""
        if self.cur_absgp is not None and pck.last_in_stream:
            target = max(0, (pck.absgp_page or 0) - self.cur_absgp)
            decoded = decoded[:, :target]
        if pck.last_in_page and pck.absgp_page is not None:
            self.cur_absgp = pck.absgp_page
        elif self.cur_absgp is not None:
            self.cur_absgp += decoded.shape[1]
        return decoded

    def dec_packet_planar_f32(self, pck: Packet) -> np.ndarray:
        return self._apply_absgp(pck, self._decode(pck.data))

    def read_dec_packet_generic(self, fmt: str = "planar_i16") -> np.ndarray | None:
        pck = self.read_next_audio_packet()
        if pck is None:
            return None
        return getattr(samples_mod, fmt)(self.dec_packet_planar_f32(pck))

    def read_dec_packet(self) -> np.ndarray | None:
        """Planar i16 [ch, n] (ref: read_dec_packet)."""
        return self.read_dec_packet_generic("planar_i16")

    def read_dec_packet_itl(self) -> np.ndarray | None:
        """Interleaved i16 [n*ch] (ref: read_dec_packet_itl)."""
        return self.read_dec_packet_generic("interleaved_i16")

    def read_all_planar_f32(self) -> np.ndarray:
        """Decode the whole stream to planar f32 [ch, samples].

        On the torch backend: host entropy decode, then chunked
        `decode_frames` on the device, one program replay a chunk; the native backend decodes each
        chain link in one call; the numpy backend packet by packet."""
        if self.backend == "torch":
            return self._read_all_device(i16=False)
        if self.backend == "native":
            return self._read_all_native()
        chunks = []
        while (pck := self.read_next_audio_packet()) is not None:
            chunks.append(self.dec_packet_planar_f32(pck))
        return _pad_concat(chunks, self.ident_hdr.channels, np.float32)

    def _read_all_buffered(self, make_dec, decode_buf,
                           empty_dtype=np.float32) -> np.ndarray:
        """Shared whole-stream loop of the batching backends (torch and
        native decode whole buffers per chain link), planar [ch, samples].

        Granule bookkeeping (_apply_absgp) is stateful and RESTARTS at 0
        in every chain link, while read_next_audio_packet's re-init
        mutates that state BEFORE the loop sees the new link's first
        packet — so buffered packets must flush at their link's EOS
        packet, not when the next link is detected (flushing after the
        re-init applied link 1's granules on link 2's restarted clock and
        over-truncated the next link's EOS packet)."""
        outs: list[np.ndarray] = []
        dec = make_dec()
        buf: list[Packet] = []

        def flush(d):
            if not buf:
                return
            for pck, pcm in zip(buf, decode_buf(d, [p.data for p in buf])):
                outs.append(self._apply_absgp(pck, pcm))
            buf.clear()

        while (pck := self.read_next_audio_packet()) is not None:
            if self._fresh_link:
                if buf:  # malformed chain: previous link had no EOS page
                    flush(dec)
                    self.cur_absgp = 0  # granules restart per link
                dec = make_dec()
                self._fresh_link = False
            buf.append(pck)
            if pck.last_in_stream:
                flush(dec)  # link ends here: apply absgp BEFORE re-init
        flush(dec)
        return _pad_concat(outs, self.ident_hdr.channels, empty_dtype)

    def _read_all_device(self, i16: bool) -> np.ndarray:
        """Whole-stream loop of the torch backend: whole buffers per chain
        link through a StreamDecoder (f32, or the i16 kernel path)."""
        def decode_buf(d, datas):
            return (d.decode_packets_i16(datas) if i16
                    else d.decode_packets(datas))

        return self._read_all_buffered(self._stream_decoder, decode_buf,
                                       np.int16 if i16 else np.float32)

    def _read_all_native(self) -> np.ndarray:
        """Whole-stream decode through one native call per chain link."""
        def decode_buf(d, datas):
            pcm, lens = d.decode_many(datas)
            pcms = []
            for i, n in enumerate(lens.tolist()):
                if n < 0:
                    raise AudioBadFormat("undecodable packet")
                # each row holds its packet packed [C, n] at the start
                pcms.append(pcm[i].reshape(-1)[: d.channels * n]
                            .reshape(d.channels, n))
            return pcms

        return self._read_all_buffered(
            lambda: native.NativeDecoder(*self._raw_headers), decode_buf)

    def read_all_i16(self) -> np.ndarray:
        """Decode the whole stream to interleaved i16 [samples, channels].
        Chained links that change the channel count are padded to the
        widest link (planar layout rules).

        On the torch backend the i16 conversion happens on the device, in
        the overlap kernel (absgp truncation only drops samples, so
        truncating the i16 rows is equivalent to truncating f32 first).

        On the native backend a fresh reader decodes the whole stream in
        ONE native call (demux -> chained headers -> synthesis -> i16;
        native/lt_file.cc): the per-packet Python loop costs more wall time
        than the C++ decode itself. A stream that call hands back (return
        codes -2 to -4: a chain link whose headers it does not parse, with
        more channels or a larger blocksize) takes the loop below, with the
        same output; ``native_route`` records which ran."""
        if self.backend == "torch":
            return self._read_all_device(i16=True).T
        if self.backend == "native":
            self.native_route = "packets"
            if self._pristine and isinstance(self.rdr, NativePacketReader):
                res = native.decode_ogg_i16(
                    self.rdr.data, self.ident_hdr.channels,
                    1 << self.ident_hdr.blocksize_1)
                if res is not None:
                    pcm, absgp = res
                    self.rdr.consume_all()
                    self.cur_absgp = absgp
                    self._pristine = False
                    self.native_route = "one-call"
                    return pcm.T
        return samples_mod.to_i16(self.read_all_planar_f32()).T

    # ------------------------------------------------------------------ #

    def skip_samples_linear(self, to_skip: int, fmt: str = "planar_i16"):
        """Skip cheaply using sample counts only; decodes just the packet
        before the target (to re-prime pwr) and the target packet
        (ref: lewton src/inside_ogg.rs:244-283).

        Returns (decoded_packet_or_None, leftover_to_skip).
        """
        last_pck: Packet | None = None
        # A packet decoded against an empty window emits 0 samples; count it
        # as such so skip positions are sample-accurate from stream start
        # (deliberate fix of a reference quirk — lewton counts the first
        # packet's nominal length, see its get_decoded_sample_count docs).
        first_primes = not self._decode_started
        while True:
            next_pck = self.read_next_audio_packet()
            if next_pck is None:
                return None, to_skip
            if self._fresh_link:
                # a chain link's first packet decodes to 0 samples against
                # the freshly reset window, so it must count as the link's
                # primer, not its nominal length (the reference decodes-
                # and-discards it inside the re-init, inside_ogg.rs:
                # 149-155); this also prevents an OLD-link last_pck from
                # re-priming the new link's window below
                self._fresh_link = False
                first_primes = True
            sample_cnt = get_decoded_sample_count(
                self.ident_hdr, self.setup_hdr, next_pck.data
            )
            if first_primes:
                sample_cnt = 0
                first_primes = False
                last_pck = next_pck
                self._decode(next_pck.data)  # prime the window
                continue
            if self.cur_absgp is not None and next_pck.last_in_stream:
                last_pck = None
                target = max(0, (next_pck.absgp_page or 0) - self.cur_absgp)
                sample_cnt = min(sample_cnt, target)
            if to_skip < sample_cnt:
                if last_pck is not None:
                    self._reset_decode_state()
                    self._decode(last_pck.data)
                decoded = self.dec_packet_planar_f32(next_pck)
                return getattr(samples_mod, fmt)(decoded), to_skip
            to_skip -= sample_cnt
            if self.cur_absgp is not None:
                self.cur_absgp += sample_cnt
            last_pck = next_pck

    def get_last_absgp(self) -> int | None:
        return self.cur_absgp

    # ------------------------------------------------------------------ #
    # Checkpoint/resume: the resumable decode state is exactly the window
    # carry + granule position (SURVEY.md §5 "checkpoint/resume"; ref state
    # is PreviousWindowRight + cur_absgp, lewton src/inside_ogg.rs:67-76).

    def save_decode_state(self) -> dict:
        """Snapshot (window carry, granule). Does not capture the container
        read position — pair with your own byte offset for full resume."""
        state = {"cur_absgp": self.cur_absgp, "backend": self.backend,
                 "started": self._decode_started}
        if self.backend == "native" and self._native_dec is not None:
            state["native"] = self._native_dec.save_state()
        elif self.backend == "torch":
            if self._dec is not None:
                state["torch"] = self._dec.save_state()
        else:
            state["pwr"] = (
                None if self.pwr.data is None else self.pwr.data.copy()
            )
        return state

    def restore_decode_state(self, state: dict) -> None:
        """Load a state of :meth:`save_decode_state` (or of the reference's
        reader: its numpy and native states have the same keys)."""
        self.cur_absgp = state["cur_absgp"]
        self._decode_started = state["started"]
        if "native" in state:
            if self._native_dec is None:
                self._native_dec = native.NativeDecoder(*self._raw_headers)
            self._native_dec.load_state(state["native"])
        elif "torch" in state:
            if self._dec is None:
                self._dec = self._stream_decoder(chunk=1)
            self._dec.load_state(state["torch"])
        else:
            self.pwr = PreviousWindowRight(
                None if state.get("pwr") is None else state["pwr"].copy()
            )
            # a state saved before any decode carries no decoder snapshot:
            # reset any live decoder back to the fresh-window state
            if self._dec is not None:
                self._dec.reset()
            if self._native_dec is not None:
                self._native_dec.reset()

    def seek_absgp_pg(self, absgp: int) -> None:
        """Page-granularity seek; resets decode state
        (ref: lewton src/inside_ogg.rs:307-313)."""
        self._pristine = False
        self.rdr.seek_absgp(absgp)
        self.cur_absgp = None
        self._reset_decode_state()


def _pad_concat(outs: list, channels: int, dtype) -> np.ndarray:
    """Planar [ch, n] pieces -> one [ch, sum n]; chained links may change
    the channel count, so every piece is padded to the widest (the
    reference emits per packet, the whole-stream paths concatenate)."""
    if not outs:
        return np.zeros((channels, 0), dtype)
    ch = max(o.shape[0] for o in outs)
    outs = [o if o.shape[0] == ch
            else np.pad(o, [(0, ch - o.shape[0]), (0, 0)]) for o in outs]
    return np.concatenate(outs, axis=1)
