# Frozen copy of lewton_tpu_torch/errors.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Error taxonomy of the port's host front-end (a copy of
lewton_tpu/errors.py: the same classes, raised in the same places).

Mirrors the layered error model of the reference decoder
(lewton `src/lib.rs:118-157`, `src/header.rs:35-111`, `src/audio.rs:27-64`):
a unified ``VorbisError`` with ``BadHeader`` / ``BadAudio`` / ``OggError``
branches, and the same graceful-degradation semantics (end-of-packet inside a
floor or residue is *data*, not an error).
"""

from __future__ import annotations


class VorbisError(Exception):
    """Base class for all decode errors (ref: lewton src/lib.rs:120-157)."""


class EndOfPacket(VorbisError):
    """Bit cursor ran past the end of the packet.

    The reference models this as ``Err(())`` from BitpackCursor
    (src/bitpacking.rs). It is caught and converted into graceful behavior
    in floors (channel unused) and residues (zero fill); anywhere else it
    escalates to BadHeader/BadAudio.
    """


class HeaderError(VorbisError):
    """Malformed or unsupported header (ref: HeaderReadError, src/header.rs:35-63)."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        self.detail = detail
        super().__init__(f"{kind}: {detail}" if detail else kind)


class BadHeader(HeaderError):
    def __init__(self, detail: str = ""):
        super().__init__("HeaderBadFormat", detail)


class NotVorbisHeader(HeaderError):
    """Packet does not begin with a Vorbis capture pattern."""

    def __init__(self, detail: str = ""):
        super().__init__("NotVorbisHeader", detail)


class UnsupportedVersion(HeaderError):
    def __init__(self, detail: str = ""):
        super().__init__("UnsupportedVorbisVersion", detail)


class AudioError(VorbisError):
    """Malformed audio packet (ref: AudioReadError, src/audio.rs:27-41)."""

    def __init__(self, kind: str, detail: str = ""):
        self.kind = kind
        self.detail = detail
        super().__init__(f"{kind}: {detail}" if detail else kind)


class AudioBadFormat(AudioError):
    def __init__(self, detail: str = ""):
        super().__init__("AudioBadFormat", detail)


class AudioIsHeader(AudioError):
    """An audio-decode entry point was handed a header packet
    (ref: AudioReadError::AudioIsHeader)."""

    def __init__(self, detail: str = ""):
        super().__init__("AudioIsHeader", detail)


class HeaderIsAudio(HeaderError):
    """A header entry point was handed an audio packet."""

    def __init__(self, detail: str = ""):
        super().__init__("HeaderIsAudio", detail)


class HuffmanError(HeaderError):
    """Invalid codebook codeword-length specification
    (ref: HuffmanError src/huffman_tree.rs:127-131)."""

    def __init__(self, detail: str = ""):
        super().__init__("HuffmanError", detail)


class OggError(VorbisError):
    """Malformed Ogg container data (the reference delegates to the `ogg`
    crate; here it is the native demux layer)."""
