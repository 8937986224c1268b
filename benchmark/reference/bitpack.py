# Frozen copy of lewton_tpu_torch/bitpack.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Vorbis bit-level primitives (host side, pure Python reference).

Vorbis I packs bits LSb-first within each octet (spec section 2). This module
provides the cursor used by header and audio packet parsing. It is the
functional equivalent of the reference's BitpackCursor
(lewton `src/bitpacking.rs:28-487`), re-designed around Python int arithmetic:
instead of macro-generated per-width octet-straddling reads, we keep a small
bit accumulator and refill from the byte buffer.

The port's copy of lewton_tpu/bitpack.py (``ilog``, ``bit_reverse``,
``float32_unpack``, ``BitCursor``), held equal to it by the CPU tests.
"""

from __future__ import annotations

from .errors import EndOfPacket

__all__ = ["BitCursor", "ilog", "bit_reverse", "float32_unpack"]


def ilog(x: int) -> int:
    """Number of bits needed to represent x; ilog(0)=0 (spec section 9.2.1).

    ref parity: lewton src/lib.rs:159-172.
    """
    if x <= 0:
        return 0
    return x.bit_length()


def bit_reverse(n: int) -> int:
    """Reverse the bits of a 32-bit integer (ref: lewton src/lib.rs:174)."""
    n &= 0xFFFFFFFF
    return int(f"{n:032b}"[::-1], 2)


def float32_unpack(x: int) -> float:
    """Unpack the Vorbis 32-bit float format (spec section 9.2.2).

    sign bit 31, 10-bit exponent (bits 21..30, bias 788), 21-bit mantissa.
    ref parity: lewton src/bitpacking.rs:304-314.
    """
    mantissa = x & 0x1FFFFF
    sign = x & 0x80000000
    exponent = (x & 0x7FE00000) >> 21
    m = -float(mantissa) if sign else float(mantissa)
    return m * (2.0 ** (exponent - 788))


class BitCursor:
    """LSb-first bit reader over a bytes-like packet.

    Reads raise :class:`EndOfPacket` when the packet is exhausted mid-read;
    callers that treat EOP as data (floor/residue decode) catch it.
    """

    __slots__ = ("_buf", "_pos", "_acc", "_nbits", "_len")

    def __init__(self, buf: bytes):
        self._buf = buf
        self._len = len(buf)
        self._pos = 0  # next byte index to consume into the accumulator
        self._acc = 0  # bit accumulator, LSb = next bit in stream order
        self._nbits = 0  # number of valid bits in the accumulator

    # -- internal -----------------------------------------------------------

    def _refill(self, need: int) -> None:
        while self._nbits < need:
            if self._pos >= self._len:
                raise EndOfPacket(f"needed {need} bits, have {self._nbits}")
            self._acc |= self._buf[self._pos] << self._nbits
            self._pos += 1
            self._nbits += 8

    # -- introspection ------------------------------------------------------

    def bits_consumed(self) -> int:
        return self._pos * 8 - self._nbits

    def bits_remaining(self) -> int:
        return self._len * 8 - self.bits_consumed()

    def at_end(self) -> bool:
        return self.bits_remaining() == 0

    # -- reads --------------------------------------------------------------

    def read_bits(self, n: int) -> int:
        """Read ``n`` (0..=64) bits as an unsigned integer, LSb-first."""
        if n == 0:
            # Spec: a zero-bit read succeeds (even at end of packet) and
            # returns 0 (lewton src/bitpacking.rs:516-538 semantics).
            return 0
        self._refill(n)
        val = self._acc & ((1 << n) - 1)
        self._acc >>= n
        self._nbits -= n
        return val

    def read_bit_flag(self) -> bool:
        return self.read_bits(1) == 1

    def read_signed_bits(self, n: int) -> int:
        """Read n bits as a two's-complement signed integer."""
        v = self.read_bits(n)
        if n > 0 and v >= (1 << (n - 1)):
            v -= 1 << n
        return v

    def read_f32(self) -> float:
        return float32_unpack(self.read_bits(32))

    def peek_bits(self, n: int) -> tuple[int, int]:
        """Peek up to ``n`` bits without consuming.

        Returns ``(value, got)`` where ``got`` <= n is the number of bits
        actually available (peeking past end of packet is not an error —
        huffman decode needs the tail bits of the final codeword).
        """
        while self._nbits < n and self._pos < self._len:
            self._acc |= self._buf[self._pos] << self._nbits
            self._pos += 1
            self._nbits += 8
        got = min(n, self._nbits)
        return self._acc & ((1 << got) - 1), got

    def advance(self, n: int) -> None:
        """Consume ``n`` bits previously peeked (n <= bits available)."""
        if self._nbits < n:
            raise EndOfPacket("advance past end")
        self._acc >>= n
        self._nbits -= n

    def read_huffman(self, tree) -> int:
        """Decode one codeword via ``tree`` (a :class:`~lewton_tpu_torch.huffman.HuffmanTree`).

        Fast path peeks 8 bits through the unrolled LUT; long codes fall back
        to bit-by-bit descent (ref behavior: lewton src/bitpacking.rs:455-487).

        A codebook with NO used entries decodes like end-of-packet
        (libvorbis-oracle semantics: vorbis_book_decode returns -1, so the
        residue keeps its partial zeros and a floor channel goes unused;
        the native backend's Huffman::decode also returns false here) —
        never a HeaderError escaping from an audio path.
        """
        if tree.empty:
            raise EndOfPacket()
        peeked, got = self.peek_bits(8)
        if got == 8:
            payload, advance = tree.lut[peeked]
            if advance != 0:
                self.advance(advance)
                return payload
            # Long code: descend starting from the 8-bit prefix node.
            self.advance(8)
            node = payload  # encoded subtree position
            while True:
                bit = self.read_bits(1)
                node, leaf, payload = tree.step(node, bit)
                if leaf:
                    return payload
        else:
            # Near end of packet: bit-by-bit from the root.
            node = tree.root
            while True:
                bit = self.read_bits(1)
                node, leaf, payload = tree.step(node, bit)
                if leaf:
                    return payload
