"""LSb-first bit writer — the encode-side mirror of :mod:`lewton_tpu_torch.bitpack`.

Used by tests to construct synthetic Vorbis packets (setup headers, floor0 /
residue-type corner cases the libvorbis encoder never emits) and by the
fuzz-style malformed-stream generators. The reference has no encoder; this is
test infrastructure only. The port's copy of lewton_tpu/utils/bitwriter.py.
"""

from __future__ import annotations

__all__ = ["BitWriter"]


class BitWriter:
    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def write_bits(self, value: int, n: int) -> "BitWriter":
        if n < 0 or value < 0 or value >= (1 << n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        if n == 0:
            return self
        self._acc |= value << self._nbits
        self._nbits += n
        while self._nbits >= 8:
            self._bytes.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8
        return self

    def write_flag(self, flag: bool) -> "BitWriter":
        return self.write_bits(1 if flag else 0, 1)

    def write_bytes(self, data: bytes) -> "BitWriter":
        for b in data:
            self.write_bits(b, 8)
        return self

    def write_huffman(self, code: int, length: int) -> "BitWriter":
        """Write an MSB-first canonical codeword in stream (LSb-first) order."""
        for i in range(length - 1, -1, -1):
            self.write_bits((code >> i) & 1, 1)
        return self

    def getvalue(self) -> bytes:
        out = bytearray(self._bytes)
        if self._nbits:
            out.append(self._acc & 0xFF)
        return bytes(out)
