# Frozen copy of lewton_tpu_torch/huffman.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Canonical Vorbis Huffman codebooks (host side).

Builds the canonical codeword assignment of Vorbis I spec section 3.2.1 from a
list of codeword lengths, validates it (over-specified / under-populated /
invalid single-entry trees are errors), and provides two decode structures:

- an 8-bit unrolled lookup table for codes of length <= 8 (one peek, one
  advance), and
- an explicit binary tree for longer codes and end-of-packet tails.

Functional parity with the reference's VorbisHuffmanTree
(lewton `src/huffman_tree.rs:183-381`), but the construction algorithm is the
classic left-aligned available-prefix assignment (as used across public
Vorbis decoders) rather than recursive tree insertion.

The port's copy of lewton_tpu/huffman.py, held equal to it by the CPU tests.
"""

from __future__ import annotations

from .errors import HuffmanError

__all__ = ["HuffmanTree", "assign_codewords"]


def assign_codewords(lengths: list[int]) -> list[tuple[int, int] | None]:
    """Assign canonical codewords.

    ``lengths[i]`` is the codeword length of entry i (0 = unused entry,
    only possible for sparse codebooks). Returns per entry ``(code, len)``
    with ``code`` in MSB-first convention, or None for unused entries.

    Raises HuffmanError for over-specified or under-populated trees
    (ref: HuffmanError::{Overspecified, Underpopulated},
    lewton src/huffman_tree.rs:127-131).
    """
    n = len(lengths)
    codes: list[tuple[int, int] | None] = [None] * n
    used = [i for i in range(n) if lengths[i] > 0]
    if not used:
        return codes
    for i in used:
        if not (1 <= lengths[i] <= 32):
            raise HuffmanError(f"codeword length {lengths[i]} out of range")
    if len(used) == 1:
        # Single-entry codebook: spec errata — encoded with one dummy bit;
        # any 1-bit input decodes to the entry
        # (ref: lewton src/huffman_tree.rs:202-217).
        if lengths[used[0]] != 1:
            raise HuffmanError("single-entry codebook with length != 1")
        codes[used[0]] = (0, 1)
        return codes

    # `avail[d]` holds the left-aligned (33-bit domain) value of the unused
    # prefix of depth d, or 0 if none. Invariant: deeper available prefixes
    # have smaller values, so taking the deepest available prefix <= len is
    # the spec's "lowest valued unused binary number of chosen length".
    TOP = 33  # left-align in a 33-bit domain so bit 32 can mark saturation
    avail = [0] * 33
    first = used[0]
    l0 = lengths[first]
    codes[first] = (0, l0)
    for d in range(1, l0 + 1):
        avail[d] = 1 << (TOP - 1 - d)

    for i in used[1:]:
        l = lengths[i]
        z = l
        while z > 0 and avail[z] == 0:
            z -= 1
        if z == 0:
            raise HuffmanError("over-specified codebook (no free codeword)")
        prefix = avail[z]
        avail[z] = 0
        codes[i] = (prefix >> (TOP - 1 - l), l)
        for d in range(z + 1, l + 1):
            avail[d] = prefix | (1 << (TOP - 1 - d))

    # Kraft check: the tree must be exactly full, otherwise some input bit
    # sequences would be undecodable.
    if any(avail[d] for d in range(1, 33)):
        raise HuffmanError("under-populated codebook (incomplete tree)")
    return codes


class HuffmanTree:
    """Decode structures for one codebook.

    Attributes:
      lut: 256-entry list of ``(payload, advance)``; ``advance>0`` means a
        full codeword of that many bits with decoded entry ``payload``;
        ``advance==0`` means ``payload`` is an inner-node id at depth 8.
      root: node id of the root (for bit-by-bit descent near packet end).
    """

    __slots__ = ("codes", "lut", "root", "_children", "_payload",
                 "num_entries", "empty")

    LEAF_BIT = 1 << 30

    def __init__(self, lengths: list[int]):
        self.codes = assign_codewords(lengths)
        self.num_entries = len(lengths)
        #: no used entries at all (entries == 0 or every length 0): legal
        #: in headers, but DECODING from it fails like end-of-packet (see
        #: bitpack.read_huffman; libvorbis-oracle + native-backend parity)
        self.empty = not any(c is not None for c in self.codes)
        # Explicit binary tree: _children[node] = [left_id, right_id], where an
        # id with LEAF_BIT set encodes payload directly; 0 = absent child.
        self._children: list[list[int]] = [[0, 0]]
        self.root = 0
        single = [i for i, c in enumerate(self.codes) if c is not None]
        if len(single) == 1:
            e = single[0] | self.LEAF_BIT
            self._children[0] = [e, e]
        else:
            for entry, c in enumerate(self.codes):
                if c is None:
                    continue
                code, l = c
                node = 0
                for bitpos in range(l - 1, -1, -1):
                    b = (code >> bitpos) & 1
                    if bitpos == 0:
                        self._children[node][b] = entry | self.LEAF_BIT
                    else:
                        child = self._children[node][b]
                        if child == 0:
                            self._children.append([0, 0])
                            child = len(self._children) - 1
                            self._children[node][b] = child
                        node = child

        # 8-bit unrolled LUT, indexed by the next 8 stream bits with the
        # FIRST-read bit in the LSB (natural LSb-first peek order).
        lut: list[tuple[int, int]] = [(0, 0)] * 256
        for entry, c in enumerate(self.codes):
            if c is None:
                continue
            code, l = c
            if len(single) == 1:
                # any one bit decodes the single entry
                for idx in range(256):
                    lut[idx] = (entry, 1)
                break
            if l > 8:
                continue
            # stream-order pattern: bit i of pattern = bit (l-1-i) of code
            pat = 0
            for i in range(l):
                pat |= ((code >> (l - 1 - i)) & 1) << i
            step = 1 << l
            for idx in range(pat, 256, step):
                # every index whose low l bits equal pat (pat < step)
                lut[idx] = (entry, l)
        if len(single) != 1:
            # Fill remaining slots with the depth-8 inner node reached by
            # that prefix (for codes longer than 8 bits).
            for idx in range(256):
                if lut[idx][1] == 0:
                    node = 0
                    ok = True
                    for i in range(8):
                        child = self._children[node][(idx >> i) & 1]
                        if child == 0 or child & self.LEAF_BIT:
                            ok = False
                            break
                        node = child
                    if ok:
                        lut[idx] = (node, 0)
                    # else: unreachable prefix in a full tree; leave (0,0) —
                    # decode via root descent would error the same way.
        self.lut = lut

    def step(self, node: int, bit: int) -> tuple[int, bool, int]:
        """Descend one bit. Returns (next_node, is_leaf, payload)."""
        child = self._children[node][bit]
        if child & self.LEAF_BIT:
            return 0, True, child & ~self.LEAF_BIT
        if child == 0:
            raise HuffmanError("descent into absent branch (corrupt tree)")
        return child, False, 0

    def is_empty(self) -> bool:
        return all(c is None for c in self.codes)
