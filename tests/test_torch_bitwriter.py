"""The port's ``utils.bitwriter.BitWriter`` on the CPU: the reference's
bytes for hypothesis-drawn sequences of writes (bits, flags, bytes,
canonical Huffman codewords), the same ``ValueError`` for a value that does
not fit, and a round trip through the port's ``bitpack.BitCursor``."""

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lewton_tpu.utils.bitwriter import BitWriter as JBitWriter
from lewton_tpu_torch.bitpack import BitCursor
from lewton_tpu_torch.utils.bitwriter import BitWriter

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)


@st.composite
def writes(draw):
    """One write: ("bits", value, n) with value < 2^n, ("flag", b),
    ("bytes", data) or ("huffman", code, length)."""
    kind = draw(st.sampled_from(["bits", "flag", "bytes", "huffman"]))
    if kind == "bits":
        n = draw(st.integers(0, 32))
        return kind, draw(st.integers(0, (1 << n) - 1)), n
    if kind == "flag":
        return kind, draw(st.booleans())
    if kind == "bytes":
        return kind, draw(st.binary(max_size=6))
    length = draw(st.integers(1, 24))
    return kind, draw(st.integers(0, (1 << length) - 1)), length


def apply(w, ops):
    for op in ops:
        if op[0] == "bits":
            assert w.write_bits(op[1], op[2]) is w
        elif op[0] == "flag":
            w.write_flag(op[1])
        elif op[0] == "bytes":
            w.write_bytes(op[1])
        else:
            w.write_huffman(op[1], op[2])
    return w.getvalue()


@settings(max_examples=200, deadline=None)
@given(st.lists(writes(), max_size=40))
def test_bytes_match_reference_and_round_trip(ops):
    data = apply(BitWriter(), ops)
    assert data == apply(JBitWriter(), ops)
    cur = BitCursor(data)
    for op in ops:
        if op[0] == "bits":
            assert cur.read_bits(op[2]) == op[1]
        elif op[0] == "flag":
            assert cur.read_bit_flag() == op[1]
        elif op[0] == "bytes":
            assert bytes(cur.read_bits(8) for _ in op[1]) == op[1]
        else:  # MSB first in stream order
            code = 0
            for _ in range(op[2]):
                code = (code << 1) | cur.read_bits(1)
            assert code == op[1]
    assert cur.bits_remaining() < 8


@pytest.mark.parametrize("value,n", [(2, 1), (-1, 3), (256, 8), (1, 0),
                                     (0, -1)])
def test_value_errors_match_reference(value, n):
    with pytest.raises(ValueError) as got:
        BitWriter().write_bits(value, n)
    with pytest.raises(ValueError) as want:
        JBitWriter().write_bits(value, n)
    assert str(got.value) == str(want.value)
