# Frozen copy of lewton_tpu_torch/header.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Vorbis header decode (host side): ident, comment, setup.

The port's copy of lewton_tpu/header.py: the parsers (``read_header_ident``,
``read_header_comment``, ``read_header_setup`` with ``read_codebook``,
``read_floor``, ``read_residue``, ``read_mapping``, ``read_mode``) and the
records they return, with the same classes, field names and field order.
``compile_setup`` reads only fields, so the records built by hand
(``testing.synthetic_headers``) and the parsed ones are taken alike. The
CPU tests hold every parsed field, codebook ``vq`` arrays included, equal
to the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .bitpack import BitCursor, ilog
from .errors import (
    BadHeader,
    EndOfPacket,
    HeaderError,
    HeaderIsAudio,
    NotVorbisHeader,
    UnsupportedVersion,
)
from .huffman import HuffmanTree

__all__ = [
    "IdentHeader",
    "CommentHeader",
    "SetupHeader",
    "HeaderSet",
    "Codebook",
    "Floor0",
    "Floor1",
    "Residue",
    "Mapping",
    "Mode",
    "read_header_ident",
    "read_header_comment",
    "read_header_setup",
    "lookup1_values",
]


def _check_capture(packet: bytes, expected_type: int) -> BitCursor:
    """Verify the `\\xNNvorbis` capture pattern and return a cursor past it.

    ref parity: lewton src/header.rs:131-152 (header-vs-audio bit check).
    """
    if len(packet) < 7:
        raise NotVorbisHeader("packet shorter than capture pattern")
    ptype = packet[0]
    if packet[1:7] != b"vorbis":
        raise NotVorbisHeader("capture pattern mismatch")
    if ptype & 1 == 0:
        raise HeaderIsAudio("audio packet passed to header reader")
    if ptype != expected_type:
        raise BadHeader(f"expected header type {expected_type}, got {ptype}")
    cur = BitCursor(packet)
    cur.read_bits(8 * 7)
    return cur


# --------------------------------------------------------------------------- #
# Ident header (spec 4.2.2; ref lewton src/header.rs:221-259)
# --------------------------------------------------------------------------- #


@dataclass
class IdentHeader:
    channels: int
    sample_rate: int
    bitrate_maximum: int
    bitrate_nominal: int
    bitrate_minimum: int
    blocksize_0: int  # exponent; actual size = 1 << blocksize_0
    blocksize_1: int

    @property
    def bs0(self) -> int:
        return 1 << self.blocksize_0

    @property
    def bs1(self) -> int:
        return 1 << self.blocksize_1


def read_header_ident(packet: bytes) -> IdentHeader:
    cur = _check_capture(packet, 1)
    try:
        version = cur.read_bits(32)
        if version != 0:
            raise UnsupportedVersion(f"version {version}")
        channels = cur.read_bits(8)
        sample_rate = cur.read_bits(32)
        bitrate_maximum = cur.read_signed_bits(32)
        bitrate_nominal = cur.read_signed_bits(32)
        bitrate_minimum = cur.read_signed_bits(32)
        blocksize_0 = cur.read_bits(4)
        blocksize_1 = cur.read_bits(4)
        framing = cur.read_bits(1)
    except EndOfPacket as e:
        raise BadHeader(f"truncated ident header: {e}") from e
    if channels == 0:
        raise BadHeader("zero channels")
    if sample_rate == 0:
        raise BadHeader("zero sample rate")
    if not (6 <= blocksize_0 <= 13) or not (6 <= blocksize_1 <= 13):
        raise BadHeader(f"blocksize exponents {blocksize_0},{blocksize_1} out of range")
    if blocksize_0 > blocksize_1:
        raise BadHeader("blocksize_0 > blocksize_1")
    if framing != 1:
        raise BadHeader("ident framing bit unset")
    return IdentHeader(
        channels,
        sample_rate,
        bitrate_maximum,
        bitrate_nominal,
        bitrate_minimum,
        blocksize_0,
        blocksize_1,
    )


# --------------------------------------------------------------------------- #
# Comment header (spec 4.2.3; ref lewton src/header.rs:309-360)
# --------------------------------------------------------------------------- #


@dataclass
class CommentHeader:
    vendor: str
    comment_list: list[tuple[str, str]]


def read_header_comment(packet: bytes) -> CommentHeader:
    _check_capture(packet, 3)
    # Comment fields are byte-aligned little-endian (the one header that
    # doesn't use the bitpack convention beyond the capture pattern).
    buf = memoryview(packet)[7:]
    pos = 0

    def read_u32() -> int:
        nonlocal pos
        if pos + 4 > len(buf):
            raise BadHeader("truncated comment header")
        v = int.from_bytes(buf[pos : pos + 4], "little")
        pos += 4
        return v

    def read_str(n: int) -> str:
        nonlocal pos
        if pos + n > len(buf):
            raise BadHeader("truncated comment string")
        s = bytes(buf[pos : pos + n])
        pos += n
        # Tolerate non-UTF-8 with a LOSSY decode (U+FFFD replacement).
        # Deliberately MORE tolerant than the reference, which skips a
        # non-UTF-8 comment entry and errors on a non-UTF-8 vendor
        # (lewton src/header.rs:328-346); libvorbis never validates UTF-8
        # at all. Metadata should never make a decodable stream fail.
        return s.decode("utf-8", errors="replace")

    vendor = read_str(read_u32())
    count = read_u32()
    comments: list[tuple[str, str]] = []
    for _ in range(count):
        entry = read_str(read_u32())
        # skip entries without '=' instead of erroring (ref behavior)
        if "=" in entry:
            k, v = entry.split("=", 1)
            comments.append((k, v))
    if pos >= len(buf) or (buf[pos] & 1) != 1:
        raise BadHeader("comment framing bit unset")
    return CommentHeader(vendor, comments)


# --------------------------------------------------------------------------- #
# Setup header (spec 4.2.4; ref lewton src/header.rs:1082-1154)
# --------------------------------------------------------------------------- #


def lookup1_values(entries: int, dim: int) -> int:
    """Largest integer l such that l**dim <= entries (spec 9.2.3).

    ref parity: lewton src/header.rs:616-648 (nth-root with integer check).
    """
    if dim == 0:
        raise BadHeader("zero-dimension codebook lookup")
    l = int(entries ** (1.0 / dim))
    # float imprecision: adjust both directions
    while (l + 1) ** dim <= entries:
        l += 1
    while l > 0 and l**dim > entries:
        l -= 1
    return l


@dataclass
class Codebook:
    dimensions: int
    entries: int
    lengths: list[int]
    tree: HuffmanTree
    lookup_type: int
    #: expanded VQ table [entries, dimensions] float32, or None (lookup 0)
    vq: np.ndarray | None


def read_codebook(cur: BitCursor) -> Codebook:
    """Spec 3.2.1 codebook decode (ref: lewton src/header.rs:673-767)."""
    sync = cur.read_bits(24)
    if sync != 0x564342:
        raise BadHeader(f"codebook sync pattern 0x{sync:06x}")
    dimensions = cur.read_bits(16)
    entries = cur.read_bits(24)
    ordered = cur.read_bit_flag()
    # Bound the length-list allocation by what the packet can back: each
    # entry costs >= 1 bit (sparse flag) / 5 bits (non-sparse), so a
    # ~40-byte crafted packet declaring entries=2^24-1 must not allocate
    # a 16.7M-element list before the reads hit EndOfPacket. (Same
    # principle as the VQ-expansion guard below.)
    if not ordered and entries > cur.bits_remaining():
        raise BadHeader("truncated codebook")
    lengths = [0] * entries
    if not ordered:
        sparse = cur.read_bit_flag()
        for i in range(entries):
            if sparse:
                if cur.read_bit_flag():
                    lengths[i] = cur.read_bits(5) + 1
            else:
                lengths[i] = cur.read_bits(5) + 1
    else:
        current_entry = 0
        current_length = cur.read_bits(5) + 1
        while current_entry < entries:
            number = cur.read_bits(ilog(entries - current_entry))
            if current_entry + number > entries:
                raise BadHeader("ordered codebook length list overflow")
            for i in range(current_entry, current_entry + number):
                lengths[i] = current_length
            current_entry += number
            current_length += 1
            if current_length > 32 and current_entry < entries:
                raise BadHeader("ordered codebook length > 32")
    tree = HuffmanTree(lengths)

    lookup_type = cur.read_bits(4)
    vq = None
    if lookup_type == 0:
        pass
    elif lookup_type in (1, 2):
        if dimensions == 0:
            # A VQ book must map entries to >= 1 scalar: libvorbis (the
            # conformance oracle) rejects dim < 1 at unpack, and a dim-0
            # book reaching residue/floor0 decode divides by zero /
            # indexes vec[-1] (native: heap OOB). Scalar (lookup 0)
            # dim-0 books stay accepted; their dims field is unused.
            raise BadHeader("VQ codebook with zero dimensions")
        minimum_value = np.float32(cur.read_f32())
        delta_value = np.float32(cur.read_f32())
        value_bits = cur.read_bits(4) + 1
        sequence_p = cur.read_bit_flag()
        if lookup_type == 1:
            lookup_values = lookup1_values(entries, dimensions)
        else:
            lookup_values = entries * dimensions
        # Bound allocations by what the packet can back: each lookup value
        # costs value_bits (>=1) bits. Without this a ~33-byte crafted setup
        # packet (ordered lengths + lookup type 1) requests a multi-TB VQ
        # expansion (entries<=2^24-1 x dims<=65535). Mirrors the native
        # guard in native/lt_header.cc read_codebook.
        if lookup_values * value_bits > cur.bits_remaining():
            raise BadHeader("truncated codebook")
        if entries * dimensions > (1 << 24):
            raise BadHeader("codebook VQ table too large")
        mults = np.array(
            [cur.read_bits(value_bits) for _ in range(lookup_values)],
            dtype=np.float32,
        )
        if entries and dimensions:
            if lookup_type == 1:
                e = np.arange(entries, dtype=np.int64)[:, None]
                j = np.arange(dimensions, dtype=np.int64)[None, :]
                if lookup_values == 0:
                    raise BadHeader("lookup1 with zero lookup values")
                div = lookup_values ** j.astype(object)
                offs = (e // div) % lookup_values
                vals = mults[offs.astype(np.int64)]
            else:
                vals = mults.reshape(entries, dimensions)
            # value = mult * delta + min (+ cumulative if sequence_p),
            # computed in f32 to match the reference op-for-op
            # (lewton src/header.rs:495-531, lookup_vec_val_decode).
            vals = vals * delta_value + minimum_value
            if sequence_p:
                vals = np.cumsum(vals.astype(np.float32), axis=1, dtype=np.float32)
            vq = np.ascontiguousarray(vals, dtype=np.float32)
        else:
            vq = np.zeros((entries, dimensions), dtype=np.float32)
    else:
        raise BadHeader(f"codebook lookup type {lookup_type}")
    return Codebook(dimensions, entries, lengths, tree, lookup_type, vq)


@dataclass
class Floor0:
    order: int
    rate: int
    bark_map_size: int
    amplitude_bits: int
    amplitude_offset: int
    books: list[int]
    floor_type: int = 0


@dataclass
class Floor1:
    partitions: int
    partition_class: list[int]
    class_dims: list[int]
    class_subclasses: list[int]
    class_masterbooks: list[int]  # -1 if absent
    subclass_books: list[list[int]]  # [class][subclass] -> book or -1
    multiplier: int
    x_list: list[int]
    floor_type: int = 1
    # derived (computed in __post_init__):
    sort_order: np.ndarray = field(default=None, repr=False)  # argsort of x_list
    low_neighbors: np.ndarray = field(default=None, repr=False)
    high_neighbors: np.ndarray = field(default=None, repr=False)

    def __post_init__(self):
        x = np.asarray(self.x_list, dtype=np.int64)
        # stable argsort: spec requires unique x values so ties don't occur
        self.sort_order = np.argsort(x, kind="stable")
        n = len(self.x_list)
        low = np.zeros(n, dtype=np.int32)
        high = np.zeros(n, dtype=np.int32)
        for i in range(2, n):
            # low_neighbor: index j < i with largest x[j] < x[i]
            # high_neighbor: index j < i with smallest x[j] > x[i]
            # (spec 9.2.4/9.2.5; ref lewton src/audio.rs:253-291)
            lo_best, hi_best = 0, 1
            for j in range(i):
                if x[j] < x[i] and x[j] >= x[lo_best]:
                    lo_best = j
                if x[j] > x[i] and x[j] <= x[hi_best]:
                    hi_best = j
            low[i], high[i] = lo_best, hi_best
        self.low_neighbors = low
        self.high_neighbors = high


def read_floor(cur: BitCursor, codebook_count: int, blocksizes: tuple[int, int]):
    """ref: lewton src/header.rs:771-918."""
    floor_type = cur.read_bits(16)
    if floor_type == 0:
        order = cur.read_bits(8)
        rate = cur.read_bits(16)
        bark_map_size = cur.read_bits(16)
        amplitude_bits = cur.read_bits(6)
        amplitude_offset = cur.read_bits(8)
        number_of_books = cur.read_bits(4) + 1
        if order == 0 or rate == 0 or bark_map_size == 0:
            raise BadHeader("floor0 zero order/rate/bark_map_size")
        if amplitude_bits > 64:
            # ref guard (lewton src/header.rs:780-787)
            raise BadHeader("floor0 amplitude_bits > 64")
        books = []
        for _ in range(number_of_books):
            b = cur.read_bits(8)
            if b >= codebook_count:
                raise BadHeader("floor0 book out of range")
            books.append(b)
        return Floor0(order, rate, bark_map_size, amplitude_bits, amplitude_offset, books)
    elif floor_type == 1:
        partitions = cur.read_bits(5)
        partition_class = [cur.read_bits(4) for _ in range(partitions)]
        max_class = max(partition_class) if partition_class else -1
        class_dims, class_subclasses = [], []
        class_masterbooks: list[int] = []
        subclass_books: list[list[int]] = []
        for _ in range(max_class + 1):
            dims = cur.read_bits(3) + 1
            subclasses = cur.read_bits(2)
            if subclasses:
                mb = cur.read_bits(8)
                if mb >= codebook_count:
                    raise BadHeader("floor1 masterbook out of range")
            else:
                mb = -1
            books = []
            for _ in range(1 << subclasses):
                b = cur.read_bits(8) - 1
                if b >= codebook_count:
                    raise BadHeader("floor1 subclass book out of range")
                books.append(b)
            class_dims.append(dims)
            class_subclasses.append(subclasses)
            class_masterbooks.append(mb)
            subclass_books.append(books)
        multiplier = cur.read_bits(2) + 1
        rangebits = cur.read_bits(4)
        x_list = [0, 1 << rangebits]
        for p in range(partitions):
            cls = partition_class[p]
            for _ in range(class_dims[cls]):
                x_list.append(cur.read_bits(rangebits))
        if len(x_list) > 65:
            raise BadHeader("floor1 x_list longer than 65")
        if len(set(x_list)) != len(x_list):
            # uniqueness required (spec; ref lewton src/header.rs:885-900)
            raise BadHeader("floor1 x_list values not unique")
        return Floor1(
            partitions,
            partition_class,
            class_dims,
            class_subclasses,
            class_masterbooks,
            subclass_books,
            multiplier,
            x_list,
        )
    else:
        raise BadHeader(f"floor type {floor_type}")


@dataclass
class Residue:
    residue_type: int
    begin: int
    end: int
    partition_size: int
    classifications: int
    classbook: int
    cascades: list[int]
    #: books[cls][pass] -> codebook index or -1
    books: list[list[int]]


def read_residue(cur: BitCursor, codebooks: list[Codebook]) -> Residue:
    """ref: lewton src/header.rs:922-982."""
    residue_type = cur.read_bits(16)
    if residue_type > 2:
        raise BadHeader(f"residue type {residue_type}")
    begin = cur.read_bits(24)
    end = cur.read_bits(24)
    if begin > end:
        # ref check (lewton src/header.rs:931-938)
        raise BadHeader("residue begin > end")
    partition_size = cur.read_bits(24) + 1
    classifications = cur.read_bits(6) + 1
    classbook = cur.read_bits(8)
    if classbook >= len(codebooks):
        raise BadHeader("residue classbook out of range")
    if codebooks[classbook].dimensions == 0:
        raise BadHeader("residue classbook with zero dimensions")
    cascades = []
    for _ in range(classifications):
        low = cur.read_bits(3)
        bitflag = cur.read_bit_flag()
        high = cur.read_bits(5) if bitflag else 0
        cascades.append((high << 3) | low)
    books: list[list[int]] = []
    for cls in range(classifications):
        row = []
        for p in range(8):
            if cascades[cls] & (1 << p):
                b = cur.read_bits(8)
                if b >= len(codebooks):
                    raise BadHeader("residue book out of range")
                if codebooks[b].vq is None:
                    # scalar-only book in a VQ context (spec 8.6.2)
                    raise BadHeader("residue book has no VQ lookup table")
                row.append(b)
            else:
                row.append(-1)
        books.append(row)
    # classifications ** classbook.dimensions must be representable; the
    # per-packet decode also guards classwords_per_codeword == 0
    # (ref lewton src/audio.rs:647-651).
    return Residue(
        residue_type, begin, end, partition_size, classifications, classbook,
        cascades, books,
    )


@dataclass
class Mapping:
    submaps: int
    coupling_magnitude: list[int]
    coupling_angle: list[int]
    mux: list[int]
    submap_floor: list[int]
    submap_residue: list[int]


def read_mapping(
    cur: BitCursor, channels: int, floor_count: int, residue_count: int
) -> Mapping:
    """ref: lewton src/header.rs:985-1057."""
    mapping_type = cur.read_bits(16)
    if mapping_type != 0:
        raise BadHeader(f"mapping type {mapping_type}")
    submaps = cur.read_bits(4) + 1 if cur.read_bit_flag() else 1
    coupling_magnitude: list[int] = []
    coupling_angle: list[int] = []
    if cur.read_bit_flag():
        coupling_steps = cur.read_bits(8) + 1
        bits = ilog(channels - 1)
        for _ in range(coupling_steps):
            mag = cur.read_bits(bits)
            ang = cur.read_bits(bits)
            if mag == ang or mag >= channels or ang >= channels:
                # ref check (lewton src/header.rs:1004-1014)
                raise BadHeader("invalid coupling channel pair")
            coupling_magnitude.append(mag)
            coupling_angle.append(ang)
    if cur.read_bits(2) != 0:
        raise BadHeader("mapping reserved bits set")
    if submaps > 1:
        mux = []
        for _ in range(channels):
            m = cur.read_bits(4)
            if m >= submaps:
                raise BadHeader("mapping mux out of range")
            mux.append(m)
    else:
        mux = [0] * channels
    submap_floor, submap_residue = [], []
    for _ in range(submaps):
        cur.read_bits(8)  # unused time configuration placeholder
        f = cur.read_bits(8)
        if f >= floor_count:
            raise BadHeader("mapping floor out of range")
        r = cur.read_bits(8)
        if r >= residue_count:
            raise BadHeader("mapping residue out of range")
        submap_floor.append(f)
        submap_residue.append(r)
    return Mapping(
        submaps, coupling_magnitude, coupling_angle, mux, submap_floor,
        submap_residue,
    )


@dataclass
class Mode:
    blockflag: int
    mapping: int


def read_mode(cur: BitCursor, mapping_count: int) -> Mode:
    """ref: lewton src/header.rs:1060-1076."""
    blockflag = cur.read_bits(1)
    windowtype = cur.read_bits(16)
    transformtype = cur.read_bits(16)
    mapping = cur.read_bits(8)
    if windowtype != 0:
        raise BadHeader(f"window type {windowtype}")
    if transformtype != 0:
        raise BadHeader(f"transform type {transformtype}")
    if mapping >= mapping_count:
        raise BadHeader("mode mapping out of range")
    return Mode(blockflag, mapping)


@dataclass
class SetupHeader:
    codebooks: list[Codebook]
    floors: list  # Floor0 | Floor1
    residues: list[Residue]
    mappings: list[Mapping]
    modes: list[Mode]


def read_header_setup(packet: bytes, ident: IdentHeader) -> SetupHeader:
    cur = _check_capture(packet, 5)
    try:
        codebook_count = cur.read_bits(8) + 1
        codebooks = [read_codebook(cur) for _ in range(codebook_count)]
        time_count = cur.read_bits(6) + 1
        for _ in range(time_count):
            if cur.read_bits(16) != 0:
                # time-domain transforms are placeholders, must be 0
                # (ref lewton src/header.rs:1103-1108)
                raise BadHeader("nonzero time transform")
        floor_count = cur.read_bits(6) + 1
        floors = [
            read_floor(cur, codebook_count, (ident.bs0, ident.bs1))
            for _ in range(floor_count)
        ]
        residue_count = cur.read_bits(6) + 1
        residues = [read_residue(cur, codebooks) for _ in range(residue_count)]
        mapping_count = cur.read_bits(6) + 1
        mappings = [
            read_mapping(cur, ident.channels, floor_count, residue_count)
            for _ in range(mapping_count)
        ]
        mode_count = cur.read_bits(6) + 1
        modes = [read_mode(cur, mapping_count) for _ in range(mode_count)]
        if cur.read_bits(1) != 1:
            raise BadHeader("setup framing bit unset")
    except EndOfPacket as e:
        raise BadHeader(f"truncated setup header: {e}") from e
    return SetupHeader(codebooks, floors, residues, mappings, modes)


@dataclass
class HeaderSet:
    ident: IdentHeader
    comment: CommentHeader
    setup: SetupHeader
    #: raw packet bytes (when read via inside_ogg.read_headers) — used to
    #: initialize the native front-end without re-serializing
    raw_ident: bytes | None = None
    raw_setup: bytes | None = None
