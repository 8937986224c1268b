# Frozen copy of lewton_tpu_torch/residue.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Residue decode (types 0/1/2): the bulk entropy payload.

Host-side bit-serial work producing per-channel f32 residue vectors.
End-of-packet mid-residue is *data*: decoding stops and the remainder stays
zero (spec 1.3.2; ref lewton src/audio.rs:655-660 'eno!' semantics).

ref parity: lewton src/audio.rs:587-760, independently implemented from
Vorbis I spec section 8.6. The begin/end clamp to actual size follows the
spec fix xiph/vorbis#35 (same as the reference).

The port's copy of lewton_tpu/residue.py, held equal to it by the CPU tests.
"""

from __future__ import annotations

import numpy as np

from .bitpack import BitCursor
from .errors import AudioBadFormat, EndOfPacket
from .header import Codebook, Residue

__all__ = ["residue_decode"]


def _decode_inner(
    cur: BitCursor,
    blocksize: int,
    do_not_decode: list[bool],
    resid: Residue,
    codebooks: list[Codebook],
) -> np.ndarray:
    ch = len(do_not_decode)
    actual_size = blocksize // 2
    begin = min(resid.begin, actual_size)
    end = min(resid.end, actual_size)
    classbook = codebooks[resid.classbook]
    cpc = classbook.dimensions  # classwords per codeword
    n_to_read = end - begin
    partitions_to_read = n_to_read // resid.partition_size

    vectors = np.zeros((ch, actual_size), dtype=np.float32)
    if n_to_read == 0:
        return vectors
    if cpc == 0:
        raise AudioBadFormat("residue classbook with zero dimensions")

    psize = resid.partition_size
    rtype = resid.residue_type
    nclass = resid.classifications
    cl = np.zeros((ch, partitions_to_read + cpc), dtype=np.int64)

    try:
        for pass_ in range(8):
            partition_count = 0
            while partition_count < partitions_to_read:
                if pass_ == 0:
                    for j in range(ch):
                        if do_not_decode[j]:
                            continue
                        temp = cur.read_huffman(classbook.tree)
                        for i in range(cpc - 1, -1, -1):
                            cl[j, i + partition_count] = temp % nclass
                            temp //= nclass
                for _ in range(cpc):
                    if partition_count >= partitions_to_read:
                        break
                    for j in range(ch):
                        if do_not_decode[j]:
                            continue
                        offs = begin + partition_count * psize
                        book_idx = resid.books[cl[j, partition_count]][pass_]
                        if book_idx < 0:
                            continue
                        book = codebooks[book_idx]
                        vq = book.vq
                        dim = book.dimensions
                        row = vectors[j]
                        if rtype == 0:
                            step = psize // dim
                            for i in range(step):
                                vec = vq[cur.read_huffman(book.tree)]
                                row[offs + i : offs + i + dim * step : step] += vec
                        else:
                            i = 0
                            while i < psize:
                                vec = vq[cur.read_huffman(book.tree)]
                                # libvorbis-oracle semantics for a vector
                                # whose dim does not divide partition_size:
                                # the symbol IS read (ceil(psize/dim) reads
                                # per partition) but components past the
                                # partition boundary are DISCARDED
                                # (codebook.c vorbis_book_decodev_add clips
                                # at n=samples_per_partition). lewton
                                # instead adds them across the boundary
                                # (src/audio.rs:601-614 slices to channel
                                # end); we deliberately follow libvorbis,
                                # the conformance oracle — real encoders
                                # never emit such books, crafted streams do
                                # (tools/craft.py res_book="dim3").
                                lim = min(dim, psize - i,
                                          actual_size - (offs + i))
                                if lim > 0:
                                    row[offs + i : offs + i + lim] += \
                                        vec[:lim]
                                i += dim
                    partition_count += 1
    except EndOfPacket:
        pass  # zeros remain — normal stop
    return vectors


def residue_decode(
    cur: BitCursor,
    blocksize: int,
    do_not_decode: list[bool],
    resid: Residue,
    codebooks: list[Codebook],
) -> np.ndarray:
    """Decode one residue for `len(do_not_decode)` channels.

    Returns f32 [ch, blocksize//2].
    """
    ch = len(do_not_decode)
    if resid.residue_type == 2:
        if all(do_not_decode):
            return np.zeros((ch, blocksize // 2), dtype=np.float32)
        inter = _decode_inner(cur, blocksize * ch, [False], resid, codebooks)
        # deinterleave: channel j takes every ch-th value starting at j
        return np.ascontiguousarray(inter.reshape(-1, ch).T)
    return _decode_inner(cur, blocksize, do_not_decode, resid, codebooks)
