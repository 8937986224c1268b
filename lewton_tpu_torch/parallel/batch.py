"""Chunk loop for a batch of streams (lewton_tpu/parallel/batch.py:66-89).

Streams are independent and decoded in lockstep by one call per chunk
(the stream axis is explicit in the core, no ``vmap``). Packet time is
sequential through the window carry, so N chunks run as a Python loop that
chains the carry; the reference's ``lax.scan`` only amortized dispatch
latency, and PyTorch dispatches eagerly.
"""

from __future__ import annotations

import torch

from ..models.decoder import CompiledSetup, decode_frames_core
from ..ops.imdct import imdct_batch

__all__ = ["decode_chunk_batch", "decode_chunks_scan"]


#: one chunk for S streams (``with_i16``, ``compact_cap`` as the
#: reference's), under the reference's name
decode_chunk_batch = decode_frames_core


def _chunk(frs: dict, i: int) -> dict:
    """Chunk i of frames with leaves [N, ...] (``f1_brackets`` is a tuple)."""
    return {k: tuple(b[i] for b in v) if isinstance(v, tuple) else v[i]
            for k, v in frs.items()}


def decode_chunks_scan(cs: CompiledSetup, frs: dict, carry,
                       with_i16: bool = False, plain: bool = False,
                       imdct=imdct_batch):
    """N chunks in order: frs leaves [N, S, T, ...]. Returns ((out, out_len
    i32 [N, S, T]), final carry), out i16 [N, S, T, C*3n1/4] with
    ``with_i16``, else f32 [N, S, T, C, 3n1/4]. Each chunk's samples are
    written into its slice of ``out``. ``imdct``: passed to every chunk's
    :func:`decode_frames_core` (a caller's transform, as the reference's
    ``_batch_core`` passes it)."""
    N, S, T = frs["mode"].shape
    dev = frs["mode"].device
    outw = 3 * cs.n1 // 4
    out = (torch.empty((N, S, T, cs.channels * outw), dtype=torch.int16,
                       device=dev) if with_i16 else
           torch.empty((N, S, T, cs.channels, outw), dtype=torch.float32,
                       device=dev))
    lens = torch.empty((N, S, T), dtype=torch.int32, device=dev)
    for i in range(N):
        (_, out_len), carry = decode_frames_core(
            cs, _chunk(frs, i), carry, with_i16=with_i16, plain=plain,
            out=out[i], imdct=imdct)
        lens[i] = out_len
    return (out, lens), carry
