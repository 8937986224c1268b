"""Lossless 12-bit residue transport (lewton_tpu/parallel/pack12.py).

When a setup's static worst-case |residue| is < 2048, every residue value
fits 12 bits two's complement, so 8 values pack into 3 u32 words: the
dominant host-to-device tensor shrinks by another 25% over i16, exactly,
for every decodable packet of the setup.

Layout (per innermost row of n = 8*K values), the reference's: the row is
viewed as 8 blocks of K consecutive values (u_j[g] = row[j*K + g]) packed
into three contiguous K-wide planes [w0 | w1 | w2]:

    w0[g] = u0 | u1 << 12 | (u2 & 0xff) << 24
    w1[g] = u2 >> 8 | u3 << 4 | u4 << 16 | (u5 & 0xf) << 28
    w2[g] = u5 >> 4 | u6 << 8 | u7 << 20          (u_j 12-bit masked)

The pack runs on the host (numpy), the unpack on the device as torch bit
ops. The packed words travel as int32 (the same bits): torch's uint32 has
no shifts, so the unpack masks after every right shift, which makes the
arithmetic shifts of int32 logical ones.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import native

__all__ = ["pack12_supported", "pack12_np", "unpack12",
           "probed_h2d_mb_s", "p12_auto", "P12_AUTO_MAX_MB_S"]

#: transport="auto" crossover, the reference's: ship p12 when the measured
#: H2D rate is below this (the 25% of H2D bytes it saves must beat one more
#: host pass over the residue)
P12_AUTO_MAX_MB_S = 500.0

_probed_rate: dict = {}


def probed_h2d_mb_s(device="cuda", refresh: bool = False) -> float:
    """Measured host-to-device rate (MB/s) of ``device``, cached per
    process: the median of 3 copies of an 8 MiB pinned host tensor, each
    closed by a synchronize, after one warm copy."""
    dev = torch.device(device)
    if dev not in _probed_rate or refresh:
        buf = torch.zeros((8 << 20) // 4, dtype=torch.float32,
                          pin_memory=True)
        buf.to(dev, non_blocking=True)
        torch.cuda.synchronize(dev)
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            buf.to(dev, non_blocking=True)
            torch.cuda.synchronize(dev)
            rates.append(buf.numel() * 4 / (time.perf_counter() - t0) / 1e6)
        _probed_rate[dev] = float(np.median(rates))
    return _probed_rate[dev]


def p12_auto(cs, device=None) -> bool:
    """transport="auto" policy: p12 iff the setup supports it, the decode
    runs on a card (``device``, default the setup's), and the measured
    link is slower than :data:`P12_AUTO_MAX_MB_S`. False on the CPU, as
    the reference's is on its CPU backend."""
    dev = torch.device(device if device is not None else cs.device)
    if dev.type == "cpu" or not pack12_supported(cs):
        return False
    return probed_h2d_mb_s(dev) < P12_AUTO_MAX_MB_S


def pack12_supported(cs) -> bool:
    """True when the 12-bit transport is exact for this setup: integer
    residues with static bound < 2048 and a group-aligned row width."""
    bound = getattr(cs, "residue_bound", None)
    return (cs.residue_i16 and bound is not None and bound < 2048
            and (cs.channels * cs.w_eff) % 8 == 0)


def pack12_np(arr: np.ndarray) -> np.ndarray:
    """Pack i16 values in [-2048, 2047] along the last axis: [..., 8K] i16
    -> [..., 3K] u32 (three K-wide planes, see the module docstring).
    Raises on a value out of range instead of truncating it. Runs the host
    library's C loop once this process has loaded it (the same words; the
    numpy form below makes several passes over the array)."""
    assert arr.dtype == np.int16 and arr.shape[-1] % 8 == 0
    if native.available():
        return native.pack12(arr)
    if arr.size and (arr.min() < -2048 or arr.max() > 2047):
        raise ValueError("pack12: residue value outside [-2048, 2047]")
    K = arr.shape[-1] // 8
    u = (arr.astype(np.uint32) & np.uint32(0xFFF)).reshape(
        arr.shape[:-1] + (8, K))
    w0 = u[..., 0, :] | (u[..., 1, :] << 12) | ((u[..., 2, :] & 0xFF) << 24)
    w1 = ((u[..., 2, :] >> 8) | (u[..., 3, :] << 4) | (u[..., 4, :] << 16)
          | ((u[..., 5, :] & 0xF) << 28))
    w2 = (u[..., 5, :] >> 4) | (u[..., 6, :] << 8) | (u[..., 7, :] << 20)
    return np.concatenate([w0, w1, w2], axis=-1)


def unpack12(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack12_np` on the tensor's device: [..., 3K] int32
    words (the u32 words' bits) -> [..., n] i16 with n = 8K."""
    K = n // 8
    w0 = packed[..., :K]
    w1 = packed[..., K: 2 * K]
    w2 = packed[..., 2 * K:]
    m = 0xFFF
    vs = [
        w0 & m,
        (w0 >> 12) & m,
        ((w0 >> 24) & 0xFF) | ((w1 << 8) & m),
        (w1 >> 4) & m,
        (w1 >> 16) & m,
        ((w1 >> 28) & 0xF) | ((w2 << 4) & m),
        (w2 >> 8) & m,
        (w2 >> 20) & m,
    ]
    u = torch.cat(vs, dim=-1)
    return (u - ((u & 0x800) << 1)).to(torch.int16)
