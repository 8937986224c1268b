"""The IMDCT as dense fp32 GEMMs (lewton_tpu/ops/imdct.py:72-273).

The i16 path uses the half-width DCT-IV form: the IMDCT output of length n
is a signed mirror arrangement of the DCT-IV X (length n/2) of the spectra,
so the GEMM emits only X and the overlap kernel rebuilds the window regions
from it. The f32 path (and taps) uses the full-width IMDCT matrix. With
``USE_DCT4_SPLIT`` the long transform of the i16 path goes through the
one-level Wang split (tables.dct4_split_tables): a twiddle rotation into
(c || d), then two half-size GEMMs whose outputs (U, V) the overlap kernel
recombines into X. The products lie outside any kernel in the reference
too (XLA's GEMMs), so here they are plain fp32 ``torch.matmul`` with TF32
off (pinned at package import).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..tables import dct4_split_tables

__all__ = ["imdct_batch_parts", "imdct_batch", "imdct_batch_parts_ct",
           "dct4_batch_parts_ct", "split_tables", "split_butterfly",
           "dct4_split_uv_ct", "dct4_split_uv_from_cd", "split_cd_head",
           "combine_split", "dct4_split_batch_parts_ct", "sum_order_bound",
           "USE_DCT4_SPLIT"]

#: opt-in, as in the reference (imdct.py:196-199): the i16 path's long
#: transform through the Wang split (half the long GEMM's FLOPs)
USE_DCT4_SPLIT = False


def imdct_batch_parts(spectra: torch.Tensor, m0: torch.Tensor,
                      m1: torch.Tensor):
    """spectra f32 [T, C, w_eff] -> (long [T, C, n1], short [T, C, n0] or
    None when n0 == n1), without the per-packet select. m0/m1: IMDCT
    matrices [<=n/2, n] (rows clipped to w_eff: spectra are zero past it)."""
    long_out = torch.matmul(spectra, m1)
    if m0.shape[1] == m1.shape[1]:
        return long_out, None
    return long_out, torch.matmul(spectra[..., : m0.shape[0]], m0)


def imdct_batch(spectra: torch.Tensor, blockflag: torch.Tensor,
                m0: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """spectra f32 [T, C, w_eff], blockflag [T] -> audio f32 [T, C, n1];
    short-block outputs occupy [:, :, :n0], zero past it."""
    long_out, short_out = imdct_batch_parts(spectra, m0, m1)
    if short_out is None:
        return long_out
    short_out = torch.nn.functional.pad(
        short_out, (0, m1.shape[1] - m0.shape[1]))
    return torch.where((blockflag == 1)[:, None, None], long_out, short_out)


def imdct_batch_parts_ct(spectra_ct: torch.Tensor, m0: torch.Tensor,
                         m1: torch.Tensor):
    """Channel-major :func:`imdct_batch_parts`: spectra_ct f32 [C, rows,
    w_eff] -> (long [C, rows, n1], short [C, rows, n0] or None when
    n0 == n1), the layout the overlap kernel's audio form takes with
    ``ct_in``."""
    return imdct_batch_parts(spectra_ct, m0, m1)


def dct4_batch_parts_ct(spectra_ct: torch.Tensor, mx0: torch.Tensor,
                        mx1: torch.Tensor):
    """spectra_ct f32 [C, rows, w_eff] -> (X long [C, rows, n1/2], X short
    [C, rows, n0/2] or None when n0 == n1). mx0/mx1: DCT-IV matrices
    [<=n/2, n/2] (rows clipped to w_eff: spectra are zero past it)."""
    long_x = torch.matmul(spectra_ct, mx1)
    if mx0.shape[1] == mx1.shape[1]:
        return long_x, None
    short_x = torch.matmul(spectra_ct[:, :, : mx0.shape[0]], mx0)
    return long_x, short_x


@functools.cache
def split_tables(n: int, device) -> tuple[torch.Tensor, ...]:
    """:func:`dct4_split_tables` of blocksize n on ``device``, made once
    per process (a host table copied over per chunk would synchronise the
    stream): (t2 [H, H], s2 [H, H], tw [2, H] = (cos, sin) of the
    twiddle angles)."""
    t2, s2, ct, st = dct4_split_tables(n)
    return tuple(torch.tensor(a, device=device)
                 for a in (t2, s2, np.stack([ct, st])))


def split_butterfly(spectra_ct: torch.Tensor, n: int):
    """The Wang split's twiddle rotation of spectra f32 [C, rows, K]
    (K <= n/2, zero past K): (c, d) f32 [C, rows, n/4] each (reference
    ops/imdct.py:202-225)."""
    N = n // 2
    H = N // 2
    _, _, tw = split_tables(n, spectra_ct.device)
    ct, st = tw[0], tw[1]
    K = spectra_ct.shape[-1]
    pad = torch.nn.functional.pad
    a = spectra_ct[..., :H]
    if K <= H:
        a = pad(a, (0, H - K))
        b = torch.zeros_like(a)
    else:
        b = pad(spectra_ct, (0, N - K))[..., H:].flip(-1)  # x_{N-1-k}
    return ct * a + st * b, ct * b - st * a


def dct4_split_uv_ct(spectra_ct: torch.Tensor, n: int):
    """The split's two half-size GEMMs without the recombination: spectra
    f32 [C, rows, K] -> (U, V) f32 [C, rows, n/4] each."""
    t2, s2, _ = split_tables(n, spectra_ct.device)
    c, d = split_butterfly(spectra_ct, n)
    return torch.matmul(c, t2), torch.matmul(d, s2)


def dct4_split_uv_from_cd(cd: torch.Tensor, n: int):
    """(U, V) from the floor kernel's rotated output (c || d) f32
    [C, rows, n/2]: the two GEMMs read c and d as strided views."""
    H = n // 4
    t2, s2, _ = split_tables(n, cd.device)
    return torch.matmul(cd[..., :H], t2), torch.matmul(cd[..., H:], s2)


def split_cd_head(cd: torch.Tensor, n: int, k0: int) -> torch.Tensor:
    """The first k0 spectrum values back out of (c || d) f32 [C, rows,
    n/2]: the rotation is orthonormal per bin, so x_k = cos c_k - sin d_k
    (about 2 ulp of round trip). Feeds the short-block GEMM."""
    H = n // 4
    _, _, tw = split_tables(n, cd.device)
    return tw[0, :k0] * cd[..., :k0] - tw[1, :k0] * cd[..., H:H + k0]


def combine_split(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """DCT-IV X f32 [.., 2H] from the split halves U, V [.., H]:
    X_0 = U_0, X_{2j-1} = U_j - V_{j-1}, X_{2j} = U_j + V_{j-1},
    X_{2H-1} = -V_{H-1}."""
    H = u.shape[-1]
    uh, vh = u[..., 1:], v[..., :H - 1]
    mid = torch.stack([uh - vh, uh + vh], -1).reshape(
        u.shape[:-1] + (2 * H - 2,))
    return torch.cat([u[..., :1], mid, -v[..., H - 1:]], -1)


def dct4_split_batch_parts_ct(spectra_ct: torch.Tensor, n0: int, n1: int,
                              mx0: torch.Tensor, mx1: torch.Tensor):
    """:func:`dct4_batch_parts_ct` with the long transform through the
    split and recombined: (X long [C, rows, n1/2], X short [C, rows, n0/2]
    or None when n0 == n1). ``mx1`` is not read."""
    long_x = combine_split(*dct4_split_uv_ct(spectra_ct, n1))
    if n0 == n1:
        return long_x, None
    return long_x, torch.matmul(spectra_ct[:, :, :mx0.shape[0]], mx0)


def sum_order_bound(spectra_ct: torch.Tensor) -> float:
    """Largest difference two fp32 evaluations of the DCT-IV GEMM may show,
    whatever order each sums in: every result is within
    gamma_K * sum_k |s_k m_kj| of the exact value (gamma_K = K u / (1 - K u),
    u = 2^-24), and |m_kj| <= 1 for the cosine matrices, so two results
    differ by at most 2 gamma_K max_row sum_k |s_k|."""
    K = spectra_ct.shape[-1]
    u = 2.0 ** -24
    gamma = K * u / (1.0 - K * u)
    row_l1 = spectra_ct.abs().to(torch.float64).sum(-1)
    return 2.0 * gamma * float(row_l1.max()) if row_l1.numel() else 0.0
