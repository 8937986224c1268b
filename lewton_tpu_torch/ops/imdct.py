"""The IMDCT as dense fp32 GEMMs (lewton_tpu/ops/imdct.py:72-174).

The i16 path uses the half-width DCT-IV form: the IMDCT output of length n
is a signed mirror arrangement of the DCT-IV X (length n/2) of the spectra,
so the GEMM emits only X and the overlap kernel rebuilds the window regions
from it. The f32 path (and taps) uses the full-width IMDCT matrix. The
products lie outside any kernel in the reference too (XLA's GEMMs), so here
they are plain fp32 ``torch.matmul`` with TF32 off (pinned at package
import).
"""

from __future__ import annotations

import torch

__all__ = ["imdct_batch_parts", "imdct_batch", "dct4_batch_parts_ct",
           "sum_order_bound"]


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
