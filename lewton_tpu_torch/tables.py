"""Header-derived constant tables of the synthesis paths (numpy).

Copies of the functions of lewton_tpu/tables.py that ``compile_setup``, the
floor numerics and the Wang-split IMDCT read, so that the port runs where
only torch and numpy are installed. tests/test_torch_setup.py and
tests/test_torch_split.py hold every table here bit for bit against the
reference's.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["window_slope", "imdct_matrix", "dct4_split_tables",
           "bark_cos_omega", "floor1_db_four_factor"]

# lewton_tpu.tables.floor1_db_four_factor() as f32 bit patterns: H1, H0, L1,
# L0 (the inverse-dB table as (H1[i>>6]*H0[(i>>4)&3])*(L1[(i>>2)&3]*L0[i&3]),
# max 2 ulp from the spec's 256 entries). The reference derives them by an
# ulp search over the spec table; the port keeps the result.
_DB_FOUR_FACTOR_BITS = (
    (0x33E4B43E, 0x36C8F3E4, 0x39B09199, 0x3C9B24C0),
    (0x3F800000, 0x402F4244, 0x40EFF754, 0x41A44830),
    (0x3F800000, 0x3FA4A8A8, 0x3FD3D10C, 0x40083D77),
    (0x3F800000, 0x3F885173, 0x3F912D48, 0x3F9A9C7E),
)


def _frozen(a: np.ndarray) -> np.ndarray:
    a.setflags(write=False)
    return a


@functools.cache
def floor1_db_four_factor() -> tuple[np.ndarray, ...]:
    """(H1, H0, L1, L0), float32[4] each."""
    return tuple(_frozen(np.array(b, np.uint32).view(np.float32))
                 for b in _DB_FOUR_FACTOR_BITS)


@functools.cache
def window_slope(half_n: int) -> np.ndarray:
    """Left window slope of length n/2 for blocksize n (spec 4.3.1 step 7),
    computed in float64 and rounded once to float32."""
    i = np.arange(half_n, dtype=np.float64)
    v = np.sin(0.5 * np.pi * (i + 0.5) / half_n)
    return _frozen(np.sin(0.5 * np.pi * v * v).astype(np.float32))


@functools.cache
def imdct_matrix(n: int) -> np.ndarray:
    """IMDCT as a dense f32 [n/2, n] matrix:
    M[k, j] = cos(pi/(2n) * (2k+1) * (2j+1+n/2))."""
    k = np.arange(n // 2, dtype=np.float64)
    j = np.arange(n, dtype=np.float64)
    m = np.cos(np.pi / (2 * n) * np.outer(2 * k + 1, 2 * j + 1 + n // 2))
    return _frozen(np.ascontiguousarray(m, dtype=np.float32))


@functools.cache
def dct4_split_tables(n: int) -> tuple[np.ndarray, ...]:
    """One-level Wang split of the DCT-IV of length N = n/2 (the i16
    path's half-width IMDCT): with theta_k = pi (2k+1) / (4N), H = N/2,

        c_k = cos(theta_k) x_k + sin(theta_k) x_{N-1-k}
        d_k = cos(theta_k) x_{N-1-k} - sin(theta_k) x_k
        U = DCT-II_H(c),  V = DST-II_H(d)
        X_0 = U_0;  X_{2j-1} = U_j - V_{j-1};  X_{2j} = U_j + V_{j-1};
        X_{N-1} = -V_{H-1}

    Returns (t2 [H, H], s2 [H, H], cos_tw [H], sin_tw [H]) in f32, t2/s2
    in the GEMM's [k, j] layout, computed in float64 and rounded once."""
    N = n // 2
    H = N // 2
    j = np.arange(H, dtype=np.float64)
    k = np.arange(H, dtype=np.float64)
    t2 = np.cos(np.pi / H * np.outer(k + 0.5, j))
    s2 = np.sin(np.pi / H * np.outer(k + 0.5, j + 1.0))
    th = np.pi * (2 * k + 1) / (4 * N)
    return tuple(_frozen(np.ascontiguousarray(a, dtype=np.float32))
                 for a in (t2, s2, np.cos(th), np.sin(th)))


def _bark(x: np.ndarray) -> np.ndarray:
    return (13.1 * np.arctan(0.00074 * x)
            + 2.24 * np.arctan(1.85e-8 * x * x) + 0.0001 * x)


@functools.cache
def bark_cos_omega(n2: int, rate: int, bark_map_size: int) -> np.ndarray:
    """cos(pi*map[i]/bark_map_size) for floor 0, i in [0, n2) (spec 6.2.2),
    in float32 arithmetic like the reference (``floor`` sits on integer
    boundaries)."""
    i = np.arange(n2, dtype=np.float32)
    hfl = np.float32(rate) / np.float32(2.0)
    hfl_dn = hfl / np.float32(n2)
    scale = np.float32(bark_map_size) / _bark(hfl)
    foobar = np.floor(_bark(i * hfl_dn) * scale)
    map_elem = np.minimum(foobar, np.float32(bark_map_size - 1))
    res = np.cos(map_elem * (np.float32(np.pi) / np.float32(bark_map_size)))
    return _frozen(res.astype(np.float32))
