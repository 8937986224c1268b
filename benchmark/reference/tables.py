# Frozen copy of lewton_tpu_torch/tables.py as of commit b69f200, part of the
# benchmark's plain NumPy reference decoder. Kept unchanged so the yardstick
# does not move when the port changes; imports nothing outside this folder.
"""Header-derived constant tables of the synthesis paths (numpy).

Copies of the functions of lewton_tpu/tables.py that ``compile_setup``, the
floor numerics, the Wang-split IMDCT and the numpy backend's synthesis
(``audio._synthesize``, ``floor.floor1_synthesis``) read, so that the port
runs where only torch and numpy are installed. tests/test_torch_setup.py,
tests/test_torch_split.py and tests/test_torch_numpy_backend.py hold every
table here bit for bit against the reference's.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = ["window_slope", "imdct_matrix", "dct4_split_tables",
           "bark_cos_omega", "floor1_db_four_factor",
           "floor1_inverse_db_table"]

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


#: the floor-1 inverse-dB table (Vorbis I spec 10.1, 256 entries) as f32 bit
#: patterns: the values of lewton_tpu/data/floor1_inverse_db.npy
_INVERSE_DB_BITS = (
    0x33E4B43E, 0x33F39109, 0x3401B28B, 0x340A203C, 0x34131A23, 0x341CA960,
    0x3426D7A7, 0x3431AF4B, 0x343D3B50, 0x34498770, 0x3456A023, 0x346492B8,
    0x34736D55, 0x34819F88, 0x348A0BFC, 0x34930493, 0x349C9269, 0x34A6BF32,
    0x34B1953F, 0x34BD1F93, 0x34C969E4, 0x34D680AD, 0x34E47136, 0x34F349A6,
    0x35018C88, 0x3509F7C0, 0x3512EF06, 0x351C7B76, 0x3526A6C0, 0x35317B37,
    0x353D03DA, 0x35494C5E, 0x3556613B, 0x35644FB9, 0x357325FC, 0x3581798A,
    0x3589E386, 0x3592D97C, 0x359C6485, 0x35A68E52, 0x35B16133, 0x35BCE825,
    0x35C92EDC, 0x35D641CE, 0x35E42E41, 0x35F30257, 0x3601668F, 0x3609CF4F,
    0x3612C3F5, 0x361C4D98, 0x362675E8, 0x36314732, 0x363CCC74, 0x3649115E,
    0x36562265, 0x36640CCE, 0x3672DEB8, 0x36815397, 0x3689BB1C, 0x3692AE72,
    0x369C36AF, 0x36A65D81, 0x36B12D35, 0x36BCB0C7, 0x36C8F3E4, 0x36D60301,
    0x36E3EB60, 0x36F2BB1E, 0x370140A2, 0x3709A6EB, 0x371298F1, 0x371C1FC9,
    0x3726451E, 0x3731133D, 0x373C951E, 0x3748D66F, 0x3755E3A2, 0x3763C9F7,
    0x37729789, 0x37812DAF, 0x378992BE, 0x37928374, 0x379C08E6, 0x37A62CBE,
    0x37B0F947, 0x37BC7979, 0x37C8B8FE, 0x37D5C447, 0x37E3A892, 0x37F273F8,
    0x38011AC0, 0x38097E93, 0x38126DF9, 0x381BF206, 0x38261462, 0x3830DF56,
    0x383C5DD8, 0x38489B92, 0x3855A4F2, 0x38638733, 0x3872506E, 0x388107D3,
    0x38896A6B, 0x38925882, 0x389BDB2A, 0x38A5FC09, 0x38B0C568, 0x38BC423B,
    0x38C87E29, 0x38D585A0, 0x38E365D9, 0x38F22CE8, 0x3900F4E9, 0x39095646,
    0x3912430E, 0x391BC451, 0x3925E3B5, 0x3930AB7F, 0x393C26A2, 0x394860C5,
    0x39556653, 0x39634483, 0x39720968, 0x3980E201, 0x39894224, 0x39922D9D,
    0x399BAD7B, 0x39A5CB63, 0x39B09199, 0x39BC0B0D, 0x39C84366, 0x39D5470B,
    0x39E32332, 0x39F1E5ED, 0x3A00CF1D, 0x3A092E05, 0x3A121830, 0x3A1B96A9,
    0x3A25B315, 0x3A3077B7, 0x3A3BEF7C, 0x3A48260A, 0x3A5527C7, 0x3A6301E6,
    0x3A71C278, 0x3A80BC3B, 0x3A8919E9, 0x3A9202C6, 0x3A9B7FDB, 0x3AA59ACB,
    0x3AB05DD8, 0x3ABBD3EF, 0x3AC808B3, 0x3AD50888, 0x3AE2E09F, 0x3AF19F07,
    0x3B00A95C, 0x3B0905D0, 0x3B11ED5E, 0x3B1B690F, 0x3B258284, 0x3B3043FD,
    0x3B3BB867, 0x3B47EB61, 0x3B54E94D, 0x3B62BF5D, 0x3B717B9C, 0x3B80967F,
    0x3B88F1BA, 0x3B91D7F9, 0x3B9B5247, 0x3BA56A41, 0x3BB02A27, 0x3BBB9CE2,
    0x3BC7CE12, 0x3BD4CA17, 0x3BE29E20, 0x3BF15835, 0x3C0083A6, 0x3C08DDA7,
    0x3C11C298, 0x3C1B3B82, 0x3C255201, 0x3C301054, 0x3C3B8161, 0x3C47B0C8,
    0x3C54AAE5, 0x3C627CE8, 0x3C7134D4, 0x3C8070CF, 0x3C88C996, 0x3C91AD3A,
    0x3C9B24C0, 0x3CA539C5, 0x3CAFF685, 0x3CBB65E5, 0x3CC79382, 0x3CD48BB9,
    0x3CE25BB4, 0x3CF11179, 0x3D005DFB, 0x3D08B589, 0x3D1197DF, 0x3D1B0E02,
    0x3D25218D, 0x3D2FDCB9, 0x3D3B4A6D, 0x3D477640, 0x3D546C91, 0x3D623A85,
    0x3D70EE22, 0x3D804B2A, 0x3D88A17F, 0x3D918288, 0x3D9AF748, 0x3DA50958,
    0x3DAFC2F2, 0x3DBB2EF8, 0x3DC75903, 0x3DD44D6D, 0x3DE2195C, 0x3DF0CAD1,
    0x3E00385B, 0x3E088D77, 0x3E116D33, 0x3E1AE090, 0x3E24F127, 0x3E2FA92E,
    0x3E3B1387, 0x3E473BCA, 0x3E542E4D, 0x3E61F837, 0x3E70A784, 0x3E80258F,
    0x3E887973, 0x3E9157E2, 0x3E9AC9DC, 0x3EA4D8F9, 0x3EAF8F6D, 0x3EBAF81B,
    0x3EC71E95, 0x3ED40F33, 0x3EE1D717, 0x3EF0843D, 0x3F0012C6, 0x3F086572,
    0x3F114293, 0x3F1AB32B, 0x3F24C0CE, 0x3F2F75B1, 0x3F3ADCB2, 0x3F470165,
    0x3F53F01D, 0x3F61B5FB, 0x3F7060FB, 0x3F800000,
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
def floor1_inverse_db_table() -> np.ndarray:
    """256-entry floor1 amplitude-to-linear table (Vorbis I spec 10.1),
    float32."""
    return _frozen(np.array(_INVERSE_DB_BITS, np.uint32).view(np.float32))


@functools.cache
def window_slope(half_n: int) -> np.ndarray:
    """Left window slope of length n/2 for blocksize n (spec 4.3.1 step 7),
    computed in float64 and rounded once to float32."""
    i = np.arange(half_n, dtype=np.float64)
    v = np.sin(0.5 * np.pi * (i + 0.5) / half_n)
    return _frozen(np.sin(0.5 * np.pi * v * v).astype(np.float32))


def imdct_matrix(n: int, dtype=np.float32) -> np.ndarray:
    """IMDCT as a dense [n/2, n] matrix of ``dtype`` (float32 or float64):
    M[k, j] = cos(pi/(2n) * (2k+1) * (2j+1+n/2)), computed in float64.

    The f32 matrices stay cached for the process. The f64 one (the numpy
    backend's IMDCT) is 268 MB at n = 8192, so only the last two
    blocksizes' are kept (a stream alternates between two)."""
    if np.dtype(dtype) == np.float64:
        return _imdct_f64(n)
    if np.dtype(dtype) != np.float32:
        raise TypeError(f"imdct_matrix: dtype {np.dtype(dtype)}, expected "
                        "float32 or float64")
    return _imdct_f32(n)


def _imdct_cos(n: int) -> np.ndarray:
    k = np.arange(n // 2, dtype=np.float64)
    j = np.arange(n, dtype=np.float64)
    return np.cos(np.pi / (2 * n) * np.outer(2 * k + 1, 2 * j + 1 + n // 2))


@functools.cache
def _imdct_f32(n: int) -> np.ndarray:
    return _frozen(np.ascontiguousarray(_imdct_cos(n), dtype=np.float32))


@functools.lru_cache(maxsize=2)
def _imdct_f64(n: int) -> np.ndarray:
    return _frozen(_imdct_cos(n))


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
