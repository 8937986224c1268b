"""The Wang-split i16 path of the port against the reference on the CPU.

With ``ops.imdct.USE_DCT4_SPLIT`` the i16 path's long DCT-IV goes through
the one-level Wang split: on the floor kernel's route K1 emits the rotated
pair (c || d) (``cd_n``), two half-size GEMMs give (U, V), the short GEMM
reads its input back out of (c || d) (``split_cd_head``), and K2's split
form rebuilds X from (U, V); on the other routes the rotation is plain
torch ops on the spectra. This file holds the split's modules to the
reference's, its Pallas kernels in interpret mode as
tests/test_floor_kernel_cd.py and tests/test_overlap_kernel.py run them;
tests/test_torch_split_slice.py holds the whole split slice.

Tolerances, each with its reason:
- ``dct4_split_tables``: bit-identical (the same float64 formulas, rounded
  once);
- the split GEMMs: the fp32 sum-order bound (ops/imdct.sum_order_bound) of
  their inputs, K = n1/4; the rotation and ``split_cd_head`` (a product
  pair and a sum per value) within CD_RTOL of the largest value, since XLA
  may contract a product and a sum into an FMA
  (tests/test_floor_kernel_cd.py:43-47);
- K1 ``cd_n``'s plain version: the spectra before the rotation
  bit-identical to the reference kernel's, (c || d) within CD_RTOL;
- K2's split form: i16 within 1 LSB (the reference's kernel and XLA paths
  differ by that much, tests/test_overlap_kernel.py), the carried right
  region equal (copied data after the same single add or sub per value);
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu import tables as jtab
from lewton_tpu import testing as jtesting
from lewton_tpu.models import decoder as jdec
from lewton_tpu.models.decoder import compile_setup as jax_compile_setup
from lewton_tpu.ops import floor_kernel as jfk
from lewton_tpu.ops import imdct as jim
from lewton_tpu.ops import windowing as jwin
from lewton_tpu_torch import tables as ttab
from lewton_tpu_torch.models.decoder import floor_stage, from_jax_setup
from lewton_tpu_torch.ops import imdct as tim
from lewton_tpu_torch.ops.windowing import overlap_add_i16_kernel_batch
from test_torch_floor import bits_equal
from test_torch_generic import CH6_STEPS
from test_torch_overlap import _case as _ola_case
from test_torch_overlap import _slopes
from test_torch_setup import carry_across

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

CD_RTOL = 2e-7


@pytest.fixture
def interpret_floor_kernel(monkeypatch):
    monkeypatch.setattr(jfk, "floor_spectra_pallas",
                        functools.partial(jfk.floor_spectra_pallas,
                                          interpret=True))


@pytest.fixture
def use_split(monkeypatch):
    monkeypatch.setattr(tim, "USE_DCT4_SPLIT", True)


@pytest.mark.parametrize("n", [64, 256, 512, 1024, 2048, 8192])
def test_dct4_split_tables_bit_identical(n):
    got, want = ttab.dct4_split_tables(n), jtab.dct4_split_tables(n)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert bits_equal(w, g)


def _close(want, got, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.shape(want)
    d = np.abs(np.asarray(want, np.float64) - got)
    assert d.max() <= tol, f"max |d| {d.max()} > {tol}"


@pytest.mark.parametrize("n0,n1,K", [
    (512, 512, 256),     # n0 == n1, K == N
    (256, 1024, 512),
    (256, 2048, 896),    # H < K < N: the mirrored operand is partly zero
    (256, 2048, 512),    # K == H: no mirrored operand
    (256, 2048, 1024),
    (256, 8192, 640),    # K < H
])
def test_split_gemms_within_sum_order_bound(n0, n1, K):
    """dct4_split_uv_ct, dct4_split_uv_from_cd, split_cd_head and the
    recombined dct4_split_batch_parts_ct against the reference's on the
    same spectra f32 [C, rows, K] (K <= n1/2, zero past K)."""
    rng = np.random.default_rng(n1 + K)
    spectra = (rng.standard_normal((2, 40, K)) * 30.0).astype(np.float32)
    spectra[:, ::5] *= 1e-3
    js, ts = jnp.asarray(spectra), torch.from_numpy(spectra)
    H = n1 // 4
    c, d = tim.split_butterfly(ts, n1)
    rot = CD_RTOL * max(float(torch.cat([c, d], -1).abs().max()), 1.0)
    # the rotation itself (reference: inside dct4_split_uv_ct)
    t2, s2, ct, st = jtab.dct4_split_tables(n1)
    x = np.pad(spectra, [(0, 0), (0, 0), (0, n1 // 2 - K)])
    a, b = x[..., :H], x[..., H:][..., ::-1]
    _close(ct * a + st * b, c, rot)
    _close(ct * b - st * a, d, rot)
    # the GEMMs on the same (c, d): sum order only
    bound = tim.sum_order_bound(torch.cat([c, d], -1))
    cd = torch.cat([c, d], -1)
    for w, g in zip(jim.dct4_split_uv_from_cd(jnp.asarray(cd.numpy()), n1),
                    tim.dct4_split_uv_from_cd(cd, n1)):
        _close(w, g, bound)
    # from the spectra: the rotation's difference goes through the GEMMs
    tol = bound + H * rot
    for w, g in zip(jim.dct4_split_uv_ct(js, n1),
                    tim.dct4_split_uv_ct(ts, n1)):
        _close(w, g, tol)
    k0 = min(K, n0 // 2)
    if n0 < n1:  # the short GEMM's input, k0 <= n0/2 <= n1/4 bins
        _close(jim.split_cd_head(jnp.asarray(cd.numpy()), n1, k0),
               tim.split_cd_head(cd, n1, k0), rot)
        _close(ts[..., :k0], tim.split_cd_head(cd, n1, k0), 4 * rot)
    m0 = jtab.imdct_matrix(n0)[:k0]
    mx0 = np.concatenate([-m0[:, 3 * n0 // 4:], m0[:, :n0 // 4]], axis=1)
    want = jim.dct4_split_batch_parts_ct(js, n0, n1, jnp.asarray(mx0), None)
    got = tim.dct4_split_batch_parts_ct(ts, n0, n1, torch.from_numpy(mx0),
                                        None)
    _close(want[0], got[0], 2 * tol + 2 * np.spacing(
        np.float32(np.abs(np.asarray(want[0])).max())))
    assert (want[1] is None) == (got[1] is None) == (n0 == n1)
    if got[1] is not None:
        _close(want[1], got[1], tim.sum_order_bound(ts[..., :k0]))


@pytest.mark.parametrize("C,steps,dtype,bs", [
    (2, None, np.int16, (8, 11)),
    (2, None, np.float32, (8, 11)),
    (6, CH6_STEPS, np.int16, (8, 11)),
    (8, None, np.int16, (8, 11)),
    (1, None, np.int16, (9, 9)),     # n0 == n1 (mono_11k_q0's geometry)
    (1, None, np.int16, (9, 10)),    # mono_16k_q3's geometry
    (2, None, np.int16, (10, 10)),   # stereo_22k_q0's geometry
])
def test_k1_cd_plain_matches_pallas(interpret_floor_kernel, C, steps, dtype,
                                    bs):
    """K1's ``cd_n`` form, plain, against the reference's interpret-mode
    kernel at ``cd_n = n1/2``: the spectra before the rotation
    bit-identical, (c || d) within CD_RTOL."""
    ident, setup = jtesting.synthetic_headers(C, *bs)
    if steps is not None:
        setup.mappings[0].coupling_magnitude = [m for m, _ in steps]
        setup.mappings[0].coupling_angle = [a for _, a in steps]
    jcs = jax_compile_setup(ident, setup)
    T = 40  # the reference kernel's row blocks: 32 + a padded 8
    fr = jtesting.synthetic_frames(jcs, T=T, seed=C + bs[1])
    rng = np.random.default_rng(C)
    fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.8
    fr["residue"] = fr["residue"].astype(dtype)
    jfr = {k: jnp.asarray(v) for k, v in fr.items()}
    N = jcs.n1 // 2
    j_spec = jdec._floor_kernel_spectra(jcs, jfr, ct_out=True)
    j_cd = np.asarray(jdec._floor_kernel_spectra(jcs, jfr, ct_out=True,
                                                 cd_n=N))
    cs = from_jax_setup(*carry_across(jcs), device="cpu")
    tfr = {k: torch.from_numpy(v)[None] for k, v in fr.items()}
    assert bits_equal(j_spec, floor_stage(cs, tfr).numpy())
    cd = floor_stage(cs, tfr, cd_n=N)
    assert cd.shape == (C, T, N) == j_cd.shape
    assert torch.equal(cd, floor_stage(cs, tfr, plain=True, cd_n=N))
    scale = max(float(np.abs(j_cd).max()), 1.0)
    _close(j_cd, cd, CD_RTOL * scale)
    assert np.abs(j_cd).max() > 0


@pytest.mark.parametrize("T,n0,n1", [(16, 256, 2048), (48, 256, 2048),
                                     (37, 256, 2048), (16, 512, 512),
                                     (16, 64, 2048), (16, 256, 8192)])
def test_k2_split_plain_matches_pallas(T, n0, n1):
    """K2's split form, plain, against the reference's interpret-mode
    kernel (``x_split``) stream by stream: i16 within 1 LSB, out_len, plen
    and started exact, the carry equal."""
    rng = np.random.default_rng(T + n0 + n1)
    S, C, H = 2, 2, n1 // 4
    bf, pf, nf, valid, _, x0, carry = _ola_case(rng, S, T, n0, n1)
    u, v = ((rng.standard_normal((C, S * T, H)) * 0.5).astype(np.float32)
            for _ in range(2))
    s0, s1 = _slopes(n0, n1)
    t = torch.from_numpy
    (out, out_len), (pwr, plen, started) = overlap_add_i16_kernel_batch(
        ((t(u), t(v)), None if x0 is None else t(x0)), t(bf), t(pf), t(nf),
        t(valid), t(s0), t(s1), n0, n1, tuple(t(c) for c in carry),
        ct_in=True, x_rep=True, x_split=True)
    assert out.shape == (S, T, C * 3 * n1 // 4) and out.dtype == torch.int16
    ref = jax.jit(lambda uv, sa, b, p, n, vl, c: jwin.overlap_add_i16_kernel_batch(
        (uv, sa), b, p, n, vl, jnp.asarray(s0), jnp.asarray(s1), n0, n1, c,
        ct_in=True, x_rep=True, x_split=True, interpret=True))
    for s in range(S):
        rows = slice(s * T, (s + 1) * T)
        (r_out, r_len), (r_pwr, r_plen, r_started) = ref(
            (jnp.asarray(u[:, rows]), jnp.asarray(v[:, rows])),
            None if x0 is None else jnp.asarray(x0[:, rows]),
            *(jnp.asarray(a[s]) for a in (bf, pf, nf, valid)),
            tuple(jnp.asarray(c[s]) for c in carry))
        d = np.abs(np.asarray(r_out, np.int32) - out[s].numpy().astype(np.int32))
        assert d.max() <= 1, f"stream {s}: {d.max()} LSB"
        assert np.array_equal(np.asarray(r_len), out_len[s].numpy())
        assert np.array_equal(np.asarray(r_pwr), pwr[s].numpy())
        assert int(r_plen) == int(plen[s]) and bool(r_started) == bool(started[s])
