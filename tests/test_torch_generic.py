"""The generic path's modules against the reference on the CPU.

Coupling (static and per-mode), the floor-1 brackets and render, the
floor-0 curve, the IMDCT GEMMs, the f32 overlap-add, ``compact_i16``, K1's
flat layout and K3, each against its lewton_tpu counterpart on the same
seeded numpy inputs. The reference's Pallas kernels run in interpret mode,
as its own tests run them.

Tolerances, each with its reason:
- coupling, floor-1 brackets and render, K1 flat, K3 against the unfused
  reference ops, ``compact_i16``: bit-identical (integer-exact or the same
  f32 ops in the same order);
- K3 against the reference's interpret-mode kernel: that test's own
  rtol=3e-6, atol=1e-7 (tests/test_synth_kernel.py);
- floor 0: relative 2^-16 (FLOOR0_RTOL). The exp argument reaches 88.7,
  where one ulp is 2^-17, and XLA may evaluate x / sqrt(y) as x * rsqrt(y),
  so the argument may differ by 2 ulp; exp turns that into a relative
  error of the curve. Measured here: at most 7.6e-6;
- IMDCT GEMMs: the fp32 sum-order bound (ops/imdct.sum_order_bound);
- f32 overlap-add on identical audio: 2 ulp of the larger operand
  (OLA_ULPS), since XLA may contract a*lhs + pwr*rhs into an FMA.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu.models import decoder as jdec
from lewton_tpu.models.decoder import _by_mode
from lewton_tpu.models.decoder import compile_setup as jax_compile_setup
from lewton_tpu.ops import coupling as jcp
from lewton_tpu.ops import floor_curve as jfc
from lewton_tpu.ops import floor_kernel as jfk
from lewton_tpu.ops import imdct as jim
from lewton_tpu.ops import synth_kernel as jsk
from lewton_tpu.ops import windowing as jwin
from lewton_tpu.tables import bark_cos_omega, imdct_matrix, window_slope
from lewton_tpu.testing import synthetic_frames, synthetic_headers
from lewton_tpu_torch.models.decoder import (floor_stage, from_jax_setup,
                                             precompute_brackets)
from lewton_tpu_torch.ops import coupling as tcp
from lewton_tpu_torch.ops import floor_curve as tfc
from lewton_tpu_torch.ops import imdct as tim
from lewton_tpu_torch.ops import windowing as twin
from lewton_tpu_torch.ops.imdct import sum_order_bound
from lewton_tpu_torch.ops.synth_kernel import (fused_floor_couple,
                                               fused_floor_couple_ref)
from test_torch_floor import bits_equal
from test_torch_setup import carry_across

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

FLOOR0_RTOL = 2.0 ** -16
OLA_ULPS = 2

CH6_STEPS = ((0, 2), (3, 4), (0, 1), (0, 3))  # the ch6 corpus file's order


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _residue(rng, T, C, W, lattice):
    """Residues on the integer lattice (i16 transport) or off it, with
    zeros so that every coupling branch is taken. No -0: the reference's
    per-mode coupling reads channels through a one-hot contraction, which
    turns -0 into +0 where the port's gather keeps it (the sign of a zero,
    which no output sample can show)."""
    r = rng.standard_normal((T, C, W)) * 40.0
    r = np.round(r) if lattice else r
    r[rng.random((T, C, W)) < 0.1] = 0.0
    return (r + 0.0).astype(np.float32)


@pytest.mark.parametrize("C,steps,lattice", [
    (2, ((0, 1),), True), (2, ((0, 1),), False), (4, ((0, 1), (2, 3)), True),
    (6, CH6_STEPS, True), (3, (), False),
])
def test_inverse_coupling_static_bit_identical(C, steps, lattice):
    rng = np.random.default_rng(C + len(steps))
    res = _residue(rng, 24, C, 128, lattice)
    want = jcp.inverse_coupling_static(jnp.asarray(res), steps)
    got = tcp.inverse_coupling_static(torch.from_numpy(res), steps)
    assert bits_equal(want, got.numpy())


@pytest.mark.parametrize("C,tables", [
    # (mag, ang) steps per mode; modes with fewer steps pad with zeros
    (2, [[(0, 1)], []]),
    (6, [list(CH6_STEPS), [(0, 1)], [], [(4, 5), (2, 3)]]),
])
def test_inverse_coupling_batch_bit_identical(C, tables):
    rng = np.random.default_rng(len(tables))
    M, smax = len(tables), max(len(t) for t in tables)
    mag = np.zeros((M, smax), np.int32)
    ang = np.zeros((M, smax), np.int32)
    n = np.array([len(t) for t in tables], np.int32)
    for m, t in enumerate(tables):
        for s, (a, b) in enumerate(t):
            mag[m, s], ang[m, s] = a, b
    T = 40
    res = _residue(rng, T, C, 128, True)
    mode = rng.integers(0, M, T).astype(np.int32)
    want = jcp.inverse_coupling_batch(*_j(res, mode, mag, ang, n))
    got = tcp.inverse_coupling_batch(*_t(res, mode, mag, ang, n))
    assert bits_equal(want, got.numpy())


def _floor1_case(C, T, seed):
    """The reference's setup and random frames of one stream (mixed modes,
    some channels unused)."""
    jcs = jax_compile_setup(*synthetic_headers(C, 8, 11))
    fr = synthetic_frames(jcs, T=T, seed=seed)
    rng = np.random.default_rng(seed)
    fr["mode"][:] = rng.integers(0, 2, T)
    fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.8
    return jcs, fr


@pytest.mark.parametrize("C", [1, 2, 6])
def test_floor1_brackets_and_render_bit_identical(C):
    jcs, fr = _floor1_case(C, 37, C)
    mode = jnp.asarray(fr["mode"])
    want = jfc.floor1_brackets_mxu(
        _by_mode(jcs.f1_xs, mode), jnp.asarray(fr["f1_ys"]),
        jnp.asarray(fr["f1_flags"]), jcs.f1_mult[mode], mode, jcs.f1_step)
    cs = from_jax_setup(*carry_across(jcs), device="cpu")
    tm = torch.from_numpy(fr["mode"]).long()
    got = tfc.floor1_brackets_mxu(cs.f1_xs[tm], *_t(fr["f1_ys"], fr["f1_flags"]),
                                  cs.f1_mult[tm], tm, cs.f1_step)
    for w, g in zip(want, got):
        assert bits_equal(w, g.numpy())
    assert bits_equal(jfc.floor1_render(want), tfc.floor1_render(got).numpy())
    # precompute_brackets over a stream axis gives the same brackets
    tfr = {k: torch.from_numpy(v)[None] for k, v in fr.items()}
    for w, g in zip(want, precompute_brackets(cs, tfr)["f1_brackets"]):
        assert bits_equal(w, g[0].numpy())


@pytest.mark.parametrize("order", [1, 2, 3, 5, 8])
def test_floor0_curve_within_bound(order):
    rng = np.random.default_rng(order)
    T, C, W = 64, 3, 256
    cw = bark_cos_omega(W, 44100, 64)
    cosc = np.cos(rng.uniform(0.0, np.pi, (T, C, order))).astype(np.float32)
    cosc[:4] = cw[40]  # every root on a bark bin: p + q = 0, the clamp
    amp = rng.integers(0, 64, (T, C)).astype(np.float32)
    orders = np.full((T, C), order, np.int32)
    orders[::5] = max(1, order - 1)
    lfv = np.full((T, C), np.float32(136) / np.float32(63), np.float32)
    off = np.full((T, C), 136.0, np.float32)
    cws = np.ascontiguousarray(np.broadcast_to(cw, (T, C, W)), np.float32)
    args = (cosc, amp, orders, lfv, off, cws)
    want = np.asarray(jfc.floor0_curve_batch(*_j(*args)))
    got = tfc.floor0_curve_batch(*_t(*args)).numpy()
    assert np.isfinite(got).all()
    assert np.array_equal(want == 0, got == 0)  # the amp > 0 mask
    rel = np.abs(got.astype(np.float64) - want) / np.where(want == 0, 1, want)
    assert rel.max() <= FLOOR0_RTOL, rel.max()
    # the clamp is hit, at exp(88.7) in f32
    clamped = np.float32(torch.exp(torch.tensor(88.7)).item())
    assert (got == clamped).sum() > 0 and want.max() >= clamped * (1 - FLOOR0_RTOL)


@pytest.mark.parametrize("bs", [(8, 11), (10, 10), (6, 13)])
def test_imdct_gemms_within_sum_order_bound(bs):
    n0, n1 = 1 << bs[0], 1 << bs[1]
    rng = np.random.default_rng(n0 + n1)
    T, C, K = 40, 2, min(n1 // 2, 512)
    spectra = (rng.standard_normal((T, C, K)) * 30.0).astype(np.float32)
    spectra[::5] *= 1e-3
    bf = rng.integers(0, 2, T).astype(np.int32)
    m0 = np.array(imdct_matrix(n0, dtype=np.float32)[: min(K, n0 // 2)])
    m1 = np.array(imdct_matrix(n1, dtype=np.float32)[:K])
    bound = sum_order_bound(torch.from_numpy(spectra))
    jm0, jm1 = jnp.asarray(m0), jnp.asarray(m1)
    tm0, tm1 = torch.from_numpy(m0), torch.from_numpy(m1)

    def close(w, g):
        assert g.shape == w.shape
        assert np.abs(np.asarray(w, np.float64) - g.numpy()).max() <= bound

    close(jim.imdct_batch(jnp.asarray(spectra), jnp.asarray(bf), jm0, jm1),
          tim.imdct_batch(*_t(spectra, bf), tm0, tm1))
    want = jim.imdct_batch_parts(jnp.asarray(spectra), jm0, jm1)
    got = tim.imdct_batch_parts(torch.from_numpy(spectra), tm0, tm1)
    assert (want[1] is None) == (got[1] is None) == (n0 == n1)
    for w, g in zip(want, got):
        if w is not None:
            close(w, g)


def _ola_case(rng, S, T, n0, n1, C=2):
    W = n1 // 2
    bf = rng.integers(0, 2, (S, T)).astype(np.int32)
    pf, nf = (rng.integers(0, 2, (S, T)).astype(bool) for _ in range(2))
    valid = np.arange(T)[None, :] < rng.integers(0, T + 1, (S, 1))
    valid[0] = True
    audio = (rng.standard_normal((S, T, C, n1)) * 0.5).astype(np.float32)
    carry = ((rng.standard_normal((S, C, W)) * 0.5).astype(np.float32),
             rng.choice([0, n0 // 2, W], S).astype(np.int32),
             rng.integers(0, 2, S).astype(bool))
    s0 = np.zeros(W, np.float32)
    s0[: n0 // 2] = window_slope(n0 // 2)
    s1 = np.asarray(window_slope(W), np.float32)
    return audio, bf, pf, nf, valid, s0, s1, carry


@pytest.mark.parametrize("T,n0,n1", [(16, 256, 2048), (33, 64, 8192),
                                     (24, 512, 512)])
def test_overlap_add_batch_within_bound(T, n0, n1):
    rng = np.random.default_rng(T + n0)
    S = 3
    audio, bf, pf, nf, valid, s0, s1, carry = _ola_case(rng, S, T, n0, n1)
    (out, out_len), (pwr, plen, started) = twin.overlap_add_batch(
        *_t(audio, bf, pf, nf, valid, s0, s1), n0, n1, _t(*carry))
    tol = OLA_ULPS * 2.0 ** -23 * max(np.abs(audio).max(),
                                      np.abs(carry[0]).max())
    for s in range(S):
        (r_out, r_len), (r_pwr, r_plen, r_started) = jax.jit(
            jwin.overlap_add_batch, static_argnums=(7, 8))(
            *_j(audio[s], bf[s], pf[s], nf[s], valid[s], s0, s1), n0, n1,
            _j(*(c[s] for c in carry)))
        assert out[s].shape == r_out.shape
        assert np.abs(np.asarray(r_out, np.float64) - out[s].numpy()).max() <= tol
        assert np.array_equal(np.asarray(r_len), out_len[s].numpy())
        assert bits_equal(r_pwr, pwr[s].numpy())  # copied data
        assert int(r_plen) == int(plen[s]) and bool(r_started) == bool(started[s])


@pytest.mark.parametrize("tight", [False, True])
def test_compact_i16_matches_reference(tight):
    rng = np.random.default_rng(int(tight))
    S, T, n0, n1 = 3, 20, 256, 2048
    audio, bf, pf, nf, valid, s0, s1, carry = _ola_case(rng, S, T, n0, n1)
    (out, out_len), _ = twin.overlap_add_batch(
        *_t(audio * 1.5, bf, pf, nf, valid, s0, s1), n0, n1, _t(*carry))
    totals = out_len.sum(1)
    # tight: smaller than total + packet width, so the reference clamps its
    # last writes to the buffer's end and the port must do the same
    cap = (max(int(totals.min()), 3 * n1 // 4) if tight
           else int(totals.max()) + n1)
    pcm, total = twin.compact_i16(out, out_len, cap)
    assert pcm.shape == (S, cap, 2) and pcm.dtype == torch.int16
    for s in range(S):
        r_pcm, r_total = jax.jit(jwin.compact_i16, static_argnums=2)(
            jnp.asarray(out[s].numpy()), jnp.asarray(out_len[s].numpy()), cap)
        assert int(r_total) == int(total[s])
        assert bits_equal(r_pcm, pcm[s].numpy())
    assert (pcm != 0).any()


@pytest.fixture
def interpret_floor_kernel(monkeypatch):
    monkeypatch.setattr(jfk, "floor_spectra_pallas",
                        functools.partial(jfk.floor_spectra_pallas,
                                          interpret=True))


@pytest.mark.parametrize("C,steps,dtype", [
    (2, None, np.int16), (2, None, np.float32), (6, CH6_STEPS, np.int16),
])
def test_k1_flat_plain_matches_pallas(interpret_floor_kernel, C, steps, dtype):
    ident, setup = synthetic_headers(C, 8, 11)
    if steps is not None:
        setup.mappings[0].coupling_magnitude = [m for m, _ in steps]
        setup.mappings[0].coupling_angle = [a for _, a in steps]
    jcs = jax_compile_setup(ident, setup)
    fr = synthetic_frames(jcs, T=80, seed=C + 7)  # two reference row blocks
    fr["f_used"][:] = np.random.default_rng(C).random(fr["f_used"].shape) < 0.8
    fr["residue"] = fr["residue"].astype(dtype)
    want = jdec._floor_kernel_spectra(jcs, {k: jnp.asarray(v)
                                            for k, v in fr.items()})
    cs = from_jax_setup(*carry_across(jcs), device="cpu")
    tfr = {k: torch.from_numpy(v)[None] for k, v in fr.items()}
    got = floor_stage(cs, tfr, ct_out=False)
    assert got.shape == (80, C, cs.w_eff)
    assert bits_equal(want, got.numpy())
    assert bits_equal(want, floor_stage(cs, tfr, plain=True, ct_out=False).numpy())
    assert torch.equal(got, floor_stage(cs, tfr).permute(1, 0, 2))


def _k3_case(C, seed):
    rng = np.random.RandomState(seed)
    T, W = 12, 128
    lo_x = rng.randint(0, 100, (T, C, W))
    hi_x = lo_x + rng.randint(1, 300, (T, C, W))
    lo_y = rng.randint(0, 1020, (T, C, W))
    hi_y = rng.randint(0, 1020, (T, C, W))
    br = np.stack([lo_x, lo_y, hi_x, hi_y], 1).astype(np.float32)
    residue = rng.randn(T, C, W).astype(np.float32)
    used = rng.rand(T, C) < 0.8
    return br, residue, used


@pytest.mark.parametrize("C,steps", [(2, ((0, 1),)), (6, CH6_STEPS), (1, ())])
def test_k3_plain_matches_reference(monkeypatch, C, steps):
    br, residue, used = _k3_case(C, C)
    jbr, jres, jused = _j(br, residue, used)
    curve = jfc.floor1_render(tuple(jbr[:, q] for q in range(4)))
    want = curve * jused[:, :, None] * jcp.inverse_coupling_static(jres, steps)
    got = fused_floor_couple_ref(*_t(br, residue, used), steps)
    assert bits_equal(want, got.numpy())
    # on the CPU the wrapper is the plain version
    assert torch.equal(fused_floor_couple(*_t(br, residue, used), steps), got)
    monkeypatch.setattr(jsk.pl, "pallas_call",
                        functools.partial(jsk.pl.pallas_call, interpret=True))
    kern = jsk.fused_floor_couple(jbr, jres, jused, steps, rows=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=3e-6,
                               atol=1e-7)
