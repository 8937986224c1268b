"""Floor-1 numerics and the floor kernel's plain version against the
reference (lewton_tpu/ops/floor_curve.py, lewton_tpu/ops/floor_kernel.py).

All of it is integer-exact or the same f32 ops in the same order, so the
tolerance is zero: bit-identical outputs. The reference's Pallas kernel
runs in interpret mode on the CPU, as its own tests run it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu.models.decoder import _by_mode
from lewton_tpu.models.decoder import compile_setup as jax_compile_setup
from lewton_tpu.ops import floor_curve as jfc
from lewton_tpu.ops.floor_kernel import floor_spectra_pallas
from lewton_tpu.testing import synthetic_frames, synthetic_headers
from lewton_tpu_torch.models.decoder import (floor_kernel_inputs, floor_stage,
                                             from_jax_setup)
from lewton_tpu_torch.ops import floor_curve as tfc
from lewton_tpu_torch.ops.floor_kernel import floor_spectra, floor_spectra_ref
from test_torch_setup import carry_across

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_telescopes_bit_identical():
    rng = np.random.default_rng(0)
    T, C, P = 64, 3, 29
    xs = np.full((T, C, P), int(jfc.BIG_X), np.int32)
    for t in range(T):
        for c in range(C):
            n = int(rng.integers(2, P + 1))
            xs[t, c, :n] = np.sort(rng.choice(4096, n, replace=False))
    ys = rng.integers(0, 256, (T, C, P)).astype(np.int32)
    flags = rng.random((T, C, P)) < 0.6
    flags[:, :, :2] = rng.random((T, C, 2)) < 0.9
    mult = rng.integers(1, 5, (T, C)).astype(np.int32)
    want = jfc.floor1_telescopes(*(jnp.asarray(a) for a in (xs, ys, flags,
                                                            mult)))
    got = tfc.floor1_telescopes(*(torch.from_numpy(a) for a in (xs, ys, flags,
                                                                mult)))
    for w, g in zip(want, got):
        assert bits_equal(w, g.numpy())


def _bres_operands():
    """The operand envelope of tests/test_floor_curve_exact.py: corner
    geometries, a random sweep, and past-the-post bins."""
    rng = np.random.RandomState(7)
    cases = []
    for lo_x, lo_y, hi_x, hi_y in [
        (0, 0, 1, 1020), (0, 1020, 1, 0), (0, 0, 4095, 1020),
        (0, 1020, 4095, 0), (0, 17, 4095, 19), (100, 500, 101, 501),
        (0, 0, 4095, 1), (0, 1, 4095, 0), (5, 255, 4090, 254),
        (7, 300, 900, 300),
    ]:
        for x in (lo_x, lo_x + 1, (lo_x + hi_x) // 2, hi_x - 1, hi_x,
                  hi_x + 50):
            cases.append((lo_x, lo_y, hi_x, hi_y, x))
    for _ in range(4000):
        lo_x = int(rng.randint(0, 4000))
        hi_x = int(lo_x + rng.randint(1, 4096 - lo_x + 1))
        cases.append((lo_x, int(rng.randint(0, 1021)), hi_x,
                      int(rng.randint(0, 1021)), int(rng.randint(lo_x, 4096))))
    arr = np.array(cases, np.float32).T
    rng = np.random.RandomState(11)
    lo_x = rng.randint(0, 4000, 20000)
    sweep = np.stack([lo_x, rng.randint(0, 1021, 20000),
                      lo_x + rng.randint(1, 4096, 20000),
                      rng.randint(0, 1021, 20000),
                      np.minimum(lo_x + rng.randint(0, 4500, 20000),
                                 2 ** 13 - 1)]).astype(np.float32)
    return np.concatenate([arr, sweep], axis=1)


def test_bresenham_bit_identical():
    ops = _bres_operands()
    want = jfc.bresenham_idx(*(jnp.asarray(a) for a in ops))
    got = tfc.bresenham_idx(*(torch.from_numpy(a) for a in ops))
    assert bits_equal(want, got.numpy())


def test_db_value_bit_identical():
    idx = np.arange(256, dtype=np.float32)
    want = jfc.floor1_db_value(jnp.asarray(idx))
    got = tfc.floor1_db_value(torch.from_numpy(idx))
    assert bits_equal(want, got.numpy())


def _frames(cs, T, rng, dtype):
    fr = synthetic_frames(cs, T=T, S=1, seed=int(rng.integers(1 << 30)))
    fr["mode"][:] = rng.integers(0, 2, fr["mode"].shape)
    fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.8
    fr["residue"] = fr["residue"].astype(dtype)
    return fr


@pytest.mark.parametrize("C,steps,dtype", [
    (2, None, np.int16), (4, None, np.int16), (2, None, np.float32),
    # chained steps in the ch6 corpus file's order (reverse-order coupling)
    (6, ((0, 2), (3, 4), (0, 1), (0, 3)), np.int16),
])
def test_floor_spectra_ref_matches_pallas(C, steps, dtype):
    ident, setup = synthetic_headers(C, 8, 11)
    if steps is not None:
        setup.mappings[0].coupling_magnitude = [m for m, _ in steps]
        setup.mappings[0].coupling_angle = [a for _, a in steps]
    jcs = jax_compile_setup(ident, setup)
    cs = from_jax_setup(*carry_across(jcs), device="cpu")
    rng = np.random.default_rng(C)
    T = 80  # two reference row blocks, the second one padded
    fr = _frames(cs, T, rng, dtype)

    # the kernel's operands as the reference prepares them
    jfr = {k: jnp.asarray(v[0]) for k, v in fr.items()}
    mode = jfr["mode"]
    tele = jfc.floor1_telescopes(_by_mode(jcs.f1_xs, mode), jfr["f1_ys"],
                                 jfr["f1_flags"], jcs.f1_mult[mode])
    P1 = tele[0].shape[2]
    tele = jnp.stack(tele, axis=2).reshape(T, C * 4 * P1)
    scal = jnp.concatenate([mode.astype(jnp.float32)[:, None],
                            jfr["f_used"].astype(jnp.float32)], axis=1)
    M = jcs.f1_step.shape[1] // P1
    want = floor_spectra_pallas(tele, jfr["residue"], scal,
                                jcs.f1_step.astype(jnp.bfloat16),
                                jcs.static_coupling, C, jcs.w_eff, M,
                                ct_out=True, interpret=True)

    # the port's preparation gives the same operands
    t_ops = floor_kernel_inputs(cs, {k: torch.from_numpy(v)
                                     for k, v in fr.items()})
    for w, g in zip((tele, jfr["residue"], scal), t_ops):
        assert bits_equal(w, g.numpy())
    got = floor_spectra_ref(*t_ops, cs.f1_step, cs.static_coupling)
    assert bits_equal(want, got.numpy())
    # on the CPU the wrapper is the plain version
    got = floor_spectra(*t_ops, cs.f1_xs, cs.f1_step, cs.static_coupling)
    assert bits_equal(want, got.numpy())
    tfr = {k: torch.from_numpy(v) for k, v in fr.items()}
    assert bits_equal(want, floor_stage(cs, tfr).numpy())
