"""The overlap kernel's plain version and the DCT-IV GEMM against the
reference (lewton_tpu/ops/overlap_kernel.py ``_kernel_x`` in interpret
mode, lewton_tpu/ops/imdct.py).

Tolerances: i16 within 1 LSB -- the reference's kernel and XLA paths
themselves differ by that much where the mix is contracted into an FMA
(tests/test_overlap_kernel.py); out_len, plen and started exact; the
carried f32 right region is copied data, so bit-identical. The GEMM is
held within the fp32 sum-order bound (ops/imdct.sum_order_bound): the two
frameworks sum the K products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu.ops.imdct import dct4_batch_parts_ct as jax_dct4
from lewton_tpu.ops.windowing import overlap_add_i16_kernel_batch as jax_ola
from lewton_tpu.tables import window_slope
from lewton_tpu_torch.models.decoder import compile_setup
from lewton_tpu_torch.ops.imdct import dct4_batch_parts_ct, sum_order_bound
from lewton_tpu_torch.ops.windowing import overlap_add_i16_kernel_batch
from lewton_tpu_torch.testing import synthetic_headers

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

C = 2


def _slopes(n0, n1):
    W = n1 // 2
    s0 = np.zeros(W, np.float32)
    s0[: n0 // 2] = window_slope(n0 // 2)
    return s0, np.array(window_slope(W), np.float32)


def _case(rng, S, T, n0, n1):
    W = n1 // 2
    flags = {k: rng.integers(0, 2, (S, T)).astype(bool)
             for k in ("prev", "next")}
    bf = rng.integers(0, 2, (S, T)).astype(np.int32)
    if T >= 48:  # every third packet short: block-boundary prev-row selects
        bf[:, :] = 1
        bf[:, ::3] = 0
    valid = np.arange(T)[None, :] < rng.integers(0, T + 1, (S, 1))
    valid[0, :] = True  # one full stream
    x1 = (rng.standard_normal((C, S * T, W)) * 0.5).astype(np.float32)
    x0 = (None if n0 == n1 else
          (rng.standard_normal((C, S * T, n0 // 2)) * 0.5).astype(np.float32))
    carry = ((rng.standard_normal((S, C, W)) * 0.5).astype(np.float32),
             rng.choice([0, n0 // 2, W], S).astype(np.int32),
             rng.integers(0, 2, S).astype(bool))
    return bf, flags["prev"], flags["next"], valid, x1, x0, carry


@pytest.mark.parametrize("T,n0,n1", [(16, 256, 2048), (48, 256, 2048),
                                     (144, 256, 2048), (16, 1024, 1024)])
def test_overlap_ref_matches_pallas_x_rep(T, n0, n1):
    rng = np.random.default_rng(T + n0)
    S = 2
    bf, pf, nf, valid, x1, x0, carry = _case(rng, S, T, n0, n1)
    s0, s1 = _slopes(n0, n1)

    def ref_stream(s):
        rows = slice(s * T, (s + 1) * T)
        audio = ((jnp.asarray(x1[:, rows]), jnp.asarray(x0[:, rows]))
                 if x0 is not None else jnp.asarray(x1[:, rows]))
        fn = jax.jit(lambda a, b, p, n, v, c: jax_ola(
            a, b, p, n, v, jnp.asarray(s0), jnp.asarray(s1), n0, n1, c,
            ct_in=True, x_rep=True, interpret=True))
        return fn(audio, jnp.asarray(bf[s]), jnp.asarray(pf[s]),
                  jnp.asarray(nf[s]), jnp.asarray(valid[s]),
                  tuple(jnp.asarray(c[s]) for c in carry))

    t = torch.from_numpy
    (out, out_len), (pwr, plen, started) = overlap_add_i16_kernel_batch(
        (t(x1), None if x0 is None else t(x0)), t(bf), t(pf), t(nf),
        t(valid), t(s0), t(s1), n0, n1, tuple(t(c) for c in carry),
        ct_in=True, x_rep=True)
    assert out.shape == (S, T, C * 3 * n1 // 4) and out.dtype == torch.int16
    for s in range(S):
        (r_out, r_len), (r_pwr, r_plen, r_started) = ref_stream(s)
        d = np.abs(np.asarray(r_out, np.int32) - out[s].numpy().astype(np.int32))
        assert d.max() <= 1, f"stream {s}: {d.max()} LSB"
        assert np.array_equal(np.asarray(r_len), out_len[s].numpy())
        assert np.asarray(r_pwr).tobytes() == pwr[s].numpy().tobytes()
        assert int(r_plen) == int(plen[s]) and bool(r_started) == bool(started[s])


def test_dct4_gemm_within_sum_order_bound():
    ident, setup = synthetic_headers(2, 8, 11)
    cs = compile_setup(ident, setup, device="cpu")
    rng = np.random.default_rng(5)
    spectra = (rng.standard_normal((C, 96, cs.w_eff)) * 40.0).astype(np.float32)
    spectra[:, ::7] *= 1e-3  # rows of mixed magnitude
    want = jax_dct4(jnp.asarray(spectra), jnp.asarray(cs.dct4_m0.numpy()),
                    jnp.asarray(cs.dct4_m1.numpy()))
    got = dct4_batch_parts_ct(torch.from_numpy(spectra), cs.dct4_m0,
                              cs.dct4_m1)
    bound = sum_order_bound(torch.from_numpy(spectra))
    assert bound > 0
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert np.abs(np.asarray(w, np.float64) - g.numpy()).max() <= bound

