"""K1's bracket arithmetic as the CUDA kernel computes it, modelled in numpy
and held bit for bit against the port's plain version and the JAX
reference on the CPU.

The kernel (lewton_tpu_torch/csrc/floor_kernel.cu) cannot run here, so
each step of its design is modelled with the kernel's operations in the
kernel's order (numpy float32: every operation rounds to nearest, no
fused multiply-add; cumulative sums are sequential):

- seg(w) = #{p < P : x_p <= w} from a [M, C, W] uint8 table that the
  kernel fills from the sorted posts (seg = p on [x_{p-1}, x_p)); a row
  whose mode is outside [0, M) takes seg = 0;
- lo = PE[seg], PE[k] = sum_{p<k} e_p accumulated in p order from 0;
  hi = G - PG[seg], G the sequential total of all P+1 terms;
- the Bresenham index from the segment's terms (adx, 1/adx, |dy|, sgn)
  with floor(x / adx) taken from x * (1/adx) and one remainder correction;
- the inverse dB from a 256-entry table of the 4-factor products;
- the branch-free coupling step.

Held to, bit for bit: the port's step-matrix contraction
(ops/floor_curve.floor1_brackets_mxu, the einsum of floor_spectra_ref),
the reference's lewton_tpu.ops.floor_curve.floor1_brackets_mxu, and the
whole plain version floor_spectra_ref, on every corpus stream (all have
floor 1), synthetic variants, the crafted geometries chip_smoke.py checks
on the card, and random post sets (hypothesis). Every value is an integer
below 2^24 or the same float32 operation in the same order, so the
tolerance is zero.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lewton_tpu import testing as jtesting
from lewton_tpu.models.decoder import compile_setup as jax_compile_setup
from lewton_tpu.ops import floor_curve as jfc
from lewton_tpu_torch.models.decoder import floor_kernel_inputs, from_jax_setup
from lewton_tpu_torch.ops import floor_curve as tfc
from lewton_tpu_torch.ops.coupling import inverse_coupling_static
from lewton_tpu_torch.ops.floor_kernel import floor_spectra_ref
from lewton_tpu_torch.tables import floor1_db_four_factor
from test_torch_floor import _bres_operands, bits_equal
from test_torch_generic_slice import _frames, _packets
from test_torch_setup import _per_mode_coupling_headers, carry_across

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

F32 = np.float32
BIG_X = 1 << 24

CORPUS = ["ch4_32k_q2", "ch6_44k_q3", "ch8_44k_q4", "chained_44k",
          "impulses_44k", "long_44k_q2", "mono_11k_q0", "mono_16k_q3",
          "mono_8k_q-1", "silence_44k", "stereo_22k_q0", "stereo_44k_managed",
          "stereo_44k_q10", "stereo_44k_q3", "stereo_48k_q5", "stereo_96k_q6",
          "tiny_44k"]
SYNTHETIC = {"flagship": (2, 8, 11), "mono": (1, 8, 11), "ch6": (6, 8, 11),
             "ch8": (8, 8, 11), "per_mode_coupling": None,
             "bs_9_9": (2, 9, 9), "bs_6_11": (2, 6, 11)}
#: chip_smoke.GEOMETRIES: (n0, n1, C, w_eff)
GEOMETRIES = ((64, 64, 1, 32), (64, 8192, 1, 512), (8192, 8192, 1, 512),
              (512, 512, 1, 256), (256, 2048, 8, 896))
CASES = ([f"corpus:{n}" for n in CORPUS] + [f"synthetic:{n}" for n in SYNTHETIC]
         + ["geometry:" + "_".join(map(str, g)) for g in GEOMETRIES])
# floor_spectra_ref needs static coupling
SPECTRA_CASES = [c for c in CASES if c != "synthetic:per_mode_coupling"]


# ---- the kernel's arithmetic, in numpy ----

def seg_table(xs, W: int) -> np.ndarray:
    """uint8 [M, C, W]: seg = p on the bins [x_{p-1}, x_p) of each sorted
    (mode, channel) post row xs [M, C, P] (pad BIG_X), filled interval by
    interval as the kernel's threads fill it."""
    M, C, P = xs.shape
    tab = np.zeros((M, C, W), np.uint8)
    for m in range(M):
        for c in range(C):
            for p in range(P + 1):
                lo = 0 if p == 0 else min(int(xs[m, c, p - 1]), W)
                hi = W if p == P else min(int(xs[m, c, p]), W)
                tab[m, c, lo:hi] = p
    return tab


def row_segs(tab, mode) -> np.ndarray:
    """int [rows, C, W]: each row's seg, 0 for a mode outside [0, M)."""
    M = tab.shape[0]
    ok = (mode >= 0) & (mode < M)
    return np.where(ok[:, None, None], tab[np.clip(mode, 0, M - 1)],
                    0).astype(np.int64)


def prefix_brackets(tele, seg):
    """(lo_x, lo_y, hi_x, hi_y) f32 [rows, C, W] from the telescopes tele
    f32 [rows, C*4*(P+1)] and seg [rows, C, W]: prefix sums in p order
    with a leading 0, lo = PE[seg], hi = G - PG[seg]."""
    rows, C, W = seg.shape
    t4 = np.asarray(tele, F32).reshape(rows, C, 4, -1)
    pre = np.zeros(t4.shape[:-1] + (t4.shape[-1] + 1,), F32)
    pre[..., 1:] = np.cumsum(t4, axis=-1, dtype=F32)

    def at(q):
        return np.take_along_axis(pre[:, :, q], seg, axis=-1)

    total = pre[:, :, :, -1:]
    return at(0), at(1), total[:, :, 2] - at(2), total[:, :, 3] - at(3)


def bresenham_from_segment(lo_x, lo_y, hi_x, hi_y, binx):
    """The index from the segment's terms: floor(x / adx) from x * (1/adx)
    and one remainder correction."""
    dy = hi_y - lo_y
    adx = np.maximum(hi_x - lo_x, F32(1))
    inv = F32(1) / adx
    sgn = np.sign(dy).astype(F32)
    ady = np.abs(dy)
    x = (binx - lo_x) * ady
    q = np.floor(x * inv)
    r = x - q * adx
    q = q + (r >= adx).astype(F32)
    q = q - (r < 0).astype(F32)
    return np.clip(lo_y + sgn * q, F32(0), F32(255))


def db_table() -> np.ndarray:
    """The 256-entry inverse-dB table the kernel fills per block."""
    H1, H0, L1, L0 = floor1_db_four_factor()
    i = np.arange(256)
    return (H1[i >> 6] * H0[(i >> 4) & 3]) * (L1[(i >> 2) & 3] * L0[i & 3])


def couple(res, steps):
    """Static inverse coupling of res f32 [rows, C, W], steps in reverse,
    each step branch-free as the kernel's couple_step."""
    res = res.copy()
    for mi, ai in reversed(steps):
        m, a = res[:, mi], res[:, ai]
        a_pos = a > 0
        d = np.where((m > 0) == a_pos, m - a, m + a)
        res[:, mi], res[:, ai] = np.where(a_pos, m, d), np.where(a_pos, d, m)
    return res


def k1_model(tele, residue, scal, xs, W, steps):
    """K1's spectra f32 [C, rows, W] (ct_out) from the kernel's operands."""
    mode = np.asarray(scal[:, 0]).astype(np.int64)
    br = prefix_brackets(tele, row_segs(seg_table(np.asarray(xs), W), mode))
    idx = bresenham_from_segment(*br, np.arange(W, dtype=F32))
    curve = db_table()[idx.astype(np.int64)] * np.asarray(scal, F32)[:, 1:,
                                                                     None]
    rows, C = curve.shape[:2]
    res = couple(np.asarray(residue, F32).reshape(rows, C, W), steps)
    return (curve * res).transpose(1, 0, 2)


# ---- the inputs ----

def _geometry_headers(n0, n1, C, w_eff):
    ident, setup = jtesting.synthetic_headers(C, n0.bit_length() - 1,
                                              n1.bit_length() - 1)
    setup.residues[0].end = C * w_eff
    return ident, setup


@functools.cache
def _case(name: str, corpus_dir: str):
    """(jcs, cs, frames [S, T, ...] numpy) of a named input."""
    kind, key = name.split(":", 1)
    rng = np.random.default_rng(len(name))
    if kind == "corpus":
        with open(os.path.join(corpus_dir, key + ".ogg"), "rb") as f:
            ident, setup, packets = _packets(f.read())
        fr = {k: v[0] for k, v in _frames(ident, setup, packets[:24], 24,
                                          1).items()}
        jcs = jax_compile_setup(ident, setup)
    else:
        if kind == "synthetic":
            hdr = SYNTHETIC[key]
            headers = (_per_mode_coupling_headers() if hdr is None
                       else jtesting.synthetic_headers(*hdr))
        else:
            headers = _geometry_headers(*map(int, key.split("_")))
        jcs = jax_compile_setup(*headers)
        fr = jtesting.synthetic_frames(jcs, T=19, S=2, seed=len(name))
        fr["mode"][:] = rng.integers(0, len(jcs.mode_blockflag),
                                     fr["mode"].shape)
        fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.8
    S, T = fr["mode"].shape
    C, W = jcs.channels, jcs.w_eff
    res = fr["residue"].reshape(S, T, C, -1)[..., :W]
    fr["residue"] = np.ascontiguousarray(res).reshape(S, T, C * W)
    return jcs, from_jax_setup(*carry_across(jcs), device="cpu"), fr


def _operands(name, corpus_dir):
    """K1's operands (tele, residue, scal) and the gathered post rows."""
    jcs, cs, fr = _case(name, corpus_dir)
    tfr = {k: torch.from_numpy(v) for k, v in fr.items()}
    tele, residue, scal = floor_kernel_inputs(cs, tfr)
    rows = tele.shape[0]
    C, P = cs.channels, cs.max_posts
    mode = tfr["mode"].reshape(rows).long()
    post = (cs.f1_xs[mode], tfr["f1_ys"].reshape(rows, C, P),
            tfr["f1_flags"].reshape(rows, C, P), cs.f1_mult[mode], mode)
    return cs, (tele, residue, scal), post


# ---- the tests ----

@pytest.mark.parametrize("name", CASES)
def test_prefix_brackets_match_port_contraction(name, corpus_dir):
    """The prefix-sum brackets at the table's seg equal the port's
    step-matrix contraction (the einsum of floor_spectra_ref)."""
    cs, (tele, _, scal), post = _operands(name, corpus_dir)
    mode = scal[:, 0].numpy().astype(np.int64)
    got = prefix_brackets(tele.numpy(), row_segs(
        seg_table(cs.f1_xs.numpy(), cs.w_eff), mode))
    want = tfc.floor1_brackets_mxu(*post, cs.f1_step)
    for g, w in zip(got, want):
        assert bits_equal(g, w.numpy())


@pytest.mark.parametrize("name", CASES)
def test_prefix_brackets_match_jax_reference(name, corpus_dir):
    """... and the reference's floor1_brackets_mxu on the CPU."""
    jcs, _, fr = _case(name, corpus_dir)
    _, (tele, _, _), _ = _operands(name, corpus_dir)
    rows = tele.shape[0]
    C, P = jcs.channels, jcs.max_posts
    mode = fr["mode"].reshape(rows)
    want = jfc.floor1_brackets_mxu(
        jnp.asarray(np.asarray(jcs.f1_xs)[mode]),
        jnp.asarray(fr["f1_ys"].reshape(rows, C, P)),
        jnp.asarray(fr["f1_flags"].reshape(rows, C, P)),
        jnp.asarray(np.asarray(jcs.f1_mult)[mode]), jnp.asarray(mode),
        jcs.f1_step)
    got = prefix_brackets(tele.numpy(), row_segs(
        seg_table(np.asarray(jcs.f1_xs), jcs.w_eff), mode.astype(np.int64)))
    for g, w in zip(got, want):
        assert bits_equal(g, np.asarray(w))


@pytest.mark.parametrize("name", CASES)
def test_seg_table_matches_step_matrix(name, corpus_dir):
    """step[c, m (P+1) + p, w] == (p < seg[m, c, w]) for every post and
    the virtual tail post p = P (seg <= P, so its row is zero, as the step
    matrix's)."""
    cs = _case(name, corpus_dir)[1]
    M, C, P = cs.f1_xs.shape
    tab = seg_table(cs.f1_xs.numpy(), cs.w_eff).astype(np.int64)
    step = cs.f1_step.numpy().reshape(C, M, P + 1, cs.w_eff)
    p = np.arange(P + 1)[None, None, :, None]
    want = (p < tab.transpose(1, 0, 2)[:, :, None, :]).astype(np.float32)
    assert bits_equal(want, step)


@pytest.mark.parametrize("name", SPECTRA_CASES)
def test_k1_model_matches_plain_spectra(name, corpus_dir):
    """The whole kernel arithmetic -- table seg, prefix brackets, segment
    Bresenham, inverse-dB table, branch-free coupling -- equals
    floor_spectra_ref bit for bit, also with modes outside [0, M) on some
    rows."""
    cs, (tele, residue, scal), _ = _operands(name, corpus_dir)
    scal = scal.clone()
    scal[::5, 0] = -1.0
    scal[3::7, 0] = float(cs.f1_xs.shape[0])
    steps = cs.static_coupling
    want = floor_spectra_ref(tele, residue, scal, cs.f1_step, steps)
    got = k1_model(tele.numpy(), residue.numpy(), scal.numpy(),
                   cs.f1_xs.numpy(), cs.w_eff, steps)
    assert bits_equal(got, want.numpy())


def test_segment_bresenham_matches_division():
    """The index from the segment's terms equals bresenham_idx (IEEE
    division) on the operand envelope of tests/test_floor_curve_exact.py."""
    ops = _bres_operands()
    want = tfc.bresenham_idx(*(torch.from_numpy(a) for a in ops))
    assert bits_equal(bresenham_from_segment(*ops), want.numpy())


def test_db_table_matches_db_value():
    idx = np.arange(256, dtype=np.float32)
    assert bits_equal(db_table(), tfc.floor1_db_value(
        torch.from_numpy(idx)).numpy())
    assert bits_equal(db_table(), np.asarray(jfc.floor1_db_value(
        jnp.asarray(idx))))


def test_branch_free_coupling_matches_plain():
    """The branch-free coupling step equals inverse_coupling_static on
    values of every sign, zeros of both signs included."""
    rng = np.random.default_rng(5)
    vals = np.array([-3.0, -1.0, -0.0, 0.0, 1.0, 2.5], F32)
    res = rng.choice(vals, (400, 4, 3)).astype(F32)
    res[:200] = np.round(rng.standard_normal((200, 4, 3)) * 40).astype(F32)
    steps = ((0, 1), (2, 3), (0, 2))
    want = inverse_coupling_static(torch.from_numpy(res), steps)
    assert bits_equal(couple(res, steps), want.numpy())


@st.composite
def _post_sets(draw):
    """Random sorted post rows xs [M, C, P] (duplicate x, BIG_X pads, P up
    to 65) with frames of random y, flags and modes (some out of range)."""
    M = draw(st.integers(1, 4))
    C = draw(st.integers(1, 3))
    P = draw(st.integers(2, 65))
    W = draw(st.integers(1, 300))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    xs = np.full((M, C, P), BIG_X, np.int32)
    for m in range(M):
        for c in range(C):
            n = int(rng.integers(2, P + 1))
            x = np.sort(rng.integers(0, 2 * W + 2, n))
            x[0] = 0
            xs[m, c, :n] = x
    rows = int(rng.integers(1, 12))
    mode = rng.integers(-1, M + 2, rows)
    ys = rng.integers(0, 256, (rows, C, P)).astype(np.int32)
    flags = rng.random((rows, C, P)) < 0.6
    flags[:, :, 0] = True
    return xs, W, mode, ys, flags


@settings(max_examples=60, deadline=None, database=None)
@given(_post_sets())
def test_prefix_brackets_random_post_sets(case):
    """Random post sets: the seg table equals a binary search over the
    posts, and the prefix-sum brackets at its seg equal the step-matrix
    contraction, rows with a mode outside [0, M) included (the
    contraction's one-hot is zero there)."""
    xs, W, mode, ys, flags = case
    M, C, P = xs.shape
    rows = mode.shape[0]
    gathered = torch.from_numpy(xs[np.clip(mode, 0, M - 1)])
    post = (gathered, torch.from_numpy(ys), torch.from_numpy(flags),
            torch.ones((rows, C), dtype=torch.int32), torch.from_numpy(mode))
    step = torch.from_numpy(tfc.floor1_step_matrix(xs, W))
    want = tfc.floor1_brackets_mxu(*post, step)
    tele = torch.stack(tfc.floor1_telescopes(*post[:4]), 2).reshape(rows, -1)
    tab = seg_table(xs, W)
    # the kernel's fallback, a binary search over the sorted posts
    search = np.stack([[np.searchsorted(xs[m, c], np.arange(W), "right")
                        for c in range(C)] for m in range(M)])
    assert np.array_equal(tab, search)
    got = prefix_brackets(tele.numpy(), row_segs(tab, mode))
    for g, w in zip(got, want):
        assert bits_equal(g, w.numpy())
