"""The port's exported floor-1 curve ops (``ops/floor_curve.py``:
``floor1_curve_batch`` and ``floor1_curve_mxu``) on the CPU.

Bit for bit against the reference's (JAX on the CPU) and against each other:
on the case of tests/test_floor1_mxu.py (random sorted posts, some past the
width, 60% flagged), on rows with no flagged post at all (the minimum
curve), on the frames of the first packets of three floor-1 corpus streams
through their compiled setups, and on ``synthetic_frames`` of the flagship
synthetic setup at full width. Also the reference's exports of
``ops/__init__.py`` and the width check of ``floor1_curve_mxu``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu.ops import floor_curve as jfc
from lewton_tpu_torch import ops
from lewton_tpu_torch.audio import decode_packet_entropy
from lewton_tpu_torch.inside_ogg import read_headers
from lewton_tpu_torch.models.decoder import compile_setup, pack_frames
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.ops import floor_curve as tfc
from lewton_tpu_torch.testing import synthetic_frames, synthetic_headers
from test_torch_frontend import stream_bytes

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)


def mxu_case(seed=11, T=24, C=2, P=17, W=256, M=2, empty_rows=()):
    """tests/test_floor1_mxu.py's inputs: (xs, ys, flags, mult, mode,
    static xs [M, C, P], W); ``empty_rows`` get no flagged post."""
    rng = np.random.RandomState(seed)
    xs_static = np.full((M, C, P), int(jfc.BIG_X), np.int32)
    nvals = np.zeros((M, C), np.int32)
    for m in range(M):
        for c in range(C):
            n = rng.randint(4, P + 1)
            vals = np.sort(rng.choice(np.arange(1, 2 * W), n - 1,
                                      replace=False))
            xs_static[m, c, :n] = np.concatenate([[0], vals])
            nvals[m, c] = n
    mode = rng.randint(0, M, T).astype(np.int32)
    xs = xs_static[mode]
    ys = rng.randint(0, 128, (T, C, P)).astype(np.int32)
    flags = rng.rand(T, C, P) < 0.6
    flags[:, :, 0] = True
    for t in range(T):
        for c in range(C):
            flags[t, c, nvals[mode[t], c]:] = False
    flags[list(empty_rows)] = False
    mult = np.full((T, C), 2, np.int32)
    return xs, ys, flags, mult, mode, xs_static, W


def both(xs, ys, flags, mult, mode, xs_static, W):
    """(reference batch, reference mxu, port batch, port mxu) curves."""
    step = jfc.floor1_step_matrix(xs_static, W)
    assert np.array_equal(step, tfc.floor1_step_matrix(xs_static, W))
    j = [jnp.asarray(a) for a in (xs, ys, flags, mult, mode)]
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (xs, ys, flags, mult, mode)]
    return (np.asarray(jfc.floor1_curve_batch(*j[:4], W)),
            np.asarray(jfc.floor1_curve_mxu(*j, jnp.asarray(step), W)),
            tfc.floor1_curve_batch(*t[:4], W).numpy(),
            tfc.floor1_curve_mxu(*t, torch.from_numpy(step), W).numpy())


def assert_all_equal(curves) -> None:
    ja, jb, ta, tb = curves
    assert ta.dtype == np.float32 and ta.shape == ja.shape
    for got in (jb, ta, tb):
        assert got.tobytes() == ja.tobytes()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_mxu_case(seed):
    assert_all_equal(both(*mxu_case(seed)))


def test_rows_without_flagged_posts():
    """Rows with no flagged post: the minimum curve, from both ops."""
    curves = both(*mxu_case(7, empty_rows=(0, 5, 23)))
    assert_all_equal(curves)
    minimum = tfc.floor1_db_value(torch.zeros(1)).item()
    assert np.all(curves[2][[0, 5, 23]] == np.float32(minimum))


def frames_case(cs, fr):
    """The ops' inputs from a compiled setup and packed frames [T, ...]."""
    mode = fr["mode"].astype(np.int32)
    xs = cs.f1_xs.numpy()[mode]
    return (xs, fr["f1_ys"], fr["f1_flags"], cs.f1_mult.numpy()[mode], mode,
            cs.f1_xs.numpy(), cs.w_eff)


@pytest.mark.parametrize("name", ["stereo_44k_q3", "f1_two_submaps",
                                  "f1_three_modes_coupled"])
def test_corpus_setups(name, corpus_dir):
    """The frames of the stream's first 16 packets through its compiled
    setup."""
    rdr = PacketReader(stream_bytes(name, corpus_dir))
    headers, serial = read_headers(rdr)
    cs = compile_setup(headers.ident, headers.setup, device="cpu")
    assert cs.has_floor1
    pcks = []
    while (p := rdr.read_packet()) is not None and len(pcks) < 16:
        if p.stream_serial == serial:
            pcks.append(p.data)
    plans = [decode_packet_entropy(headers.ident, headers.setup, p)
             for p in pcks]
    assert_all_equal(both(*frames_case(cs, pack_frames(cs, plans, 16))))


def test_flagship_full_width():
    """synthetic_headers(2, 8, 11): w_eff 896, P 26, two modes."""
    cs = compile_setup(*synthetic_headers(2, 8, 11), device="cpu")
    assert (cs.w_eff, cs.max_posts, cs.f1_xs.shape[0]) == (896, 26, 2)
    fr = {k: v[0] for k, v in synthetic_frames(cs, T=8, S=1, seed=5).items()}
    assert_all_equal(both(*frames_case(cs, fr)))


def test_exports_and_width_check():
    from lewton_tpu import ops as jops
    names = {"floor0_curve_batch", "floor1_curve_batch",
             "inverse_coupling_batch", "imdct_batch", "overlap_add_batch"}
    assert names <= set(dir(ops)) and names <= set(dir(jops))
    xs, ys, flags, mult, mode, xs_static, W = mxu_case()
    t = [torch.from_numpy(a) for a in (xs, ys, flags, mult, mode)]
    with pytest.raises(ValueError, match="width"):
        tfc.floor1_curve_mxu(*t, torch.from_numpy(
            tfc.floor1_step_matrix(xs_static, W)), W + 1)
