"""The Wang-split i16 slice of the port against the reference on the CPU.

The split path of ``decode_chunks_scan`` (``ops.imdct.USE_DCT4_SPLIT``)
against the reference's split branch of ``decode_frames_core``, composed
from its own functions with its Pallas kernels in interpret mode (the
reference takes that branch only on a TPU,
lewton_tpu/models/decoder.py:654-689), and whole streams through the split
path against libvorbis. The split's modules are held to the reference in
tests/test_torch_split.py.

Tolerances, each with its reason:
- the split slice: i16 within 1 LSB, out_len/plen/started exact, the carry
  within the sum-order bound of (c || d) plus the rotation's CD_RTOL
  carried through the GEMMs;
- against libvorbis: +/-2 LSB, the conformance contract.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu import testing as jtesting
from lewton_tpu.header import Floor0 as JFloor0
from lewton_tpu.models import decoder as jdec
from lewton_tpu.ops import imdct as jim
from lewton_tpu.ops import windowing as jwin
from lewton_tpu_torch import testing as ttesting
from lewton_tpu_torch.models import decoder as tdec
from lewton_tpu_torch.models.decoder import (floor_stage, split_ok,
                                             synthesis_route,
                                             synthesize_spectra_tapped)
from lewton_tpu_torch.ops import imdct as tim
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.parallel.batch import decode_chunks_scan
from test_torch_generic import FLOOR0_RTOL
from test_torch_generic_slice import _frames, _packets, _setups
from test_torch_setup import _per_mode_coupling_headers
from test_torch_split import (CD_RTOL, _close,  # noqa: F401 (fixtures)
                              interpret_floor_kernel, use_split)

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)


def _port_synthetic(C, bs, T, N, S, seed, **kw):
    """Port-side headers (testing.synthetic_headers(**kw)) with the
    matching reference headers, and frames [N, S, T, ...] with random valid
    prefixes."""
    ident, setup = jtesting.synthetic_headers(C, *bs)
    if kw.get("per_mode_coupling"):
        ident, setup = _per_mode_coupling_headers()
    if kw.get("floor0"):
        setup.floors = [JFloor0(order=2, rate=44100, bark_map_size=64,
                                amplitude_bits=6, amplitude_offset=136,
                                books=[0])]
    cs = tdec.compile_setup(*ttesting.synthetic_headers(C, *bs, **kw),
                            device="cpu")
    make = (ttesting.synthetic_floor0_frames if cs.has_floor0
            else ttesting.synthetic_frames)
    rng = np.random.default_rng(seed)
    chunks = []
    for n in range(N):
        fr = make(cs, T=T, S=S, seed=seed + n)
        fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.9
        for s in range(S):
            fr["valid"][s, rng.integers(T // 2, T + 1):] = False
        chunks.append(fr)
    return ident, setup, {k: np.stack([c[k] for c in chunks])
                          for k in chunks[0]}


def _corpus(corpus_dir, name, T, N):
    with open(os.path.join(corpus_dir, name + ".ogg"), "rb") as f:
        ident, setup, packets = _packets(f.read())
    return ident, setup, _frames(ident, setup, packets[:T * N], T, N)


SLICES = {
    "synthetic": lambda d: _port_synthetic(2, (8, 11), 24, 2, 2, 10),
    "synthetic_odd_T": lambda d: _port_synthetic(2, (8, 11), 37, 2, 2, 30),
    "per_mode_coupling": lambda d: _port_synthetic(
        2, (8, 11), 16, 2, 2, 40, per_mode_coupling=True),
    "floor0": lambda d: _port_synthetic(2, (8, 11), 16, 2, 2, 50,
                                        floor0=True),
    "synthetic_n0_eq_n1": lambda d: _port_synthetic(1, (9, 9), 24, 2, 2, 60),
    "stereo_44k_q3": lambda d: _corpus(d, "stereo_44k_q3", 24, 2),
    "ch6_44k_q3": lambda d: _corpus(d, "ch6_44k_q3", 16, 2),
    "ch8_44k_q4": lambda d: _corpus(d, "ch8_44k_q4", 16, 2),
    "mono_16k_q3": lambda d: _corpus(d, "mono_16k_q3", 16, 2),
    "mono_11k_q0": lambda d: _corpus(d, "mono_11k_q0", 16, 2),
    "stereo_22k_q0": lambda d: _corpus(d, "stereo_22k_q0", 16, 2),
}


def _ref_split_chunk(jcs, k1: bool):
    """The reference's split branch of decode_frames_core
    (lewton_tpu/models/decoder.py:666-689) for one stream's chunk, its
    Pallas kernels in interpret mode: K1 ``cd_n`` -> split GEMMs +
    split_cd_head short GEMM, or the generic spectra -> dct4_split_uv_ct;
    then K2 ``x_split``."""
    n0, n1 = jcs.n0, jcs.n1
    mx0 = jcs.dct4_m0

    def chunk(fr, carry):
        bf = jcs.mode_blockflag[fr["mode"]]
        if k1:
            cd = jdec._floor_kernel_spectra(jcs, fr, ct_out=True,
                                            cd_n=n1 // 2)
            uv = jim.dct4_split_uv_from_cd(cd, n1)
            head = (None if n0 == n1
                    else jim.split_cd_head(cd, n1, mx0.shape[0]))
        else:
            spectra, _, _ = jdec._synthesize_spectra_tapped(jcs, fr)
            spectra_ct = jnp.transpose(spectra, (1, 0, 2))
            uv = jim.dct4_split_uv_ct(spectra_ct, n1)
            head = spectra_ct[:, :, :mx0.shape[0]]
        short = (None if n0 == n1
                 else jim.imdct_einsum("ctk,km->ctm", head, mx0))
        return jwin.overlap_add_i16_kernel_batch(
            (uv, short), bf, fr["prev_flag"], fr["next_flag"], fr["valid"],
            jcs.slope0, jcs.slope1, n0, n1, carry, ct_in=True, x_rep=True,
            x_split=True, interpret=True)
    return jax.jit(chunk)


def _split_bound(cs, fr):
    """How far the two frameworks' carried right regions may differ: the
    sum-order bound of the split GEMMs' input (c || d) plus the rotation's
    CD_RTOL, which reaches each of U and V through H terms of magnitude
    <= 1 (and the short GEMM through at most n0/2 <= n1/2 terms), plus
    2 ulp of the result for the final add; for floor 0 also FLOOR0_RTOL
    of the largest row sum (the curves differ by that much,
    tests/test_torch_generic.py)."""
    n1, N = cs.n1, cs.n1 // 2
    if synthesis_route(cs, fr) == "k1":
        cd = floor_stage(cs, fr, cd_n=N)
    else:
        spectra, _, _ = synthesize_spectra_tapped(cs, fr)
        cd = torch.cat(tim.split_butterfly(spectra.permute(1, 0, 2), n1), -1)
    scale = max(float(cd.abs().max()), 1.0)
    bound = tim.sum_order_bound(cd) + 2 * N * CD_RTOL * scale
    if cs.has_floor0:  # the curves differ by FLOOR0_RTOL
        bound += FLOOR0_RTOL * float(cd.abs().to(torch.float64).sum(-1).max())
    return bound


@pytest.mark.parametrize("name", sorted(SLICES))
def test_split_slice_matches_reference(interpret_floor_kernel, use_split,
                                       monkeypatch, corpus_dir, name):
    ident, setup, frs = SLICES[name](corpus_dir)
    jcs, cs = _setups(ident, setup)
    assert split_ok(cs)
    N, S = frs["mode"].shape[:2]
    tfrs = {k: torch.from_numpy(v) for k, v in frs.items()}
    k1 = synthesis_route(cs, {k: v[0] for k, v in tfrs.items()}) == "k1"
    calls = []
    for fn in ("dct4_split_uv_from_cd", "dct4_split_uv_ct"):
        orig = getattr(tdec, fn)
        monkeypatch.setattr(tdec, fn, lambda *a, _f=orig, _n=fn:
                            calls.append(_n) or _f(*a))
    W = cs.n1 // 2
    (out, out_len), (pwr, plen, started) = decode_chunks_scan(
        cs, tfrs, init_window_carry(cs.channels, W, S, "cpu"), with_i16=True)
    assert calls == N * ["dct4_split_uv_from_cd" if k1 else "dct4_split_uv_ct"]

    ref = _ref_split_chunk(jcs, k1)
    bound = max(_split_bound(cs, {k: v[n] for k, v in tfrs.items()})
                for n in range(N))
    for s in range(S):
        carry = tuple(jnp.asarray(c) for c in jwin.init_window_carry(
            cs.channels, W))
        for n in range(N):
            fr = {k: jnp.asarray(v[n, s]) for k, v in frs.items()}
            (r_out, r_len), carry = ref(fr, carry)
            d = np.abs(np.asarray(r_out, np.int32)
                       - out[n, s].numpy().astype(np.int32))
            assert d.max() <= 1, f"chunk {n} stream {s}: {d.max()} LSB"
            assert np.array_equal(np.asarray(r_len), out_len[n, s].numpy())
        _close(carry[0], pwr[s], bound + 2 * np.spacing(
            np.float32(np.abs(np.asarray(carry[0])).max())))
        assert int(carry[1]) == int(plen[s])
        assert bool(carry[2]) == bool(started[s])
    assert int(out_len.sum()) > 0 and bool((out != 0).any())


@pytest.mark.parametrize("name,T", [("stereo_44k_q3", 48), ("ch6_44k_q3", 32),
                                    ("mono_16k_q3", 32), ("mono_11k_q0", 32)])
def test_split_path_matches_libvorbis(use_split, monkeypatch, corpus_dir,
                                      name, T):
    """The whole stream through the port's split path (plain versions on
    the CPU) within +/-2 LSB of libvorbis; the split branch is taken in
    every chunk."""
    with open(os.path.join(corpus_dir, name + ".ogg"), "rb") as f:
        ident, setup, packets = _packets(f.read())
    golden = np.load(os.path.join(corpus_dir, name + ".golden.npy"))
    N = -(-len(packets) // T)
    frs = _frames(ident, setup, packets, T, N)
    _, cs = _setups(ident, setup)
    assert split_ok(cs)
    calls = []
    orig = tdec.dct4_split_uv_from_cd
    monkeypatch.setattr(tdec, "dct4_split_uv_from_cd",
                        lambda *a: calls.append(1) or orig(*a))
    (out, lens), _ = decode_chunks_scan(
        cs, {k: torch.from_numpy(v) for k, v in frs.items()},
        init_window_carry(cs.channels, cs.n1 // 2, 1, "cpu"), with_i16=True)
    assert len(calls) == N
    C, outw = cs.channels, 3 * cs.n1 // 4
    pcm = np.concatenate(
        [out[n, 0, t].numpy().reshape(C, outw)[:, :int(lens[n, 0, t])]
         for n in range(N) for t in range(T)], 1).T
    assert pcm.shape[0] >= golden.shape[0] > 0 and pcm.shape[1] == C
    d = np.abs(pcm[:golden.shape[0]].astype(np.int32) - golden.astype(np.int32))
    assert d.max() <= 2, f"max diff {d.max()}"
    assert np.abs(golden).max() > 10
