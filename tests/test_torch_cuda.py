"""The CUDA kernels against their plain torch versions on the card.

Marked ``cuda``: these skip where there is no card. On a machine with one
(no JAX there, so without this directory's conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every kernel rounds exactly as its plain version does, so the tolerance
is zero. The generic path on the card is held to the port's plain path on
the CPU: the GEMMs sum in other orders there, so i16 within 1 LSB.
chip_smoke.py repeats these checks at the headline shapes.
"""

import os

import numpy as np
import pytest
import torch

from lewton_tpu_torch.header import Mode
from lewton_tpu_torch.inside_ogg import OggStreamReader
from lewton_tpu_torch.models.decoder import (compile_setup,
                                             floor_kernel_inputs, floor_stage,
                                             precompute_brackets)
from lewton_tpu_torch.ops import (floor_kernel, imdct, overlap_kernel,
                                  synth_kernel)
from lewton_tpu_torch.ops.imdct import (dct4_batch_parts_ct,
                                        dct4_split_uv_from_cd,
                                        imdct_batch_parts_ct)
from lewton_tpu_torch.ops.windowing import init_window_carry, overlap_table
from lewton_tpu_torch.parallel.batch import decode_chunks_scan
from lewton_tpu_torch.testing import (synthetic_floor0_frames,
                                      synthetic_frames, synthetic_headers)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _frames(cs, S, T, seed, dev, dtype=None):
    rng = np.random.default_rng(seed)
    make = synthetic_floor0_frames if cs.has_floor0 else synthetic_frames
    fr = make(cs, T=T, S=S, seed=seed)
    fr["mode"][:] = rng.integers(0, 2, fr["mode"].shape)
    fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.8
    for s in range(S):
        fr["valid"][s, rng.integers(0, T + 1):] = False
    if dtype is not None:
        fr["residue"] = fr["residue"].astype(dtype)
    return {k: torch.from_numpy(v).to(dev) for k, v in fr.items()}


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("C,dtype", [(2, None), (2, np.float32), (6, None)])
def test_floor_kernel_matches_plain(dev, C, dtype):
    cs = compile_setup(*synthetic_headers(C, 8, 11), device=dev)
    fr = _frames(cs, 3, 37, C, dev, dtype)
    ops = floor_kernel_inputs(cs, fr)
    before = floor_kernel.LAUNCHES
    got = floor_kernel.floor_spectra(*ops, cs.f1_xs, cs.f1_step,
                                     cs.static_coupling)
    assert floor_kernel.LAUNCHES == before + 1
    want = floor_kernel.floor_spectra_ref(*ops, cs.f1_step,
                                          cs.static_coupling)
    before = floor_kernel.LAUNCHES_FLAT
    flat = floor_kernel.floor_spectra(*ops, cs.f1_xs, cs.f1_step,
                                      cs.static_coupling, ct_out=False)
    assert floor_kernel.LAUNCHES_FLAT == before + 1
    flat_want = floor_kernel.floor_spectra_ref(
        *ops, cs.f1_step, cs.static_coupling, ct_out=False)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(flat), _bits(flat_want))
    assert torch.equal(_bits(flat), _bits(got.permute(1, 0, 2)))


@pytest.mark.parametrize("C,bs", [(2, (8, 11)), (6, (8, 11)), (1, (9, 9)),
                                  (2, (8, 13))])
def test_floor_kernel_cd_matches_plain(dev, C, bs):
    """K1's cd_n form (the Wang split's rotated pair)."""
    cs = compile_setup(*synthetic_headers(C, *bs), device=dev)
    ops = floor_kernel_inputs(cs, _frames(cs, 3, 37, C, dev))
    N = cs.n1 // 2
    before = floor_kernel.LAUNCHES_CD
    got = floor_kernel.floor_spectra(*ops, cs.f1_xs, cs.f1_step,
                                     cs.static_coupling, cd_n=N)
    assert floor_kernel.LAUNCHES_CD == before + 1
    want = floor_kernel.floor_spectra_ref(*ops, cs.f1_step,
                                          cs.static_coupling, cd_n=N)
    torch.cuda.synchronize()
    assert got.shape == (C, 3 * 37, N)
    assert torch.equal(_bits(got), _bits(want))


def _k1_forms(ops, xs, step, steps, N):
    """K1's three forms and their plain versions on the same operands."""
    got = (floor_kernel.floor_spectra(*ops, xs, step, steps),
           floor_kernel.floor_spectra(*ops, xs, step, steps, ct_out=False),
           floor_kernel.floor_spectra(*ops, xs, step, steps, cd_n=N))
    want = (floor_kernel.floor_spectra_ref(*ops, step, steps),
            floor_kernel.floor_spectra_ref(*ops, step, steps, ct_out=False),
            floor_kernel.floor_spectra_ref(*ops, step, steps, cd_n=N))
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("C", range(1, 9))
def test_floor_kernel_every_channel_count(dev, C):
    """K1's three forms at every channel count the kernel instantiates."""
    cs = compile_setup(*synthetic_headers(C, 8, 11), device=dev)
    ops = floor_kernel_inputs(cs, _frames(cs, 3, 37, 60 + C, dev))
    got, want = _k1_forms(ops, cs.f1_xs, cs.f1_step, cs.static_coupling,
                          cs.n1 // 2)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
@pytest.mark.parametrize("w", [333, 895])
def test_floor_kernel_odd_width_bad_modes(dev, dtype, w):
    """K1 at an odd w_eff (scalar, masked accesses), with the residue one
    element past an aligned start and modes outside [0, M) on some rows:
    those rows take brackets of no post, as the plain version's one-hot."""
    cs = compile_setup(*synthetic_headers(2, 8, 11), device=dev)
    tele, residue, scal = floor_kernel_inputs(cs, _frames(cs, 3, 37, w, dev))
    rows = tele.shape[0]
    residue = residue.reshape(rows, 2, cs.w_eff)[:, :, :w].to(dtype)
    buf = torch.empty(residue.numel() + 1, dtype=dtype, device=dev)
    residue = buf[1:].view(rows, 2 * w).copy_(residue.reshape(rows, 2 * w))
    scal = scal.clone()
    scal[::4, 0] = -1.0
    scal[1::5, 0] = 2.0
    step = cs.f1_step[:, :, :w].contiguous()
    got, want = _k1_forms((tele, residue, scal), cs.f1_xs, step,
                          cs.static_coupling, cs.n1 // 2)
    for g, w_ in zip(got, want):
        assert torch.equal(_bits(g), _bits(w_))


def test_floor_kernel_search_fallback(dev):
    """K1 with 10 modes: the [M, C, W] seg table exceeds its shared-memory
    budget, so the kernel searches the row's posts instead."""
    ident, setup = synthetic_headers(2, 8, 11)
    setup.modes += [Mode(i % 2, 0) for i in range(8)]
    cs = compile_setup(ident, setup, device=dev)
    fr = _frames(cs, 3, 37, 8, dev)
    fr["mode"] = torch.randint(0, 10, tuple(fr["mode"].shape),
                               generator=torch.Generator().manual_seed(3),
                               dtype=torch.int32).to(dev)
    got, want = _k1_forms(floor_kernel_inputs(cs, fr), cs.f1_xs, cs.f1_step,
                          cs.static_coupling, cs.n1 // 2)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.parametrize("S,T,bs", [(3, 1, (8, 11)), (2, 37, (8, 11)),
                                    (2, 9, (6, 6)), (2, 9, (6, 13))])
def test_overlap_x_and_split_edges(dev, S, T, bs):
    """K2's X and split forms at T = 1, at a T that is not a multiple of
    the row tile, at (n0, n1) = (64, 64) and (64, 8192), with rows that mix
    nothing (ov_len = 0) and rows cut short inside a group of 8."""
    cs = compile_setup(*synthetic_headers(2, *bs), device=dev)
    fr, (scal, *tail) = _overlap_operands(cs, S, T, dev)
    scal = scal.clone()
    scal[:, ::3, 6] = 0.0
    scal[:, 1::2, 7] = 3.0 * cs.n1 / 8 + 3.0
    spectra = floor_stage(cs, fr, plain=True)
    x_long, x_short = dct4_batch_parts_ct(spectra, cs.dct4_m0, cs.dct4_m1)
    got = overlap_kernel.overlap_i16(x_long, x_short, scal, *tail)
    want = overlap_kernel.overlap_i16_ref(x_long, x_short, scal, *tail)
    pairs = [(got, want)]
    if cs.n1 >= 512:
        cd = floor_stage(cs, fr, plain=True, cd_n=cs.n1 // 2)
        u, v = (x.contiguous() for x in dct4_split_uv_from_cd(cd, cs.n1))
        pairs.append((
            overlap_kernel.overlap_i16_split(u, v, x_short, scal, *tail),
            overlap_kernel.overlap_i16_split_ref(u, v, x_short, scal, *tail)))
    torch.cuda.synchronize()
    for (out, pwr), (out_r, pwr_r) in pairs:
        assert torch.equal(out, out_r) and torch.equal(_bits(pwr), _bits(pwr_r))


@pytest.mark.parametrize("C", [1, 2, 6, 10])
def test_synth_kernel_matches_plain(dev, C):
    """K3 in registers (C <= 8) and in its wide form (C = 10)."""
    cs = compile_setup(*synthetic_headers(C, 8, 11), device=dev)
    fr = precompute_brackets(cs, _frames(cs, 3, 37, C, dev))
    br = torch.stack(fr["f1_brackets"], 2).reshape(3 * 37, 4, C, cs.w_eff)
    residue = fr["residue"].reshape(3 * 37, C, cs.w_eff).float()
    used = fr["f_used"].reshape(3 * 37, C)
    before = synth_kernel.LAUNCHES
    got = synth_kernel.fused_floor_couple(br, residue, used,
                                          cs.static_coupling)
    assert synth_kernel.LAUNCHES == before + 1
    want = synth_kernel.fused_floor_couple_ref(br, residue, used,
                                               cs.static_coupling)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("bs", [(8, 11), (10, 10)])
def test_overlap_kernel_matches_plain(dev, bs):
    cs = compile_setup(*synthetic_headers(2, *bs), device=dev)
    S, T = 3, 37
    fr = _frames(cs, S, T, 7, dev)
    spectra = floor_stage(cs, fr, plain=True)
    x_long, x_short = dct4_batch_parts_ct(spectra, cs.dct4_m0, cs.dct4_m1)
    g = torch.Generator().manual_seed(1)
    pwr0 = torch.randn((S, 2, cs.n1 // 2), generator=g).to(dev)
    scal, slopes, _, _ = overlap_table(
        cs.mode_blockflag[fr["mode"].long()], fr["prev_flag"],
        fr["next_flag"], fr["valid"], cs.slope0, cs.slope1, cs.n0, cs.n1,
        torch.full((S,), cs.n0 // 2, dtype=torch.int32, device=dev),
        torch.ones(S, dtype=torch.bool, device=dev))
    args = (x_long, x_short, scal, slopes, pwr0, cs.n0, cs.n1)
    before = overlap_kernel.LAUNCHES
    out, pwr = overlap_kernel.overlap_i16(*args)
    assert overlap_kernel.LAUNCHES == before + 1
    out_r, pwr_r = overlap_kernel.overlap_i16_ref(*args)
    # into a given tensor: a slice of a larger output, as the chunk loop does
    big = torch.full((2,) + tuple(out.shape), 7, dtype=torch.int16, device=dev)
    _, pwr_1 = overlap_kernel.overlap_i16(*args, out=big[1])
    torch.cuda.synchronize()
    assert torch.equal(out, out_r)
    assert torch.equal(_bits(pwr), _bits(pwr_r))
    assert torch.equal(big[1], out_r) and bool((big[0] == 7).all())
    assert torch.equal(_bits(pwr_1), _bits(pwr_r))


def _overlap_operands(cs, S, T, dev):
    fr = _frames(cs, S, T, 7, dev)
    g = torch.Generator().manual_seed(1)
    pwr0 = torch.randn((S, cs.channels, cs.n1 // 2), generator=g).to(dev)
    scal, slopes, _, _ = overlap_table(
        cs.mode_blockflag[fr["mode"].long()], fr["prev_flag"],
        fr["next_flag"], fr["valid"], cs.slope0, cs.slope1, cs.n0, cs.n1,
        torch.full((S,), cs.n0 // 2, dtype=torch.int32, device=dev),
        torch.ones(S, dtype=torch.bool, device=dev))
    return fr, (scal, slopes, pwr0, cs.n0, cs.n1)


@pytest.mark.parametrize("bs", [(8, 11), (9, 9), (6, 11)])
def test_overlap_split_matches_plain(dev, bs):
    """K2's split form on the split GEMMs' (U, V)."""
    cs = compile_setup(*synthetic_headers(2, *bs), device=dev)
    S, T = 3, 37
    fr, tail = _overlap_operands(cs, S, T, dev)
    cd = floor_stage(cs, fr, plain=True, cd_n=cs.n1 // 2)
    u, v = (x.contiguous() for x in dct4_split_uv_from_cd(cd, cs.n1))
    _, x_short = dct4_batch_parts_ct(floor_stage(cs, fr, plain=True),
                                     cs.dct4_m0, cs.dct4_m1)
    before = overlap_kernel.LAUNCHES_SPLIT
    out, pwr = overlap_kernel.overlap_i16_split(u, v, x_short, *tail)
    assert overlap_kernel.LAUNCHES_SPLIT == before + 1
    out_r, pwr_r = overlap_kernel.overlap_i16_split_ref(u, v, x_short, *tail)
    torch.cuda.synchronize()
    assert torch.equal(out, out_r) and torch.equal(_bits(pwr), _bits(pwr_r))


@pytest.mark.parametrize("ct_in", [False, True])
@pytest.mark.parametrize("selected", [False, True])
@pytest.mark.parametrize("bs", [(8, 11), (9, 9), (6, 11)])
def test_overlap_audio_matches_plain(dev, bs, selected, ct_in):
    """K2's audio form: un-selected or pre-selected IMDCT output,
    channel-major or [rows, C, n]."""
    cs = compile_setup(*synthetic_headers(2, *bs), device=dev)
    S, T = 3, 37
    fr, tail = _overlap_operands(cs, S, T, dev)
    spectra = floor_stage(cs, fr, plain=True)
    long_a, short_a = imdct_batch_parts_ct(spectra, cs.imdct_m0, cs.imdct_m1)
    if selected and short_a is not None:
        bf = cs.mode_blockflag[fr["mode"].long()].reshape(1, -1, 1)
        pad = torch.nn.functional.pad(short_a, (0, cs.n1 - cs.n0))
        long_a, short_a = torch.where(bf == 1, long_a, pad), None
    if not ct_in:
        long_a, short_a = (None if a is None else a.permute(1, 0, 2).contiguous()
                           for a in (long_a, short_a))
    before = overlap_kernel.LAUNCHES_AUDIO
    out, pwr = overlap_kernel.overlap_i16_audio(long_a, short_a, *tail, ct_in)
    assert overlap_kernel.LAUNCHES_AUDIO == before + 1
    out_r, pwr_r = overlap_kernel.overlap_i16_audio_ref(long_a, short_a, *tail,
                                                        ct_in)
    torch.cuda.synchronize()
    assert torch.equal(out, out_r) and torch.equal(_bits(pwr), _bits(pwr_r))


@pytest.mark.parametrize("kw", [{}, {"per_mode_coupling": True}])
def test_split_path_matches_cpu(dev, monkeypatch, kw):
    """USE_DCT4_SPLIT on the card: K1 cd_n and K2 split_in once per chunk
    (K2 split_in only on the generic route), within 1 LSB of the port's
    plain path on the CPU."""
    monkeypatch.setattr(imdct, "USE_DCT4_SPLIT", True)
    headers = synthetic_headers(**kw)
    cs = compile_setup(*headers, device=dev)
    N, S, T = 2, 3, 40
    chunks = [_frames(cs, S, T, 40 + n, dev) for n in range(N)]
    frs = {k: torch.stack([c[k] for c in chunks]) for k in chunks[0]}
    carry = init_window_carry(cs.channels, cs.n1 // 2, S, dev)
    cd0, sp0 = floor_kernel.LAUNCHES_CD, overlap_kernel.LAUNCHES_SPLIT
    (out, ln), c = decode_chunks_scan(cs, frs, carry, with_i16=True)
    k1 = 0 if kw else N
    assert (floor_kernel.LAUNCHES_CD - cd0,
            overlap_kernel.LAUNCHES_SPLIT - sp0) == (k1, N)
    cs_cpu = compile_setup(*headers, device="cpu")
    (out_c, ln_c), _ = decode_chunks_scan(
        cs_cpu, {k: v.cpu() for k, v in frs.items()},
        init_window_carry(cs.channels, cs.n1 // 2, S, "cpu"), with_i16=True)
    assert (out.cpu().int() - out_c.int()).abs().max() <= 1
    assert torch.equal(ln.cpu(), ln_c)


def test_caller_imdct_path_matches_cpu(dev):
    """A caller's IMDCT on the card: the generic stages, then K2's audio
    form once per chunk (no K1), within 1 LSB of the CPU plain path."""
    def own(spectra, bf, m0, m1):
        return imdct.imdct_batch(spectra, bf, m0, m1)

    headers = synthetic_headers()
    cs = compile_setup(*headers, device=dev)
    N, S, T = 2, 3, 40
    chunks = [_frames(cs, S, T, 50 + n, dev) for n in range(N)]
    frs = {k: torch.stack([c[k] for c in chunks]) for k in chunks[0]}
    k1, a0 = floor_kernel.LAUNCHES, overlap_kernel.LAUNCHES_AUDIO
    (out, ln), _ = decode_chunks_scan(
        cs, frs, init_window_carry(2, cs.n1 // 2, S, dev), with_i16=True,
        imdct=own)
    assert floor_kernel.LAUNCHES == k1
    assert overlap_kernel.LAUNCHES_AUDIO - a0 == N
    cs_cpu = compile_setup(*headers, device="cpu")
    (out_c, ln_c), _ = decode_chunks_scan(
        cs_cpu, {k: v.cpu() for k, v in frs.items()},
        init_window_carry(2, cs.n1 // 2, S, "cpu"), with_i16=True, imdct=own)
    assert (out.cpu().int() - out_c.int()).abs().max() <= 1
    assert torch.equal(ln.cpu(), ln_c)


def test_slice_runs_through_kernels(dev):
    cs = compile_setup(*synthetic_headers(2, 8, 11), device=dev)
    N, S, T = 2, 3, 40
    chunks = [_frames(cs, S, T, 20 + n, dev) for n in range(N)]
    frs = {k: torch.stack([c[k] for c in chunks]) for k in chunks[0]}
    carry = init_window_carry(2, cs.n1 // 2, S, dev)
    f0, o0 = floor_kernel.LAUNCHES, overlap_kernel.LAUNCHES
    (out, ln), c = decode_chunks_scan(cs, frs, carry, with_i16=True)
    assert (floor_kernel.LAUNCHES - f0, overlap_kernel.LAUNCHES - o0) == (N, N)
    (out_p, ln_p), c_p = decode_chunks_scan(cs, frs, carry, with_i16=True,
                                            plain=True)
    torch.cuda.synchronize()
    assert torch.equal(out, out_p) and torch.equal(ln, ln_p)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(c, c_p))


@pytest.mark.parametrize("kw", [{"floor0": True}, {"per_mode_coupling": True},
                                {"channels": 10}])
def test_generic_i16_path_matches_cpu(dev, kw):
    """Setups outside K1's gate: generic stages, DCT-IV GEMM, K2 (and no
    K1) on the card, against the port's plain path on the CPU."""
    headers = synthetic_headers(**kw)
    cs = compile_setup(*headers, device=dev)
    N, S, T = 2, 3, 40
    chunks = [_frames(cs, S, T, 30 + n, dev) for n in range(N)]
    frs = {k: torch.stack([c[k] for c in chunks]) for k in chunks[0]}
    carry = init_window_carry(cs.channels, cs.n1 // 2, S, dev)
    k1 = (floor_kernel.LAUNCHES, floor_kernel.LAUNCHES_FLAT)
    o0 = overlap_kernel.LAUNCHES
    (out, ln), c = decode_chunks_scan(cs, frs, carry, with_i16=True)
    assert (floor_kernel.LAUNCHES, floor_kernel.LAUNCHES_FLAT) == k1
    assert overlap_kernel.LAUNCHES - o0 == N
    cs_cpu = compile_setup(*headers, device="cpu")
    (out_c, ln_c), c_c = decode_chunks_scan(
        cs_cpu, {k: v.cpu() for k, v in frs.items()},
        init_window_carry(cs.channels, cs.n1 // 2, S, "cpu"),
        with_i16=True)
    assert (out.cpu().int() - out_c.int()).abs().max() <= 1
    assert torch.equal(ln.cpu(), ln_c)
    assert bool(torch.isfinite(c[0]).all())


@pytest.mark.parametrize("name", ["stereo_44k_q3", "ch6_44k_q3"])
def test_read_all_i16_on_the_card_matches_golden(dev, name):
    """A committed gate stream, file to PCM on the card through K1 and K2:
    exact length, within +/-2 LSB of its libvorbis golden."""
    gate = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_gate")
    before = (floor_kernel.LAUNCHES, overlap_kernel.LAUNCHES)
    out = OggStreamReader(os.path.join(gate, name + ".ogg"),
                          device=dev).read_all_i16()
    assert floor_kernel.LAUNCHES > before[0]
    assert overlap_kernel.LAUNCHES > before[1]
    with np.load(os.path.join(gate, name + ".golden.npz")) as z:
        golden = z["pcm"]
    assert out.shape == golden.shape
    assert np.abs(out.astype(np.int32) - golden.astype(np.int32)).max() <= 2
