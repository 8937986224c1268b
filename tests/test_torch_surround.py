"""libvorbis's surround modes through the port, held to the benchmark's
plain references: 5.1 at -q 3 (44.1 kHz: six channels, two submaps, a
type-2 residue over five channels, four chained coupling steps) and 7.1 at
-q 4 (eight uncoupled channels, one submap, a type-1 residue coded per
channel). A test that holds for either layout is a case of each stream.

- ``benchmark/reference/synth_torch.py`` (plain torch, device half) decodes
  each libvorbis stream within 1 LSB of libvorbisfile, at exact length.
- On a synthetic setup with the 5.1 mapping (mux [0,0,0,0,0,1], steps
  (0,2), (3,4), (0,1), (0,3)) and on one with the 7.1 mapping (mux all 0,
  type-1 residue, no steps), both at small blocks, the port's
  ``decode_chunk_batch`` on seeded random frames agrees with synth_torch
  (f32 within the GEMM's sum-order bound, i16 within 1 LSB); the 5.1
  frames with the steps applied forward do not: the check sees the
  chain's order.
- ``BatchDecoder.decode_streams_i16`` on harness files of each source
  equals the NumPy reference within its configuration's limits.
- The tracer's ``frontend.deinterleave_ns`` counts the five-channel
  submap's scratch and nothing on the stereo direct write;
  ``frontend.residue01_ns`` counts 7.1's per-channel residue and nothing
  on stereo; with the tracer off the native entry gets null pointers and
  nothing is timed.
- Marked ``cuda`` (skips without a card; no JAX, so on the card
  ``python -m pytest --noconftest -p no:cacheprovider -s -m cuda
  tests/test_torch_surround.py``): the K1 route at the published widths
  (each stream's own setup: blocks 256/2048, w_eff 896, C = 6 or 8, one
  chunk of S = 64 x T = 64) against synth_torch.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import check, traffic
from benchmark.harness.core import ROOT
from benchmark.harness.source import load_json, load_source
from benchmark.reference import synth_torch
from benchmark.reference.decode import Reference
from lewton_tpu_torch import native, profiling
from lewton_tpu_torch.header import (Floor1, IdentHeader, Mapping, Mode,
                                     Residue, SetupHeader, read_header_ident,
                                     read_header_setup)
from lewton_tpu_torch.models.decoder import (compile_setup,
                                             synthesize_audio_tapped,
                                             synthesis_route)
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.parallel.batch import BatchDecoder, decode_chunk_batch
from lewton_tpu_torch.testing import synthetic_frames

torch.set_num_threads(1)

GATE = os.path.join(os.path.dirname(__file__), "data", "torch_gate")
STEPS = ((0, 2), (3, 4), (0, 1), (0, 3))
#: each surround stream: its configuration, channels and coupling steps
STREAMS = {
    "ch6_44k_q3": ("surround51_q3_44k", 6, STEPS),
    "ch8_44k_q4": ("surround71_q4_44k", 8, ()),
}


def _config(name):
    return load_json(ROOT / f"benchmark/configs/{STREAMS[name][0]}.json")


def _bytes(name):
    with open(os.path.join(GATE, name + ".ogg"), "rb") as f:
        return f.read()


def _floor(x_list, dims):
    k = len(dims)
    return Floor1(partitions=k, partition_class=list(range(k)),
                  class_dims=list(dims), class_subclasses=[0] * k,
                  class_masterbooks=[-1] * k, subclass_books=[[-1]] * k,
                  multiplier=2, x_list=list(x_list))


def surround_headers(bs0_exp=6, bs1_exp=8):
    """libvorbis's 5.1 layout at small blocks: floors 0 / 1 (short / long)
    for the five main channels, floor 2 for the LFE; submap 0 takes a
    type-2 residue over the five, submap 1 a type-1 residue."""
    ident = IdentHeader(channels=6, sample_rate=44100, bitrate_maximum=0,
                        bitrate_nominal=276000, bitrate_minimum=0,
                        blocksize_0=bs0_exp, blocksize_1=bs1_exp)
    h0, h1 = (1 << bs0_exp) // 2, (1 << bs1_exp) // 2
    floors = [_floor([0, h0, h0 // 2, 4, 12, 20], (2, 2)),
              _floor([0, h1, 64, 16, 96, 4, 32, 48, 80, 112, 8], (3, 3, 3)),
              _floor([0, h1, 6], (1,))]
    residues = [Residue(residue_type=rt, begin=0, end=end, partition_size=8,
                        classifications=2, classbook=0, cascades=[0, 0],
                        books=[[-1] * 8] * 2)
                for rt, end in ((2, 5 * h0), (2, 5 * h1), (1, 12))]
    mappings = [Mapping(submaps=2, coupling_magnitude=[m for m, _ in STEPS],
                        coupling_angle=[a for _, a in STEPS],
                        mux=[0, 0, 0, 0, 0, 1], submap_floor=[f, 2],
                        submap_residue=[f, 2])
                for f in (0, 1)]
    setup = SetupHeader(codebooks=[], floors=floors, residues=residues,
                        mappings=mappings, modes=[Mode(0, 0), Mode(1, 1)])
    return ident, setup


def uncoupled_headers(bs0_exp=6, bs1_exp=8):
    """libvorbis's uncoupled 7.1 layout at small blocks: floors 0 / 1
    (short / long) for all eight channels in one submap, a type-1 residue
    coded per channel, no coupling."""
    ident = IdentHeader(channels=8, sample_rate=44100, bitrate_maximum=0,
                        bitrate_nominal=688000, bitrate_minimum=0,
                        blocksize_0=bs0_exp, blocksize_1=bs1_exp)
    h0, h1 = (1 << bs0_exp) // 2, (1 << bs1_exp) // 2
    floors = [_floor([0, h0, h0 // 2, 4, 12, 20, 28], (2, 3)),
              _floor([0, h1, 64, 16, 96, 4, 32, 48, 80, 112, 8, 120, 56],
                     (3, 4, 4))]
    residues = [Residue(residue_type=1, begin=0, end=end, partition_size=8,
                        classifications=2, classbook=0, cascades=[0, 0],
                        books=[[-1] * 8] * 2)
                for end in (h0 - 8, h1 - 16)]
    mappings = [Mapping(submaps=1, coupling_magnitude=[], coupling_angle=[],
                        mux=[0] * 8, submap_floor=[f], submap_residue=[f])
                for f in (0, 1)]
    setup = SetupHeader(codebooks=[], floors=floors, residues=residues,
                        mappings=mappings, modes=[Mode(0, 0), Mode(1, 1)])
    return ident, setup


#: the synthetic setup of each stream's mapping
HEADERS = {"ch6_44k_q3": surround_headers, "ch8_44k_q4": uncoupled_headers}


def surround_frames(cs, layout, S, T, seed):
    """Random frames of the 5.1 layout: posts past a floor's own left
    unused, short blocks' residue zero past n0/2 (as the front-end leaves
    them), some floors unused and ragged valid prefixes."""
    rng = np.random.default_rng(seed)
    fr = synthetic_frames(cs, T=T, S=S, seed=seed)
    fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.85
    for m, row in enumerate(layout.xs):
        sel = fr["mode"] == m
        for c, xs in enumerate(row):
            fr["f1_flags"][..., c, len(xs):][sel] = False
            fr["f1_ys"][..., c, len(xs):][sel] = 0
    res = fr["residue"].reshape(S, T, cs.channels, cs.w_eff)
    res[..., cs.n0 // 2:][fr["mode"] == 0] = 0
    # a long block's window flags are its neighbours' block sizes
    bf = np.asarray(layout.blockflag)[fr["mode"]].astype(bool)
    fr["prev_flag"][:, 1:] = bf[:, :-1]
    fr["next_flag"][:, :-1] = bf[:, 1:]
    for s in range(S):
        fr["valid"][s, rng.integers(T // 2, T + 1):] = False
    return fr


def _port(cs, fr, with_i16):
    S = fr["mode"].shape[0]
    tfr = {k: torch.from_numpy(v) for k, v in fr.items()}
    carry = init_window_carry(cs.channels, cs.n1 // 2, S, "cpu")
    (out, out_len), _ = decode_chunk_batch(cs, tfr, carry, with_i16=with_i16)
    return out.numpy(), out_len.numpy()


def _bound(layout, fr):
    """Largest |port - synth| an f32 PCM sample may show: the port's f32
    GEMM lies within gamma_K sum_k |s_k| of the exact transform (K = n1/2
    terms, |cos| <= 1) and synth_torch's f64 product within half an f32
    ulp of it; the two overlapped terms are weighted by window values
    whose squares sum to 1, so 2 gamma_K max_row sum |s_k| bounds them
    (``ops.imdct.sum_order_bound``'s form), plus 2 ulp of the result."""
    S, T = fr["mode"].shape
    C = layout.channels
    spectra = synth_torch.packet_spectra(
        layout, fr["mode"].reshape(-1), fr["residue"].reshape(S * T, C, -1),
        fr["f_used"].reshape(S * T, C), fr["f1_ys"].reshape(S * T, C, -1),
        fr["f1_flags"].reshape(S * T, C, -1))
    K = layout.n1 // 2
    u = 2.0 ** -24
    gamma = K * u / (1.0 - K * u)
    return 2.0 * gamma * float(spectra.abs().double().sum(-1).max())


def _worst(layout, fr, out, out_len, with_i16):
    """Largest excess of |port - synth| over the tolerance (<= 0 when every
    sample is within it), over every valid packet."""
    pcm = synth_torch.decode_frames(layout, fr)
    bound = _bound(layout, fr)
    worst = -np.inf
    for s, packets in enumerate(pcm):
        for t, want in enumerate(packets):
            want = want.numpy()
            L = want.shape[1]
            assert out_len[s, t] == L
            if not L:
                continue
            if with_i16:
                got = out[s, t].reshape(want.shape[0], -1)[:, :L]
                d = np.abs(got.astype(np.int32)
                           - synth_torch.to_i16(torch.from_numpy(want))
                           .numpy().astype(np.int32))
                worst = max(worst, float(d.max()) - 1.0)
            else:
                got = out[s, t, :, :L]
                d = np.abs(got.astype(np.float64) - want)
                tol = bound + 2.0 * np.spacing(np.abs(want))
                worst = max(worst, float((d - tol).max()))
    return worst


@functools.cache
def _synthetic(name):
    """(setup, layout, seeded random frames) of the synthetic setup of
    ``name``'s mapping."""
    ident, setup = HEADERS[name]()
    cs = compile_setup(ident, setup, device="cpu")
    layout = synth_torch.layout_of(ident, setup)
    fr = surround_frames(cs, layout, S=3, T=24, seed=51)
    return cs, layout, fr


@pytest.fixture(scope="module")
def synthetic():
    return _synthetic("ch6_44k_q3")


@pytest.mark.parametrize("name", list(STREAMS))
def test_synth_torch_decodes_the_stream_within_1_lsb(name):
    with np.load(os.path.join(GATE, name + ".golden.npz")) as z:
        golden = z["pcm"]
    with open(os.path.join(GATE, "manifest.json")) as f:
        samples = json.load(f)["streams"][name]["samples"]
    out = synth_torch.decode(_bytes(name), device="cpu")
    assert out.shape == golden.shape == (samples, STREAMS[name][1])
    assert np.abs(out.astype(np.int32) - golden).max() <= 1


def test_synthetic_setup_is_the_51_layout(synthetic):
    cs, layout, fr = synthetic
    assert cs.channels == 6 and cs.static_coupling == STEPS
    assert layout.coupling == [list(STEPS)] * 2
    tfr = {k: torch.from_numpy(v) for k, v in fr.items()}
    assert synthesis_route(cs, tfr) == "k1"


def test_synthetic_setup_is_the_71_layout():
    cs, layout, fr = _synthetic("ch8_44k_q4")
    assert cs.channels == 8 and cs.static_coupling == ()
    assert layout.coupling == [[], []]
    tfr = {k: torch.from_numpy(v) for k, v in fr.items()}
    assert synthesis_route(cs, tfr) == "k1"


@pytest.mark.parametrize("with_i16", [False, True])
@pytest.mark.parametrize("name", list(STREAMS))
def test_port_matches_synth_torch(name, with_i16):
    cs, layout, fr = _synthetic(name)
    out, out_len = _port(cs, fr, with_i16)
    assert _worst(layout, fr, out, out_len, with_i16) <= 0


@pytest.mark.parametrize("with_i16", [False, True])
def test_steps_applied_forward_fail(synthetic, with_i16):
    """The reference with the chain applied forward (its steps listed in
    reverse) is off the port by more than the tolerance."""
    cs, layout, fr = synthetic
    forward = dataclasses.replace(
        layout, coupling=[steps[::-1] for steps in layout.coupling])
    out, out_len = _port(cs, fr, with_i16)
    assert _worst(forward, fr, out, out_len, with_i16) > 0


@pytest.mark.parametrize("name", list(STREAMS))
def test_batch_decoder_on_harness_files_within_limits(name):
    config = _config(name)
    src = load_source(ROOT, config)
    files = traffic.make_files(src, 8, [1, 2], 2 ** 31 + 51)
    ident = read_header_ident(src.headers[0])
    setup = read_header_setup(src.headers[2], ident)
    dec = BatchDecoder(ident, setup, chunk=64, scan=1,
                       raw_headers=(src.headers[0], src.headers[2]),
                       device="cpu")
    outs = dec.decode_streams_i16(
        [native.demux_spans(f.data)[0][3:] for f in files])
    got = check.compare([(f.data, [o]) for f, o in zip(files, outs)],
                        Reference())
    assert all(got[k] <= config["limits"][k] for k in check.NUMBERS), got
    assert got["max_lsb_diff"] <= 1


def _decoder(name):
    """(a BatchDecoder of the gate stream ``name`` at chunk 16, its audio
    packets)."""
    pk = native.demux_spans(_bytes(name))[0]
    ident = read_header_ident(pk[0])
    setup = read_header_setup(pk[2], ident)
    return BatchDecoder(ident, setup, chunk=16, raw_headers=(pk[0], pk[2]),
                        device="cpu"), pk[3:]


def _counts_of(name):
    dec, audio = _decoder(name)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            dec.decode_streams_i16([audio] * 3)
        counts = {}
        for r in profiling.records():
            if isinstance(r, profiling.Count):
                counts[r.name] = counts.get(r.name, 0) + r.n
        return counts
    finally:
        profiling.reset()


def test_deinterleave_counter_under_the_tracer():
    six = _counts_of("ch6_44k_q3")
    assert 0 < six["frontend.deinterleave_ns"] < six["frontend.busy_ns"]
    assert _counts_of("stereo_44k_q3").get("frontend.deinterleave_ns", 0) == 0


def test_residue01_counter_under_the_tracer():
    eight = _counts_of("ch8_44k_q4")
    assert 0 < eight["frontend.residue01_ns"] < eight["frontend.busy_ns"]
    assert _counts_of("stereo_44k_q3").get("frontend.residue01_ns", 0) == 0


def test_residue01_counter_in_the_trace_file(tmp_path):
    dec, audio = _decoder("ch8_44k_q4")
    profiling.reset()
    try:
        with profiling.trace(str(tmp_path)):
            dec.decode_streams_i16([audio] * 2)
    finally:
        profiling.reset()
    with open(tmp_path / profiling.TRACE_FILE) as f:
        counts = json.load(f)["lt_counts"]
    assert 0 < counts["frontend.residue01_ns"] < counts["frontend.busy_ns"]


@pytest.mark.parametrize("name", list(STREAMS))
def test_deinterleave_counter_off_without_the_tracer(monkeypatch, name):
    dec, audio = _decoder(name)
    tails = []
    lib = dec._sd._native._lib
    entry = lib.lt_decode_chunk

    def spy(*args):
        tails.append(args[-3:])
        return entry(*args)

    monkeypatch.setattr(lib, "lt_decode_chunk", spy)
    profiling.reset()
    dec.decode_streams_i16([audio] * 2)
    assert tails and all(t == (None, None, None) for t in tails)
    assert profiling.records() == []


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STREAMS))
def test_k1_route_matches_synth_torch_on_card(name):
    """The port's K1 route and IMDCT on the card against synth_torch at the
    published widths: the stream's own setup, one chunk of 64 x 64 random
    frames. Spectra agree bit for bit (the same curve table, exact integer
    coupling, one f32 product); the IMDCT output within the f32 GEMM's
    sum-order bound of synth_torch's f64 product rounded once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    _, C, steps = STREAMS[name]
    pk = native.demux_spans(_bytes(name))[0]
    ident = read_header_ident(pk[0])
    setup = read_header_setup(pk[2], ident)
    cs = compile_setup(ident, setup, device=dev)
    layout = synth_torch.layout_of(ident, setup)
    assert (cs.n0, cs.n1, cs.w_eff, cs.channels) == (256, 2048, 896, C)
    assert cs.static_coupling == steps
    S = T = 64
    fr = surround_frames(cs, layout, S, T, seed=2 ** 31 + C)
    tfr = {k: torch.from_numpy(v).to(dev) for k, v in fr.items()}
    assert synthesis_route(cs, tfr) == "k1"
    audio, _, _ = synthesize_audio_tapped(cs, tfr, "k1")
    torch.cuda.synchronize(dev)
    want = synth_torch.packet_audio(
        layout, fr["mode"].reshape(-1), fr["residue"].reshape(S * T, C, -1),
        fr["f_used"].reshape(S * T, C), fr["f1_ys"].reshape(S * T, C, -1),
        fr["f1_flags"].reshape(S * T, C, -1), device=dev)
    err = float((audio - want).abs().max())
    bound = _bound(layout, fr)
    print(f"\n{name} K1 route vs synth_torch on "
          f"{torch.cuda.get_device_name(dev)}: IMDCT max |err| {err:.6g} "
          f"(bound {bound:.6g}, peak "
          f"{float(want.abs().max()):.6g})")
    assert err <= bound + float(np.spacing(want.abs().max().item()))
