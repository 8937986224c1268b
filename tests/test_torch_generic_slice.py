"""The port's whole decode dispatch against the reference on the CPU.

``lewton_tpu_torch.parallel.batch.decode_chunks_scan`` against the
reference's, with ``with_i16=False`` (f32 PCM) and ``with_i16=True``, on
the setups that take the floor kernel (the flagship synthetic setup and
corpus files) and on those that take the generic stages: floor 0 (three
streams of tools/floor0_stream.py), per-mode coupling
(``f1_three_modes_coupled`` of tools/craft.py) and 10 channels. Frames
are packed by the reference's ``pack_frames`` on the test side. Also:
those generic-path streams within +/-2 LSB of libvorbis end to end,
``with_taps``, ``compact_cap``, and the opt-in K3 path.

Tolerances:
- i16 within 1 LSB (the GEMMs sum in different orders; the reference's own
  kernel and XLA paths differ by that much, tests/test_overlap_kernel.py);
- f32 PCM within 2 x the fp32 sum-order bound of the spectra
  (ops/imdct.sum_order_bound; the carry brings the previous chunk's
  error) plus 2 ulp of |out| (XLA may contract the window mix into an
  FMA). For floor 0 the bound adds FLOOR0_RTOL of the spectra's row sum:
  the curves themselves differ by that much (tests/test_torch_generic.py);
- out_len, plen and started exact; the carried right region within the
  same bound as the PCM.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu.audio import decode_packet_entropy
from lewton_tpu.inside_ogg import read_headers
from lewton_tpu.models.decoder import compact_invalid_frames, pack_frames
from lewton_tpu.models.decoder import compile_setup as jax_compile_setup
from lewton_tpu.models.decoder import decode_frames as jax_decode_frames
from lewton_tpu.ogg import PacketReader
from lewton_tpu.ops.windowing import init_window_carry as jax_init_carry
from lewton_tpu.parallel.batch import decode_chunk_batch as jax_chunk
from lewton_tpu.parallel.batch import decode_chunks_scan as jax_scan
from lewton_tpu.testing import synthetic_frames, synthetic_headers
from lewton_tpu_torch import testing as ttesting
from lewton_tpu_torch.models import decoder as tdec
from lewton_tpu_torch.models.decoder import compile_setup as tcompile_setup
from lewton_tpu_torch.models.decoder import (decode_frames, from_jax_setup,
                                             precompute_brackets,
                                             synthesis_route,
                                             synthesize_spectra_tapped)
from lewton_tpu_torch.ops.imdct import sum_order_bound
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.parallel.batch import (decode_chunk_batch,
                                             decode_chunks_scan)
from test_torch_generic import FLOOR0_RTOL
from test_torch_setup import carry_across
from tools import floor0_stream
from tools.craft import VARIANTS, build_stream

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

#: the floor-0 streams: mono (residue type 1), stereo coupled (type 2),
#: mono residue type 2
FLOOR0 = {"floor0_mono": {},
          "floor0_stereo_coupled": {"channels": 2, "submaps": 1,
                                    "residue_type": 2, "coupling": True},
          "floor0_type2": {"residue_type": 2}}
GENERIC = sorted(FLOOR0) + ["f1_three_modes_coupled"]


def _stream_bytes(name):
    if name in FLOOR0:
        return floor0_stream.build_stream(**FLOOR0[name])
    return build_stream(VARIANTS[name])


def _packets(data):
    rdr = PacketReader(data)
    headers, serial = read_headers(rdr)
    packets = []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial == serial:
            packets.append(p.data)
    return headers.ident, headers.setup, packets


def _frames(ident, setup, packets, T, N):
    """N chunks of T packets of one stream, [N, 1, T, ...] (the last chunk
    padded with invalid slots)."""
    jcs = jax_compile_setup(ident, setup)
    chunks = []
    for n in range(N):
        plans = [decode_packet_entropy(ident, setup, p)
                 for p in packets[n * T:(n + 1) * T]]
        fr = {k: v[None] for k, v in pack_frames(jcs, plans, T).items()}
        compact_invalid_frames(fr)
        chunks.append(fr)
    return {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}


def _synthetic(channels, N, S, T, seed):
    ident, setup = synthetic_headers(channels, 8, 11)
    jcs = jax_compile_setup(ident, setup)
    rng = np.random.default_rng(seed)
    chunks = []
    for n in range(N):
        fr = synthetic_frames(jcs, T=T, S=S, seed=seed + n)
        fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.9
        for s in range(S):
            fr["valid"][s, rng.integers(T // 2, T + 1):] = False
        chunks.append(fr)
    return ident, setup, {k: np.stack([c[k] for c in chunks])
                          for k in chunks[0]}


def _case(name, corpus_dir=None):
    """(ident, setup, frames [N, S, T, ...]) of a named input."""
    if name == "synthetic":
        return _synthetic(2, 2, 2, 24, 10)
    if name == "synthetic_10ch":
        return _synthetic(10, 2, 2, 16, 20)
    if name in GENERIC:  # 40 packets: the whole stream in two chunks
        ident, setup, packets = _packets(_stream_bytes(name))
        return ident, setup, _frames(ident, setup, packets, 20, 2)
    with open(os.path.join(corpus_dir, name + ".ogg"), "rb") as f:
        ident, setup, packets = _packets(f.read())
    T = 24 if name.startswith("stereo") else 16
    return ident, setup, _frames(ident, setup, packets[:2 * T], T, 2)


def _setups(ident, setup):
    jcs = jax_compile_setup(ident, setup)
    return jcs, from_jax_setup(*carry_across(jcs), device="cpu")


def _jax_carry(C, W, S):
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                        jax_init_carry(C, W))


def _pcm_bound(cs, frs):
    """Largest difference the two frameworks' f32 PCM and carry may show:
    2 x the sum-order bound of the spectra over all chunks, plus, for
    floor 0, FLOOR0_RTOL of their largest row sum."""
    worst, l1 = 0.0, 0.0
    for i in range(frs["mode"].shape[0]):
        spectra, _, _ = synthesize_spectra_tapped(
            cs, {k: v[i] for k, v in frs.items()})
        worst = max(worst, sum_order_bound(spectra))
        l1 = max(l1, float(spectra.abs().to(torch.float64).sum(-1).max()))
    return 2.0 * worst + (FLOOR0_RTOL * l1 if cs.has_floor0 else 0.0)


def _close_f32(want, got, bound):
    want = np.asarray(want, np.float32)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    tol = bound + 2.0 * np.spacing(np.abs(want))
    d = np.abs(want.astype(np.float64) - got)
    assert (d <= tol).all(), f"max |d| {d.max()} (bound {bound})"


def _close_i16(want, got):
    d = np.abs(np.asarray(want, np.int32) - got.numpy().astype(np.int32))
    assert d.max() <= 1, f"{d.max()} LSB over {int((d > 0).sum())} samples"


def _compare(ident, setup, frs, with_i16):
    jcs, cs = _setups(ident, setup)
    N, S = frs["mode"].shape[:2]
    W = cs.n1 // 2
    (j_out, j_len), (j_pwr, j_plen, j_started) = jax_scan(
        jcs, {k: jnp.asarray(v) for k, v in frs.items()},
        _jax_carry(cs.channels, W, S), with_i16=with_i16)
    tfrs = {k: torch.from_numpy(v) for k, v in frs.items()}
    (out, out_len), (pwr, plen, started) = decode_chunks_scan(
        cs, tfrs, init_window_carry(cs.channels, W, S, "cpu"), with_i16=with_i16)
    bound = _pcm_bound(cs, tfrs)
    if with_i16:
        assert tuple(out.shape) == np.asarray(j_out).shape
        _close_i16(j_out, out)
    else:
        _close_f32(j_out, out, bound)
    assert np.array_equal(np.asarray(j_len), out_len.numpy())
    assert np.array_equal(np.asarray(j_plen), plen.numpy())
    assert np.array_equal(np.asarray(j_started), started.numpy())
    _close_f32(j_pwr, pwr, bound)
    return out, out_len


@pytest.mark.parametrize("with_i16", [False, True])
@pytest.mark.parametrize("name", ["synthetic", "stereo_44k_q3", "ch6_44k_q3",
                                  *GENERIC, "synthetic_10ch"])
def test_generic_slice_matches_reference(corpus_dir, name, with_i16):
    ident, setup, frs = _case(name, corpus_dir)
    _, out_len = _compare(ident, setup, frs, with_i16)
    assert int(out_len.sum()) > 0


@pytest.mark.parametrize("name", GENERIC)
def test_generic_streams_match_libvorbis(tmp_path, name):
    """The whole stream through the port's i16 path, within +/-2 LSB of
    libvorbis (the samples past the last granule are trimmed there)."""
    from tools import vorbisref

    data = _stream_bytes(name)
    path = tmp_path / f"{name}.ogg"
    path.write_bytes(data)
    golden = vorbisref.decode_file_i16(str(path))
    ident, setup, packets = _packets(data)
    frs = _frames(ident, setup, packets, 20, 2)
    assert len(packets) == 40
    _, cs = _setups(ident, setup)
    (out, lens), _ = decode_chunks_scan(
        cs, {k: torch.from_numpy(v) for k, v in frs.items()},
        init_window_carry(cs.channels, cs.n1 // 2, 1, "cpu"), with_i16=True)
    C, outw = cs.channels, 3 * cs.n1 // 4
    pcm = np.concatenate(
        [out[n, 0, t].numpy().reshape(C, outw)[:, :int(lens[n, 0, t])]
         for n in range(out.shape[0]) for t in range(out.shape[2])], 1).T
    assert pcm.shape[0] >= golden.shape[0] > 0 and pcm.shape[1] == C
    d = np.abs(pcm[:golden.shape[0]].astype(np.int32) - golden.astype(np.int32))
    assert d.max() <= 2, f"max diff {d.max()}"
    assert np.abs(golden).max() > 10


@pytest.mark.parametrize("name", ["floor0_stereo_coupled",
                                  "f1_three_modes_coupled", "synthetic_10ch",
                                  "synthetic"])
def test_taps_match_reference(name):
    """``with_taps`` through the single-stream entry: the reference's tap
    names and values (first chunk of the first stream)."""
    ident, setup, frs = _case(name)
    jcs, cs = _setups(ident, setup)
    fr = {k: v[0, 0] for k, v in frs.items()}
    W = cs.n1 // 2
    (j_out, j_len, j_taps), j_carry = jax_decode_frames(
        jcs, {k: jnp.asarray(v) for k, v in fr.items()},
        jax_init_carry(cs.channels, W), with_taps=True)
    (out, out_len, taps), carry = decode_frames(
        cs, {k: torch.from_numpy(v) for k, v in fr.items()},
        tuple(c[0] for c in init_window_carry(cs.channels, W, 1, "cpu")),
        with_taps=True)
    assert sorted(taps) == sorted(j_taps)
    for k in ("residue_pre_inverse", "residue_post_inverse"):
        assert np.asarray(j_taps[k]).tobytes() == taps[k].numpy().tobytes(), k
    spectra = taps["pre_mdct"]
    if cs.has_floor0:
        _close_f32(j_taps["pre_mdct"], spectra,
                   FLOOR0_RTOL * float(spectra.abs().max()))
    else:
        assert np.asarray(j_taps["pre_mdct"]).tobytes() == \
            spectra.numpy().tobytes()
    bound = _pcm_bound(cs, {k: torch.from_numpy(v[:1]) for k, v in frs.items()})
    _close_f32(j_taps["post_mdct"], taps["post_mdct"], bound)
    _close_f32(j_out, out, bound)
    assert np.array_equal(np.asarray(j_len), out_len.numpy())
    _close_f32(j_carry[0], carry[0], bound)
    assert int(j_carry[1]) == int(carry[1])
    assert bool(j_carry[2]) == bool(carry[2])


@pytest.mark.parametrize("name", ["synthetic", "floor0_stereo_coupled"])
def test_compact_cap_matches_reference(name):
    ident, setup, frs = _case(name)
    jcs, cs = _setups(ident, setup)
    fr = {k: v[0] for k, v in frs.items()}
    S, T = fr["mode"].shape
    W = cs.n1 // 2
    cap = T * cs.n1 + cs.n1
    (j_pcm, j_total, j_len), _ = jax_chunk(
        jcs, {k: jnp.asarray(v) for k, v in fr.items()},
        _jax_carry(cs.channels, W, S), compact_cap=cap)
    (pcm, total, out_len), _ = decode_chunk_batch(
        cs, {k: torch.from_numpy(v) for k, v in fr.items()},
        init_window_carry(cs.channels, W, S, "cpu"), compact_cap=cap)
    assert pcm.shape == (S, cap, cs.channels) and pcm.dtype == torch.int16
    _close_i16(j_pcm, pcm)
    assert np.array_equal(np.asarray(j_total), total.numpy())
    assert np.array_equal(np.asarray(j_len), out_len.numpy())
    assert int(total.min()) > 0


@pytest.mark.parametrize("with_i16", [False, True])
@pytest.mark.parametrize("name", ["synthetic", "synthetic_10ch"])
def test_fused_synth_path_matches_reference(monkeypatch, name, with_i16):
    """USE_FUSED_SYNTH_KERNEL on frames that carry precomputed brackets
    takes K3 (its plain version on the CPU) at any channel count, whose
    spectra equal the generic stages' and K1's bit for bit, so the decode
    equals the K1 route's (10 channels: the generic route's), which
    test_generic_slice_matches_reference holds to the reference."""
    ident, setup, frs = _case(name)
    _, cs = _setups(ident, setup)
    tfrs = {k: torch.from_numpy(v) for k, v in frs.items()}
    carry = init_window_carry(cs.channels, cs.n1 // 2, frs["mode"].shape[1],
                              "cpu")
    want = decode_chunks_scan(cs, tfrs, carry, with_i16=with_i16)
    monkeypatch.setattr(tdec, "USE_FUSED_SYNTH_KERNEL", True)
    got = decode_chunks_scan(cs, precompute_brackets(cs, tfrs), carry,
                             with_i16=with_i16)
    assert torch.equal(want[0][0], got[0][0])
    assert torch.equal(want[0][1], got[0][1])
    fr = precompute_brackets(cs, {k: v[0] for k, v in tfrs.items()})
    assert synthesis_route(cs, fr) == "k3"
    spectra, _, taps = synthesize_spectra_tapped(cs, fr)
    monkeypatch.setattr(tdec, "USE_FUSED_SYNTH_KERNEL", False)
    generic, _, _ = synthesize_spectra_tapped(cs, fr)
    assert taps == {} and torch.equal(spectra, generic)


@pytest.mark.parametrize("kw,fused,brackets,allow_fused,want", [
    ({}, False, False, True, "k1"),
    ({}, True, False, True, "k1"),
    ({}, True, True, True, "k3"),
    ({}, False, True, True, "generic"),
    ({}, True, True, False, "generic"),
    ({"channels": 10}, False, False, True, "generic"),
    ({"channels": 10}, True, False, True, "k3"),
    ({"per_mode_coupling": True}, True, True, True, "generic"),
    ({"floor0": True}, True, False, True, "generic"),
])
def test_synthesis_route(monkeypatch, kw, fused, brackets, allow_fused, want):
    """The one routing decision, as the reference's
    ``_synthesize_spectra_tapped`` makes it: K1 when its gate admits the
    frames; else K3 under USE_FUSED_SYNTH_KERNEL for a floor-1 setup with
    static coupling, at any channel count; else the generic stages."""
    cs = tcompile_setup(*ttesting.synthetic_headers(**kw), device="cpu")
    make = (ttesting.synthetic_floor0_frames if cs.has_floor0
            else ttesting.synthetic_frames)
    fr = {k: torch.from_numpy(v) for k, v in make(cs, T=4, S=2).items()}
    if brackets:
        fr = precompute_brackets(cs, fr)
    monkeypatch.setattr(tdec, "USE_FUSED_SYNTH_KERNEL", fused)
    assert synthesis_route(cs, fr, allow_fused) == want
