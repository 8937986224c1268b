"""K2's audio form and the caller-supplied IMDCT path of the port against
the reference on the CPU.

``decode_frames_core(imdct=<a caller's transform>)`` takes the generic
stages (K1 and K3 are off for that chunk, as in the reference), then the
caller's IMDCT, then ``finish_stream``: on the i16 path the overlap
kernel's audio form (the reference's ``_kernel``), which takes the IMDCT
output itself, channel-major [C, rows, n] or [rows, C, n], either
un-selected (long, short) or pre-selected. This is the hook the
reference's tensor-parallel IMDCT plugs into
(lewton_tpu/parallel/batch.py:55-63, 92-127).

Tolerances, each with its reason:
- K2's audio form, plain, against the reference's interpret-mode kernel:
  i16 within 1 LSB (the reference's own kernel and XLA paths differ by
  that much, tests/test_overlap_kernel.py), out_len, plen and started
  exact, the carried right region bit-identical (copied data); the
  un-selected and pre-selected forms of the same audio bit-identical;
- the caller-IMDCT slice against the reference's
  ``decode_frames_core(imdct=...)`` (whose CPU tail is its XLA i16 path):
  i16 within 1 LSB, f32 PCM and the carry within the bound of
  tests/test_torch_generic_slice.py (2 x the fp32 sum-order bound of the
  spectra, + FLOOR0_RTOL for floor 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu.ops import imdct as jim
from lewton_tpu.ops import windowing as jwin
from lewton_tpu.parallel import batch as jbatch
from lewton_tpu_torch import testing as ttesting
from lewton_tpu_torch.models import decoder as tdec
from lewton_tpu_torch.models.decoder import (finish_stream,
                                             precompute_brackets,
                                             synthesis_route,
                                             synthesize_audio)
from lewton_tpu_torch.ops import imdct as tim
from lewton_tpu_torch.ops.windowing import (init_window_carry,
                                            overlap_add_i16_kernel_batch)
from lewton_tpu_torch.parallel.batch import decode_chunks_scan
from test_torch_generic_slice import (GENERIC, _case, _close_f32, _close_i16,
                                      _jax_carry, _pcm_bound, _setups)
from test_torch_overlap import _case as _ola_case
from test_torch_overlap import _slopes

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

C = 2


def _audio_case(rng, S, T, n0, n1):
    """Random overlap operands with IMDCT audio: (bf, prev, next, valid,
    long [S*T, C, n1], short [S*T, C, n0] or None, pre-selected
    [S*T, C, n1] (short rows: their n0 samples, then zeros, as
    ``imdct_batch`` gives them), carry)."""
    bf, pf, nf, valid, _, _, carry = _ola_case(rng, S, T, n0, n1)
    long_a = (rng.standard_normal((S * T, C, n1)) * 0.5).astype(np.float32)
    short_a = (None if n0 == n1 else
               (rng.standard_normal((S * T, C, n0)) * 0.5).astype(np.float32))
    sel = long_a.copy()
    if short_a is not None:
        short_rows = bf.reshape(-1) == 0
        sel[short_rows] = 0.0
        sel[short_rows, :, :n0] = short_a[short_rows]
    return bf, pf, nf, valid, long_a, short_a, sel, carry


def _ct(a, ct_in):
    return None if a is None else (np.ascontiguousarray(a.transpose(1, 0, 2))
                                   if ct_in else a)


@pytest.mark.parametrize("T,n0,n1", [(16, 256, 2048), (37, 256, 2048),
                                     (16, 512, 512), (16, 64, 2048)])
@pytest.mark.parametrize("selected", [False, True])
@pytest.mark.parametrize("ct_in", [False, True])
def test_k2_audio_plain_matches_pallas(ct_in, selected, T, n0, n1):
    """K2's audio form, plain, against the reference's interpret-mode
    ``_kernel`` stream by stream, on un-selected (long, short) or
    pre-selected audio, [rows, C, n] or channel-major (``ct_in``)."""
    rng = np.random.default_rng(T + n0 + n1)
    S = 2
    bf, pf, nf, valid, long_a, short_a, sel, carry = _audio_case(
        rng, S, T, n0, n1)
    s0, s1 = _slopes(n0, n1)
    t = torch.from_numpy
    parts = (_ct(sel, ct_in), None) if selected else (
        _ct(long_a, ct_in), _ct(short_a, ct_in))

    def port(audio):
        return overlap_add_i16_kernel_batch(
            audio, t(bf), t(pf), t(nf), t(valid), t(s0), t(s1), n0, n1,
            tuple(t(c) for c in carry), ct_in=ct_in)

    (out, out_len), (pwr, plen, started) = port(
        tuple(None if a is None else t(a) for a in parts))
    assert out.shape == (S, T, C * 3 * n1 // 4) and out.dtype == torch.int16
    if selected:  # a bare tensor is the pre-selected form too
        (o2, _), (p2, _, _) = port(t(parts[0]))
    else:  # the same audio pre-selected gives the same samples
        (o2, _), (p2, _, _) = port((t(_ct(sel, ct_in)), None))
    assert torch.equal(out, o2) and torch.equal(pwr, p2)

    ref = jax.jit(lambda la, sa, b, p, n, vl, c: jwin.overlap_add_i16_kernel_batch(
        la if sa is None else (la, sa), b, p, n, vl, jnp.asarray(s0),
        jnp.asarray(s1), n0, n1, c, ct_in=ct_in, interpret=True))
    for s in range(S):
        rows = slice(s * T, (s + 1) * T)
        la, sa = (None if a is None else
                  jnp.asarray(a[:, rows] if ct_in else a[rows]) for a in parts)
        (r_out, r_len), (r_pwr, r_plen, r_started) = ref(
            la, sa, *(jnp.asarray(a[s]) for a in (bf, pf, nf, valid)),
            tuple(jnp.asarray(c[s]) for c in carry))
        d = np.abs(np.asarray(r_out, np.int32) - out[s].numpy().astype(np.int32))
        assert d.max() <= 1, f"stream {s}: {d.max()} LSB"
        assert np.array_equal(np.asarray(r_len), out_len[s].numpy())
        assert np.asarray(r_pwr).tobytes() == pwr[s].numpy().tobytes()
        assert int(r_plen) == int(plen[s]) and bool(r_started) == bool(started[s])


def _port_imdct(spectra, bf, m0, m1):
    """A caller's IMDCT for the port: the stock transform, but not the
    stock function, so the chunk takes the caller-IMDCT route."""
    return tim.imdct_batch(spectra, bf, m0, m1)


def _port_imdct_parts(spectra, bf, m0, m1):
    """A caller's IMDCT that leaves the blocksize select to the overlap
    kernel: un-selected (long, short) outputs."""
    long_a, short_a = tim.imdct_batch_parts(spectra, m0, m1)
    return long_a if short_a is None else (long_a, short_a)


def _jax_imdct(spectra, bf, m0, m1):
    return jim.imdct_batch(spectra, bf, m0, m1)


def _ref_chunks(jcs, frs, with_i16):
    """The reference's decode_frames_core(imdct=_jax_imdct) over the
    stream batch (its ``_batch_core``), chunk by chunk."""
    N, S = frs["mode"].shape[:2]
    fn = jax.jit(lambda fr, c: jbatch._batch_core(
        jcs, fr, c, with_i16, None, imdct=_jax_imdct))
    carry = _jax_carry(jcs.channels, jcs.n1 // 2, S)
    outs, lens = [], []
    for n in range(N):
        (out, out_len), carry = fn({k: jnp.asarray(v[n])
                                    for k, v in frs.items()}, carry)
        outs.append(np.asarray(out))
        lens.append(np.asarray(out_len))
    return np.stack(outs), np.stack(lens), carry


@pytest.mark.parametrize("name,with_i16", [
    *((n, True) for n in ["synthetic", "synthetic_10ch", *GENERIC,
                          "stereo_44k_q3", "ch6_44k_q3", "mono_16k_q3",
                          "mono_11k_q0"]),
    ("synthetic", False), ("stereo_44k_q3", False)])
def test_caller_imdct_slice_matches_reference(monkeypatch, corpus_dir, name,
                                              with_i16):
    ident, setup, frs = _case(name, corpus_dir)
    jcs, cs = _setups(ident, setup)
    N, S = frs["mode"].shape[:2]
    tfrs = {k: torch.from_numpy(v) for k, v in frs.items()}
    bound = _pcm_bound(cs, tfrs)
    calls = []

    def imdct(*a):
        calls.append(1)
        return _port_imdct(*a)

    def no_kernel_route(*a, **k):
        raise AssertionError("a caller's IMDCT must not take K1 or K3")

    monkeypatch.setattr(tdec, "floor_stage", no_kernel_route)
    monkeypatch.setattr(tdec, "fused_floor_couple", no_kernel_route)
    carry = init_window_carry(cs.channels, cs.n1 // 2, S, "cpu")
    (out, out_len), (pwr, plen, started) = decode_chunks_scan(
        cs, tfrs, carry, with_i16=with_i16, imdct=imdct)
    assert len(calls) == N
    j_out, j_len, (j_pwr, j_plen, j_started) = _ref_chunks(jcs, frs, with_i16)
    if with_i16:
        assert tuple(out.shape) == j_out.shape
        _close_i16(j_out, out)
        # un-selected parts from the caller: the same samples, bit for bit
        (o2, l2), c2 = decode_chunks_scan(cs, tfrs, carry, with_i16=True,
                                          imdct=_port_imdct_parts)
        assert torch.equal(out, o2) and torch.equal(out_len, l2)
        assert all(torch.equal(a, b) for a, b in zip((pwr, plen, started), c2))
    else:
        _close_f32(j_out, out, bound)
    assert np.array_equal(j_len, out_len.numpy())
    assert np.array_equal(np.asarray(j_plen), plen.numpy())
    assert np.array_equal(np.asarray(j_started), started.numpy())
    _close_f32(j_pwr, pwr, bound)
    assert int(out_len.sum()) > 0


@pytest.mark.parametrize("kw,fused", [({}, False), ({}, True),
                                      ({"channels": 10}, True)])
def test_caller_imdct_takes_generic_route(monkeypatch, kw, fused):
    """With a caller's IMDCT the chunk takes the generic stages whatever
    the frames and USE_FUSED_SYNTH_KERNEL would otherwise pick, and
    ``synthesize_audio`` equals the stock transform's audio."""
    cs = tdec.compile_setup(*ttesting.synthetic_headers(**kw), device="cpu")
    fr = {k: torch.from_numpy(v)
          for k, v in ttesting.synthetic_frames(cs, T=6, S=2).items()}
    if fused:
        fr = precompute_brackets(cs, fr)
    monkeypatch.setattr(tdec, "USE_FUSED_SYNTH_KERNEL", fused)
    assert synthesis_route(cs, fr) != "generic"
    assert synthesis_route(cs, fr, allow_fused=False) == "generic"
    audio, bf = synthesize_audio(cs, fr, imdct=_port_imdct)
    want, want_bf = synthesize_audio(cs, fr)
    assert torch.equal(bf, want_bf) and torch.equal(audio, want)


def test_finish_stream_forms():
    """finish_stream: the overlap kernel's audio form on the i16 path
    (parts or pre-selected), the f32 overlap-add otherwise; un-selected
    parts need the kernel."""
    cs = tdec.compile_setup(*ttesting.synthetic_headers(), device="cpu")
    S, T = 2, 6
    fr = {k: torch.from_numpy(v)
          for k, v in ttesting.synthetic_frames(cs, T=T, S=S).items()}
    carry = init_window_carry(cs.channels, cs.n1 // 2, S, "cpu")
    sel, bf = synthesize_audio(cs, fr, imdct=_port_imdct)
    parts, _ = synthesize_audio(cs, fr, imdct=_port_imdct_parts)
    (a, la), ca = finish_stream(cs, sel, bf, fr, carry, with_i16=True)
    (b, lb), cb = finish_stream(cs, parts, bf, fr, carry, with_i16=True)
    assert a.shape == (S, T, cs.channels * 3 * cs.n1 // 4)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert torch.equal(ca[0], cb[0])
    (f, lf), _ = finish_stream(cs, sel, bf, fr, carry)
    assert f.shape == (S, T, cs.channels, 3 * cs.n1 // 4)
    assert torch.equal(lf, la)
    i16 = torch.trunc(torch.clamp(f * 32768.0, -32768.0, 32767.0))
    assert (i16.to(torch.int32).reshape(a.shape) - a.to(torch.int32)).abs().max() <= 1
    with pytest.raises(TypeError):
        finish_stream(cs, parts, bf, fr, carry)
