"""The port's single-stream chunk programs and the dp mesh's program on
the CPU, where a program runs its eager body on its static buffers
(``models.decoder.frames_program``, ``parallel.graphs.stream_programs``,
``decode_chunk_sharded(programs=)``).

- ``decode_frames(programs=)`` over 3 chained chunks of one stream (the
  carry a run returns passed back to the next, no copy) against the
  reference's jitted ``decode_frames`` on JAX's CPU, i16 and f32, on the
  floor kernel's route (the flagship synthetic setup) and on the generic
  route (per-mode coupling, floor 0). On the CPU the reference takes its
  XLA path (its Pallas gates read the backend), the plain reference its
  own tests hold its kernels to in interpret mode. Tolerances as in
  tests/test_torch_generic_slice.py: i16 within 1 LSB; f32 PCM and the
  carry within 2 x the fp32 sum-order bound of the spectra plus 2 ulp
  (floor 0 adds its curves' FLOOR0_RTOL); out_len, plen and started
  exact.
- Keying: two ``compile_setup``s of one setup share one program, a setup
  of the same geometry with other table values shares it and decodes
  with its own tables, another geometry makes a new one; fresh readers
  of one stream add no program to the device's owner.
- The carry rule: two ``StreamDecoder``s of one setup interleaved chunk
  by chunk, and two readers packet by packet, each bit for bit its solo
  decode.
- ``save_state`` / ``load_state``, the reader's save/restore and seek
  through programs, bit for bit as under ``graphs.eager()``.
- ``decode_frames(with_taps=True, programs=)`` (the reference's jit takes
  ``with_taps`` as a static argument): bit for bit the eager taps, PCM and
  carry over two chained chunks, and on two gate streams (a K1-eligible
  setup the taps route sends through the generic stages, and floor 0)
  within tests/test_torch_debug_taps.py's tolerances of the reference's
  jitted ``decode_frames(with_taps=True)``.
- ``decode_chunk_sharded(programs=)`` on a (2, 1) gloo CPU mesh within
  1 LSB of the unsharded decode and bit for bit its own eager run, and
  ``BatchDecoder(mesh=)`` at tp = 1 through programs, bit for bit under
  ``graphs.eager()`` (tp > 1: tests/test_torch_parallel.py).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu.models.decoder import decode_frames as jax_decode_frames
from lewton_tpu.ops.windowing import init_window_carry as jax_init_carry
from lewton_tpu_torch import _build, debug
from lewton_tpu_torch.inside_ogg import OggStreamReader, read_headers
from lewton_tpu_torch.models.decoder import (StreamDecoder, compile_setup,
                                             decode_frames,
                                             decode_frames_core,
                                             synthesis_route)
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.parallel import graphs
from lewton_tpu_torch.parallel.launch import spawn
from lewton_tpu_torch.testing import synthetic_frames, synthetic_headers
from test_torch_frontend import stream_bytes
from test_torch_generic_slice import (_close_f32, _close_i16, _frames,
                                      _packets, _pcm_bound, _setups,
                                      _stream_bytes, _synthetic)

# one intra-op thread: the suite runs a pytest worker per core
torch.set_num_threads(1)

N = 3  # chained chunks
ROUTES = {"synthetic": "k1", "f1_three_modes_coupled": "generic",
          "floor0_stereo_coupled": "generic"}


def _case(name):
    """(ident, setup, frames [N, 1, T, ...]) of one stream."""
    if name == "synthetic":
        return _synthetic(2, N, 1, 24, 10)
    ident, setup, packets = _packets(_stream_bytes(name))
    return ident, setup, _frames(ident, setup, packets, 12, N)


def _carry1(cs):
    return tuple(c[0] for c in init_window_carry(cs.channels, cs.n1 // 2, 1,
                                                 "cpu"))


def _equal(a, b) -> bool:
    """Bit for bit, f32 by its bits."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _packets_of(name):
    """(headers, audio packets) of a committed stream."""
    rdr = PacketReader(stream_bytes(name))
    headers, serial = read_headers(rdr)
    pcks = []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial == serial:
            pcks.append(p.data)
    return headers, pcks


@pytest.mark.parametrize("with_i16", [True, False])
@pytest.mark.parametrize("name", sorted(ROUTES))
def test_decode_frames_program_against_reference(name, with_i16):
    ident, setup, frs = _case(name)
    jcs, cs = _setups(ident, setup)
    W = cs.n1 // 2
    programs = graphs.Programs()
    jcarry, carry = jax_init_carry(cs.channels, W), _carry1(cs)
    bound = _pcm_bound(cs, {k: torch.from_numpy(v) for k, v in frs.items()})
    for n in range(N):
        fr = {k: v[n, 0] for k, v in frs.items()}
        (j_out, j_len), jcarry = jax_decode_frames(
            jcs, {k: jnp.asarray(v) for k, v in fr.items()}, jcarry,
            with_i16=with_i16)
        tfr = {k: torch.from_numpy(v) for k, v in fr.items()}
        assert synthesis_route(cs, {k: v[None] for k, v in tfr.items()}) \
            == ROUTES[name]
        (out, out_len), carry = decode_frames(cs, tfr, carry, with_i16,
                                              programs=programs)
        (prog,) = programs.programs.values()
        assert carry is prog.carry  # the next run takes it with no copy
        if with_i16:
            assert tuple(out.shape) == np.asarray(j_out).shape
            _close_i16(j_out, out)
        else:
            _close_f32(j_out, out, bound)
        assert np.array_equal(np.asarray(j_len), out_len.numpy())
        assert np.array_equal(np.asarray(jcarry[1]), carry[1].numpy())
        assert np.array_equal(np.asarray(jcarry[2]), carry[2].numpy())
        _close_f32(jcarry[0], carry[0], bound)
    assert int(carry[1]) > 0


def _modified(cs):
    """A setup of ``cs``'s geometry with other table values: the IMDCT and
    DCT-IV matrices halved."""
    return dataclasses.replace(cs, **{k: getattr(cs, k) * 0.5 for k in (
        "imdct_m0", "imdct_m1", "dct4_m0", "dct4_m1")})


def test_programs_keyed_by_geometry():
    """Two compile_setups of one setup take one program (the second's
    tables loaded into the owner's static copy); a setup of that geometry
    with other tables takes it too and decodes with its own tables, bit
    for bit its eager decode, and so does the first again after it; a
    setup of another geometry makes a second program."""
    headers = synthetic_headers(2, 8, 11)
    a, b = (compile_setup(*headers, device="cpu") for _ in range(2))
    c = _modified(a)
    fr = {k: torch.from_numpy(v[0])
          for k, v in synthetic_frames(a, T=16, S=1, seed=4).items()}
    programs = graphs.Programs()
    want = {}
    for name, cs in (("a", a), ("b", b), ("c", c), ("a", a)):
        (out, ln), carry = decode_frames(cs, fr, _carry1(cs), True,
                                         programs=programs)
        got = [out.clone(), ln.clone()] + [x.clone() for x in carry]
        (e_out, e_ln), e_carry = decode_frames(cs, fr, _carry1(cs), True)
        assert all(_equal(g, e) for g, e in zip(
            got, [e_out, e_ln, *e_carry]))
        want.setdefault(name, got)
        assert all(_equal(g, w) for g, w in zip(got, want[name]))
        assert programs.stats()["programs"] == 1
    assert not _equal(want["a"][0], want["c"][0])
    mono = compile_setup(*synthetic_headers(1, 8, 11), device="cpu")
    frm = {k: torch.from_numpy(v[0])
           for k, v in synthetic_frames(mono, T=16, S=1, seed=4).items()}
    decode_frames(mono, frm, _carry1(mono), True, programs=programs)
    assert programs.stats()["programs"] == 2


def test_fresh_readers_share_the_devices_programs():
    """A second fresh reader of a stream makes no program in the CPU's
    owner (its setup is compiled again, its geometry is the same); the
    per-packet loop runs a program of T = 1 (made at its first use in the
    process), and a fresh reader's per-packet loop makes none."""
    owner = graphs.stream_programs("cpu")
    data = stream_bytes("stereo_44k_q3")
    first = OggStreamReader(data, device="cpu").read_all_i16()
    before = owner.stats()["programs"]
    again = OggStreamReader(data, device="cpu").read_all_i16()
    assert owner.stats()["programs"] == before
    assert np.array_equal(first, again)
    r = OggStreamReader(data, device="cpu")
    while r.read_dec_packet() is not None:
        pass
    # the per-packet program (T = 1) of the setup's geometry, made here or
    # by an earlier test of this process
    one = owner.stats()["programs"]
    assert one - before <= 1
    static = tuple(getattr(r._dec.cs, k) for k in r._dec.cs._static_names)
    assert any(p.key[1] == static and p.inputs["mode"].shape == (1,)
               for p in owner.programs.values())
    r = OggStreamReader(data, device="cpu")
    r.read_dec_packet()
    assert owner.stats()["programs"] == one
    assert graphs.stream_programs(torch.device("cpu")) is owner


def test_stream_decoders_interleaved_chunk_by_chunk():
    """Two StreamDecoders of one setup, chunk by chunk in turn on other
    packets, each bit for bit its solo decode: each copies the owner's
    carry into its own after every chunk."""
    headers, pcks = _packets_of("stereo_44k_q3")
    streams = (pcks[:40], pcks[17:57])

    def dec():
        return StreamDecoder(headers.ident, headers.setup, chunk=8,
                             frontend="python", device="cpu")

    solo = [dec().decode_packets_i16(s) for s in streams]
    decs = [dec(), dec()]
    got = [[], []]
    for i in range(0, 40, 8):
        for j in (0, 1):
            got[j] += decs[j].decode_packets_i16(streams[j][i:i + 8])
    for j in (0, 1):
        assert len(got[j]) == len(solo[j]) == 40
        assert all(np.array_equal(g, s) for g, s in zip(got[j], solo[j]))
        assert sum(g.shape[1] for g in got[j]) > 0


def _packet_loop(rdr, n=None) -> list:
    outs = []
    while (n is None or len(outs) < n) and \
            (p := rdr.read_dec_packet()) is not None:
        outs.append(p)
    return outs


def test_readers_interleaved_packet_by_packet():
    """Two readers of one setup, the second 7 packets ahead, packet by
    packet in turn, each bit for bit its solo run."""
    datas = (stream_bytes("stereo_44k_q3"), stream_bytes("stereo_44k_q3"))
    solo = [_packet_loop(OggStreamReader(d, device="cpu")) for d in datas]
    rdrs = [OggStreamReader(d, device="cpu") for d in datas]
    _packet_loop(rdrs[1], 7)  # the second runs 7 packets ahead
    got = [[], solo[1][:7]]
    done = [False, False]
    while not all(done):
        for j in (0, 1):
            if not done[j]:
                p = rdrs[j].read_dec_packet()
                done[j] = p is None
                if p is not None:
                    got[j].append(p)
    for j in (0, 1):
        assert len(got[j]) == len(solo[j])
        assert all(np.array_equal(g, s) for g, s in zip(got[j], solo[j]))


def test_save_load_and_seek_through_programs():
    """StreamDecoder.save_state / load_state (a state restored after a
    decode of other packets replays the same samples), the reader's
    save_decode_state / restore_decode_state (the carry and granule only:
    the reader reads on from where it is) and a seek, through programs,
    bit for bit as the same calls under graphs.eager()."""
    headers, pcks = _packets_of("stereo_44k_q3")
    data = stream_bytes("stereo_44k_q3")

    def run():
        sd = StreamDecoder(headers.ident, headers.setup, chunk=8,
                           frontend="python", device="cpu")
        res = sd.decode_packets_i16(pcks[:12])
        state = sd.save_state()
        res += sd.decode_packets_i16(pcks[12:20])
        sd.reset()
        sd.decode_packets_i16(pcks[30:34])  # a carry of other packets
        sd.load_state(state)
        res += sd.decode_packets_i16(pcks[12:20])
        r = OggStreamReader(data, device="cpu")
        res += _packet_loop(r, 10)
        st = r.save_decode_state()
        res += _packet_loop(r, 5)
        r.restore_decode_state(st)
        res += _packet_loop(r, 5)
        r.seek_absgp_pg(40000)
        res += _packet_loop(r, 6)
        return res

    got = run()
    with graphs.eager():
        want = run()
    assert len(got) == len(want) == 12 + 8 + 8 + 10 + 5 + 5 + 6
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    # the decoder's restored state replays its 8 packets bit for bit
    assert np.array_equal(np.concatenate(got[12:20], 1),
                          np.concatenate(got[20:28], 1))


def test_with_taps_through_programs():
    """decode_frames(with_taps=True, programs=) over two chained chunks
    (each path's carry passed back to it): the taps, the f32 PCM, out_len
    and the carry bit for bit the eager run's; one program, whose taps are
    its static buffers of the eager taps' shapes."""
    cs = compile_setup(*synthetic_headers(2, 8, 11), device="cpu")
    programs = graphs.Programs()
    carry = e_carry = _carry1(cs)
    for seed in (1, 2):
        fr = {k: torch.from_numpy(v[0])
              for k, v in synthetic_frames(cs, T=6, S=1, seed=seed).items()}
        (pcm, ln, taps), carry = decode_frames(cs, fr, carry, with_taps=True,
                                               programs=programs)
        (e_pcm, e_ln, e_taps), e_carry = decode_frames(cs, fr, e_carry,
                                                       with_taps=True)
        (prog,) = programs.programs.values()
        assert carry is prog.carry and taps is prog.outputs[2]
        assert tuple(taps) == debug.TAP_NAMES == tuple(e_taps)
        assert all(_equal(taps[k], e_taps[k]) for k in taps)
        assert all(_equal(a, b) for a, b in zip(
            (pcm, ln) + carry, (e_pcm, e_ln) + e_carry))
    assert int(ln.sum()) > 0 and float(taps["post_mdct"].abs().max()) > 0


#: tests/test_torch_debug_taps.py's tolerances: the residue and pre-MDCT
#: taps, and the post-MDCT tap
TAP_ATOL, TAP_ATOL_POST = 2e-6, 1e-4


@pytest.mark.parametrize("name", ["stereo_44k_q3", "f0_coupled_stereo"])
def test_taps_program_against_reference(name):
    """decode_frames(with_taps=True, programs=) over 2 chained chunks of a
    corpus stream against the reference's jitted decode_frames(with_taps=
    True) on JAX's CPU: each tap within tests/test_torch_debug_taps.py's
    tolerances, out_len and the carry's plen and started exact, the f32
    PCM within the sum-order bound."""
    ident, setup, packets = _packets(stream_bytes(name))
    frs = _frames(ident, setup, packets, 12, 2)
    jcs, cs = _setups(ident, setup)
    programs = graphs.Programs()
    jcarry, carry = jax_init_carry(cs.channels, cs.n1 // 2), _carry1(cs)
    bound = _pcm_bound(cs, {k: torch.from_numpy(v) for k, v in frs.items()})
    for n in range(2):
        fr = {k: v[n, 0] for k, v in frs.items()}
        (j_out, j_len, j_taps), jcarry = jax_decode_frames(
            jcs, {k: jnp.asarray(v) for k, v in fr.items()}, jcarry,
            with_taps=True)
        (out, out_len, taps), carry = decode_frames(
            cs, {k: torch.from_numpy(v) for k, v in fr.items()}, carry,
            with_taps=True, programs=programs)
        for k in debug.TAP_NAMES:
            want = np.asarray(j_taps[k])
            assert taps[k].shape == want.shape, k
            tol = TAP_ATOL_POST if k == "post_mdct" else TAP_ATOL
            np.testing.assert_allclose(taps[k].numpy(), want, atol=tol,
                                       rtol=0, err_msg=k)
        _close_f32(j_out, out, bound)
        assert np.array_equal(np.asarray(j_len), out_len.numpy())
        assert np.array_equal(np.asarray(jcarry[1]), carry[1].numpy())
        assert np.array_equal(np.asarray(jcarry[2]), carry[2].numpy())
    assert programs.stats()["programs"] == 1 and int(carry[1]) > 0


#: decode_chunk_sharded on synthetic frames at (2, 1): setup, S, T, chunks
SHARDED = {"setup": [2, 8, 11], "S": 4, "T": 8, "N": 2, "seed": 5}


def test_sharded_programs_on_a_dp_mesh(tmp_path):
    """(2, 1) gloo CPU ranks: decode_chunk_sharded(programs=) i16 within
    1 LSB of the unsharded decode here (lengths and plen/started exact)
    and bit for bit its own eager run on every rank, one program a rank;
    BatchDecoder(mesh=) at tp = 1 through its transfer slots' programs,
    bit for bit its rerun under graphs.eager() (on the CPU no program is
    captured: ``graphed`` is false)."""
    _build.load_host_library()
    spec = tmp_path / "spec.json"
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "torch_gate", "stereo_44k_q3.ogg")
    spec.write_text(json.dumps({"cases": [
        dict(SHARDED, name="chunk", kind="chunk", with_i16=True,
             programs=True),
        {"name": "streams", "kind": "streams", "file": path,
         "lengths": [40, 33], "chunk": 16, "i16": True, "eager": True}]}))
    job = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_parallel_jobs.py") + ":cases"
    spawn(2, 1, job, tmp_path, "gloo", "cpu", spec, timeout=60.0,
          collective_timeout=30.0)
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(2)]
    with np.load(tmp_path / "rank0.npz") as z:
        got = {k: z[k] for k in z.files}
    for r in recs:
        chunk = r["cases"]["chunk"]
        assert chunk["programs"]["programs"] == 1
        assert chunk["eager"]["eager_maxdiff"] == 0.0
        assert chunk["eager"]["digest_gathered"] == chunk["digest_gathered"]
        streams = r["cases"]["streams"]
        assert streams["graphed"] is False and chunk["graphed"] is False
        assert streams["programs"]["programs"] >= 1
        assert streams["eager"]["eager_maxdiff"] == 0.0
        assert streams["eager"]["digest_gathered"] == \
            streams["digest_gathered"]
    cs = compile_setup(*synthetic_headers(*SHARDED["setup"]), device="cpu")
    S = SHARDED["S"]
    carry = init_window_carry(cs.channels, cs.n1 // 2, S, "cpu")
    for i in range(SHARDED["N"]):
        fr = {k: torch.from_numpy(v) for k, v in synthetic_frames(
            cs, T=SHARDED["T"], S=S, seed=SHARDED["seed"] + i).items()}
        (out, ln), carry = decode_frames_core(cs, fr, carry, with_i16=True)
        d = np.abs(got[f"chunk__out{i}_0"].astype(np.int32)
                   - out.numpy().astype(np.int32))
        assert got[f"chunk__out{i}_0"].shape == tuple(out.shape)
        assert d.max() <= 1
        assert np.array_equal(got[f"chunk__out{i}_1"], ln.numpy())
    for j in (1, 2):
        assert np.array_equal(got[f"chunk__carry_{j}"], carry[j].numpy())
    assert got["streams__stream0"].shape[0] > 0
