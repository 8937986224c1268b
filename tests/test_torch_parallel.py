"""The port's multi-device sharding against the reference's, on the CPU.

The port runs one process per rank on gloo CPU ranks
(``lewton_tpu_torch/parallel/launch.py``; the ranks import no JAX) at the
(dp, tp) meshes (2, 1), (1, 2), (2, 2) and (2, 3); each mesh is spawned
once with every case of this file (a module fixture) and the tests read the
ranks' records and rank 0's arrays. The reference runs in this process on
the conftest's 8 virtual CPU devices: ``BatchDecoder(mesh=make_mesh(dp,
tp))`` on its Python front-end and ``decode_chunk_sharded``. The ranks
join through a FileStore (no TCP port), every collective has a timeout and
the parent kills every rank once one fails or ``RANK_TIMEOUT`` passes, so
no test can hang.

Tolerances, each with its reason:
- f32 PCM and carry within 2 x the fp32 sum-order bound of the chunk's
  spectra plus 2 ulp of |out| (tests/test_torch_generic_slice.py): the tp
  split sums the IMDCT's terms in another order, as the GEMMs of the two
  frameworks do;
- i16 within 1 LSB, lengths exact: the same sum orders, and the
  reference's own kernel and XLA paths differ by 1 LSB
  (tests/test_overlap_kernel.py);
- the tp ranks of a dp block against each other, and the gathered outputs
  of every rank, bit for bit (sha256 of the arrays): they must not drift
  apart chunk by chunk;
- ``_imdct_tp`` against ``imdct_batch`` within the bound two fp32 sums of
  the same terms may differ by: 2 gamma_K max_j sum_k |s_k m_kj|;
- at tp > 1 ((2, 2), (2, 3)) ``decode_chunk_sharded(programs=)`` and
  ``BatchDecoder(mesh=)`` run their chunks as two segments around the tp
  all-reduce (``graphs.SegmentedProgram``): bit for bit their eager runs,
  and ``_imdct_tp`` split into its local part and the all-reduce bit for
  bit the unsplit one.
"""

import concurrent.futures
import contextlib
import functools
import json
import os
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from lewton_tpu.inside_ogg import read_headers as j_read_headers
from lewton_tpu.models.decoder import compile_setup as j_compile_setup
from lewton_tpu.ogg import PacketReader as JPacketReader
from lewton_tpu.ops.windowing import init_window_carry as j_init_carry
from lewton_tpu.parallel import BatchDecoder as JBatchDecoder
from lewton_tpu.parallel import decode_chunk_sharded as j_decode_sharded
from lewton_tpu.parallel import make_mesh as j_make_mesh
from lewton_tpu.testing import synthetic_frames as j_synthetic_frames
from lewton_tpu.testing import synthetic_headers as j_synthetic_headers
from lewton_tpu_torch import _build
from lewton_tpu_torch.inside_ogg import read_headers
from lewton_tpu_torch.models.decoder import (StreamDecoder, compile_setup,
                                             decode_frames_core,
                                             frames_to_device,
                                             synthesize_spectra_tapped)
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.ops.imdct import imdct_batch, sum_order_bound
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.parallel import batch as tbatch
from lewton_tpu_torch.parallel.batch import BatchDecoder, make_mesh
from lewton_tpu_torch.parallel import launch
from lewton_tpu_torch.parallel.launch import RankFailed, spawn
from lewton_tpu_torch.testing import synthetic_frames, synthetic_headers
from test_torch_decoders import _f32_bound, _lsb, _raw, _stream
from test_torch_frontend import GATE_DIR, MANIFEST

# one intra-op thread: the suite runs a pytest worker per core
torch.set_num_threads(1)

MESHES = [(2, 1), (1, 2), (2, 2), (2, 3)]
CHUNK = 16
#: stream -> packets of each stream of the batch (None: all); the second
#: stream is shorter, so one dp rank runs chunks past its own streams' end
F32_STREAMS = {"tiny_44k": [None, 7], "stereo_44k_q3": [56, 41]}
I16_STREAMS = {"stereo_44k_q3": [56, 41], "ch6_44k_q3": [None, 40]}
I16_MESHES = [(2, 1), (2, 2), (2, 3)]
#: the meshes whose chunks run as two segments around the tp all-reduce
#: (graphs.SegmentedProgram)
TP_MESHES = [(2, 2), (2, 3)]
#: decode_chunk_sharded on synthetic frames: setup, S, T, chunks, seed
SYNTH = {"setup": [2, 8, 11], "S": 4, "T": 8, "N": 2, "seed": 5}
CAP = 8192  # compact_cap of the compacted chunk case (at (2, 2))
#: seconds for a whole spawn: the slowest spawn of a full tier-1 run under
#: ``-n 6`` (8 cores) took 9.6 s, at (2, 2); 6x that, so that a hung
#: spawn costs its tests a minute, not the suite its time limit
RANK_TIMEOUT = 60.0
#: seconds for each collective of a rank (the rendezvous included): the
#: longest wait is the ranks' start-up skew, inside a whole spawn's time
COLLECTIVE_TIMEOUT = 30.0
#: the ranks' job: the launcher's cases, plus the failing and erring kinds
JOB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "_torch_parallel_jobs.py") + ":cases"


def _path(name: str) -> str:
    return os.path.join(GATE_DIR, MANIFEST["streams"][name]["ogg"])


def _spec(dp: int, tp: int) -> list:
    cases = [{"name": f"f32_{n}", "kind": "streams", "file": _path(n),
              "lengths": lens, "chunk": CHUNK}
             for n, lens in F32_STREAMS.items()]
    # at tp > 1 the i16 batch decodes run again under graphs.eager()
    eager = tp > 1
    if (dp, tp) in I16_MESHES:
        cases += [{"name": f"i16_{n}", "kind": "streams", "file": _path(n),
                   "lengths": lens, "chunk": CHUNK, "i16": True,
                   "eager": eager}
                  for n, lens in I16_STREAMS.items()]
        cases.append({"name": "i16_host", "kind": "streams",
                      "file": _path("stereo_44k_q3"),
                      "lengths": I16_STREAMS["stereo_44k_q3"],
                      "chunk": CHUNK, "i16": True, "compact": "host",
                      "eager": eager})
    cases += [dict(SYNTH, name=f"chunk_{w}", kind="chunk", with_i16=w)
              for w in (False, True)]
    if (dp, tp) in TP_MESHES:
        cases += [dict(SYNTH, name=f"prog_{w}", kind="chunk", with_i16=w,
                       programs=True) for w in (False, True)]
    if (dp, tp) == (2, 2):
        cases.append(dict(SYNTH, name="chunk_cap", kind="chunk",
                          compact_cap=CAP))
    if dp == 2:
        cases.append(dict(SYNTH, name="chunk_odd_s", kind="chunk", S=3,
                          expect_error="ValueError"))
        cases.append({"name": "streams_odd_s", "kind": "streams",
                      "file": _path("tiny_44k"), "lengths": [None] * 3,
                      "chunk": CHUNK, "expect_error": "ValueError"})
    return cases


def _spawn(out, dp, tp):
    spec = out / "spec.json"
    spec.write_text(json.dumps({"cases": _spec(dp, tp)}))
    spawn(dp, tp, JOB, out, "gloo", "cpu", spec, timeout=RANK_TIMEOUT,
          collective_timeout=COLLECTIVE_TIMEOUT)
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(dp * tp)]
    with np.load(out / "rank0.npz") as z:
        return recs, {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(dp, tp) -> (records of every rank, rank 0's arrays). The host
    library is built first (not by every rank); then one thread spawns
    each mesh in turn while the tests compute the reference."""
    _build.load_host_library()
    outs = {m: tmp_path_factory.mktemp(f"mesh{m[0]}x{m[1]}") for m in MESHES}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        done = {m: pool.submit(_spawn, outs[m], *m) for m in MESHES}
        yield lambda dp, tp: done[(dp, tp)].result()
        for f in done.values():
            f.cancel()


def _case(arrays: dict, name: str) -> dict:
    p = name + "__"
    return {k[len(p):]: v for k, v in arrays.items() if k.startswith(p)}


def _streams(arrays: dict, name: str) -> list:
    got = _case(arrays, name)
    return [got[f"stream{i}"] for i in range(len(got))]


def _packets(name, lengths):
    headers, pcks = _stream(PacketReader, read_headers, name)
    return headers, [pcks[:n] for n in lengths]


_J_MESHES: dict = {}


def _j_mesh(dp, tp):
    if (dp, tp) not in _J_MESHES:
        _J_MESHES[(dp, tp)] = j_make_mesh(dp, tp)
    return _J_MESHES[(dp, tp)]


def _j_streams(dp, tp, name, lengths, i16=False, compact="device"):
    """The reference's sharded BatchDecoder on its Python front-end."""
    jh, jp = _stream(JPacketReader, j_read_headers, name)
    dec = JBatchDecoder(jh.ident, jh.setup, chunk=CHUNK, mesh=_j_mesh(dp, tp),
                        frontend="python")
    streams = [jp[:n] for n in lengths]
    if i16:
        return dec.decode_streams_i16(streams, compact=compact)
    return dec.decode_streams(streams)


def _close_f32(want, got, bound):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = bound + 2.0 * np.spacing(np.abs(want))
    d = np.abs(want.astype(np.float64) - got)
    assert (d <= tol).all(), f"max |d| {d.max()} (bound {bound})"


def _stream_bound(headers, streams) -> float:
    sd = StreamDecoder(headers.ident, headers.setup, chunk=CHUNK,
                       device="cpu")
    return max(_f32_bound(sd, s) for s in streams)


@pytest.mark.parametrize("name", list(F32_STREAMS))
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_decode_streams_f32(runs, mesh, name):
    """BatchDecoder(mesh=).decode_streams: every stream within the f32
    bound of the reference's sharded decode and of the port's unsharded
    one."""
    _, arrays = runs(*mesh)
    got = _streams(arrays, f"f32_{name}")
    headers, streams = _packets(name, F32_STREAMS[name])
    bound = _stream_bound(headers, streams)
    plain = BatchDecoder(headers.ident, headers.setup, chunk=CHUNK,
                         raw_headers=_raw(headers),
                         device="cpu").decode_streams(streams)
    want = _j_streams(*mesh, name, F32_STREAMS[name])
    assert len(got) == len(want) == len(plain) == 2
    for g, w, p in zip(got, want, plain):
        assert g.dtype == np.float32 and g.shape[1] > 0
        _close_f32(w, g, bound)
        _close_f32(p, g, bound)


@pytest.mark.parametrize("name", list(I16_STREAMS))
@pytest.mark.parametrize("mesh", I16_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_decode_streams_i16(runs, mesh, name):
    """BatchDecoder(mesh=).decode_streams_i16: exact lengths, within 1 LSB
    of the reference's sharded decode; the rank's own bytes in its
    last_stats (the i16 transport, device-compacted)."""
    recs, arrays = runs(*mesh)
    got = _streams(arrays, f"i16_{name}")
    want = _j_streams(*mesh, name, I16_STREAMS[name], i16=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.int16 and g.shape[0] > 0
        assert _lsb(g, np.asarray(w)) <= 1
    stats = [r["cases"][f"i16_{name}"]["last_stats"] for r in recs]
    assert all(s["transport"] == "i16" and s["h2d_bytes"] > 0 for s in stats)
    # each rank copied its own block's PCM out: together at least the PCM
    pcm = sum(g.nbytes for g in got)
    assert sum(s["d2h_bytes"] for s in stats[:: mesh[1]]) >= pcm


@pytest.mark.parametrize("mesh", I16_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_host_compaction(runs, mesh):
    """compact="host" with a mesh takes the device-compacted path and its
    slicing (the reference's test_mesh_host_compaction): bit for bit the
    compact="device" output, the same bytes copied out, within 1 LSB of
    the reference's mesh decode with compact="host"."""
    recs, arrays = runs(*mesh)
    host = _streams(arrays, "i16_host")
    device = _streams(arrays, "i16_stereo_44k_q3")
    for h, d in zip(host, device):
        assert np.array_equal(h, d)
    for r in recs:
        assert r["cases"]["i16_host"]["last_stats"]["d2h_bytes"] == \
            r["cases"]["i16_stereo_44k_q3"]["last_stats"]["d2h_bytes"]
    want = _j_streams(*mesh, "stereo_44k_q3", I16_STREAMS["stereo_44k_q3"],
                      i16=True, compact="host")
    for h, w in zip(host, want):
        assert _lsb(h, np.asarray(w)) <= 1


def _synth_frames(cs):
    return [synthetic_frames(cs, T=SYNTH["T"], S=SYNTH["S"],
                             seed=SYNTH["seed"] + i)
            for i in range(SYNTH["N"])]


def _synth_bound(cs, frs) -> float:
    return 2.0 * max(sum_order_bound(synthesize_spectra_tapped(
        cs, frames_to_device(fr, "cpu"))[0]) for fr in frs)


@functools.cache
def _j_chunks(mesh, with_i16, compact_cap=None):
    """The reference's decode_chunk_sharded over SYNTH's chunks: [outputs
    of each chunk], final carry."""
    jcs = j_compile_setup(*j_synthetic_headers(*SYNTH["setup"]))
    S = SYNTH["S"]
    carry = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                         j_init_carry(jcs.channels, jcs.n1 // 2))
    outs = []
    for i in range(SYNTH["N"]):
        fr = {k: jnp.asarray(v) for k, v in j_synthetic_frames(
            jcs, T=SYNTH["T"], S=S, seed=SYNTH["seed"] + i).items()}
        out, carry = j_decode_sharded(_j_mesh(*mesh), jcs, fr, carry,
                                      with_i16=with_i16,
                                      compact_cap=compact_cap)
        outs.append([np.asarray(x) for x in out])
    return outs, [np.asarray(c) for c in carry]


def _check_chunks(got: dict, want, carry, cs, with_i16):
    bound = _synth_bound(cs, _synth_frames(cs))
    for i, out in enumerate(want):
        pcm, lens = got[f"out{i}_0"], got[f"out{i}_1"]
        if with_i16:
            assert pcm.dtype == np.int16 and _lsb(pcm, out[0]) <= 1
        else:
            _close_f32(out[0], pcm, bound)
        assert np.array_equal(lens, out[1])
    _close_f32(carry[0], got["carry_0"], bound)
    for j in (1, 2):
        assert np.array_equal(got[f"carry_{j}"], carry[j])


@pytest.mark.parametrize("with_i16", [False, True])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_decode_chunk_sharded(runs, mesh, with_i16):
    """decode_chunk_sharded on synthetic frames, two chunks with the carry
    chained: the global outputs and carry against the reference's (the
    plain kernel versions on the CPU; at tp > 1 K2's audio form's)."""
    _, arrays = runs(*mesh)
    cs = compile_setup(*synthetic_headers(*SYNTH["setup"]), device="cpu")
    want, carry = _j_chunks(mesh, with_i16)
    _check_chunks(_case(arrays, f"chunk_{with_i16}"), want, carry, cs,
                  with_i16)


@pytest.mark.parametrize("with_i16", [False, True])
@pytest.mark.parametrize("mesh", TP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tp_chunk_programs(runs, mesh, with_i16):
    """decode_chunk_sharded(programs=) at tp > 1, its chunks as two
    segments around the tp all-reduce (one program a rank): the gathered
    outputs and carry bit for bit the same chunks decoded without
    programs, and on every rank bit for bit its own eager rerun; within
    the reference's decode_chunk_sharded by this file's bounds."""
    recs, arrays = runs(*mesh)
    got, eager = _case(arrays, f"prog_{with_i16}"), _case(
        arrays, f"chunk_{with_i16}")
    assert got.keys() == eager.keys()
    assert all(np.array_equal(got[k], eager[k]) for k in got)
    for r in recs:
        c = r["cases"][f"prog_{with_i16}"]
        assert c["programs"]["programs"] == 1 and c["graphed"] is False
        assert c["eager"]["eager_maxdiff"] == 0.0
        assert c["eager"]["digest_block"] == c["digest_block"]
        assert c["eager"]["digest_gathered"] == c["digest_gathered"]
    cs = compile_setup(*synthetic_headers(*SYNTH["setup"]), device="cpu")
    _check_chunks(got, *_j_chunks(mesh, with_i16), cs, with_i16)


@pytest.mark.parametrize("mesh", TP_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tp_batch_decoder_programs(runs, mesh):
    """BatchDecoder(mesh=).decode_streams_i16 at tp > 1 through its
    transfer slots' programs (segments around the tp all-reduce): every
    rank's streams bit for bit its rerun under graphs.eager(), a program
    for each group shape (none captured on the CPU); the streams against
    the reference's mesh decode are test_decode_streams_i16's."""
    recs, _ = runs(*mesh)
    names = [f"i16_{n}" for n in I16_STREAMS] + ["i16_host"]
    for r in recs:
        for name in names:
            c = r["cases"][name]
            assert c["programs"]["programs"] >= 1 and c["graphed"] is False
            assert c["eager"]["eager_maxdiff"] == 0.0
            assert c["eager"]["digest_block"] == c["digest_block"]
            assert c["eager"]["digest_gathered"] == c["digest_gathered"]


def test_decode_chunk_sharded_compact_cap(runs):
    """decode_chunk_sharded(compact_cap=) at (2, 2): the compacted i16
    [S, cap, C], totals and packet lengths against the reference's."""
    _, arrays = runs(2, 2)
    got = _case(arrays, "chunk_cap")
    want, carry = _j_chunks((2, 2), False, CAP)
    for i, (pcm, total, lens) in enumerate(want):
        assert got[f"out{i}_0"].shape == pcm.shape == (SYNTH["S"], CAP, 2)
        assert _lsb(got[f"out{i}_0"], pcm) <= 1
        assert np.array_equal(got[f"out{i}_1"], total)
        assert np.array_equal(got[f"out{i}_2"], lens)
    for j in (1, 2):
        assert np.array_equal(got[f"carry_{j}"], carry[j])


def test_tp3_pads_the_contraction(runs):
    """tp = 3 does not divide the spectral widths (896, and the short
    matrix's 128 rows): the padded contraction keeps every row, so the
    (2, 3) mesh's chunks and streams are within the f32 bound of the port's
    unsharded decode (a floor-divided slice drops the tail rows: wrong
    audio, no error)."""
    _, arrays = runs(2, 3)
    cs = compile_setup(*synthetic_headers(*SYNTH["setup"]), device="cpu")
    assert cs.imdct_m1.shape[0] % 3 and cs.imdct_m0.shape[0] % 3
    frs = _synth_frames(cs)
    carry = init_window_carry(cs.channels, cs.n1 // 2, SYNTH["S"], "cpu")
    got = _case(arrays, "chunk_False")
    bound = _synth_bound(cs, frs)
    for i, fr in enumerate(frs):
        (pcm, lens), carry = decode_frames_core(
            cs, frames_to_device(fr, "cpu"), carry)
        _close_f32(pcm.numpy(), got[f"out{i}_0"], bound)
        assert np.array_equal(lens.numpy(), got[f"out{i}_1"])
    headers, streams = _packets("tiny_44k", F32_STREAMS["tiny_44k"])
    tcs = StreamDecoder(headers.ident, headers.setup, device="cpu").cs
    assert tcs.imdct_m1.shape[0] % 3
    plain = BatchDecoder(headers.ident, headers.setup, chunk=CHUNK,
                         device="cpu").decode_streams(streams)
    bound = _stream_bound(headers, streams)
    for p, g in zip(plain, _streams(arrays, "f32_tiny_44k")):
        _close_f32(p, g, bound)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_ranks_agree_bit_for_bit(runs, mesh):
    """The tp ranks of each dp block hold the same outputs and final carry
    bit for bit in every case, and every rank the same gathered ones."""
    recs, _ = runs(*mesh)
    assert sorted((r["dp_rank"], r["tp_rank"]) for r in recs) == sorted(
        (i, j) for i in range(mesh[0]) for j in range(mesh[1]))
    for name, rec0 in recs[0]["cases"].items():
        if "error" in rec0:
            continue
        for r in recs:
            peer = next(q for q in recs if q["dp_rank"] == r["dp_rank"])
            assert r["cases"][name]["digest_block"] == \
                peer["cases"][name]["digest_block"], (name, r["rank"])
            assert r["cases"][name]["digest_gathered"] == \
                rec0["digest_gathered"], (name, r["rank"])


@pytest.mark.parametrize("ntp", [1, 2, 3])
def test_imdct_tp_matches_imdct_batch(ntp, monkeypatch):
    """_imdct_tp's partial products (each tp rank's padded k-slice) summed
    in rank order, as the all-reduce does, against imdct_batch within the
    bound of two fp32 sums of the same terms."""
    cs = compile_setup(*synthetic_headers(2, 8, 11), device="cpu")
    rng = np.random.default_rng(ntp)
    rows, W = 24, cs.imdct_m1.shape[0]
    spectra = torch.from_numpy(
        rng.standard_normal((rows, cs.channels, W)).astype(np.float32))
    bf = torch.from_numpy(rng.integers(0, 2, rows).astype(np.int32))
    m0, m1 = cs.imdct_m0, cs.imdct_m1
    want = imdct_batch(spectra, bf, m0, m1)
    parts = []
    for ti in range(ntp):
        monkeypatch.setattr(tbatch.dist, "get_rank", lambda group=None: ti)
        monkeypatch.setattr(tbatch.dist, "all_reduce",
                            lambda t, op=None, group=None: t)
        parts.append(tbatch._imdct_tp(spectra, bf, m0, m1, None, ntp))
    got = parts[0]
    for p in parts[1:]:
        got = got + p
    s64 = spectra.abs().to(torch.float64)
    K = W
    gamma = K * 2.0 ** -24 / (1 - K * 2.0 ** -24)
    bound = 2 * gamma * max(float((s64 @ m1.abs().double()).max()),
                            float((s64[..., : m0.shape[0]]
                                   @ m0.abs().double()).max()))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= bound
    if ntp == 1:
        assert torch.equal(got, want)


def _imdct_tp_before(spectra, bf, m0, m1, group=None, ntp: int = 1):
    """_imdct_tp as it stood before it was split into its local part and
    the all-reduce, for the test below."""
    ti = dist.get_rank(group) if ntp > 1 else 0

    def part(mat, spec):
        w = mat.shape[0]
        wk = -(-w // ntp)
        lo, hi = min(ti * wk, w), min((ti + 1) * wk, w)
        sl, mk = spec[..., lo:hi], mat[lo:hi]
        if hi - lo < wk:  # this rank's slice reaches into the zero pad
            sl = torch.nn.functional.pad(sl, (0, wk - (hi - lo)))
            mk = torch.nn.functional.pad(mk, (0, 0, 0, wk - (hi - lo)))
        return torch.matmul(sl, mk)

    n0, n1 = m0.shape[1], m1.shape[1]
    out = part(m1, spectra)
    if n0 != n1:
        short = torch.nn.functional.pad(part(m0, spectra), (0, n1 - n0))
        out = torch.where((bf == 1)[:, None, None], out, short)
    if ntp > 1:
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


@pytest.mark.parametrize("ntp", [1, 2, 3])
def test_imdct_tp_split_is_the_old_one(ntp, monkeypatch):
    """The factored _imdct_tp (_imdct_tp_local, then the all-reduce) and
    the mesh's transform (_TPImdct: its local part, then its collective,
    the split a segmented program runs) bit for bit the unsplit _imdct_tp
    on every tp rank, the all-reduce stood in for by one that doubles its
    tensor in place (once per call, on the group given)."""
    cs = compile_setup(*synthetic_headers(2, 8, 11), device="cpu")
    rng = np.random.default_rng(ntp)
    rows, W = 24, cs.imdct_m1.shape[0]
    spectra = torch.from_numpy(
        rng.standard_normal((rows, cs.channels, W)).astype(np.float32))
    bf = torch.from_numpy(rng.integers(0, 2, rows).astype(np.int32))
    m0, m1 = cs.imdct_m0, cs.imdct_m1
    group = SimpleNamespace(group_name="tp")
    calls = []

    def all_reduce(t, op=None, group=None):
        calls.append(group)
        t.mul_(2.0)
    monkeypatch.setattr(tbatch.dist, "all_reduce", all_reduce)
    for ti in range(ntp):
        monkeypatch.setattr(tbatch.dist, "get_rank", lambda group=None: ti)
        want = _imdct_tp_before(spectra, bf, m0, m1, group, ntp)
        got = tbatch._imdct_tp(spectra, bf, m0, m1, group, ntp)
        split = tbatch._TPImdct(group, ntp)
        local = split.local(spectra, bf, m0, m1)
        if ntp > 1:
            split.collective(local)
        whole = split(spectra, bf, m0, m1)
        for g in (got, local, whole):
            assert _equal_bits(g, want)
        assert split == tbatch._TPImdct(group, ntp)
        assert hash(split) == hash(tbatch._TPImdct(group, ntp))
    assert calls == ([group] * 4 * ntp if ntp > 1 else [])


def _equal_bits(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("differ", [False, True])
def test_held_kernels(monkeypatch, differ):
    """launch.held_kernels, which the chip's mesh phase runs around every
    rank's second run: each launch of a kernel form is recorded with its
    output shapes and held against its plain version on the same inputs
    (bit for bit, else AssertionError naming the wrapper), and the run
    ends with the kernel run's outputs. On the CPU the wrappers run their
    plain versions and count nothing, so stand-ins count a launch here and,
    with ``differ``, move K1's output by 1e-3."""
    from lewton_tpu_torch.models import decoder
    from lewton_tpu_torch.ops import floor_kernel, overlap_kernel, windowing

    k1, k2 = decoder.floor_spectra, windowing.overlap_i16

    def floor_spectra(*a, **kw):
        floor_kernel.LAUNCHES += 1
        return k1(*a, **kw) + (1e-3 if differ else 0.0)

    def overlap_i16(*a, **kw):
        overlap_kernel.LAUNCHES += 1
        return k2(*a, **kw)

    monkeypatch.setattr(floor_kernel, "LAUNCHES", 0)
    monkeypatch.setattr(overlap_kernel, "LAUNCHES", 0)
    monkeypatch.setattr(decoder, "floor_spectra", floor_spectra)
    monkeypatch.setattr(windowing, "overlap_i16", overlap_i16)
    cs = compile_setup(*synthetic_headers(*SYNTH["setup"]), device="cpu")
    fr = frames_to_device(_synth_frames(cs)[0], "cpu")
    carry = init_window_carry(cs.channels, cs.n1 // 2, SYNTH["S"], "cpu")
    calls: dict = {}
    if differ:
        with pytest.raises(AssertionError, match="floor_spectra at"):
            with launch.held_kernels(calls):
                decode_frames_core(cs, fr, carry, with_i16=True)
        assert decoder.floor_spectra is floor_spectra
        return
    want = decode_frames_core(cs, fr, carry, with_i16=True)
    with launch.held_kernels(calls):
        got = decode_frames_core(cs, fr, carry, with_i16=True)
    assert decoder.floor_spectra is floor_spectra
    rows = SYNTH["S"] * SYNTH["T"]
    assert calls == {
        "floor": {"calls": 1, "shapes": [[[2, rows, cs.w_eff]]],
                  "max_abs_err": 0.0},
        "overlap": {"calls": 1, "max_abs_err": 0.0, "shapes": [[
            [SYNTH["S"], SYNTH["T"], 2 * 3 * cs.n1 // 4],
            [SYNTH["S"], 2, cs.n1 // 2]]]}}
    for a, b in zip(want[0] + want[1], got[0] + got[1]):
        assert torch.equal(a, b)


@contextlib.contextmanager
def _one_rank_group(path):
    dist.init_process_group("gloo", init_method=f"file://{path}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_refuses_a_mismatched_group(tmp_path):
    """make_mesh without a process group, and with a world size other than
    dp x tp, raises ValueError naming both numbers; it never initializes a
    group itself."""
    with pytest.raises(ValueError, match="none is initialized"):
        make_mesh(2, 1, "cpu")
    assert not dist.is_initialized()
    with _one_rank_group(tmp_path / "store"):
        with pytest.raises(ValueError, match=r"need 2 ranks .* has 1"):
            make_mesh(2, 1, "cpu")
        with pytest.raises(ValueError, match=r"need 6 ranks \(dp 2 x tp 3\)"):
            make_mesh(2, 3, "cpu")
        assert make_mesh(1, 1, "cpu").mesh_dim_names == ("dp", "tp")


def test_stream_batch_not_divisible_by_dp(runs):
    """S = 3 streams on dp = 2: decode_chunk_sharded and BatchDecoder(mesh=)
    raise ValueError on every rank."""
    recs, _ = runs(2, 1)
    for r in recs:
        for name in ("chunk_odd_s", "streams_odd_s"):
            err = r["cases"][name]["error"]
            assert err.startswith("ValueError") and "S=3" in err \
                and "dp size 2" in err, err


def test_cuda_mesh_without_a_card_raises(tmp_path):
    """No fallback: without a card a CUDA mesh raises; nothing decodes on
    the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is present")
    with _one_rank_group(tmp_path / "store"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(1, 1, "cuda")


def test_dryrun_job(tmp_path, capsys):
    """The dryrun job at dp = 2, tp = 2 prints the reference's
    dryrun_multichip(4) line, character for character."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(4)
    want = capsys.readouterr().out.strip()
    spawn(2, 2, "dryrun", tmp_path, "gloo", "cpu", timeout=RANK_TIMEOUT,
          collective_timeout=COLLECTIVE_TIMEOUT)
    log = (tmp_path / "rank0.log").read_text()
    assert want.startswith("dryrun_multichip ok: mesh dp=2 tp=2")
    assert want in log.splitlines()


def test_a_failed_rank_fails_the_launch(tmp_path):
    """A rank that raises makes spawn raise RankFailed naming it, and the
    rank stuck in the collective it never joins is killed at once, not at
    the timeout."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"cases": [{"name": "f", "kind": "fail",
                                           "rank": 1}]}))
    t0 = time.monotonic()
    with pytest.raises(RankFailed,
                       match=r"rank 1 exited 1(.|\n)*rank 1 fails on purpose"):
        spawn(1, 2, JOB, tmp_path, "gloo", "cpu", spec=spec,
              timeout=RANK_TIMEOUT, collective_timeout=COLLECTIVE_TIMEOUT)
    assert time.monotonic() - t0 < RANK_TIMEOUT / 2


def test_parallel_exports():
    """lewton_tpu_torch.parallel exports what lewton_tpu.parallel does."""
    import lewton_tpu.parallel as jpar
    import lewton_tpu_torch.parallel as tpar

    names = ("BatchDecoder", "decode_chunk_batch", "decode_chunk_sharded",
             "make_mesh")
    for n in names:
        assert hasattr(jpar, n)
        assert getattr(tpar, n) is getattr(tbatch, n)
