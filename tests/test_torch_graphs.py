"""The port's chunk programs (``lewton_tpu_torch.parallel.graphs``) on the
CPU, where a program runs its eager body on its static buffers.

- A ``ChunkProgram`` of N = 3 chunks, run twice with the carry it returns
  passed back (the static carry, no copy), against the reference's
  ``decode_chunks_scan`` on JAX's CPU chained the same way (on the CPU the
  reference takes its XLA path: its Pallas gates are off there). i16
  within 1 LSB, out_len, plen and started exact, the carried right region
  within the fp32 sum-order bound of the GEMM that made it
  (ops/imdct.sum_order_bound): the tolerances of test_torch_slice.py.
- The same program inside ``graphs.eager()``, and the eager
  ``decode_chunks_scan`` with fresh outputs, bit for bit.
- The carry a run returns is the owner's: a run of another program of the
  same owner and carry layout overwrites it (the stated lifetime).
- The four packed functions, eager and as programs, bit for bit the
  unpacked frames' decode.
- ``BatchDecoder.decode_streams_i16`` at scan 8 with a ragged tail: at
  most log2(scan) + 1 programs per slot, the programs of one slot and N
  writing one PCM buffer and those of one N sharing their inputs, and its
  PCM bit for bit the eager decoder's and the one-chunk-a-group
  decoder's.
- Programs run eagerly inside ``launch.plain_kernels()``,
  ``launch.held_kernels()`` and ``graphs.eager()`` (a graph captured with
  the kernels never replays there).
- A replay's launches go to ``launch.REPLAYED``, the wrappers' counters
  count only their own launches.
- A program whose IMDCT holds a collective (a mesh's at tp > 1, stood in
  for by a transform that halves and then doubles) runs as two segments a
  chunk around it, bit for bit the eager decode; on a stood-in card each
  segment is a graph, the collective runs between the replays, and each
  segment's launches are added at its replay.
- A capture error on a card propagates as ``CaptureError`` naming the op;
  nothing runs eagerly in its place.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu.models.decoder import compile_setup as jax_compile_setup
from lewton_tpu.ops.windowing import init_window_carry as jax_init_carry
from lewton_tpu.parallel.batch import decode_chunks_scan as jax_scan
from lewton_tpu.testing import synthetic_frames, synthetic_headers
from lewton_tpu_torch.inside_ogg import read_headers
from lewton_tpu_torch.models import decoder
from lewton_tpu_torch.models.decoder import (decode_frames_core, floor_stage,
                                             from_jax_setup)
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.ops import imdct
from lewton_tpu_torch.ops.imdct import sum_order_bound
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.ops import floor_kernel, overlap_kernel, windowing
from lewton_tpu_torch.parallel import batch, graphs, launch
from lewton_tpu_torch.parallel.batch import (BatchDecoder, decode_chunk_batch,
                                             decode_chunks_scan,
                                             pack_frame_buffers, scan_program)
from test_torch_frontend import stream_bytes
from test_torch_setup import carry_across

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

N, S, T = 3, 2, 24


def _frames(jcs, seed: int) -> dict:
    """N chunks of synthetic frames [N, S, T, ...] with random valid
    prefixes and unused floors."""
    rng = np.random.default_rng(seed)
    chunks = []
    for n in range(N):
        fr = synthetic_frames(jcs, T=T, S=S, seed=seed + n)
        fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.9
        for s in range(S):
            fr["valid"][s, rng.integers(T // 2, T + 1):] = False
        chunks.append(fr)
    return {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}


@pytest.fixture(scope="module")
def case():
    """The flagship setup in both packages and two runs of N chunks."""
    ident, setup = synthetic_headers(2, 8, 11)
    jcs = jax_compile_setup(ident, setup)
    cs = from_jax_setup(*carry_across(jcs), device="cpu")
    return jcs, cs, [_frames(jcs, 10), _frames(jcs, 40)]


def _torch_frames(fr: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in fr.items()}


def _carry0(cs):
    return init_window_carry(cs.channels, cs.n1 // 2, S, "cpu")


def _equal(a, b) -> bool:
    """Bit for bit, f32 by its bits."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def test_program_chains_carry_against_reference(case):
    jcs, cs, runs = case
    W = cs.n1 // 2
    jcarry = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                          jax_init_carry(cs.channels, W))
    programs = graphs.Programs()
    prog = scan_program(programs, cs, _torch_frames(runs[0]), _carry0(cs),
                        with_i16=True)
    carry = _carry0(cs)
    for fr in runs:
        (j_out, j_len), jcarry = jax_scan(
            jcs, {k: jnp.asarray(v) for k, v in fr.items()}, jcarry,
            with_i16=True)
        (out, out_len), carry = prog(_torch_frames(fr), carry)
        assert carry is prog.carry  # the next run takes it with no copy
        d = np.abs(np.asarray(j_out, np.int32) - out.numpy().astype(np.int32))
        assert d.max() <= 1, f"{d.max()} LSB over {int((d > 0).sum())}"
        assert np.array_equal(np.asarray(j_len), out_len.numpy())
        j_pwr, j_plen, j_started = (np.asarray(c) for c in jcarry)
        assert np.array_equal(j_plen, carry[1].numpy())
        assert np.array_equal(j_started, carry[2].numpy())
        last = {k: torch.from_numpy(v[-1]) for k, v in fr.items()}
        bound = sum_order_bound(floor_stage(cs, last))
        assert np.abs(j_pwr.astype(np.float64) - carry[0].numpy()).max() \
            <= bound
        assert int(out_len.sum()) > 0
    assert list(programs.programs.values()) == [prog]


@pytest.mark.parametrize("with_i16", [True, False])
def test_program_eager_bit_for_bit(case, with_i16):
    """The program's run, its eager run inside graphs.eager() and the
    eager decode_chunks_scan (fresh outputs), each chained over both runs,
    bit for bit."""
    _, cs, runs = case
    programs = graphs.Programs()
    got = {}
    for way in ("program", "eager()", "fresh"):
        carry, outs = _carry0(cs), []
        for fr in runs:
            frs = _torch_frames(fr)
            with graphs.eager() if way == "eager()" else \
                    contextlib.nullcontext():
                (out, ln), carry = decode_chunks_scan(
                    cs, frs, carry, with_i16=with_i16,
                    programs=None if way == "fresh" else programs)
            outs += [out.clone(), ln.clone()]
        got[way] = outs + [c.clone() for c in carry]
    assert len(programs.programs) == 1
    for way in ("eager()", "fresh"):
        assert all(_equal(a, b) for a, b in zip(got["program"], got[way]))


@pytest.mark.parametrize("compact_cap", [None, 3 * 2048 * T])
def test_one_chunk_program_and_broadcast_frames(case, compact_cap):
    """decode_chunk_batch(programs=) returns decode_frames_core's results
    (compact_cap included) bit for bit; a program made for frames broadcast
    over N (the bench's) keeps the broadcast axis in its static inputs and
    decodes as the dense frames do."""
    _, cs, runs = case
    fr = {k: torch.from_numpy(v[0]) for k, v in runs[0].items()}
    want, w_carry = decode_frames_core(cs, fr, _carry0(cs), with_i16=True,
                                       compact_cap=compact_cap)
    got, g_carry = decode_chunk_batch(cs, fr, _carry0(cs), with_i16=True,
                                      compact_cap=compact_cap,
                                      programs=graphs.Programs())
    assert len(got) == len(want)
    assert all(_equal(a, b) for a, b in zip(got + g_carry, want + w_carry))

    programs = graphs.Programs()
    bcast = {k: v.expand(N, *v.shape) for k, v in fr.items()}
    (out, ln), c = decode_chunks_scan(cs, bcast, _carry0(cs), with_i16=True,
                                      programs=programs)
    (prog,) = programs.programs.values()
    assert prog.inputs["residue"].stride()[0] == 0
    dense = {k: v.contiguous() for k, v in bcast.items()}
    (d_out, d_ln), d_c = decode_chunks_scan(cs, dense, _carry0(cs),
                                            with_i16=True)
    assert all(_equal(a, b) for a, b in zip((out, ln) + c,
                                            (d_out, d_ln) + d_c))


def test_carry_is_shared_by_the_owners_programs(case):
    """The carry a program returns is its owner's static carry of that
    layout: a run of another program of the same owner (a one-chunk
    decode_chunk_batch after a decode_chunks_scan, from another carry)
    rewrites it in place, as the lifetime in parallel/graphs.py says. The
    returned outputs are each program's own and stay."""
    _, cs, runs = case
    programs = graphs.Programs()
    frs = _torch_frames(runs[0])
    (out, _), carry = decode_chunks_scan(cs, frs, _carry0(cs), with_i16=True,
                                         programs=programs)
    held = [c.clone() for c in carry]
    out_held = out.clone()
    fr = {k: torch.from_numpy(v[0]) for k, v in runs[1].items()}
    _, other = decode_chunk_batch(cs, fr, _carry0(cs), with_i16=True,
                                  programs=programs)
    assert len(programs.programs) == 2
    assert all(a is b for a, b in zip(other, carry))
    _, want = decode_frames_core(cs, fr, _carry0(cs), with_i16=True)
    assert all(_equal(a, b) for a, b in zip(carry, want))
    assert not all(_equal(a, b) for a, b in zip(carry, held))
    assert _equal(out, out_held)


@pytest.mark.parametrize("route", ["batch", "batch_i16", "scan", "scan_i16"])
@pytest.mark.parametrize("graphed", [False, True])
def test_packed_functions(case, route, graphed):
    """decode_chunk_batch_packed[_i16] and decode_chunks_scan_packed[_i16]
    over pack_frame_buffers' buffers, eager and as a program of a
    Programs (run twice: made once), bit for bit the unpacked frames'
    decode_frames_core / decode_chunks_scan."""
    _, cs, runs = case
    cap = 3 * 2048 * T
    fr_np = runs[0] if route.startswith("scan") else \
        {k: v[0] for k, v in runs[0].items()}
    residue, b, i, f, shapes = pack_frame_buffers(fr_np)
    bufs = tuple(map(torch.from_numpy, (residue, b, i, f)))
    fr = _torch_frames(fr_np)
    if route == "batch":
        want = decode_frames_core(cs, fr, _carry0(cs), compact_cap=cap)
    elif route == "batch_i16":
        want = decode_frames_core(cs, fr, _carry0(cs), with_i16=True)
    elif route == "scan_i16":
        want = decode_chunks_scan(cs, fr, _carry0(cs), with_i16=True)
    else:
        outs = batch._scan_outputs(cs, N, S, T, False, cap, "cpu")
        c = batch._scan_into(cs, fr, _carry0(cs), outs, compact_cap=cap)
        want = outs[:2], c
    fn = getattr(batch, {"batch": "decode_chunk_batch_packed",
                         "batch_i16": "decode_chunk_batch_packed_i16",
                         "scan": "decode_chunks_scan_packed",
                         "scan_i16": "decode_chunks_scan_packed_i16"}[route])
    extra = (cap,) if route in ("batch", "scan") else ()
    programs = graphs.Programs() if graphed else None
    for _ in range(2):
        got = fn(cs, *bufs, shapes, _carry0(cs), *extra, programs=programs)
        assert len(got[0]) == len(want[0])
        assert all(_equal(a, b) for a, b in zip(got[0] + got[1],
                                                want[0] + want[1]))
    if graphed:
        assert len(programs.programs) == 1


def test_routing_flags_key_the_program(case, monkeypatch):
    """A program made with the Wang split off is not the one taken with it
    on: the routing a graph keeps is part of its key."""
    _, cs, runs = case
    programs = graphs.Programs()
    frs = _torch_frames(runs[0])
    off = scan_program(programs, cs, frs, _carry0(cs), with_i16=True)
    monkeypatch.setattr(imdct, "USE_DCT4_SPLIT", True)
    on = scan_program(programs, cs, frs, _carry0(cs), with_i16=True)
    assert on is not off and len(programs.programs) == 2
    monkeypatch.setattr(imdct, "USE_DCT4_SPLIT", False)
    assert scan_program(programs, cs, frs, _carry0(cs), with_i16=True) is off


@pytest.mark.parametrize("compact", ["host", "device"])
def test_batch_decoder_programs(compact):
    """scan 8 on three streams of 13, 10 and 8 chunks (groups of 8, 4 and
    1): at most log2(8) + 1 programs per slot, made once and kept across
    calls, and the PCM bit for bit the eager decoder's (inside
    graphs.eager()) and the one-chunk-a-group decoder's."""
    rdr = PacketReader(stream_bytes("stereo_44k_q3"))
    headers, serial = read_headers(rdr)
    pcks = []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial == serial:
            pcks.append(p.data)
    chunk = 8
    streams = [pcks[:13 * chunk], pcks[:10 * chunk - 3], pcks[:8 * chunk]]

    def decode(scan, **kw):
        dec = BatchDecoder(headers.ident, headers.setup, chunk=chunk,
                           scan=scan, frontend="python", device="cpu")
        return dec, dec.decode_streams_i16(streams, compact=compact, **kw)

    dec, outs = decode(8)
    progs = dec._slots.programs.programs
    keys = list(progs)
    again = dec.decode_streams_i16(streams, compact=compact)
    assert list(progs) == keys
    # a TransferSlots program's key ends with its slot and N
    per_slot = {slot: sum(k[-2] == slot for k in keys) for slot in (0, 1)}
    assert sorted({k[-1] for k in keys}) == [1, 4, 8]
    assert max(per_slot.values()) <= 4, per_slot
    for k, p in progs.items():
        for k2, p2 in progs.items():
            same = k[-2:] == k2[-2:]
            assert (p.outputs[0].data_ptr() == p2.outputs[0].data_ptr()) \
                == same
            if k[-1] == k2[-1]:
                assert p.inputs is p2.inputs
    assert len(dec._slots.pcm) == len({k[-2:] for k in keys})
    with graphs.eager():
        _, eager = decode(8)
    _, single = decode(1)
    for o, a, e, s in zip(outs, again, eager, single):
        assert o.shape[0] > 0
        assert np.array_equal(o, a) and np.array_equal(o, e)
        assert np.array_equal(o, s)


def test_programs_run_eager_where_wrappers_are_swapped(case, monkeypatch):
    """On a card a program replays only with the kernels' own wrappers, in
    a graphed owner and outside graphs.eager(): inside plain_kernels() and
    held_kernels() it runs its eager body, so no kernel captured in a graph
    hides on the plain path and every held launch is checked."""
    _, cs, runs = case
    prog = scan_program(graphs.Programs(), cs, _torch_frames(runs[0]),
                        _carry0(cs), with_i16=True)
    # a mesh's program at tp > 1 (its segments around the collective) takes
    # the same route
    mesh_prog = scan_program(graphs.Programs(), cs, _torch_frames(runs[0]),
                             _carry0(cs), imdct=_Split())
    assert isinstance(mesh_prog, graphs.SegmentedProgram)
    progs = (prog, mesh_prog)
    assert not any(p.graphed() for p in progs)  # the CPU
    for p in progs:
        monkeypatch.setattr(p, "device", torch.device("cuda"))
    assert all(p.graphed() for p in progs)
    assert launch.kernels_in_use()
    with launch.plain_kernels():
        assert not launch.kernels_in_use()
        assert not any(p.graphed() for p in progs)
    with launch.held_kernels({}):
        assert not launch.kernels_in_use()
        assert not any(p.graphed() for p in progs)
    assert launch.kernels_in_use() and all(p.graphed() for p in progs)
    with graphs.eager():
        assert not any(p.graphed() for p in progs)
    monkeypatch.setattr(decoder, "floor_spectra", decoder.floor_spectra_ref)
    assert not launch.kernels_in_use()
    assert not any(p.graphed() for p in progs)


class _Split:
    """A stand-in for a mesh's tp IMDCT (``batch._TPImdct``) on one process:
    ``local`` the stock IMDCT halved, ``collective`` doubling its input in
    place (exact: the sum of two equal halves), counting its calls."""

    def __init__(self):
        self.calls = 0

    def local(self, spectra, bf, m0, m1):
        return imdct.imdct_batch(spectra, bf, m0, m1) * 0.5

    def collective(self, audio) -> None:
        self.calls += 1
        audio.mul_(2.0)

    def __call__(self, spectra, bf, m0, m1):
        audio = self.local(spectra, bf, m0, m1)
        self.collective(audio)
        return audio


@pytest.mark.parametrize("with_i16, compact_cap",
                         [(False, None), (True, None), (False, 16384)])
def test_segmented_program_against_eager(case, with_i16, compact_cap):
    """A program whose IMDCT holds a collective (a mesh's at tp > 1) runs
    as segments around it: one segment before the collective, the
    collective, one after, for each chunk. Run twice with the carry it
    returns passed back, bit for bit the eager decode with the same
    transform (which calls it whole), and the collective runs once a
    chunk."""
    _, cs, runs = case
    split = _Split()
    prog = scan_program(graphs.Programs(), cs, _torch_frames(runs[0]),
                        _carry0(cs), with_i16, compact_cap, imdct=split)
    assert isinstance(prog, graphs.SegmentedProgram)
    assert [c for c, _ in prog.steps] == [True, False, True] * N
    carry = e_carry = _carry0(cs)
    for fr in map(_torch_frames, runs):
        got, carry = prog(fr, carry)
        got = tuple(x.clone() for x in got)
        assert carry is prog.carry
        want = batch._scan_outputs(cs, N, S, T, with_i16, compact_cap, "cpu")
        e_carry = batch._scan_into(cs, fr, e_carry, want, with_i16,
                                   compact_cap, imdct=split)
        assert got[0].numel() and all(
            _equal(g, w) for g, w in zip(got + carry, want + e_carry))
    assert split.calls == 4 * N  # two program runs, two eager decodes


def test_segments_capture_and_replay_around_the_collective(case,
                                                           monkeypatch):
    """On a (stood-in) card a segmented program captures each segment as a
    graph of its own: 2 N graphs for N chunks, the collectives run at the
    first call's warm-up and at every replay call (never captured), and
    each segment's replay adds the launches recorded at its capture to
    launch.REPLAYED (K2's audio form, stood in for by a wrapper that
    counts, in each chunk's second segment)."""
    _, cs, runs = case
    split = _Split()
    frs = _torch_frames(runs[0])
    prog = scan_program(graphs.Programs(), cs, frs, _carry0(cs), True,
                        imdct=split)
    kernel = windowing.overlap_i16_audio

    def overlap_i16_audio(*a, **kw):
        overlap_kernel.LAUNCHES_AUDIO += 1
        return kernel(*a, **kw)

    _stand_in_card(monkeypatch, [])
    monkeypatch.setattr(windowing, "overlap_i16_audio", overlap_i16_audio)
    monkeypatch.setattr(launch, "_DEFINED", tuple(
        (m, n, overlap_i16_audio if n == "overlap_i16_audio" else f)
        for m, n, f in launch._DEFINED))
    monkeypatch.setattr(overlap_kernel, "LAUNCHES_AUDIO", 0)
    monkeypatch.setattr(launch, "REPLAYED", dict.fromkeys(launch.COUNTERS, 0))
    prog(frs, _carry0(cs))  # warm-up, capture
    assert split.calls == N and overlap_kernel.LAUNCHES_AUDIO == N
    assert len(prog.graph) == 3 * N  # a step each, None for a collective
    assert sum(seg is not None for seg in prog.graph) == 2 * N
    assert prog.launches == {"overlap_audio": N}
    assert not any(launch.REPLAYED.values())
    for _ in range(2):
        prog(frs, _carry0(cs))
    assert split.calls == 3 * N and overlap_kernel.LAUNCHES_AUDIO == N
    assert launch.REPLAYED == dict.fromkeys(launch.COUNTERS, 0) | {
        "overlap_audio": 2 * N}
    st = prog.owner.stats()
    assert st["captured"] == 1 and st["replays"] == 2


class _Graph:
    """A stand-in for torch.cuda.CUDAGraph whose replay runs nothing."""

    def replay(self):
        pass

    def pool(self):
        return (0, 1)


def _stand_in_card(monkeypatch, capturing: list):
    """The graphed route on the CPU: the program captures and replays
    (torch.cuda.graph a context that marks ``capturing``, CUDAGraph a
    stand-in, the warm-up run on the caller's stream)."""
    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        capturing.append(True)
        try:
            yield
        finally:
            capturing.pop()

    def warm_up(self):
        self._run()
        return None

    monkeypatch.setattr(graphs.ChunkProgram, "graphed", lambda self: True)
    monkeypatch.setattr(graphs.ChunkProgram, "_warm_up", warm_up)
    monkeypatch.setattr(graphs, "_pool_bytes", lambda pool: 0)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph", graph)


def test_replays_count_apart_from_the_wrappers(case, monkeypatch):
    """The warm-up's launches count at the wrapper; the capture's are
    recorded and taken back (a capture runs nothing); each replay adds the
    recorded launches to launch.REPLAYED and leaves the wrappers' counters
    alone. (The floor kernel's wrapper is stood in for by one that counts
    a launch, as the card's does.)"""
    _, cs, runs = case
    frs = _torch_frames(runs[0])
    prog = scan_program(graphs.Programs(), cs, frs, _carry0(cs),
                        with_i16=True)
    kernel = decoder.floor_spectra

    def floor_spectra(*a, **kw):
        floor_kernel.LAUNCHES += 1
        return kernel(*a, **kw)

    _stand_in_card(monkeypatch, [])
    monkeypatch.setattr(decoder, "floor_spectra", floor_spectra)
    monkeypatch.setattr(floor_kernel, "LAUNCHES", 0)
    monkeypatch.setattr(launch, "REPLAYED", dict.fromkeys(launch.COUNTERS, 0))
    prog(frs, _carry0(cs))  # warm-up, capture
    assert floor_kernel.LAUNCHES == N and prog.launches == {"floor": N}
    assert not any(launch.REPLAYED.values())
    for _ in range(2):
        prog(frs, _carry0(cs))
    assert floor_kernel.LAUNCHES == N
    assert launch.REPLAYED == dict.fromkeys(launch.COUNTERS, 0) | {
        "floor": 2 * N}
    st = prog.owner.stats()
    assert st["captured"] == 1 and st["replays"] == 2
    assert st["first_use_s"] >= st["capture_s"] > 0


def test_capture_error_propagates(case, monkeypatch):
    """A capture that fails on a card raises CaptureError with the op that
    broke it, on this call and the next: the program never runs its eager
    body in the graph's place. (The card is stood in for: the program
    takes the graphed route, its warm-up runs on the CPU, and the capture
    context makes the floor kernel refuse as a card refuses a host sync
    inside a capture.)"""
    _, cs, runs = case
    frs = _torch_frames(runs[0])
    prog = scan_program(graphs.Programs(), cs, frs, _carry0(cs),
                        with_i16=True)
    capturing = []
    kernel = decoder.floor_spectra

    def floor_spectra(*a, **kw):
        if capturing:
            raise RuntimeError("CUDA error: operation not permitted when "
                               "stream is capturing")
        return kernel(*a, **kw)

    _stand_in_card(monkeypatch, capturing)
    monkeypatch.setattr(decoder, "floor_spectra", floor_spectra)
    before = launch._counters(), dict(launch.REPLAYED)
    for _ in range(2):
        with pytest.raises(graphs.CaptureError,
                           match="not permitted when stream is capturing") \
                as err:
            prog(frs, _carry0(cs))
        assert "test_torch_graphs.py" in str(err.value)  # the op's frame
        assert prog.graph is None and not capturing
        assert (launch._counters(), launch.REPLAYED) == before
