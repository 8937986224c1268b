"""The port's setup compilation against the reference's, leaf for leaf.

``lewton_tpu_torch.models.decoder.compile_setup`` is a numpy copy of the
reference's ``compile_setup`` (which imports JAX); both must produce the
same tables bit for bit, and ``from_jax_setup`` must carry the reference's
setup across unchanged. The port's own constant tables, header records and
synthetic frames (which let it run without ``lewton_tpu``) are held equal
to the reference's. Also decodes the three kinds of setup outside the floor
kernel's gate (per-mode coupling, more than 8 channels, floor 0) through
the generic stages, against the reference (i16 within 1 LSB).
"""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lewton_tpu import tables as jtab
from lewton_tpu import testing as jtesting
from lewton_tpu.header import Floor0 as JFloor0
from lewton_tpu.header import Mapping as JMapping
from lewton_tpu.header import Mode as JMode
from lewton_tpu.header import read_header_ident, read_header_setup
from lewton_tpu.inside_ogg import read_headers
from lewton_tpu.models.decoder import compile_setup as jax_compile_setup
from lewton_tpu.ogg import PacketReader
from lewton_tpu.ops.windowing import init_window_carry as jax_init_carry
from lewton_tpu.parallel.batch import decode_chunk_batch as jax_chunk
from lewton_tpu_torch import tables as ttab
from lewton_tpu_torch.models.decoder import (CompiledSetup, compile_setup,
                                             decode_frames_core,
                                             floor_kernel_ok, from_jax_setup)
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.testing import (synthetic_floor0_frames,
                                      synthetic_frames, synthetic_headers)

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)


def carry_across(jcs):
    """The reference setup as numpy leaves + Python statics."""
    leaves = {k: np.asarray(getattr(jcs, k)) for k in jcs._leaf_names}
    static = {k: getattr(jcs, k) for k in jcs._static_names}
    return leaves, static


def assert_same_setup(cs: CompiledSetup, leaves: dict, static: dict):
    for k in CompiledSetup._leaf_names:
        a, b = getattr(cs, k).numpy(), leaves[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k  # bitwise
    for k in CompiledSetup._static_names:
        assert getattr(cs, k) == static[k], k


def _check(ident, setup, port_headers=None):
    """The reference's setup from ``(ident, setup)`` against the port's,
    compiled from ``port_headers`` (default: the same headers)."""
    leaves, static = carry_across(jax_compile_setup(ident, setup))
    assert_same_setup(compile_setup(*(port_headers or (ident, setup)),
                                    device="cpu"), leaves, static)
    assert_same_setup(from_jax_setup(leaves, static, device="cpu"), leaves,
                      static)


HDRS = [(2, 8, 11), (1, 8, 11), (4, 8, 11), (2, 9, 10), (6, 8, 12),
        (2, 11, 11)]


@pytest.mark.parametrize("hdr", HDRS)
def test_compile_setup_synthetic(hdr):
    """Reference headers into both packages, and the port's own records of
    the same configuration into the port."""
    _check(*jtesting.synthetic_headers(*hdr))
    _check(*jtesting.synthetic_headers(*hdr),
           port_headers=synthetic_headers(*hdr))


@pytest.mark.parametrize("hdr", HDRS[:3])
def test_synthetic_headers_and_frames_match_reference(hdr):
    mine, ref = synthetic_headers(*hdr), jtesting.synthetic_headers(*hdr)
    for a, b in zip(mine, ref):
        assert type(a).__name__ == type(b).__name__
    assert dataclasses.astuple(mine[0]) == dataclasses.astuple(ref[0])
    for part in ("residues", "mappings", "modes"):
        assert [dataclasses.astuple(x) for x in getattr(mine[1], part)] == \
            [dataclasses.astuple(x) for x in getattr(ref[1], part)]
    (f,), (g,) = mine[1].floors, ref[1].floors
    for fld in dataclasses.fields(f):
        assert np.array_equal(getattr(f, fld.name), getattr(g, fld.name))
    cs = compile_setup(*mine, device="cpu")
    for S in (None, 3):
        a = synthetic_frames(cs, T=9, S=S, seed=4)
        b = jtesting.synthetic_frames(cs, T=9, S=S, seed=4)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes()


def test_tables_match_reference():
    for got, want in zip(ttab.floor1_db_four_factor(),
                         jtab.floor1_db_four_factor()):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    for n in (64, 256, 2048, 8192):
        assert ttab.imdct_matrix(n).tobytes() == \
            jtab.imdct_matrix(n, dtype=np.float32).tobytes()
        assert ttab.window_slope(n // 2).tobytes() == \
            jtab.window_slope(n // 2).tobytes()
    for args in ((128, 44100, 256), (1024, 22050, 512), (64, 8000, 128)):
        assert ttab.bark_cos_omega(*args).tobytes() == \
            jtab.bark_cos_omega(*args).tobytes()


@pytest.mark.parametrize("name", ["stereo_44k_q3", "ch6_44k_q3",
                                  "mono_16k_q3", "stereo_22k_q0"])
def test_compile_setup_corpus(corpus_dir, name):
    with open(os.path.join(corpus_dir, name + ".ogg"), "rb") as f:
        headers, _ = read_headers(PacketReader(f.read()))
    _check(headers.ident, headers.setup)


def test_compile_setup_floor0():
    from tools.floor0_stream import build_headers

    ident_pkt, _, setup_pkt = build_headers(channels=2, coupling=True)
    ident = read_header_ident(ident_pkt)
    setup = read_header_setup(setup_pkt, ident)
    assert any(isinstance(f, JFloor0) for f in setup.floors)
    _check(ident, setup)


def _gated(ident, setup, port_headers=None):
    """A setup outside the floor kernel's gate decodes through the generic
    stages as the reference does: one chunk of two streams, i16 within
    1 LSB, out_len exact. The reference compiles ``(ident, setup)``, the
    port ``port_headers`` (default: the same headers)."""
    cs = compile_setup(*(port_headers or (ident, setup)), device="cpu")
    S, T = 2, 8
    make = synthetic_floor0_frames if cs.has_floor0 else synthetic_frames
    fr = make(cs, T=T, S=S, seed=5)
    tfr = {k: torch.from_numpy(v) for k, v in fr.items()}
    assert not floor_kernel_ok(cs, tfr)
    W = cs.n1 // 2
    jcarry = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                          jax_init_carry(cs.channels, W))
    (j_out, j_len), _ = jax_chunk(
        jax_compile_setup(ident, setup),
        {k: jnp.asarray(v) for k, v in fr.items()}, jcarry, with_i16=True)
    (out, out_len), _ = decode_frames_core(
        cs, tfr, init_window_carry(cs.channels, W, S, "cpu"), with_i16=True)
    d = np.abs(np.asarray(j_out, np.int32) - out.numpy().astype(np.int32))
    assert d.max() <= 1
    assert np.array_equal(np.asarray(j_len), out_len.numpy())
    assert int(out_len.sum()) > 0 and bool((out != 0).any())


def _per_mode_coupling_headers():
    """The reference's flagship headers with mode 1 on an uncoupled
    mapping."""
    ident, setup = jtesting.synthetic_headers(2, 8, 11)
    setup.mappings.append(JMapping(
        submaps=1, coupling_magnitude=[], coupling_angle=[], mux=[0, 0],
        submap_floor=[0], submap_residue=[0]))
    setup.modes[1] = JMode(1, 1)
    return ident, setup


def test_synthetic_generic_variants_match_reference():
    """The port's per-mode-coupling and floor-0 variants of the flagship
    setup compile to the reference's tables for the same headers."""
    _check(*_per_mode_coupling_headers(),
           port_headers=synthetic_headers(per_mode_coupling=True))
    ident, setup = jtesting.synthetic_headers(2, 8, 11)
    setup.floors = [JFloor0(order=2, rate=44100, bark_map_size=64,
                            amplitude_bits=6, amplitude_offset=136, books=[0])]
    _check(ident, setup, port_headers=synthetic_headers(floor0=True))


def test_gate_per_mode_coupling():
    _gated(*_per_mode_coupling_headers(),
           port_headers=synthetic_headers(per_mode_coupling=True))


def test_gate_channels():
    _gated(*jtesting.synthetic_headers(10, 8, 11),
           port_headers=synthetic_headers(10, 8, 11))


def test_gate_floor0():
    from tools.floor0_stream import build_headers

    ident_pkt, _, setup_pkt = build_headers(channels=1)
    ident = read_header_ident(ident_pkt)
    _gated(ident, read_header_setup(setup_pkt, ident))


def _spawn_default(tmp) -> torch.device:
    """One dryrun rank at spawn's default device: the rank builds its mesh
    with ``make_mesh(..., "cuda")``, which raises without a card, and
    decodes there; returns that device once the rank reports its decode."""
    from lewton_tpu_torch.parallel.launch import spawn

    spawn(1, 1, "dryrun", tmp, timeout=120.0, collective_timeout=60.0)
    assert "dryrun_multichip ok" in (tmp / "rank0.log").read_text()
    return torch.device("cuda")


def _bench_default() -> torch.device:
    """The device of the bench's surfaces without --cpu."""
    from lewton_tpu_torch import bench

    args = bench.parse_args([])
    assert not args.cpu
    return bench.resolve_device(args.cpu)


@pytest.mark.parametrize("name", ["compile_setup", "from_jax_setup",
                                  "init_window_carry", "spawn",
                                  "bench.main"])
def test_entry_points_default_to_the_card(name, tmp_path):
    """The port's entry points that create tensors put them on the card
    unless the caller names another device; without a card such a call
    fails instead of running on the CPU. ``parallel.launch.spawn`` starts
    its ranks on the card, and ``bench.main`` (``python -m
    lewton_tpu_torch.bench``) runs on the card unless ``--cpu`` is given."""
    from lewton_tpu_torch import bench
    from lewton_tpu_torch.parallel.launch import spawn

    calls = {
        "compile_setup": (compile_setup,
                          lambda: compile_setup(*synthetic_headers()).device),
        "from_jax_setup": (from_jax_setup, lambda: from_jax_setup(
            *carry_across(jax_compile_setup(*jtesting.synthetic_headers())))
            .device),
        "init_window_carry": (init_window_carry,
                              lambda: init_window_carry(2, 1024, 3)[0].device),
        "spawn": (spawn, lambda: _spawn_default(tmp_path)),
        "bench.main": (None, _bench_default),
    }
    fn, call = calls[name]
    if fn is not None:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert call().type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            call()
    if name == "bench.main" and not torch.cuda.is_available():
        for surface in ([], ["--check"], ["--e2e"], ["--serve"],
                        ["--frontend"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                bench.main(surface)
