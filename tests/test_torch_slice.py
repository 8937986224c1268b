"""The port's whole i16 synthesis slice against the reference on the CPU.

``lewton_tpu_torch.parallel.batch.decode_chunks_scan`` (floor -> DCT-IV
GEMM -> overlap, the kernels' plain versions on the CPU) against the
reference's ``decode_chunks_scan(with_i16=True)``, on synthetic frames
with random valid prefixes and on the frames of real corpus files packed
by the reference's own ``pack_frames`` / ``compact_invalid_frames``.

Tolerances: i16 within 1 LSB (the GEMMs sum in different orders, and the
reference's own kernel and XLA paths differ by 1 LSB, see
tests/test_overlap_kernel.py); out_len, plen and started exact; the carried
right region within the fp32 sum-order bound of the GEMM that made it
(ops/imdct.sum_order_bound).
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
from lewton_tpu.ogg import PacketReader
from lewton_tpu.ops.windowing import init_window_carry as jax_init_carry
from lewton_tpu.parallel.batch import decode_chunks_scan as jax_scan
from lewton_tpu.testing import synthetic_frames, synthetic_headers
from lewton_tpu_torch.models.decoder import floor_stage, from_jax_setup
from lewton_tpu_torch.ops.imdct import sum_order_bound
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.parallel.batch import decode_chunks_scan
from test_torch_setup import carry_across

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)


def _compare(ident, setup, frs):
    """Run both packages over frames [N, S, T, ...] and hold them to the
    stated tolerances."""
    jcs = jax_compile_setup(ident, setup)
    cs = from_jax_setup(*carry_across(jcs), device="cpu")
    N, S = frs["mode"].shape[:2]
    W = cs.n1 // 2
    jcarry = jax.tree.map(lambda x: jnp.broadcast_to(x, (S,) + x.shape),
                          jax_init_carry(cs.channels, W))
    (j_out, j_len), (j_pwr, j_plen, j_started) = jax_scan(
        jcs, {k: jnp.asarray(v) for k, v in frs.items()}, jcarry,
        with_i16=True)
    tfrs = {k: torch.from_numpy(v) for k, v in frs.items()}
    (out, out_len), (pwr, plen, started) = decode_chunks_scan(
        cs, tfrs, init_window_carry(cs.channels, W, S, "cpu"), with_i16=True)

    assert tuple(out.shape) == np.asarray(j_out).shape
    d = np.abs(np.asarray(j_out, np.int32) - out.numpy().astype(np.int32))
    assert d.max() <= 1, f"{d.max()} LSB over {int((d > 0).sum())} samples"
    assert np.array_equal(np.asarray(j_len), out_len.numpy())
    assert np.array_equal(np.asarray(j_plen), plen.numpy())
    assert np.array_equal(np.asarray(j_started), started.numpy())
    last = {k: v[-1] for k, v in tfrs.items()}
    bound = sum_order_bound(floor_stage(cs, last))
    assert np.abs(np.asarray(j_pwr, np.float64) - pwr.numpy()).max() <= bound
    return int(out_len.sum())


def test_slice_synthetic_matches_reference():
    ident, setup = synthetic_headers(2, 8, 11)
    cs = jax_compile_setup(ident, setup)
    N, S, T = 2, 2, 48
    rng = np.random.default_rng(3)
    chunks = []
    for n in range(N):
        fr = synthetic_frames(cs, T=T, S=S, seed=10 + n)
        fr["f_used"][:] = rng.random(fr["f_used"].shape) < 0.9
        for s in range(S):
            fr["valid"][s, rng.integers(T // 2, T + 1):] = False
        chunks.append(fr)
    frs = {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
    assert _compare(ident, setup, frs) > 0


@pytest.mark.parametrize("name,T,N", [("stereo_44k_q3", 48, 2),
                                      ("ch6_44k_q3", 32, 2),
                                      ("mono_16k_q3", 32, 2)])
def test_slice_corpus_frames_match_reference(corpus_dir, name, T, N):
    with open(os.path.join(corpus_dir, name + ".ogg"), "rb") as f:
        rdr = PacketReader(f.read())
    headers, serial = read_headers(rdr)
    packets = []
    while (p := rdr.read_packet()) is not None and len(packets) < T * N:
        if p.stream_serial == serial:
            packets.append(p.data)
    ident, setup = headers.ident, headers.setup
    jcs = jax_compile_setup(ident, setup)
    chunks = []
    for n in range(N):
        plans = [decode_packet_entropy(ident, setup, p)
                 for p in packets[n * T:(n + 1) * T]]
        fr = {k: v[None] for k, v in pack_frames(jcs, plans, T).items()}
        compact_invalid_frames(fr)
        chunks.append(fr)
    frs = {k: np.stack([c[k] for c in chunks]) for k in chunks[0]}
    assert _compare(ident, setup, frs) > 0
