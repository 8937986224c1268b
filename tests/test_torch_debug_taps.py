"""The port's debug taps (``lewton_tpu_torch.debug``) on the CPU.

The four record points of the numpy backend (``audio._synthesize``:
residues before and after inverse coupling, spectra before and after the
IMDCT), collected by ``debug.taps()`` over the first 8 packets of
``tiny_44k`` (and of a floor-0 stream): equal (``np.array_equal``) to the
reference's numpy taps, and within the tolerances of
tests/test_debug_taps.py of the port's device pipeline's taps
(``decode_frames(with_taps=True)`` on the CPU): 2e-6 for the residue and
pre-MDCT taps, 1e-4 for post-MDCT.
"""

import numpy as np
import pytest
import torch

from lewton_tpu import debug as jdebug
from lewton_tpu.inside_ogg import OggStreamReader as JReader
from lewton_tpu_torch import debug
from lewton_tpu_torch.audio import decode_packet_entropy
from lewton_tpu_torch.inside_ogg import OggStreamReader, read_headers
from lewton_tpu_torch.models.decoder import (compile_setup, decode_frames,
                                             frames_to_device, pack_frames)
from lewton_tpu_torch.ogg import PacketReader
from lewton_tpu_torch.ops.windowing import init_window_carry
from test_torch_frontend import stream_bytes

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

N = 8  # packets


def numpy_taps(data: bytes, reader, taps) -> dict:
    with taps() as t:
        r = reader(data, backend="numpy")
        for _ in range(N):
            r.read_dec_packet()
    return t


@pytest.mark.parametrize("name", ["tiny_44k", "f0_coupled_stereo"])
def test_taps_match_reference_and_device(name, corpus_dir):
    data = stream_bytes(name, corpus_dir)
    t = numpy_taps(data, OggStreamReader, debug.taps)
    j = numpy_taps(data, JReader, jdebug.taps)
    assert tuple(t) == debug.TAP_NAMES == jdebug.TAP_NAMES
    for k in debug.TAP_NAMES:
        assert len(t[k]) == len(j[k]) == N
        for a, b in zip(t[k], j[k]):
            assert a.dtype == b.dtype and np.array_equal(a, b), k

    rdr = PacketReader(data)
    headers, serial = read_headers(rdr)
    pcks = []
    while (p := rdr.read_packet()) is not None:
        if p.stream_serial == serial:
            pcks.append(p.data)
    pcks = pcks[:N]
    cs = compile_setup(headers.ident, headers.setup, device="cpu")
    plans = [decode_packet_entropy(headers.ident, headers.setup, p)
             for p in pcks]
    fr = frames_to_device(pack_frames(cs, plans, N), "cpu")
    carry = tuple(c[0] for c in init_window_carry(cs.channels, cs.n1 // 2, 1,
                                                  "cpu"))
    (_, _, taps), _ = decode_frames(cs, fr, carry, with_taps=True)
    for k in ("residue_pre_inverse", "residue_post_inverse", "pre_mdct"):
        dev = taps[k].numpy()  # device taps span w_eff columns
        for i, ref in enumerate(t[k]):
            n2 = min(ref.shape[1], cs.w_eff)
            np.testing.assert_allclose(dev[i, :, :n2], ref[:, :n2],
                                       atol=2e-6, err_msg=f"{k}[{i}]")
            assert np.all(ref[:, cs.w_eff:] == 0), f"{k}[{i}] beyond w_eff"
    dev = taps["post_mdct"].numpy()
    for i, ref in enumerate(t["post_mdct"]):
        np.testing.assert_allclose(dev[i, :, :ref.shape[1]], ref, atol=1e-4,
                                   err_msg=f"post_mdct[{i}]")


def test_taps_inactive_and_nested():
    """record() keeps nothing outside taps(); nested collectors both get
    each value recorded while they are open, copied at the record point."""
    a = np.arange(4, dtype=np.float32)
    debug.record("pre_mdct", a)
    with debug.taps() as outer:
        with debug.taps() as inner:
            debug.record("pre_mdct", a)
        debug.record("post_mdct", a)
        a[0] = 9
    assert len(inner["pre_mdct"]) == 1 and not inner["post_mdct"]
    assert len(outer["pre_mdct"]) == 1 and len(outer["post_mdct"]) == 1
    assert outer["pre_mdct"][0][0] == 0 and inner["pre_mdct"][0][0] == 0
    with debug.taps() as fresh:
        pass
    assert all(not v for v in fresh.values())
