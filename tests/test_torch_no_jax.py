"""The port never imports JAX or the JAX package, and on the CPU its kernel
wrappers run the plain versions and launch nothing.

The machine with the card has no JAX, so every module of
``lewton_tpu_torch`` and ``chip_smoke.py`` is imported in a subprocess
whose import hook refuses ``jax`` and ``lewton_tpu``; the same subprocess
decodes a small chunk on the CPU through every path and a committed gate
stream from the file through ``OggStreamReader.read_all_i16`` (within
+/-2 LSB of its libvorbis golden) on the native front-end, and checks that
no kernel was launched or built, and that the one host library it loaded is
the port's own, built under ``build/lewton_tpu_torch/`` from
``lewton_tpu_torch/native/``, never the reference's
``lewton_tpu/native/liblewton_host.so``.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_GUARDED = r'''
import importlib, pkgutil, sys

REFUSED = ("jax", "jaxlib", "lewton_tpu")

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError("refused: " + name)

sys.meta_path.insert(0, NoJax())
import lewton_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(lewton_tpu_torch.__path__,
                                               "lewton_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401
assert {"lewton_tpu_torch.ops.coupling", "lewton_tpu_torch.ops.synth_kernel",
        "lewton_tpu_torch.errors", "lewton_tpu_torch.bitpack",
        "lewton_tpu_torch.huffman", "lewton_tpu_torch.header",
        "lewton_tpu_torch.floor", "lewton_tpu_torch.residue",
        "lewton_tpu_torch.audio", "lewton_tpu_torch.samples",
        "lewton_tpu_torch.ogg.demux", "lewton_tpu_torch.inside_ogg",
        "lewton_tpu_torch.parallel.pack12",
        "lewton_tpu_torch.parallel.batch",
        "lewton_tpu_torch.native"} <= set(mods)

import torch
from lewton_tpu_torch import _build
from lewton_tpu_torch.models import decoder
from lewton_tpu_torch.models.decoder import compile_setup, precompute_brackets
from lewton_tpu_torch.ops import floor_kernel, imdct, overlap_kernel, synth_kernel
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.parallel.batch import decode_chunks_scan
from lewton_tpu_torch.testing import (synthetic_floor0_frames,
                                      synthetic_frames, synthetic_headers)

assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
assert torch.get_float32_matmul_precision() == "highest"
def caller_imdct(spectra, bf, m0, m1):
    return imdct.imdct_batch(spectra, bf, m0, m1)

# every path: the floor kernel's three forms, K3, the generic stages, the
# Wang split and a caller's IMDCT (K2's three forms)
for kw, fused, split, own in (
        ({}, False, False, False), ({}, True, False, False),
        ({"floor0": True}, False, False, False),
        ({"per_mode_coupling": True}, False, False, False),
        ({}, False, True, False), ({"per_mode_coupling": True}, False, True,
                                   False), ({}, False, False, True)):
    cs = compile_setup(*synthetic_headers(**kw), device="cpu")
    make = synthetic_floor0_frames if cs.has_floor0 else synthetic_frames
    frs = {k: torch.from_numpy(v)[None]
           for k, v in make(cs, T=8, S=2, seed=0).items()}
    if fused:
        frs = precompute_brackets(cs, frs)
    decoder.USE_FUSED_SYNTH_KERNEL = fused
    imdct.USE_DCT4_SPLIT = split
    assert decoder.split_ok(cs) == split
    fn = caller_imdct if own else imdct.imdct_batch
    carry = init_window_carry(2, cs.n1 // 2, 2, "cpu")
    for with_i16 in (False, True):
        (out, ln), c = decode_chunks_scan(cs, frs, carry, with_i16=with_i16,
                                          imdct=fn)
        (out_p, ln_p), c_p = decode_chunks_scan(cs, frs, carry,
                                                with_i16=with_i16, plain=True,
                                                imdct=fn)
        assert torch.equal(out, out_p) and torch.equal(ln, ln_p)
        assert all(torch.equal(a, b) for a, b in zip(c, c_p))
imdct.USE_DCT4_SPLIT = False

# a committed gate stream, file to PCM on the native front-end, against
# its libvorbis golden
import os
import numpy as np
from lewton_tpu_torch import native
from lewton_tpu_torch.inside_ogg import OggStreamReader
from lewton_tpu_torch.models.decoder import StreamDecoder
assert not native.available()
rdr = OggStreamReader("tests/data/torch_gate/stereo_44k_q3.ogg", device="cpu")
assert isinstance(rdr.rdr, native.NativePacketReader)
assert StreamDecoder(rdr.ident_hdr, rdr.setup_hdr,
                     raw_headers=rdr._raw_headers, device="cpu")._native
out = rdr.read_all_i16()
with np.load("tests/data/torch_gate/stereo_44k_q3.golden.npz") as z:
    golden = z["pcm"]
assert out.shape == golden.shape
assert np.abs(out.astype(np.int32) - golden).max() <= 2
assert (floor_kernel.LAUNCHES, floor_kernel.LAUNCHES_FLAT,
        floor_kernel.LAUNCHES_CD, overlap_kernel.LAUNCHES,
        overlap_kernel.LAUNCHES_SPLIT, overlap_kernel.LAUNCHES_AUDIO,
        synth_kernel.LAUNCHES) == (0,) * 7
assert _build._lib is None
host = os.path.realpath(_build._host_lib._name)
assert host.startswith(os.path.realpath(_build.BUILD_DIR) + os.sep), host
assert os.path.basename(host).startswith("liblewton_host_"), host
with open("/proc/self/maps") as f:
    libs = {line.split()[-1] for line in f if "liblewton_host" in line}
assert libs == {host}, libs
assert "lewton_tpu/native" not in "".join(libs)
assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
print("OK", len(mods))
'''


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _GUARDED], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 24  # every submodule was imported


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|lewton_tpu)\b",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "lewton_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_wrappers_refuse_other_devices():
    """A tensor that is not on the CPU reaches a kernel or raises: there is
    no silent fallback to the plain version."""
    from lewton_tpu_torch.ops.floor_kernel import floor_spectra
    from lewton_tpu_torch.ops.overlap_kernel import (overlap_i16,
                                                     overlap_i16_audio,
                                                     overlap_i16_split)
    from lewton_tpu_torch.ops.synth_kernel import fused_floor_couple

    meta = torch.empty((4, 2 * 4 * 3), device="meta")
    for ct_out, cd_n in ((True, 0), (False, 0), (True, 512)):
        with pytest.raises(ValueError, match="unsupported device"):
            floor_spectra(meta, meta, meta, meta, meta, (), ct_out=ct_out,
                          cd_n=cd_n)
    with pytest.raises(ValueError, match="unsupported device"):
        overlap_i16(meta, None, meta, meta, meta, 256, 256)
    with pytest.raises(ValueError, match="unsupported device"):
        overlap_i16_split(meta, meta, None, meta, meta, meta, 512, 512)
    for ct_in in (False, True):
        with pytest.raises(ValueError, match="unsupported device"):
            overlap_i16_audio(meta, None, meta, meta, meta, 256, 256, ct_in)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_floor_couple(torch.empty((4, 4, 2, 8), device="meta"), meta,
                           meta, ())


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA the smoke script exits nonzero and prints no result,
    both in the checkout and alone in an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    src = os.path.join(ROOT, "chip_smoke.py")
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(src, "rb").read())
    for script, cwd in ((src, ROOT), (str(alone), str(tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=300,
                              env=dict(os.environ, PYTHONPATH=""))
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
