"""The port never imports JAX or the JAX package, and on the CPU its kernel
wrappers run the plain versions and launch nothing.

The machine with the card has no JAX, so every module of
``lewton_tpu_torch`` and ``chip_smoke.py`` is imported in a subprocess
whose import hook refuses ``jax`` and ``lewton_tpu``; the same subprocess
decodes a small chunk on the CPU and checks that no kernel was launched or
built.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

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
assert {"lewton_tpu_torch.ops.coupling",
        "lewton_tpu_torch.ops.synth_kernel"} <= set(mods)

import torch
from lewton_tpu_torch import _build
from lewton_tpu_torch.models import decoder
from lewton_tpu_torch.models.decoder import compile_setup, precompute_brackets
from lewton_tpu_torch.ops import floor_kernel, overlap_kernel, synth_kernel
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.parallel.batch import decode_chunks_scan
from lewton_tpu_torch.testing import (synthetic_floor0_frames,
                                      synthetic_frames, synthetic_headers)

assert not torch.backends.cuda.matmul.allow_tf32
assert not torch.backends.cudnn.allow_tf32
assert torch.get_float32_matmul_precision() == "highest"
# every path: the floor kernel's two layouts, K3, and the generic stages
for kw, fused in (({}, False), ({}, True), ({"floor0": True}, False),
                  ({"per_mode_coupling": True}, False)):
    cs = compile_setup(*synthetic_headers(**kw))
    make = synthetic_floor0_frames if cs.has_floor0 else synthetic_frames
    frs = {k: torch.from_numpy(v)[None]
           for k, v in make(cs, T=8, S=2, seed=0).items()}
    if fused:
        frs = precompute_brackets(cs, frs)
    decoder.USE_FUSED_SYNTH_KERNEL = fused
    carry = init_window_carry(2, cs.n1 // 2, 2)
    for with_i16 in (False, True):
        (out, ln), c = decode_chunks_scan(cs, frs, carry, with_i16=with_i16)
        (out_p, ln_p), c_p = decode_chunks_scan(cs, frs, carry,
                                                with_i16=with_i16, plain=True)
        assert torch.equal(out, out_p) and torch.equal(ln, ln_p)
        assert all(torch.equal(a, b) for a, b in zip(c, c_p))
assert (floor_kernel.LAUNCHES, floor_kernel.LAUNCHES_FLAT,
        overlap_kernel.LAUNCHES, synth_kernel.LAUNCHES) == (0, 0, 0, 0)
assert _build._lib is None
assert not any(m.split(".")[0] in REFUSED for m in sys.modules)
print("OK", len(mods))
'''


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _GUARDED], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 10  # every submodule was imported


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
    from lewton_tpu_torch.ops.overlap_kernel import overlap_i16
    from lewton_tpu_torch.ops.synth_kernel import fused_floor_couple

    meta = torch.empty((4, 2 * 4 * 3), device="meta")
    for ct_out in (True, False):
        with pytest.raises(ValueError, match="unsupported device"):
            floor_spectra(meta, meta, meta, meta, meta, (), ct_out=ct_out)
    with pytest.raises(ValueError, match="unsupported device"):
        overlap_i16(meta, None, meta, meta, meta, 256, 256)
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
