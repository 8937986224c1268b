"""The frozen plain reference against libvorbis, the page writer's CRC,
and the control: the reference in TF32 in the program's place fails the
check's limits."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark.harness import check, traffic
from benchmark.harness.core import ROOT
from benchmark.harness.oggwrite import ogg_crc, ogg_crc_bitwise
from benchmark.harness.source import load_json, load_source
from benchmark.reference.decode import Reference, tf32
from benchmark.reference.ogg_demux import crc32_ogg

CONFIGS = ["music_q3_44k_stereo", "speech_q3_16k_mono"]


def _config(name):
    return load_json(ROOT / f"benchmark/configs/{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_within_2_lsb_of_libvorbis(name):
    c = _config(name)
    data = (ROOT / c["stream"]).read_bytes()
    with np.load(ROOT / c["golden"]) as z:
        golden = z["pcm"]
    out = Reference().decode(data)
    assert out.shape == golden.shape
    assert np.abs(out.astype(np.int32) - golden).max() <= 2


@pytest.mark.parametrize("n", [0, 1, 27, 255, 4100])
def test_ogg_crc(n):
    data = os.urandom(n)
    assert ogg_crc(data) == ogg_crc_bitwise(data) == crc32_ogg(data)


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10,
                  -3.0000002], np.float32)
    got = tf32(x)
    assert got[0] == 1.0 and got[1] == 1.0  # a tie goes to even
    assert got[2] == np.float32(1.0 + 2 ** -9)  # the other tie: up to even
    assert got[3] == np.float32(1.0 + 2 ** -10)
    assert got[4] == np.float32(-3.0)


@pytest.mark.parametrize("name", CONFIGS)
def test_control_fails_the_limit(name):
    """The control (the reference with a TF32 IMDCT, in the program's place)
    reads above the configuration's limit on a few generated files; the
    f64 reference reads 0 against itself."""
    c = _config(name)
    src = load_source(ROOT, c)
    files = traffic.make_files(src, 4, [2, 3], 77)
    ref, ctl = Reference(), Reference("tf32")
    answers = [(f.data, [ctl.decode(f.data)]) for f in files]
    got = check.compare(answers, ref)
    assert got["max_lsb_diff"] > c["limits"]["max_lsb_diff"]
    assert got["differ_ppm"] > c["limits"]["differ_ppm"]
    same = check.compare([(f.data, [ref.decode(f.data)]) for f in files], ref)
    assert same == {"max_lsb_diff": 0, "differ_ppm": 0.0,
                    "length_mismatches": 0, "missing": 0}


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.decode;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    tops = set(eval(out))
    assert not tops & {"lewton_tpu_torch", "lewton_tpu", "jax", "jaxlib",
                       "torch"}
