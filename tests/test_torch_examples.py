"""The port's command-line programs against the reference's: the native
front-end's packets/s benchmark ``lt_bench`` (``_build.build_bench()`` against
``make -C lewton_tpu/native bench``) and the examples
``python -m lewton_tpu_torch.examples.player`` / ``.perf`` (against
``examples/player.py`` / ``perf.py``): the same packets, the same bytes of
output, the same line formats.
"""

import concurrent.futures
import fcntl
import os
import re
import subprocess
import sys

import pytest
import torch

from lewton_tpu_torch import _build
from test_torch_native import build_reference_native  # noqa: F401

# one intra-op thread: the suite runs a pytest worker per core, and torch's
# default pool in every worker would oversubscribe the CPU many times over
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = os.path.join(ROOT, "tests", "data", "torch_gate")
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")


def numbers_out(line: str) -> str:
    return re.sub(r"\d+(\.\d+)?", "N", line)


def reference_lt_bench() -> str:
    """``make -C lewton_tpu/native bench`` under the lock the other test
    files take for that directory; the program lies in the reference's
    tree (ignored by git)."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "lewton_tpu_native.lock"),
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", os.path.join(ROOT, "lewton_tpu",
                                                   "native"), "-s", "bench"],
                       check=True)
    return os.path.join(ROOT, "lewton_tpu", "native", "lt_bench")


def test_lt_bench_matches_reference():
    """Both programs built (in parallel) and run on stereo_44k_q3, 5 times
    over: the same packet count and bad-packet count, and the same line
    format (numbers aside)."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        port_f = pool.submit(_build.build_bench)
        ref_exe = reference_lt_bench()
        port_exe = port_f.result()
    assert str(port_exe).startswith(str(_build.BUILD_DIR))
    ogg = os.path.join(GATE, "stereo_44k_q3.ogg")
    outs = [subprocess.run([str(exe), ogg, "5"], capture_output=True,
                           text=True, check=True).stdout.splitlines()
            for exe in (port_exe, ref_exe)]
    assert outs[0][0] == outs[1][0] == "packets 950 (x5 of 190), bad 0"
    assert [numbers_out(x) for x in outs[0]] == \
        [numbers_out(x) for x in outs[1]]
    assert len(outs[0]) == 3
    bad = subprocess.run([str(port_exe)], capture_output=True, text=True)
    assert bad.returncode == 2 and "usage" in bad.stderr


def run(cmd: list) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *cmd], cwd=ROOT, env=ENV,
                          capture_output=True, text=True, timeout=300)


def test_player_wav_matches_reference(tmp_path):
    """player on tiny_44k with the native backend: the port's WAV has the
    reference's bytes, and the same line."""
    ogg = os.path.join(GATE, "tiny_44k.ogg")
    port, ref = tmp_path / "port.wav", tmp_path / "ref.wav"
    p = run(["-m", "lewton_tpu_torch.examples.player", ogg, str(port),
             "--backend", "native"])
    r = run(["examples/player.py", ogg, str(ref), "--backend", "native"])
    assert p.returncode == 0 and r.returncode == 0, p.stderr + r.stderr
    assert port.read_bytes() == ref.read_bytes()
    assert p.stdout.replace(str(port), "OUT") == \
        r.stdout.replace(str(ref), "OUT")


def test_player_realtime_matches_reference(tmp_path):
    """player --realtime: the paced raw s16le stream, packet by packet, has
    the reference's bytes (numpy backend)."""
    ogg = os.path.join(GATE, "tiny_44k.ogg")
    port, ref = tmp_path / "port.raw", tmp_path / "ref.raw"
    p = run(["-m", "lewton_tpu_torch.examples.player", ogg, str(port),
             "--backend", "numpy", "--realtime"])
    r = run(["examples/player.py", ogg, str(ref), "--backend", "numpy",
             "--realtime"])
    assert p.returncode == 0 and r.returncode == 0, p.stderr + r.stderr
    assert port.read_bytes() == ref.read_bytes()
    assert p.stderr == r.stderr and "streamed 2205 samples" in p.stderr


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_perf_line_matches_reference(backend):
    """perf on tiny_44k: the reference's line, numbers aside."""
    ogg = os.path.join(GATE, "tiny_44k.ogg")
    p = run(["-m", "lewton_tpu_torch.examples.perf", ogg, "--backend",
             backend])
    r = run(["examples/perf.py", ogg, "--backend", backend])
    assert p.returncode == 0 and r.returncode == 0, p.stderr + r.stderr
    assert numbers_out(p.stdout) == numbers_out(r.stdout)
    assert f"backend={backend}" in p.stdout


def test_examples_torch_backend_is_on_the_card(tmp_path):
    """The torch backend decodes on the card: without one, both examples
    fail (and write no WAV); nothing runs on the CPU in its place."""
    card = torch.cuda.is_available()
    ogg = os.path.join(GATE, "tiny_44k.ogg")
    wav = tmp_path / "x.wav"
    for cmd in (["-m", "lewton_tpu_torch.examples.perf", ogg],
                ["-m", "lewton_tpu_torch.examples.player", ogg, str(wav)]):
        p = run([*cmd, "--backend", "torch"])
        assert (p.returncode == 0) == card, p.stderr[-2000:]
    assert wav.exists() == card
