"""The port never imports JAX or the JAX package, and on the CPU its kernel
wrappers run the plain versions and launch nothing.

The machine with the card has no JAX, so every module of
``lewton_tpu_torch`` and ``chip_smoke.py`` is imported in a subprocess
whose import hook refuses ``jax``, ``lewton_tpu`` and the reference's
``tools``; the same subprocess
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

REFUSED = ("jax", "jaxlib", "lewton_tpu", "tools")

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
        "lewton_tpu_torch.parallel.graphs",
        "lewton_tpu_torch.native", "lewton_tpu_torch.serve",
        "lewton_tpu_torch.aio", "lewton_tpu_torch.profiling",
        "lewton_tpu_torch.debug", "lewton_tpu_torch.utils.bitwriter",
        "lewton_tpu_torch.ops.floor_curve", "lewton_tpu_torch.bench",
        "lewton_tpu_torch.examples.perf",
        "lewton_tpu_torch.examples.player"} <= set(mods)
# the reference's public API, and no library built or loaded by the imports
from lewton_tpu_torch import (AudioBadFormat, AudioIsHeader, BadHeader,
                              CommentHeader, HeaderIsAudio, HeaderSet,
                              IdentHeader, NotVorbisHeader, OggError,
                              OggStreamReader, Packet, PacketReader,
                              PreviousWindowRight, SetupHeader, VorbisError,
                              __version__, get_decoded_sample_count,
                              read_audio_packet, read_audio_packet_generic,
                              read_header_comment, read_header_ident,
                              read_header_setup, read_headers)
from lewton_tpu_torch import _build as _b0
assert _b0._lib is None and _b0._host_lib is None

import torch
from lewton_tpu_torch import _build
from lewton_tpu_torch.models import decoder
from lewton_tpu_torch.models.decoder import compile_setup, precompute_brackets
from lewton_tpu_torch.ops import floor_kernel, imdct, overlap_kernel, synth_kernel
from lewton_tpu_torch.ops.windowing import init_window_carry
from lewton_tpu_torch.parallel import graphs
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
        # the same chunks as one program (its eager body on the CPU)
        (out_g, ln_g), c_g = decode_chunks_scan(
            cs, frs, carry, with_i16=with_i16, imdct=fn,
            programs=graphs.Programs())
        assert torch.equal(out, out_g) and torch.equal(ln, ln_g)
        assert all(torch.equal(a, b) for a, b in zip(c, c_g))
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
# the CPU backends: the numpy synthesis (with its debug taps) and the C++
# decoder, one call and per link
from lewton_tpu_torch import debug
with debug.taps() as t:
    cpu = OggStreamReader("tests/data/torch_gate/stereo_44k_q3.ogg",
                          backend="numpy").read_all_i16()
assert len(t["post_mdct"]) > 100
assert np.abs(cpu.astype(np.int32) - golden).max() <= 2
for fresh in (True, False):
    rdr = OggStreamReader("tests/data/torch_gate/stereo_44k_q3.ogg",
                          backend="native")
    if not fresh:  # the rest of the stream, after one packet read
        rdr.read_dec_packet()
    cpu = rdr.read_all_i16()
    assert rdr.native_route == ("one-call" if fresh else "packets")
    assert len(cpu) > len(golden) - 4096
    assert np.abs(cpu.astype(np.int32) - golden[len(golden) - len(cpu):]
                  ).max() <= 2

# one scheduler pass (two streams, scan 2) and the async reader
import asyncio
from lewton_tpu_torch.aio import AsyncOggStreamReader
from lewton_tpu_torch.profiling import StageTimer
from lewton_tpu_torch.serve import StreamingScheduler
data = open("tests/data/torch_gate/stereo_44k_q3.ogg", "rb").read()
sched = StreamingScheduler(capacity=2, chunk=32, scan=2, device="cpu")
timer = StageTimer()
sched.add_stream("a", data)
sched.add_stream("b", data)
with timer.stage("serve"):
    while sched.step():
        pass
    timer.sync(sched.groups)
for sid in "ab":
    assert np.array_equal(sched.poll(sid), out)
    assert sched.is_done(sid)
assert "serve" in timer.report()

class Source:
    def __init__(self):
        self.pos = 0
    async def read(self, n):
        chunk = data[self.pos: self.pos + 4096]
        self.pos += len(chunk)
        return chunk

async def first_packets():
    rdr = await AsyncOggStreamReader.new(Source(), device="cpu")
    return [await rdr.read_dec_packet() for _ in range(3)]
assert [p.shape[0] for p in asyncio.run(first_packets())] == [2, 2, 2]

# the bench's synthesis and e2e surfaces, tiny, on the CPU
import contextlib, io
from lewton_tpu_torch import bench
with contextlib.redirect_stdout(io.StringIO()):
    line = bench.main(["--cpu", "--streams", "2", "--chunk", "4", "--iters",
                       "1", "--scan", "1"])
    e2e = bench.main(["--cpu", "--e2e", "--streams", "1", "--scan", "1"])
assert line["detail"]["platform"] == e2e["detail"]["platform"] == "cpu"
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
    """No source of the port (nor chip_smoke.py) imports JAX, the JAX
    package or the reference's ``tools``."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|lewton_tpu|tools)\b",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "lewton_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_no_reference_include_in_native_sources():
    """The port's C++ sources (the library's, the fuzzer) include no
    file of the reference's tree."""
    pat = re.compile(r'^\s*#\s*include\s*[<"][^>"]*lewton_tpu/', re.M)
    native = os.path.join(ROOT, "lewton_tpu_torch", "native")
    files = [os.path.join(d, n) for d, _, names in os.walk(native)
             for n in names if n.endswith((".cc", ".h", ".inc"))]
    assert {"lt_synth.cc", "lt_file.cc", "lt_capi.cc", "lewton_tpu.h",
            "lt_inverse_db.inc", "lt_fuzz.cc",
            "lt_bench.cc"} <= set(map(os.path.basename,
                                                          files))
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
