"""Build the port's CUDA kernels with nvcc and load them with ctypes; check
the tensors a wrapper hands to them.

Every ``csrc/*.cu`` file is compiled to an object by its own nvcc process,
all started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers: a build takes seconds, not
minutes), under ``build/lewton_tpu_torch/`` at the root of the checkout. The
library's file name carries a hash of the sources (``*.cuh`` included) and
flags, so an edited source is rebuilt on first use and a stale library is
never loaded. A failed build raises; there is no fallback.

Flags: ``sm_90a`` (Hopper), ``--fmad=false`` so every multiply and add is
rounded separately (the kernels are held bit-identical to their plain torch
versions, which round separately), ``-prec-div=true`` for IEEE division and
no ``-use_fast_math`` (no flush-to-zero, no approximate division).

The host library (``native/*.cc``: Ogg demux, header parse, entropy
decode into frames, the CPU synthesis decoder, the whole-file decode and
the lewton-compatible C ABI of ``native/lewton_tpu.h``) is built the same
way by the host's C++ compiler, no CUDA involved, into
``liblewton_host_<hash>.so`` beside the kernels (its hash covers
``native/*.cc``, ``*.h`` and ``*.inc``); C clients link against the stable
name :func:`capi_library` returns:
``-ffp-contract=off`` keeps every float operation rounded as the Python
front-end rounds it (GCC contracts ``a*b+c`` into an FMA under
``-march=native`` otherwise), except in ``lt_synth.cc`` (:data:`CONTRACTED`),
the CPU decoder, which is built with GCC's default contraction as the
reference builds its copy (its PCM is held bit for bit to the reference's
library's), and ``-Wl,-Bsymbolic`` binds the library's
calls to its own code when another build of the same sources is loaded in
the process. Its hash also covers what ``-march=native`` means on this host
(the compiler's predefined macros), so a library built on another CPU is
never loaded. A file lock lets one process build while the others wait.
:func:`build_fuzzer` builds ``native/tools/lt_fuzz.cc`` with the same
sources under ASAN and UBSAN, :func:`build_bench` the entropy front-end's
packets/s benchmark ``native/tools/lt_bench.cc`` with the library's flags.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["load_library", "library_path", "compile_library",
           "open_library", "check_operand", "BUILD_DIR",
           "load_host_library", "host_library_path", "capi_library",
           "build_fuzzer", "build_bench"]

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "lewton_tpu_torch"
HOST_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17",
              "-ffp-contract=off")
#: sources built with ``-ffp-contract=fast`` in place of ``off``
CONTRACTED = ("lt_synth.cc",)
HOST_LINK = ("-shared", "-Wl,-Bsymbolic", "-Wl,--no-undefined", "-pthread")
#: the sanitizer build of the fuzzer (memory errors and undefined
#: behaviour abort it)
FUZZ_FLAGS = ("-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
              "-fno-sanitize-recover=all", "-pthread")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + (
    "-std=c++17", "-O3", "--fmad=false", "-prec-div=true", "-Xptxas=-v",
    "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int  # pointers (and the stream), ints
#: argument types of the C entry points (csrc/*.cu), set on load
_SIGNATURES = {
    "lt_floor_spectra": [_P, _P, _I, _P, _P, _P] + [_I] * 6 + [_P] * 2
    + [_I, _P],
    "lt_floor_spectra_cd": [_P, _P, _I] + [_P] * 4 + [_I] * 7 + [_P] * 3,
    "lt_overlap_i16": [_P] * 7 + [_I] * 5 + [_P],
    "lt_overlap_i16_split": [_P] * 8 + [_I] * 5 + [_P],
    "lt_overlap_i16_audio": [_P] * 7 + [_I] * 6 + [_P],
    "lt_fused_floor_couple": [_P] * 4 + [_I] * 4 + [_P] * 3,
    "lt_floor_kernel_attrs": [_I] * 7 + [_P],
    "lt_overlap_kernel_attrs": [_I, _P],
}

_lib: ctypes.CDLL | None = None
#: (seconds, nvcc's output) of the build this process ran; None when the
#: library was already built
build_info: tuple[float, str] | None = None
_host_lib: ctypes.CDLL | None = None
#: seconds of the host library's build this process ran; None when it was
#: already built
host_build_seconds: float | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lewton_tpu_torch cannot be built")
    return path


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"liblewton_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands as parallel processes, wait for all of them, and
    return their output; raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{os.path.basename(cmd[0])} failed (exit "
                               f"{p.returncode}):\n{' '.join(cmd)}\n{out}")
    return "".join(outs)


def compile_library(so: Path, csrc: Path = CSRC) -> str:
    """Compile every ``*.cu`` of ``csrc`` to an object in parallel, link the
    library into ``so``; returns nvcc's output."""
    tmp = so.parent / f"{so.stem}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        nvcc = _nvcc()
        srcs = sorted(csrc.glob("*.cu"))
        objs = [tmp / f"{src.stem}.o" for src in srcs]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(srcs, objs)])
        lib = tmp / so.name
        log += _run_all([[nvcc, *ARCH, "-shared", "-o", str(lib),
                          *map(str, objs)]])
        os.replace(lib, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return log


def open_library(so: Path) -> ctypes.CDLL:
    """Load a built library and declare its C entry points."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    global _lib, build_info
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        t0 = time.perf_counter()
        log = compile_library(so)
        build_info = (time.perf_counter() - t0, log)
    _lib = open_library(so)
    return _lib


def _cxx() -> str:
    path = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not path:
        raise RuntimeError("no C++ compiler found: the host front-end of "
                           "lewton_tpu_torch cannot be built")
    return path


def _host_sources(extra=()) -> list[Path]:
    """The host library's sources and headers (and ``extra`` files)."""
    return sorted([*NATIVE.glob("*.cc"), *NATIVE.glob("*.h"),
                   *NATIVE.glob("*.inc"), *extra])


def _host_hash(flags, extra=()) -> str:
    """Hash of the host sources, ``flags``, the compiler and the CPU (the
    compiler's predefined macros under ``-march=native``)."""
    cxx = _cxx()
    target = subprocess.run(
        [cxx, *HOST_FLAGS, "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, text=True, check=True).stdout
    h = hashlib.sha256(" ".join(flags).encode())
    h.update("\n".join(sorted(target.splitlines())).encode())
    for f in _host_sources(extra):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def host_library_path() -> Path:
    """Path of the host library for the current sources, flags, compiler
    and CPU."""
    return BUILD_DIR / (f"liblewton_host_"
                        f"{_host_hash(HOST_FLAGS + HOST_LINK + CONTRACTED)}.so")


def _host_flags(src: Path) -> tuple:
    if src.name in CONTRACTED:
        return tuple("-ffp-contract=fast" if f == "-ffp-contract=off" else f
                     for f in HOST_FLAGS)
    return HOST_FLAGS


def compile_host_library(so: Path) -> None:
    """Compile every ``native/*.cc`` to an object in parallel and link the
    host library into ``so``."""
    tmp = so.parent / f"{so.stem}.{os.getpid()}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    try:
        cxx = _cxx()
        srcs = sorted(NATIVE.glob("*.cc"))
        objs = [tmp / f"{s.stem}.o" for s in srcs]
        _run_all([[cxx, *_host_flags(s), "-c", "-o", str(o), str(s)]
                  for s, o in zip(srcs, objs)])
        lib = tmp / so.name
        _run_all([[cxx, *HOST_LINK, "-o", str(lib), *map(str, objs), "-lm"]])
        os.replace(lib, so)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def _host_lock():
    """One process at a time builds host code; the others wait."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host_build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        yield


def load_host_library() -> ctypes.CDLL:
    """Build (if needed, one process at a time) and load the host
    front-end's shared library. A failed build raises."""
    global _host_lib, host_build_seconds
    if _host_lib is not None:
        return _host_lib
    so = host_library_path()
    if not so.exists():
        with _host_lock():
            if not so.exists():
                t0 = time.perf_counter()
                compile_host_library(so)
                host_build_seconds = time.perf_counter() - t0
    _host_lib = ctypes.CDLL(str(so))
    return _host_lib


def capi_library() -> Path:
    """The host library under a stable name for C clients of
    ``native/lewton_tpu.h``: builds it if needed and points
    ``build/lewton_tpu_torch/liblewton_host.so`` at the current build, so
    ``cc app.c -I lewton_tpu_torch/native -L build/lewton_tpu_torch
    -llewton_host`` links against it. Returns the link's path."""
    so = Path(load_host_library()._name)
    link = BUILD_DIR / "liblewton_host.so"
    tmp = BUILD_DIR / f".liblewton_host.{os.getpid()}.lnk"
    tmp.unlink(missing_ok=True)
    tmp.symlink_to(so.name)
    os.replace(tmp, link)  # atomic: a reader sees the old or the new link
    return link


def _build_program(main_src: Path, name: str, flags_of, link_flags) -> Path:
    """Build (if needed, one process at a time) the program ``main_src``
    with the host library's sources, each compiled with ``flags_of(src)``
    and in parallel, into ``BUILD_DIR/<name>_<hash>``; returns its path."""
    srcs = [*sorted(NATIVE.glob("*.cc")), main_src]
    flags = [f for s in srcs for f in flags_of(s)] + list(link_flags)
    exe = BUILD_DIR / f"{name}_{_host_hash(flags, [main_src])}"
    if exe.exists():
        return exe
    with _host_lock():
        if exe.exists():
            return exe
        tmp = BUILD_DIR / f"{exe.name}.{os.getpid()}.tmp"
        tmp.mkdir(parents=True, exist_ok=True)
        try:
            cxx = _cxx()
            objs = [tmp / f"{s.stem}.o" for s in srcs]
            _run_all([[cxx, *flags_of(s), "-I", str(NATIVE), "-c", "-o",
                       str(o), str(s)] for s, o in zip(srcs, objs)])
            _run_all([[cxx, *link_flags, "-o", str(tmp / exe.name),
                       *map(str, objs), "-lm"]])
            os.replace(tmp / exe.name, exe)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return exe


def build_fuzzer() -> Path:
    """Build (if needed, one process at a time) ``native/tools/lt_fuzz.cc``
    with the host library's sources under ASAN and UBSAN
    (:data:`FUZZ_FLAGS`); returns the executable's path. Run it as
    ``lt_fuzz FILE.ogg ...``: it decodes each file and deterministic
    mutations of it, and aborts on any sanitizer finding."""
    return _build_program(NATIVE / "tools" / "lt_fuzz.cc", "lt_fuzz",
                          lambda src: FUZZ_FLAGS, FUZZ_FLAGS)


def build_bench() -> Path:
    """Build (if needed, one process at a time) ``native/tools/lt_bench.cc``
    with the host library's sources and the library's own flags (plus
    ``-g``, a profiler's target); returns the executable's path. Run it as
    ``lt_bench FILE.ogg [REPEAT]``: packets/s of the entropy front-end
    (``lt_decode_chunk`` in chunks of 128 packets) on the file's audio
    packets, ``REPEAT`` (40) times over."""
    return _build_program(NATIVE / "tools" / "lt_bench.cc", "lt_bench",
                          lambda src: (*_host_flags(src), "-g"),
                          ("-pthread",))


def check_operand(name, t, dtype, shape, device) -> None:
    """Raise unless tensor ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
