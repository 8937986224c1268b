#!/usr/bin/env python3
"""A/B of K1's bracket lookup on one CUDA card (lewton_tpu_torch).

    python3 tools/torch_ab_floor_seg.py

K1 (csrc/floor_kernel.cu) finds each bin's seg -- the number of the
mode's sorted posts at or before it -- in a [M, C, W] seg table that every
block builds in shared memory, and falls back to a binary search over the
row's posts where the table does not fit. This builds the kernels twice
from lewton_tpu_torch/csrc: as they are (the table) and from a copy whose
table budget is 0 (the search), checks that both give the same bits as the
plain version, and times K1's ct_out and cd_n forms at the headline shapes
(S=256 streams x T=128 packets, flagship stereo setup) by CUDA events, in
turns table, search, search, table. Prints one line per form with the
card's name and power limit. Needs torch and numpy only.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from lewton_tpu_torch import _build  # noqa: E402
from lewton_tpu_torch.models.decoder import (compile_setup,  # noqa: E402
                                             floor_kernel_inputs)
from lewton_tpu_torch.ops import floor_kernel  # noqa: E402
from lewton_tpu_torch.testing import (synthetic_frames,  # noqa: E402
                                      synthetic_headers)

S, T = 256, 128
TABLE = "constexpr size_t kSegTableBytes = 16 * 1024;"
SEARCH = "constexpr size_t kSegTableBytes = 0;"


def search_library():
    """The kernels built from a copy of csrc with a seg table budget of 0."""
    root = _build.BUILD_DIR / "ab_floor_seg"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    src = root / "floor_kernel.cu"
    text = src.read_text()
    if text.count(TABLE) != 1:
        raise SystemExit(f"{TABLE!r} is not in floor_kernel.cu once")
    src.write_text(text.replace(TABLE, SEARCH))
    so = root / "liblewton_kernels_search.so"
    _build.compile_library(so, root)
    return _build.open_library(so)


def cuda_ms(fn, iters: int = 20) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_ab_floor_seg: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    libs = {"table": _build.load_library(), "search": search_library()}
    cs = compile_setup(*synthetic_headers(2, 8, 11), device=dev)
    fr = {k: torch.from_numpy(v).to(dev)
          for k, v in synthetic_frames(cs, T=T, S=S, seed=3).items()}
    k1 = floor_kernel_inputs(cs, fr)
    args = (cs.f1_xs, cs.f1_step, cs.static_coupling)
    forms = {"ct_out": {}, "cd_n": {"cd_n": cs.n1 // 2}}
    for form, kw in forms.items():
        want = floor_kernel.floor_spectra_ref(*k1, *args[1:], **kw)
        times = {name: [] for name in libs}
        for name in ("table", "search", "search", "table"):
            _build._lib = libs[name]
            got = floor_kernel.floor_spectra(*k1, *args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{form} {name}: kernel != plain")
            times[name].append(cuda_ms(
                lambda: floor_kernel.floor_spectra(*k1, *args, **kw)))
        print(f"ab floor seg {form} (ms per call, S={S} T={T}, in turns "
              "table, search, search, table): "
              + ", ".join(f"{n} {' / '.join(f'{t:.4f}' for t in ts)}"
                          for n, ts in times.items())
              + f" (bit-identical) | card: {card}")
    _build._lib = libs["table"]


if __name__ == "__main__":
    main()
