"""A cell's run on the CPU at a tiny size, through the harness's own code:
the rehearsal of the tests (no card, the kernels' plain versions)."""

from __future__ import annotations

import io
import time

#: tiny sizes of each kind of entry
TINY = {"batch_decoder": {"files": 5, "tilings": [1, 2], "check_files": 3},
        "scheduler": {"files": 4, "tilings": [1, 2], "check_files": 3,
                      "scheduler": {"capacity": 4, "chunk": 8, "scan": 1}}}
SEED = 2 ** 31 + 4242


def rehearse(cell: str, trace: bool = False, seed: int = SEED,
             seconds: float = 1.0, root=None) -> tuple[dict, str, str]:
    """(result, stdout, stderr) of one CPU run of ``cell``."""
    import torch

    from benchmark.harness.core import ROOT, load_cell, run_cell

    root = ROOT if root is None else root
    entry = load_cell(root, cell)["traffic"]["entry"]
    out, err = io.StringIO(), io.StringIO()
    res = run_cell(root, cell, seed, seconds, trace, torch.device("cpu"),
                   time.perf_counter(), TINY[entry], out=out, err=err)
    return res, out.getvalue(), err.getvalue()
