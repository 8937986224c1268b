"""The control of the correctness check of a mixed-setup cell: the plain
reference put in the program's place, computed one precision below the
program's (the IMDCT in TF32 instead of f32 with TF32 off,
``Reference("tf32")``), over the answers a run of the cell compares: the
cell's own files and sample, made by its entry's file maker
(``entries/batch_mixed.py``'s ``corpus``), the same numbers. Its readings
are the upper ends the check's limits are set below (``PERF.md``).

    python3 benchmark/control_mixed.py --workload batch_mixed_setups --seeds 11,12,13

Prints one JSON line a seed, with the numbers of each setup's answers
beside those of all of them. NumPy only: it needs no card and loads
nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: str, seed: int) -> dict:
    from benchmark.harness import check
    from benchmark.harness.core import load_cell, load_module
    from benchmark.reference.decode import Reference

    spec = load_cell(ROOT, cell)
    entry = load_module(spec["entry"], "control_entry")
    srcs = entry.sources(ROOT, spec["config"])
    files, sample = entry.corpus(srcs, spec["traffic"], seed)
    ctl, ref = Reference("tf32"), Reference()
    answers = [(files[i][1].data, [ctl.decode(files[i][1].data)])
               for i in sample]
    out = {"all": check.compare(answers, ref)}
    for k, s in enumerate(spec["config"]["streams"]):
        out[s["name"]] = check.compare(
            [a for a, i in zip(answers, sample) if files[i][0] == k], ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = readings(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
