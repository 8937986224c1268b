"""The control of the correctness check: the plain reference put in the
program's place, computed one precision below the program's (the IMDCT in
TF32 instead of f32 with TF32 off, ``Reference("tf32")``), over the
answers a run of the cell compares, at the cell's own size: the same
files, the same sample, the same numbers. Its readings are the upper ends
the check's limits are set below (``PERF.md``).

    python3 benchmark/control.py --workload batch_music_q3 --seeds 11,12,13

Prints one JSON line a seed. NumPy only: it needs no card and loads
nothing of the program. A run compares a batch cell's sample once a batch:
the control would answer every batch alike, so it reads the sample once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: str, seed: int) -> dict:
    from benchmark.harness import check, traffic
    from benchmark.harness.core import load_cell
    from benchmark.harness.source import load_source
    from benchmark.reference.decode import Reference

    spec = load_cell(ROOT, cell)
    tr, src = spec["traffic"], load_source(ROOT, spec["config"])
    files = traffic.make_files(src, tr["files"], tr["tilings"], seed)
    pick = traffic.check_sample(files, tr["check_files"], seed)
    ctl = Reference("tf32")
    answers = [(files[i].data, [ctl.decode(files[i].data)]) for i in pick]
    return check.compare(answers, Reference())


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
