"""Decode-speed timer (analog of lewton's examples/perf.rs).

    python -m lewton_tpu_torch.examples.perf FILE.ogg ... \\
        [--backend numpy|native|torch]

Prints each file's decode seconds and x realtime. ``torch`` decodes on the
card; ``numpy`` and ``native`` are the CPU decoders.
"""

import argparse
import time

from ..inside_ogg import BACKENDS, OggStreamReader


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m lewton_tpu_torch.examples.perf")
    ap.add_argument("files", nargs="+")
    ap.add_argument("--backend", default="native", choices=BACKENDS)
    args = ap.parse_args(argv)
    for path in args.files:
        r = OggStreamReader(path, backend=args.backend)
        t0 = time.perf_counter()
        pcm = r.read_all_i16()
        dt = time.perf_counter() - t0
        secs = pcm.shape[0] / r.ident_hdr.sample_rate
        print(f"{path}: {secs:.2f}s audio decoded in {dt:.3f}s "
              f"({secs / dt:.1f}x realtime, backend={args.backend})")


if __name__ == "__main__":
    main()
