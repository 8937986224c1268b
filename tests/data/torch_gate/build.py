"""Build the conformance gate's committed streams and libvorbis goldens.

Writes, next to this file, one ``<name>.ogg`` per gate stream, its golden
PCM as ``<name>.golden.npz`` (``np.savez_compressed``, key ``pcm``:
interleaved i16 [samples, channels], decoded by libvorbisfile through
``tools/vorbisref.decode_file_i16``) and ``manifest.json`` (each file's
sha256, each stream's kind, channels, rate and sample count, and what was
left out and why). The streams are the corpus of ``tools/corpus.py``, the
crafted floor-1 variants of ``tools/craft.py`` and the four floor-0 variants
that ``bench.py``'s conformance check builds. The machine with the card has
no libvorbis, so ``chip_smoke.py`` reads these files only.

Run from the repository root (needs the system's libvorbis):

    python tests/data/torch_gate/build.py
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))

#: gate data budget (bytes of committed files)
BUDGET = 4_000_000
#: left out of the committed set, largest first, to fit the budget
LEFT_OUT = {
    "long_44k_q2": "2.1 MB of raw golden (30 s of stereo q2); stereo 44.1k "
                   "and q2 are covered by stereo_44k_q3 and ch4_32k_q2",
}


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def streams() -> dict:
    """name -> (kind, ogg bytes) of every gate stream."""
    from tools import corpus
    from tools.craft import VARIANTS, build_stream
    from tools.floor0_stream import build_stream as build_f0

    corpus_dir = os.path.join(ROOT, "tests", "data", "corpus")
    corpus.ensure_corpus(corpus_dir)
    out = {}
    for name, _ in corpus.SPECS:
        if name in LEFT_OUT:
            continue
        with open(os.path.join(corpus_dir, name + ".ogg"), "rb") as f:
            out[name] = ("corpus", f.read())
    for name, spec in sorted(VARIANTS.items()):
        out[name] = ("crafted_floor1", build_stream(spec))
    out["f0_restype0"] = ("floor0", build_f0(residue_type=0))
    out["f0_coupled_stereo"] = ("floor0", build_f0(
        channels=2, submaps=1, residue_type=2, coupling=True))
    out["f0_two_books"] = ("floor0", build_f0(n_books=2))
    out["f0_max_amp"] = ("floor0", build_f0(max_amp=True))
    return out


def main() -> None:
    sys.path.insert(0, ROOT)
    from tools import vorbisref as vr

    entries = {}
    total = 0
    for name, (kind, data) in streams().items():
        ogg = os.path.join(HERE, name + ".ogg")
        with open(ogg, "wb") as f:
            f.write(data)
        with tempfile.NamedTemporaryFile(suffix=".ogg") as f:
            f.write(data)
            f.flush()
            golden = vr.decode_file_i16(f.name)
        gpath = os.path.join(HERE, name + ".golden.npz")
        np.savez_compressed(gpath, pcm=golden)
        total += os.path.getsize(ogg) + os.path.getsize(gpath)
        entries[name] = {
            "kind": kind, "channels": int(golden.shape[1]),
            "samples": int(golden.shape[0]),
            "ogg": name + ".ogg", "ogg_sha256": _sha(ogg),
            "golden": name + ".golden.npz", "golden_sha256": _sha(gpath),
        }
    manifest = {
        "golden_source": "tools/vorbisref.decode_file_i16 (libvorbisfile)",
        "bytes": total, "budget": BUDGET,
        "streams": entries, "left_out": LEFT_OUT,
    }
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(entries)} streams, {total} bytes (budget {BUDGET})")
    if total > BUDGET:
        raise SystemExit("gate data over its budget")


if __name__ == "__main__":
    main()
