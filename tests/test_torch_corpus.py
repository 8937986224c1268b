"""The generated test corpus, made once before any test runs.

``tests/conftest.py``'s ``corpus_dir`` fixture calls
``tools.corpus.ensure_corpus`` in every pytest worker. On a tree without
the corpus, several workers then rewrite the same files while others open
them with libvorbisfile to make the goldens, and a reader of a file that is
being rewritten can spin forever: a worker stuck in ``ov_fopen`` holds its
whole share of the suite until the suite's time limit. Every worker imports
this module while it collects, before it runs any test, so making the
corpus here under a file lock leaves the fixture a finished corpus to find.
"""

import fcntl
import json
import os

import numpy as np

from tools import corpus

CORPUS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "corpus")


def ensure_corpus_locked(root: str) -> None:
    """``corpus.ensure_corpus(root)`` with one process at a time: the
    first makes the files, the others wait and find the version stamp."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        corpus.ensure_corpus(root)


ensure_corpus_locked(CORPUS)


def test_corpus_is_complete():
    """Every corpus file is there with its golden and its metadata, and the
    metadata agree with the files."""
    with open(os.path.join(CORPUS, "VERSION")) as f:
        assert f.read().strip() == str(corpus.GENERATOR_VERSION)
    for name, _ in corpus.SPECS:
        with open(os.path.join(CORPUS, name + ".json")) as f:
            meta = json.load(f)
        golden = np.load(os.path.join(CORPUS, name + ".golden.npy"))
        assert golden.dtype == np.int16
        assert golden.shape == (meta["pcm_total"], meta["channels"])
        assert os.path.getsize(os.path.join(CORPUS, name + ".ogg")) == \
            meta["ogg_bytes"]
