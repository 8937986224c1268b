"""The one general generator: a traffic mix's parameters (a JSON file under
``benchmark/traffic/``) and ``--seed`` in, the files and their order out.

Every seed gets the same work in another order: a mix's file lengths are
a fixed multiset (whole tilings of the source cycle, each count from
``tilings[0]`` to ``tilings[1]`` equally often). The seed picks the order,
each file's rotation of the cycle and its serial number.

Mix parameters:

- ``entry``: the program's entry the harness drives (``batch_decoder``:
  one worker, the next batch starts when the last ends; ``scheduler``: a
  closed loop that registers the next request as soon as one retires),
  with its arguments under ``decoder`` / ``scheduler``.
- ``files``: the files the mix makes (a batch's files; the pool a serving
  loop's requests are taken from); ``tilings``: [least, most] cycles a
  file.
- ``check_files``: how many of them the correctness check compares.
"""

from __future__ import annotations

import itertools

import numpy as np

from .source import File, Source

__all__ = ["rng_of", "tiling_multiset", "make_files", "rounds",
           "check_sample"]


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """Independent generators of one seed (any whole number >= 0)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def tiling_multiset(n: int, tilings) -> np.ndarray:
    lo, hi = int(tilings[0]), int(tilings[1])
    return lo + np.arange(n) % (hi - lo + 1)


def make_files(source: Source, n: int, tilings, seed: int) -> list[File]:
    """``n`` files of the multiset of lengths, in a seeded order, each from
    a seeded rotation with a seeded serial."""
    rng = rng_of(seed, 1)
    tiles = rng.permutation(tiling_multiset(n, tilings))
    rot = rng.integers(0, len(source.cycle), n)
    serial = rng.integers(0, 2 ** 32, n)
    return [source.make_file(int(r), int(t), int(s))
            for r, t, s in zip(rot, tiles, serial)]


def rounds(files: list[File], seed: int):
    """An endless queue of indices into ``files``: round after round, one
    file of each length a round in a seeded order, the files of one length
    taken in turn. Any stretch of the queue holds the same lengths, up to one
    round, whatever the seed."""
    by_len: dict[int, list[int]] = {}
    for i, f in enumerate(files):
        by_len.setdefault(f.tilings, []).append(i)
    lengths = sorted(by_len)
    rng = rng_of(seed, 4)
    for r in itertools.count():
        for t in rng.permutation(lengths):
            group = by_len[int(t)]
            yield group[r % len(group)]


def check_sample(files: list[File], k: int, seed: int) -> list[int]:
    """Indices of the ``k`` answers the check compares: the longest files
    (up to a quarter of ``k``) and a seeded draw of the others."""
    order = sorted(range(len(files)), key=lambda i: -files[i].packets)
    longest = order[: max(1, k // 4)]
    rest = [i for i in range(len(files)) if i not in set(longest)]
    drawn = rng_of(seed, 3).choice(len(rest), min(len(rest), k - len(longest)),
                                   replace=False)
    return sorted(longest + [rest[int(i)] for i in drawn])
