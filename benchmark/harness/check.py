"""The correctness check: answers of the timed path against the plain
reference, once the window has closed.

The numbers compared, each against its limit in the configuration's
``limits``:

- ``max_lsb_diff``: the largest |program - reference| over every sample of
  every compared answer, in i16 LSB;
- ``differ_ppm``: samples that differ from the reference at all, per
  million samples compared;
- ``length_mismatches``: answers whose length (samples x channels) is not
  the reference's (exact: 0);
- ``missing``: answers that never came (exact: 0).
"""

from __future__ import annotations

import numpy as np

__all__ = ["compare", "NUMBERS"]

NUMBERS = ("max_lsb_diff", "differ_ppm", "length_mismatches", "missing")


def compare(answers, reference) -> dict:
    """``answers``: (file bytes, [the program's i16 PCM [n, C] of each time
    the file was answered, or None for one that never came]) pairs.
    Returns the numbers compared."""
    worst, mismatched, missing, differ, compared = 0, 0, 0, 0, 0
    for data, outs in answers:
        want = reference.decode(data)
        for got in outs:
            if got is None:
                missing += 1
            elif got.shape != want.shape:
                mismatched += 1
            elif want.size:
                d = np.abs(got.astype(np.int32) - want.astype(np.int32))
                worst = max(worst, int(d.max()))
                differ += int(np.count_nonzero(d))
                compared += d.size
    return {"max_lsb_diff": worst,
            "differ_ppm": 1e6 * differ / compared if compared else 0.0,
            "length_mismatches": mismatched, "missing": missing}
