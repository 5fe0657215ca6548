"""The comparison that decides ``correct``.

Every call of the window is compared, unit by unit (a resident handle or
a fresh batch), with the plain reference's records of that unit.  The
numbers compared, summed over the calls, each with the limit 0 (the
comparison is exact):

- ``missing``: reference records the call did not return;
- ``extra``: returned records the reference does not have;
- ``misordered``: neighbouring returned records out of ``(document, end,
  start)`` order;
- ``bad_start``: returned records whose start is not the end less the
  needle's length (or whose pattern id names no needle).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Mapping, Sequence

import numpy as np

LIMITS = {"missing": 0, "extra": 0, "misordered": 0, "bad_start": 0}


def compare_unit(got: dict, ref: dict, needle_lens: np.ndarray) -> Dict[str, int]:
    out = dict.fromkeys(LIMITS, 0)
    doc = np.asarray(got["doc"], np.int64)
    pos = np.asarray(got["pos"], np.int64)
    pid = np.asarray(got["pattern"], np.int64)
    start = np.asarray(got["start_postion"], np.int64)
    if not (np.array_equal(doc, ref["doc"]) and np.array_equal(pos, ref["pos"])
            and np.array_equal(pid, ref["pattern"])):
        g = Counter(zip(doc.tolist(), pos.tolist(), pid.tolist()))
        r = Counter(zip(ref["doc"].tolist(), ref["pos"].tolist(),
                        ref["pattern"].tolist()))
        out["missing"] = sum((r - g).values())
        out["extra"] = sum((g - r).values())
    if doc.size > 1:
        key = np.stack([doc, pos, start])
        later = key[:, 1:]
        earlier = key[:, :-1]
        gt = later > earlier
        lt = later < earlier
        # the first differing field decides; equal keys are in order
        first_lt = np.argmax(lt | gt, axis=0)
        bad = lt[first_lt, np.arange(lt.shape[1])]
        out["misordered"] = int(bad.sum())
    valid = (pid >= 0) & (pid < needle_lens.size)
    want = pos - needle_lens[np.where(valid, pid, 0)]
    out["bad_start"] = int((~valid | (start != want)).sum())
    return out


def compare_calls(calls: Sequence[tuple], refs: Mapping[int, dict],
                  needle_lens: np.ndarray) -> dict:
    """``calls``: ``(units, results)`` of each call; ``refs[k]``: the
    reference's records of unit ``k``.  Returns the summed numbers and
    the count of calls with any difference (``failed``)."""
    total = dict.fromkeys(LIMITS, 0)
    failed = 0
    for units, results in calls:
        bad = False
        results = list(results) + [None] * (len(units) - len(results))
        for k, got in zip(units, results):
            if got is None:
                got = {key: np.zeros(0, np.int64)
                       for key in ("doc", "pos", "pattern", "start_postion")}
            c = compare_unit(got, refs[k], needle_lens)
            for key, v in c.items():
                total[key] += v
            bad |= any(c.values())
        failed += bad
    return {"numbers": total, "failed": failed}


def passed(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
