"""Share (%) of the traced window in which the device was idle while the
program was inside one of the spans named in ``spec["spans"]``: the union
of those spans' host intervals (all inside the window) less its overlap
with the device's busy intervals (the union of kernel, copy and set
intervals that ``device_idle`` reads), over the window. It is at most the
device's whole idle share. Nothing in an untraced run or without such a
span."""

import numpy as np

from portbench import spans


def _union(intervals) -> list:
    """Disjoint sorted [start, end] pairs covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a: list, b) -> int:
    """Total length shared by two lists of disjoint sorted intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(record: dict, spec: dict):
    got = spans.windowed(record)
    if got is None:
        return None
    names = set(spec["spans"])
    inside = _union((s.start_ns, s.end_ns) for s in got if s.name in names)
    if not inside:
        return None
    tr = record["trace"]
    busy = np.asarray(tr._merged()).tolist()
    covered = sum(e - s for s, e in inside)
    idle_inside = covered - _overlap(inside, busy)
    w0, w1 = tr.window
    return 100.0 * idle_inside / (w1 - w0)
