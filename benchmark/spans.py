"""What the readers of the program's own spans and marks share.

The program (casualhdrsplat_torch/utils/profiling.py) names its layers in
the traced slice two ways:

- host spans `chs.<name>` (a step's `chs.step.launch`, `chs.step.read`; a
  request's `chs.request`, `chs.request.copy_out`), read from the trace's
  host events (`TraceReading.host`, binned by millisecond: taken once each
  here);
- device marks, empty kernels named `chs_mark_<boundary>` that a captured
  graph replays at each layer boundary, in a fixed order a unit (`ORDER`).

A layer's device time in a unit is the device's busy time (the union of
the kernel, copy and set intervals) from the end of its first mark to the
start of the next one, averaged over the units.  Where the marks are not
exactly `units` times the unit's order (a record the profiler dropped, a
program without marks) there is nothing to read: None, never a number
from a part of the slice.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

MARK = "chs_mark_"
ORDER = {
    "train": ("step_begin", "project", "bin", "composite", "loss", "backward", "step_end"),
    "serve": ("render_begin", "project", "bin", "composite", "render_end"),
}


def host_spans(t, name: str) -> List[Tuple[float, float]]:
    """The (start, end) of every host event named `name`, in start order (us)."""
    found = {(s, e) for events in t.host.values() for n, s, e in events if n == name}
    return sorted(found)


def unit_marks(t) -> Optional[List[Dict[str, Tuple[float, float]]]]:
    """Each unit's marks, {boundary: (start, end)}, or None where the slice
    does not hold exactly `t.units` units' marks in their order."""
    order = ORDER.get(t.kind)
    marks = [(n[len(MARK):], s, e) for n, s, e in t.device if n.startswith(MARK)]
    if order is None or t.units < 1 or len(marks) != t.units * len(order):
        return None
    marks.sort(key=lambda m: m[1])
    units = []
    for u in range(t.units):
        chunk = marks[u * len(order):(u + 1) * len(order)]
        if tuple(n for n, _, _ in chunk) != order:
            return None
        units.append({n: (s, e) for n, s, e in chunk})
    return units


class Busy:
    """The union of the slice's device intervals, for busy time in a span."""

    def __init__(self, t, names: Optional[Tuple[str, ...]] = None):
        merged: List[List[float]] = []
        for n, s, e in sorted((d for d in t.device
                               if names is None or any(k in d[0] for k in names)),
                              key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self._starts = [s for s, _ in merged]
        self._ends = [e for _, e in merged]

    def within(self, lo: float, hi: float) -> float:
        """Busy us inside [lo, hi]."""
        total = 0.0
        i = bisect.bisect_right(self._ends, lo)
        while i < len(self._starts) and self._starts[i] < hi:
            total += min(self._ends[i], hi) - max(self._starts[i], lo)
            i += 1
        return total


def layer_ms(t, kind: str, first: str, second: str) -> Optional[float]:
    """The mean device busy ms a unit from the end of mark `first` to the
    start of mark `second`, in a slice of `kind`."""
    if t.kind != kind:
        return None
    units = unit_marks(t)
    if units is None:
        return None
    busy = Busy(t)
    return sum(busy.within(u[first][1], u[second][0]) for u in units) / len(units) * 1e-3
