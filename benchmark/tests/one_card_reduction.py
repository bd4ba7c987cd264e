"""The trace's reduction as it read one card, before it read cards apart:
kept as the reference that the per-card reduction (devtrace.Reduced)
is held to on one card, where every reading must come out the same."""
from __future__ import annotations

import heapq

import numpy as np

from benchmark.devtrace import DEVICE_CATS, MARKER, short_name


class Reduced:
    """Device events of the window: `ops` (name, start_us, dur_us) in
    trace time (`kernels` the kernels among them), `t0`/`t1` the window's
    bounds there, and `offset_us` = trace time - host time."""

    def __init__(self, events: list, host_marks: list[int]):
        ops = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                e.get("cat"))
               for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        marks = sorted(o[1] for o in ops if MARKER in o[0])
        self.raw = {"events": len(events), "markers": len(marks)}
        for o in ops:
            self.raw[o[3]] = self.raw.get(o[3], 0) + 1
        ops = [o for o in ops if MARKER not in o[0]]
        # the closing marker sets the clocks' offset: the opening one can
        # start late while the profiler starts up
        host0, host1 = host_marks[0] / 1e3, host_marks[-1] / 1e3
        if marks:
            self.t1 = marks[-1]
        else:
            self.t1 = max((o[1] + o[2] for o in ops), default=0.0)
        self.offset_us = self.t1 - host1
        self.t0 = host0 + self.offset_us
        self.start_lag_us = marks[0] - self.t0 if len(marks) >= 2 else None
        inside = [o for o in ops if self.t0 <= o[1] < self.t1]
        self.ops = [o[:3] for o in inside]
        self.kernels = [o[:3] for o in inside if o[3] == "kernel"]
        self.window_s = (self.t1 - self.t0) / 1e6
        # both markers and an op between them: else CUPTI lost records
        self.complete = len(marks) >= 2 and bool(self.ops)
        self._busy = None

    def busy_intervals(self) -> np.ndarray:
        """Merged (start, end) intervals, in us, where an op ran."""
        if self._busy is not None:
            return self._busy
        if not self.ops:
            return np.zeros((0, 2))
        iv = np.array([(ts, min(ts + d, self.t1)) for _n, ts, d in self.ops])
        iv = iv[np.argsort(iv[:, 0])]
        merged = [list(iv[0])]
        for s, e in iv[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self._busy = np.array(merged)
        return self._busy

    def _busy_before(self, t) -> np.ndarray:
        """Busy us before each trace time in `t` (an array)."""
        iv = self.busy_intervals()
        t = np.asarray(t, float)
        if not len(iv):
            return np.zeros_like(t)
        cum = np.concatenate([[0.0], np.cumsum(iv[:, 1] - iv[:, 0])])
        i = np.searchsorted(iv[:, 0], t, side="right")
        j = np.maximum(i - 1, 0)
        part = np.clip(t - iv[j, 0], 0.0, iv[j, 1] - iv[j, 0])
        return np.where(i > 0, cum[j] + part, 0.0)

    def busy_within(self, spans) -> float:
        """Seconds in which an op ran inside the host spans (start_ns,
        end_ns, ...), summed over the spans."""
        if not spans:
            return 0.0
        a = np.array([s[0] for s in spans]) / 1e3 + self.offset_us
        b = np.array([s[1] for s in spans]) / 1e3 + self.offset_us
        return float((self._busy_before(b) - self._busy_before(a)).sum()) / 1e6

    def count_of(self, substrings) -> int:
        """Kernels in the window whose short name holds any of
        `substrings` ("unnamed kernel" matches those the trace gives no
        name)."""
        return sum(1 for n, _ts, _d in self.kernels
                   if any(s in short_name(n) for s in substrings))

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e6 if len(iv) else 0.0

    def time_of(self, substrings) -> float:
        """Seconds of the ops whose name holds any of `substrings`."""
        return sum(d for n, _ts, d in self.ops
                   if any(s in n for s in substrings)) / 1e6

    def top_ops(self, k: int = 10) -> list:
        tot: dict[str, float] = {}
        for n, _ts, d in self.ops:
            key = short_name(n)
            tot[key] = tot.get(key, 0.0) + d / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]

    def idle_by_span(self, spans: dict, k: int = 10) -> list:
        """Idle seconds of the window split by the benchmark span open on
        the host at each instant: the innermost (latest started) open
        span, "outside spans" where none is."""
        items = []
        for name, lst in spans.items():
            for a, b, _t in lst:
                lo = max(a / 1e3 + self.offset_us, self.t0)
                hi = min(b / 1e3 + self.offset_us, self.t1)
                if hi > lo:
                    items.append((lo, hi, name))
        cuts = np.array(sorted({self.t0, self.t1}
                               | {x for lo, hi, _n in items for x in (lo, hi)}))
        idle = np.diff(cuts) - np.diff(self._busy_before(cuts))
        items.sort()
        out: dict[str, float] = {}
        open_: list = []
        nxt = 0
        for x0, gap in zip(cuts[:-1], idle):
            while nxt < len(items) and items[nxt][0] <= x0:
                lo, hi, name = items[nxt]
                heapq.heappush(open_, (-lo, nxt, hi, name))
                nxt += 1
            while open_ and open_[0][2] <= x0:      # the innermost has closed
                heapq.heappop(open_)
            key = open_[0][3] if open_ else "outside spans"
            if gap > 0:
                out[key] = out.get(key, 0.0) + gap / 1e6
        return sorted(([n, s] for n, s in out.items()), key=lambda x: -x[1])[:k]
