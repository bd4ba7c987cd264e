"""The device side of a traced run: torch.profiler (CUPTI) over the
measured window, reduced to the device's busy intervals, each kernel's
time and the idle gaps labelled with the benchmark span open on the host.

The trace and the host clock are tied by marker kernels
(torch.cuda._sleep, "spin_kernel") launched right after a synchronise at
the window's start and end: the closing one gives the offset between the
clocks, and the window in trace time is the host's window shifted by it.
(The opening marker can start late while CUPTI starts up; its lag is
reported.)  The profiler keeps only device records that fall inside its
session on the host's clock, and the card's timestamps can lead or lag
the host's by milliseconds, so a marker at a session's very edge can be
dropped: GUARD_S of host time on each side keeps both clear of the
edges.

Over a mesh of several cards the markers go on every card of it, each
synchronised and each given its marker, and the reduction keeps each
record's card: busy time, and so idle time, is read card by card and
averaged over the cards, while a kernel's time is summed over them."""
from __future__ import annotations

import heapq
import json
import os
import time

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"
GUARD_S = 1.0


def short_name(name: str) -> str:
    """A kernel's name without its argument list, at most 120 chars
    ("unnamed kernel" where the trace gives none)."""
    return name.split("(")[0][:120] or "unnamed kernel"


class DeviceTrace:
    def __init__(self, path: str, cards=(0,)):
        self.path = path
        self.cards = list(cards)
        self.prof = None
        self.host_marks: list[int] = []

    def _mark(self) -> None:
        import torch
        for c in self.cards:
            torch.cuda.synchronize(c)
        self.host_marks.append(time.perf_counter_ns())
        for c in self.cards:
            with torch.cuda.device(c):
                torch.cuda._sleep(100)
        for c in self.cards:
            torch.cuda.synchronize(c)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(GUARD_S)
        self._mark()

    def stop(self) -> "Reduced":
        self._mark()
        time.sleep(GUARD_S)
        self.prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        return Reduced(events, self.host_marks, self.cards)


def _merged(iv: list) -> np.ndarray:
    """(start, end) intervals merged where they overlap or touch."""
    if not iv:
        return np.zeros((0, 2))
    iv = np.array(iv)
    iv = iv[np.argsort(iv[:, 0])]
    merged = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.array(merged)


class Reduced:
    """Device events of the window: `ops` (name, start_us, dur_us, card)
    in trace time (`kernels` the kernels among them), `t0`/`t1` the
    window's bounds there, and `offset_us` = trace time - host time.
    `cards` are the traced cards; with one, every record is its own (as
    a one-card trace is read whatever card number it carries), with
    several, a record's card is the one the trace names, and the first
    card's closing marker ties the clocks (CUPTI stamps every card on one
    clock)."""

    def __init__(self, events: list, host_marks: list[int], cards=(0,)):
        self.cards = list(cards)
        one = len(self.cards) == 1

        def card(e):
            return self.cards[0] if one else e.get("args", {}).get("device")
        ops = [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                e.get("cat"), card(e))
               for e in events
               if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        marks = {c: sorted(o[1] for o in ops if MARKER in o[0] and o[4] == c)
                 for c in self.cards}
        self.raw = {"events": len(events),
                    "markers": sum(len(m) for m in marks.values())}
        for o in ops:
            self.raw[o[3]] = self.raw.get(o[3], 0) + 1
        ops = [o for o in ops if MARKER not in o[0]]
        # the closing marker sets the clocks' offset: the opening one can
        # start late while the profiler starts up
        first = marks[self.cards[0]]
        host0, host1 = host_marks[0] / 1e3, host_marks[-1] / 1e3
        if first:
            self.t1 = first[-1]
        else:
            self.t1 = max((o[1] + o[2] for o in ops), default=0.0)
        self.offset_us = self.t1 - host1
        self.t0 = host0 + self.offset_us
        self.start_lag_us = first[0] - self.t0 if len(first) >= 2 else None
        inside = [o for o in ops if self.t0 <= o[1] < self.t1]
        self.ops = [(o[0], o[1], o[2], o[4]) for o in inside]
        self.kernels = [(o[0], o[1], o[2], o[4]) for o in inside
                        if o[3] == "kernel"]
        self.window_s = (self.t1 - self.t0) / 1e6
        # both markers on every card and an op between them: else CUPTI
        # lost records
        self.complete = (all(len(m) >= 2 for m in marks.values())
                         and bool(self.ops))
        self._busy = None

    def busy_intervals(self) -> dict:
        """Per card, merged (start, end) intervals, in us, where an op
        ran."""
        if self._busy is None:
            self._busy = {c: _merged([(ts, min(ts + d, self.t1))
                                      for _n, ts, d, k in self.ops if k == c])
                          for c in self.cards}
        return self._busy

    def busy_by_card(self) -> dict:
        """Seconds in which an op ran, per card."""
        return {c: float((iv[:, 1] - iv[:, 0]).sum()) / 1e6 if len(iv)
                else 0.0 for c, iv in self.busy_intervals().items()}

    def _busy_before(self, t) -> np.ndarray:
        """Busy us before each trace time in `t` (an array), averaged
        over the cards."""
        t = np.asarray(t, float)
        per = []
        for iv in self.busy_intervals().values():
            if not len(iv):
                per.append(np.zeros_like(t))
                continue
            cum = np.concatenate([[0.0], np.cumsum(iv[:, 1] - iv[:, 0])])
            i = np.searchsorted(iv[:, 0], t, side="right")
            j = np.maximum(i - 1, 0)
            part = np.clip(t - iv[j, 0], 0.0, iv[j, 1] - iv[j, 0])
            per.append(np.where(i > 0, cum[j] + part, 0.0))
        return sum(per) / len(per)

    def busy_within(self, spans) -> float:
        """Seconds in which an op ran inside the host spans (start_ns,
        end_ns, ...), summed over the spans (the cards' mean)."""
        if not spans:
            return 0.0
        a = np.array([s[0] for s in spans]) / 1e3 + self.offset_us
        b = np.array([s[1] for s in spans]) / 1e3 + self.offset_us
        return float((self._busy_before(b) - self._busy_before(a)).sum()) / 1e6

    def count_of(self, substrings) -> int:
        """Kernels in the window, on every card, whose short name holds
        any of `substrings` ("unnamed kernel" matches those the trace
        gives no name)."""
        return sum(1 for n, _ts, _d, _c in self.kernels
                   if any(s in short_name(n) for s in substrings))

    def busy_s(self) -> float:
        """Seconds in which an op ran, the cards' mean."""
        per = list(self.busy_by_card().values())
        return sum(per) / len(per)

    def time_of(self, substrings) -> float:
        """Seconds of the ops whose name holds any of `substrings`, summed
        over the cards."""
        return sum(d for n, _ts, d, _c in self.ops
                   if any(s in n for s in substrings)) / 1e6

    def top_ops(self, k: int = 10) -> list:
        tot: dict[str, float] = {}
        for n, _ts, d, _c in self.ops:
            key = short_name(n)
            tot[key] = tot.get(key, 0.0) + d / 1e6
        return sorted(([n, s] for n, s in tot.items()),
                      key=lambda x: -x[1])[:k]

    def idle_by_span(self, spans: dict, k: int = 10) -> list:
        """Idle seconds of the window (the cards' mean) split by the
        benchmark span open on the host at each instant: the innermost
        (latest started) open span, "outside spans" where none is."""
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
