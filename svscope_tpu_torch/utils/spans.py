"""Named spans of work on the device's own clock: CUDA events on a CUDA
device, the host clock elsewhere.  Spans are marked as the work is issued
and read at one synchronise, so marking them adds no wait between the
calls they time."""
from __future__ import annotations

import time

import torch


class Spans:
    def __init__(self):
        self._spans = []          # (name, start mark, end mark)
        self._devs = set()

    def mark(self, dev: torch.device):
        """A point in `dev`'s stream (an event recorded on its current
        stream), or the host clock's now off CUDA."""
        dev = torch.device(dev)
        if dev.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        self._devs.add(dev)
        return ev

    def add(self, name: str, start, dev: torch.device):
        """Close a span `name` from `start` to a new mark; returns that
        mark (the start of a following span)."""
        end = self.mark(dev)
        self._spans.append((name, start, end))
        return end

    def read(self, totals: dict) -> dict:
        """Synchronise the marked devices and add each span's seconds to
        totals[name]; the spans are cleared.  Returns totals."""
        for dev in self._devs:
            torch.cuda.synchronize(dev)
        for name, a, b in self._spans:
            s = a.elapsed_time(b) / 1e3 if isinstance(a, torch.cuda.Event) \
                else b - a
            totals[name] = totals.get(name, 0.0) + s
        self._spans.clear()
        return totals
