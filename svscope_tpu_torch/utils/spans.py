"""Named spans of the program's work, on two clocks.

`TRACE` (a `Recorder`, off by default) keeps host spans at the layer
boundaries of the localGraph engine: each record is (name, start_ns,
end_ns, thread, span_id, parent_id, call_id, attrs), on the host clock
`time.perf_counter_ns`, the clock a device trace is tied to by marker
kernels, so a span maps onto the device's timeline by one offset.  The
parent is the span open on the same thread; `call_id` is the
`process_window_batch` call (`Recorder.call`), carried onto a worker
thread by `Recorder.carry`.  Records stay in memory up to a cap; past it
they are counted in `dropped`.  While the recorder is off a span site
costs one attribute test and returns the shared `NO_SPAN`: no clock read,
no allocation.

`Spans`: named spans of work on the device's own clock: CUDA events on a
CUDA device, the host clock elsewhere.  Spans are marked as the work is
issued and read at one synchronise, so marking them adds no wait between
the calls they time."""
from __future__ import annotations

import contextvars
import functools
import itertools
import json
import os
import threading
import time

import torch

CAP = 4_000_000        # records kept; later ones are counted as dropped


class _NoSpan:
    """The span a site gets while the recorder is off: records nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    """One span: its clock is read on entry and exit; it is recorded when
    it has a recorder (`rec`), and `sink(span)` is called on exit when
    given.  `seconds` is its length once closed."""
    __slots__ = ("rec", "name", "attrs", "sink", "start", "end", "sid",
                 "parent")

    def __init__(self, rec, name: str, attrs: dict, sink=None):
        self.rec, self.name, self.attrs, self.sink = rec, name, attrs, sink

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            stack = rec._stack()
            self.parent = stack[-1] if stack else None
            self.sid = next(rec._ids)
            stack.append(self.sid)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        rec = self.rec
        if rec is not None:
            rec._stack().pop()
            rec._add((self.name, self.start, self.end, threading.get_ident(),
                      self.sid, self.parent, rec._call.get(),
                      self.attrs or None))
        if self.sink is not None:
            self.sink(self)
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a count, a time)."""
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _CallSpan(_Span):
    """A span that opens a new call: it and every span under it carry
    its call_id."""
    __slots__ = ("token",)

    def __enter__(self):
        self.token = self.rec._call.set(next(self.rec._calls))
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.rec._call.reset(self.token)
        return False


class Recorder:
    """Host spans of the program, in memory (see the module's doc)."""

    def __init__(self, cap: int = CAP):
        self.on = False
        self.cap = cap
        self.dropped = 0
        self._records: list[tuple] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._calls = itertools.count(1)
        self._call = contextvars.ContextVar("svscope_call", default=None)

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def records(self) -> list[tuple]:
        """A copy of the records, in the order they closed."""
        with self._lock:
            return list(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0

    def span(self, name: str, **attrs):
        """A context manager recording span `name` while the recorder is
        on; `NO_SPAN` while it is off."""
        if not self.on:
            return NO_SPAN
        return _Span(self, name, attrs)

    def call(self, name: str, **attrs):
        """`span`, for the span of one call of the engine: it sets the
        call_id its spans carry."""
        if not self.on:
            return NO_SPAN
        return _CallSpan(self, name, attrs)

    def timed(self, name: str, sink=None, **attrs) -> _Span:
        """A span whose clock is read whether the recorder is on or not
        (for a caller's own timing, through `sink(span)` on exit or the
        span's `seconds`); recorded only while the recorder is on."""
        return _Span(self if self.on else None, name, attrs, sink)

    def carry(self, fn):
        """`fn` to run on another thread with the caller's call_id (the
        caller's context), while the recorder is on; `fn` itself while it
        is off."""
        if not self.on:
            return fn
        return functools.partial(contextvars.copy_context().run, fn)

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, record: tuple) -> None:
        # list.append is atomic under the interpreter lock; two threads at
        # the cap may both append, which the cap (a memory bound) allows
        if len(self._records) < self.cap:
            self._records.append(record)
        else:
            with self._lock:
                self.dropped += 1

    def write_chrome_trace(self, path: str, counts: dict) -> None:
        """The records as a Chrome-trace JSON file (Perfetto, chrome://
        tracing): one complete event a span on its thread's track, times
        in microseconds after `baseTimeNanoseconds` on the wall clock, as
        torch.profiler writes its traces; `counts` ({group: {name:
        value}}) as one counter event per group at the last span's end."""
        recs = self.records()
        shift = time.time_ns() - time.perf_counter_ns()
        base = (min((r[1] for r in recs), default=0) + shift) // 10**9 \
            * 10**9
        us = lambda ns: (ns + shift - base) / 1e3
        pid = os.getpid()
        events = []
        for name, t0, t1, tid, sid, parent, call, attrs in recs:
            args = {"span_id": sid, "parent_id": parent, "call_id": call}
            args.update(attrs or {})
            events.append({"ph": "X", "cat": "svscope", "name": name,
                           "pid": pid, "tid": tid, "ts": us(t0),
                           "dur": (t1 - t0) / 1e3, "args": args})
        t_end = us(max((r[2] for r in recs), default=base - shift))
        for group, values in counts.items():
            events.append({"ph": "C", "cat": "svscope", "name": group,
                           "pid": pid, "ts": t_end, "args": dict(values)})
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "baseTimeNanoseconds": base,
                       "otherData": {"clock": "time.perf_counter_ns",
                                     "dropped": self.dropped}}, f)


TRACE = Recorder()


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
