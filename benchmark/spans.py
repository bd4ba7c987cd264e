"""Spans and captures recorded from the benchmark's own code: a program
function is wrapped under the name its caller binds ("module:attr"), and
each call through it is timed on the host clock (perf_counter_ns), with
its inputs and result kept where a reader needs them.  Imports nothing of
the program itself: targets are resolved when wrapped."""
from __future__ import annotations

import importlib
import threading
import time
from collections import defaultdict

import numpy as np


def resolve(target: str):
    mod_name, attr = target.split(":")
    return importlib.import_module(mod_name), attr


class Recorder:
    """Wraps targets; `spans[name]` holds (start_ns, end_ns, thread) of
    each call, `io[name]` (args, kwargs, result) where asked for.  Every
    wrap is undone by `restore`."""

    def __init__(self):
        self.spans: dict[str, list] = defaultdict(list)
        self.io: dict[str, list] = defaultdict(list)
        self.on = True
        self._patches: list = []
        self._wrapped: set[str] = set()
        self._keep: dict[str, bool] = {}

    def wrap(self, name: str, target: str, keep_io: bool = False) -> None:
        """Wrap `target` once; a second wrap of it only adds keep_io."""
        if target in self._wrapped:
            self._keep[target] = self._keep[target] or keep_io
            return
        mod, attr = resolve(target)
        orig = getattr(mod, attr)
        spans, io = self.spans[name], self.io[name]
        self._keep[target] = keep_io
        keep = self._keep

        def wrapper(*args, **kwargs):
            if not self.on:
                return orig(*args, **kwargs)
            t0 = time.perf_counter_ns()
            res = orig(*args, **kwargs)
            spans.append((t0, time.perf_counter_ns(), threading.get_ident()))
            if keep[target]:
                io.append((args, kwargs, res))
            return res

        wrapper.__wrapped__ = orig
        setattr(mod, attr, wrapper)
        self._patches.append((mod, attr, orig))
        self._wrapped.add(target)

    def restore(self) -> None:
        for mod, attr, orig in reversed(self._patches):
            setattr(mod, attr, orig)
        self._patches.clear()
        self._wrapped.clear()

    def clear(self) -> None:
        """Forget every span and capture (the wrappers stay)."""
        for lst in (*self.spans.values(), *self.io.values()):
            lst.clear()

    def total_s(self, name: str) -> float:
        return sum(b - a for a, b, _t in self.spans.get(name, ())) / 1e9


class EmCapture:
    """What the EM hands the emission, per batch call and window: the
    engine's phase-B dispatch (`engine.localgraph:_dispatch_em`) gets the
    chunk's ready windows and returns a fetch(); the wrapped fetch keeps
    each window's BICs (item 6 of its [K, x, labels, ..., bics], a copy;
    the rest is let go) under (call, id(window))."""

    TARGET = "svscope_tpu_torch.engine.localgraph:_dispatch_em"

    def __init__(self):
        self.call = -1
        self.results: dict[tuple[int, int], list] = {}
        self._patch = None

    def install(self) -> None:
        mod, attr = resolve(self.TARGET)
        orig = getattr(mod, attr)
        cap = self

        def dispatch(ready, *args, **kwargs):
            fetch = orig(ready, *args, **kwargs)
            call = cap.call

            def wrapped_fetch():
                res = fetch()
                for entry, r in zip(ready, res):
                    cap.results[(call, id(entry[0]))] = (
                        None if r is None else np.array(r[6], copy=True))
                return res
            return wrapped_fetch

        setattr(mod, attr, dispatch)
        self._patch = (mod, attr, orig)

    def restore(self) -> None:
        if self._patch is not None:
            mod, attr, orig = self._patch
            setattr(mod, attr, orig)
            self._patch = None
