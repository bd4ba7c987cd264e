"""Timers of the kernel measurement tools: CUDA events on the card (the
device's own clock), the host clock on the CPU.

A `queued` timing on the card holds the stream with a spin kernel
(`torch.cuda._sleep`) while the host issues every timed call, so all of
them are queued before the start event is reached and the events time the
device's work alone, not the host's issue rate for the wrapper.  If the
device reaches the start event before the host has issued the last call,
the run is repeated with a hold four times as long; after HOLD_TRIES
such runs the timing raises.  Plain versions that wait for the device
themselves (a `.cpu()` inside) are timed with `queued=False`: events
around calls issued back to back, host work included."""
from __future__ import annotations

import time

import torch

HOLD_CYCLES = 1 << 18   # first hold per timed call: ~130 us at 1.98 GHz
HOLD_TRIES = 6          # each try holds the stream 4x longer


def _timed(prepare, count: int, dev: torch.device, queued: bool) -> float:
    """Mean ms per call of the run that prepare() returns (made before the
    timing starts), which makes `count` calls."""
    if dev.type != "cuda":
        run = prepare()
        t0 = time.perf_counter()
        run()
        return (time.perf_counter() - t0) * 1e3 / count
    cycles = HOLD_CYCLES * count
    for _ in range(HOLD_TRIES if queued else 1):
        run = prepare()
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(cycles)
        start.record()
        run()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize(dev)
        if ahead or not queued:
            return start.elapsed_time(end) / count
        cycles *= 4
    raise RuntimeError(f"the host did not queue {count} calls within a "
                       f"{cycles // 4}-cycle hold of the stream")


def time_call(fn, dev: torch.device, reps: int, queued: bool) -> float:
    """Mean ms of fn() over `reps` calls, after one warm-up call."""
    fn()

    def prepare():
        def run():
            for _ in range(reps):
                fn()
        return run
    return _timed(prepare, reps, dev, queued)


def time_each(setup, fn, dev: torch.device, reps: int, queued: bool) -> float:
    """Mean ms of fn(*setup()) over `reps` calls, after one warm-up call: for
    a function that updates its inputs in place, every call gets fresh
    ones, all made by setup() before the timing starts."""
    fn(*setup())

    def prepare():
        args = [setup() for _ in range(reps)]

        def run():
            for a in args:
                fn(*a)
        return run
    return _timed(prepare, reps, dev, queued)
