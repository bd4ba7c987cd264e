"""Share of the card's idle time that falls while the host runs a POA
engine's host parts: 100 x the device-idle time inside the union, over
both threads, of the program's spans of the per-round engine's host parts
(`poa.round.route`, `poa.round.host_dp`, `poa.chunk.pack`,
`poa.chunk.fuse`, `poa.extract`) and the fused engine's (`fused.plan`,
`fused.arrays`, `fused.enqueue`, `fused.emit`, `fused.fallback`) / the
traced window's device-idle time.  The spans are on the host clock the
trace's markers tie to it (`offset_us`); busy time is torch.profiler's
CUPTI trace.  Loading this reader turns the program's span recorder on;
nothing where the program has none, or the trace misses kernels the
program launched."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "%", "ops.poa_batch", "lower", "device_trace", "windows_per_s")
SPANS = []
NAMES = ("poa.round.route", "poa.round.host_dp", "poa.chunk.pack",
         "poa.chunk.fuse", "poa.extract", "fused.plan", "fused.arrays",
         "fused.enqueue", "fused.emit", "fused.fallback")

try:
    from svscope_tpu_torch.utils.spans import TRACE
except ImportError:
    TRACE = None
else:
    TRACE.enable()


def read(run):
    if not run.windows or TRACE is None:
        return None
    if run.trace is None or not run.trace_ok or run.trace.window_s <= 0:
        return None
    t0, t1 = run.calls[run.first][1], run.calls[-1][2]
    spans = sorted((r[1], r[2]) for r in TRACE.records()
                   if r[0] in NAMES and t0 <= r[1] and r[2] <= t1)
    union: list = []
    for a, b in spans:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    idle = run.trace.window_s - run.trace.busy_s()
    if not union or idle <= 0:
        return None
    inside = sum(b - a for a, b in union) / 1e9 - run.trace.busy_within(union)
    return 100.0 * inside / idle
