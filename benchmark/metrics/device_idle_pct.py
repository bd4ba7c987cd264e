"""Share of the traced window in which nothing ran on the card: 100 x (1 -
union of kernel, copy and memset intervals / window), from torch.profiler's
CUPTI trace; nothing where the trace misses kernels the program
launched."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "%", "device", "lower", "device_trace", "windows_per_s")
SPANS = []


def read(run):
    if (run.trace is None or not run.trace_ok or run.trace.window_s <= 0
            or not run.trace.ops):
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
