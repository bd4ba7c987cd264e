"""Host milliseconds a window's call spends blocked on stage A: the
program's own spans `localgraph.stage_a_wait` (the caller waiting for the
worker thread's stage-A future in process_window_batch's pipeline),
summed over the traced window's calls, over the windows completed there.
Loading this reader turns the program's span recorder on; nothing where
the program has none."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "ms/window", "engine.localgraph", "lower", "program_span",
    "windows_per_s")
SPANS = []
NAMES = ("localgraph.stage_a_wait",)

try:
    from svscope_tpu_torch.utils.spans import TRACE
except ImportError:
    TRACE = None
else:
    TRACE.enable()


def read(run):
    if not run.windows or TRACE is None:
        return None
    t0, t1 = run.calls[run.first][1], run.calls[-1][2]
    spans = [r for r in TRACE.records()
             if r[0] in NAMES and t0 <= r[1] and r[2] <= t1]
    if not spans:
        return None
    return sum(r[2] - r[1] for r in spans) / 1e6 / run.windows
