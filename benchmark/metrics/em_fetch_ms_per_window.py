"""Host milliseconds a window spends in the EM's fetch: the program's own
spans `mixture.fetch` (the wait for the device, the copies back, the
NaN-BIC retries and the label selection), summed over the traced window's
calls, over the windows completed there.  Loading this reader turns the
program's span recorder on; nothing where the program has none."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "ms/window", "models.mixture", "lower", "program_span", "windows_per_s")
SPANS = []
NAMES = ("mixture.fetch",)

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
