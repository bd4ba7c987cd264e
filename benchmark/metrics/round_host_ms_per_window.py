"""Host milliseconds a window spends in the per-round device POA's host
parts: the program's own spans `poa.round.route`, `poa.round.host_dp`,
`poa.chunk.pack`, `poa.chunk.fuse` and `poa.extract` (ops.poa_batch's
`_DeviceBuild`, stage A's MSA on the worker thread and the consensus POA
on the caller alike), summed over the traced window's calls, over the
windows completed there.  Not the chunks' launches and waits.  Loading
this reader turns the program's span recorder on; nothing where the
program has none."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "ms/window", "ops.poa_batch", "lower", "program_span", "windows_per_s")
SPANS = []
NAMES = ("poa.round.route", "poa.round.host_dp", "poa.chunk.pack",
         "poa.chunk.fuse", "poa.extract")

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
