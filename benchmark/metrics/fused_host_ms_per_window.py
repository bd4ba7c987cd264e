"""Host milliseconds a window spends in the fused engine's host parts: the
program's own spans `fused.plan` (plan_buckets), `fused.arrays`
(chunk_arrays), `fused.enqueue` (the builds' per-round launches),
`fused.emit` (the C++ engine's pk_emit_batch over a chunk) and
`fused.fallback` (the host engine's windows), both threads, summed over
the traced window's calls, over the windows completed there.  Not the
fetch, which waits for the card.  Loading this reader turns the
program's span recorder on; nothing where the program has none."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "ms/window", "ops.poa_fused", "lower", "program_span", "windows_per_s")
SPANS = []
NAMES = ("fused.plan", "fused.arrays", "fused.enqueue", "fused.emit",
         "fused.fallback")

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
