"""Host milliseconds a window spends in stage A (gates, the POA MSA,
feature selection): the span of each call of engine.localgraph's
`_stage_a`, summed over the traced window (a worker thread runs it beside
the EM and the emission), over the windows completed there."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "ms/window", "engine.localgraph", "lower", "program_span",
    "windows_per_s")
SPANS = [("_stage_a", "svscope_tpu_torch.engine.localgraph:_stage_a",
          False)]


def read(run):
    if not run.rec.spans.get("_stage_a") or not run.windows:
        return None
    return 1e3 * run.rec.total_s("_stage_a") / run.windows
