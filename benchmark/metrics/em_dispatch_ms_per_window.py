"""Host milliseconds a window spends in the EM's dispatch: the span of each
call of `em_cluster_batch_dispatch` as engine.localgraph binds it (host
prep, the Ward cut included, up to the device launch), over the windows
completed in the traced window."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "ms/window", "models.mixture", "lower", "program_span", "windows_per_s")
SPANS = [("em_cluster_batch_dispatch",
          "svscope_tpu_torch.engine.localgraph:em_cluster_batch_dispatch",
          False)]


def read(run):
    if not run.rec.spans.get("em_cluster_batch_dispatch") or not run.windows:
        return None
    return 1e3 * run.rec.total_s("em_cluster_batch_dispatch") / run.windows
