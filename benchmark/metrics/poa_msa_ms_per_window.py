"""Host milliseconds a window spends in `poa_msa_batch` as
engine.localgraph binds it: stage A's MSA and the clusters' consensus POA
(ops.poa_batch, whichever engine the configuration picks), over the
windows completed in the traced window."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "ms/window", "ops.poa_batch", "lower", "program_span", "windows_per_s")
SPANS = [("poa_msa_batch",
          "svscope_tpu_torch.engine.localgraph:poa_msa_batch", True)]


def read(run):
    if not run.rec.spans.get("poa_msa_batch") or not run.windows:
        return None
    return 1e3 * run.rec.total_s("poa_msa_batch") / run.windows
