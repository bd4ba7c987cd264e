"""Share of the fused engine's wall in which the card does nothing: 100 x
(1 - device-busy time inside the spans of `fused_msa_batch` / those
spans), the busy time from torch.profiler's CUPTI trace.  What is left
is host work around the device build (plan_buckets, chunk_arrays, the
C++ engine's pk_emit_batch a chunk, the host engine's fallbacks, counted
in poa_fused.COUNTS["fallbacks"]) and the host's waits, for the
interpreter lock among them; the build's kernels and copies are not.
Nothing where the trace misses kernels the program launched."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "%", "ops.poa_fused", "lower", "device_trace", "windows_per_s")
SPANS = [
    ("fused_msa_batch", "svscope_tpu_torch.ops.poa_batch:fused_msa_batch",
     False),
    # not read here: they split the breakdown's idle time inside the engine
    ("build_batch_pk", "svscope_tpu_torch.ops.poa_fused:build_batch_pk",
     False),
    ("fetch_build", "svscope_tpu_torch.ops.poa_fused:fetch_build", False),
]


def read(run):
    spans = run.rec.spans.get("fused_msa_batch")
    if run.trace is None or not run.trace_ok or not spans:
        return None
    total = sum(b - a for a, b, _t in spans) / 1e9
    if total <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_within(spans) / total)
