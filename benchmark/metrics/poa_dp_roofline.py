"""The POA DP kernel's share of its H100 roofline: the least time the card
could take for the DP work the traced window asked for (peaks.py, counted
from each poa_msa_batch call's windows and MSAs: real nodes, pred edges
and read lengths, not the padded bucket) over the device time of the
configuration's DP kernels in the trace (config "dp_kernels": K1 in the
default engine, K3 in the fused one).  Nothing where the trace misses
kernels the program launched."""
from benchmark import peaks

UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "%", "kernels", "higher", "device_trace", "windows_per_s")
SPANS = [("poa_msa_batch",
          "svscope_tpu_torch.engine.localgraph:poa_msa_batch", True)]


def read(run):
    if run.trace is None or not run.trace_ok:
        return None
    kernel_s = run.trace.time_of(run.cfg["dp_kernels"])
    calls = [(args[0], res) for args, _kw, res in
             run.rec.io.get("poa_msa_batch", ())]
    ops, nbytes = peaks.dp_work(calls)
    if kernel_s <= 0 or ops <= 0:
        return None
    return 100.0 * peaks.bound_s(nbytes, ops) / kernel_s
