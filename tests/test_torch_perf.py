"""Pinned-workload perf guard of the port (counterpart of
tests/test_perf.py): the 64-window bench workload
(svscope_tpu_torch/tools/workloads.make_window_payloads, the same RNG
seed as bench.py) through the port's process_window_batch with host C++
POA on the CPU, against test_perf.py's committed envelope.  An
order-of-magnitude slowdown (an accidentally serialized batch path) is an
engine regression; the tight envelope asserts only where a host opts in
with SVSCOPE_PERF_ASSERT=1, as shared hosts can blow a 2.5x margin with no
engine regression.  tools/bench.py's trial_s and stages carry the
fine-grained story."""
import os
import time

import numpy as np
import torch

from svscope_tpu_torch.engine.localgraph import process_window_batch
from svscope_tpu_torch.tools.workloads import make_window_payloads

# tests/test_perf.py's envelope: seconds for 64 windows on a CPU host (the
# port took 0.19 s warm there on 2 cores)
ENVELOPE_64_S = 2.5
GUARD_FACTOR = 2.5


def test_pinned_workload_cpu_throughput():
    torch.set_num_threads(2)
    wins = make_window_payloads(64, np.random.default_rng(0))
    process_window_batch(wins, device_poa=False, device="cpu")   # warm
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        records = process_window_batch(wins, device_poa=False, device="cpu")
        best = min(best, time.perf_counter() - t0)
    n_som = sum(1 for r in records if str(r[9]).endswith("EMOutput"))
    assert n_som >= 51, f"only {n_som}/64 somatic calls"
    loose = ENVELOPE_64_S * 10
    assert best <= loose, (
        f"pinned 64-window workload took {best:.1f}s on the CPU (>10x the "
        f"{ENVELOPE_64_S}s envelope): an order-of-magnitude engine "
        "regression; see tools/bench.py's stages to localize")
    limit = ENVELOPE_64_S * GUARD_FACTOR
    if os.environ.get("SVSCOPE_PERF_ASSERT") != "1":
        print(f"[test_torch_perf] 64 windows in {best:.2f}s (tight envelope "
              f"{limit:.0f}s asserts with SVSCOPE_PERF_ASSERT=1)")
        return
    assert best <= limit, (
        f"pinned 64-window workload took {best:.1f}s on the CPU (envelope "
        f"{ENVELOPE_64_S}s x{GUARD_FACTOR}): engine regression; see "
        "tools/bench.py's stages to localize")
