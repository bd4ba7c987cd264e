"""The slice end to end on the CPU with device_poa="fused": the port's
localGraph engine (plain versions of K3 and K4 for every round of stage A's
MSA and of the per-cluster consensus) against the JAX golden."""
import torch

import localgraph_golden as lgg
from svscope_tpu_torch.engine.localgraph import (process_window_batch,
                                                 record_line)
from svscope_tpu_torch.ops import poa_fused as tpf
from svscope_tpu_torch.ops import poa_fused_kernel as tpk

torch.set_num_threads(1)


def test_fused_bench_windows_match_golden():
    golden = lgg.load_golden()["workloads"]["bench256"]["records"]
    wins = lgg.make_workload("bench256")[:4]
    tpf.reset_counts()
    launches = dict(tpk.LAUNCHES)
    recs = process_window_batch(wins, device="cpu", device_poa="fused")
    assert [lgg.sha256(record_line(r)) for r in recs] == golden[:4]
    assert sum(str(r[9]).endswith("EMOutput") for r in recs) == 4
    assert tpf.COUNTS["fallbacks"] == 0
    assert tpf.COUNTS["windows"] > 4      # stage A and the consensus jobs
    assert tpk.LAUNCHES == launches       # CPU tensors: plain versions
