"""tools/glue_split.py on the CPU: its workloads are the states that
chip_smoke.py's pk-glue-time phase times (the bench256 chunk at round 12,
the heavy tier at round 200), its capture is the graph state that the
build hands K6 at that round, its summary reads the slowest block, and it
refuses to run without the card (the stamps exist only in the kernels).
The stamped kernels themselves run in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import chip_smoke
import localgraph_golden as lgg
from svscope_tpu_torch.tools import glue_split as gs
from svscope_tpu_torch.tools.workloads import make_window_payloads

torch.set_num_threads(1)


def test_workloads_are_chip_smokes_captures():
    b, h = lgg.WORKLOADS["bench256"], lgg.WORKLOADS["heavy32x400"]
    assert gs.WORKLOADS["bench"] == (
        chip_smoke.PK_BATCH, b["seed"], b["n_reads"], b["ins_carriers"],
        chip_smoke.PK_BENCH_ROUNDS[1])
    assert gs.WORKLOADS["heavy"] == (
        h["n"], h["seed"], h["n_reads"], h["ins_carriers"],
        chip_smoke.PK_HEAVY_ROUND)


def test_capture_is_the_builds_round_state(monkeypatch):
    monkeypatch.setitem(gs.WORKLOADS, "small", (4, 0, 6, 2, 2))
    st, seq, slen = gs.capture("small", torch.device("cpu"))
    wins = make_window_payloads(4, np.random.default_rng(0), n_reads=6,
                                ins_carriers=2)
    _b, caps = chip_smoke.capture_rounds([w.sequences for w in wins], (2,),
                                         "cpu")
    ops, want, *_ = caps[2]
    assert all(torch.equal(a, b) for a, b in zip(st.tensors(),
                                                 want.tensors()))
    assert torch.equal(seq, ops[3][:, 1:]) and torch.equal(slen, ops[4])
    assert (st.nn > 0).all()


def test_summary_reads_the_slowest_block():
    cyc = np.array([[10, 100, 5, 5], [20, 300, 10, 10]])
    r = gs.summarize(cyc, gs.PREP_PARTS, {"kahn steps": np.array([10, 30])},
                     "step")
    assert r["slowest_block"] == 1
    assert r["parts"]["kahn steps"]["slowest_cycles"] == 300
    assert r["cycles_per_step"] == 10.0
    assert r["mean_cycles_per_step"] == 10.0
    assert abs(sum(p["mean_share"] for p in r["parts"].values()) - 1) < 1e-12


def test_refuses_to_run_without_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gs.main(["--workload", "bench"])
