"""The port's engine probes on the CPU at their smallest sizes: every
variant's records equal the engine's (core_scaling_probe, stage_probe,
pipeline_probe, e2e_probe; tools/probe/ of the port)."""
import os

import numpy as np
import pytest
import torch

import localgraph_golden as lgg
from svscope_tpu_torch.ops.poa_batch import ROUND_PARTS, poa_msa_batch
from svscope_tpu_torch.tools.probe import (core_scaling_probe, e2e_probe,
                                           pipeline_probe, stage_probe)
from svscope_tpu_torch.tools.workloads import make_window_payloads

torch.set_num_threads(1)
QUIET = dict(log=lambda *_: None)


@pytest.fixture
def one_core():
    cpus = os.sched_getaffinity(0)
    os.sched_setaffinity(0, {min(cpus)})
    try:
        yield
    finally:
        os.sched_setaffinity(0, cpus)


def test_core_counts():
    assert core_scaling_probe.core_counts(range(1)) == [1]
    assert core_scaling_probe.core_counts(range(8)) == [1, 2, 4, 8]
    assert core_scaling_probe.core_counts(range(6)) == [1, 2, 4, 6]


def test_timed_device_round_equals_poa_msa_batch():
    """poa_msa_batch(timing=), which the probe reads, gives the untimed
    build's MSAs (device aligner, plain K1 on the CPU) and times every
    part of the device round."""
    jobs = [w.sequences for w in
            make_window_payloads(2, np.random.default_rng(3))]
    parts = {}
    got = poa_msa_batch(jobs, use_device=True, device="cpu", timing=parts)
    assert got == poa_msa_batch(jobs, use_device=True, device="cpu")
    assert set(parts) == set(ROUND_PARTS)
    assert all(v >= 0 for v in parts.values())


def test_core_scaling_probe_runs_at_one_core(one_core):
    res = core_scaling_probe.run(windows=2, trials=1, device="cpu", **QUIET)
    assert list(res["rows"]) == [1]
    row = res["rows"][1]
    assert row["engine_s"] > 0 and row["poa_s"] > 0
    assert set(row["glue"]) == set(ROUND_PARTS)
    assert 0 < sum(row["glue"].values()) <= row["msa_s"]
    assert os.sched_getaffinity(0) == {min(os.sched_getaffinity(0))}


def test_stage_probe_parts_and_records():
    res = stage_probe.run(windows=8, trials=1, device="cpu", **QUIET)
    assert set(res["best"]) == set(stage_probe.PARTS)
    assert len(res["records"]) == 8
    assert all(str(r[9]).endswith("EMOutput") for r in res["records"])


def test_pipeline_probe_two_chunks():
    """136 windows: two chunks, so the pipelined path runs its worker
    thread; serial and pipelined records are equal."""
    res = pipeline_probe.run(("serial", "pipe-t1"), windows=136, trials=1,
                             device="cpu", **QUIET)
    assert set(res) == {"serial", "pipe-t1"}
    with pytest.raises(SystemExit):
        pipeline_probe.main(["nope", "--device", "cpu"])


def test_e2e_probe_engines_agree_with_the_golden():
    golden = lgg.load_golden()["workloads"]["bench256"]["records"]
    res = e2e_probe.run(("host", "pallas"), windows=2, trials=1,
                        device="cpu", golden=golden, **QUIET)
    for row in res.values():
        assert row["same_as_first"] == 2 and row["golden"] == 2
        assert row["somatic"] == 2
