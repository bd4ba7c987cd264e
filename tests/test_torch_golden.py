"""tests/data/jax_localgraph_golden.json stays what the JAX engine emits,
and the port on the CPU (host POA) reproduces it.  chip_smoke.py holds the
port on the GPU to the same file."""
import pytest
import torch

import localgraph_golden as lgg
from svscope_tpu_torch.engine.localgraph import process_window_batch, record_line

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    return lgg.load_golden()


@pytest.mark.parametrize("name", sorted(lgg.WORKLOADS))
def test_golden_workload_is_fresh(golden, name):
    g = golden["workloads"][name]
    assert {k: g[k] for k in lgg.WORKLOADS[name]} == lgg.WORKLOADS[name]
    assert g["payload_sha256"] == lgg.payload_sha256(lgg.make_workload(name))
    assert g["records"] == lgg.jax_workload_records(name)


def test_golden_synth_pair_is_fresh(golden):
    assert golden["synth_pair"]["raw_bed_sha256"] == \
        lgg.jax_synth_raw_bed_sha()


def test_port_cpu_matches_golden_bench256(golden):
    wins = lgg.make_workload("bench256")
    recs = process_window_batch(wins, device_poa=False, device="cpu")
    got = [lgg.sha256(record_line(r)) for r in recs]
    want = golden["workloads"]["bench256"]["records"]
    assert sum(a == b for a, b in zip(got, want)) == len(want) == 256


def test_record_line_is_the_golden_join():
    rec = ["chr1", "10", "20", "-", "-", 0, "-", "-", 0, "NormalOutput"]
    assert record_line(rec) == lgg.record_line(rec)
