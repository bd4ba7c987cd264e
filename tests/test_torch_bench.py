"""The port's bench (svscope_tpu_torch/tools/bench.py) on the CPU at small
sizes: bench.py's JSON keys and workload, the golden records, the
baseline's source, the stage parts, and no CPU run where CUDA was asked
for."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import localgraph_golden as lgg
from svscope_tpu_torch.ops.poa_batch import ROUND_PARTS
from svscope_tpu_torch.tools import bench
from svscope_tpu_torch.tools.probe import stage_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUIET = dict(log=lambda *_: None)
torch.set_num_threads(1)


def jax_bench_keys():
    """(keys of bench.run_measurement's `out` literal, keys it adds by
    subscript): what the JAX bench always prints, and what it may."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "run_measurement")
    always, maybe = set(), set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "out"):
            always |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)
              and isinstance(node.value, ast.Name)
              and node.value.id == "out"):
            maybe.add(node.slice.value)
    return always, maybe


@pytest.fixture(scope="module")
def small_run():
    golden = lgg.load_golden()
    return bench.run_measurement(16, heavy=False, device="cpu",
                                 golden=golden, engines=("host",), **QUIET)


def test_line_holds_every_key_of_bench_py(small_run):
    always, maybe = jax_bench_keys()
    assert {"metric", "value", "trial_s", "stages", "device_probe_s"} \
        <= always
    assert {"heavy_tier", "vs_baseline_poa_incl"} <= maybe
    line = json.dumps(small_run)
    assert "\n" not in line and json.loads(line) == small_run
    assert always | {"device", "baseline_source", "engines"} <= set(small_run)
    assert {"n_windows", "stage_a_poa_feat_s", "stage_b_em_device_s",
            "stage_c_consensus_s"} <= set(small_run["stages"])
    assert small_run["device"] == "cpu" and small_run["device_probe_s"] \
        is None
    assert "CPU EM" in small_run["metric"]
    assert set(small_run["engines"]) == {"host"}
    assert small_run["engines"]["host"]["launches"] == {
        "K1": 0, "K3": 0, "K4": 0, "K6": 0, "K7": 0}


def test_heavy_tier_keys(monkeypatch):
    """The heavy tier's keys (bench.py's, plus the pallas run's: plain K1
    on the CPU), at 1 window x 24 reads."""
    monkeypatch.setattr(bench, "HEAVY_WINDOWS", 1)
    monkeypatch.setattr(bench, "HEAVY_READS", 24)
    res = bench.measure_heavy_tier(torch.device("cpu"), ("host", "pallas"))
    assert set(res) == {"n_windows", "n_reads", "w_per_s", "trial_s",
                        "em_dispatch_prep_s", "em_device_wait_s", "pallas"}
    assert res["n_windows"] == 1 and len(res["trial_s"]) == 2
    assert res["em_dispatch_prep_s"] >= 0 and res["em_device_wait_s"] >= 0
    assert set(res["pallas"]) == {"w_per_s", "cold_s", "trial_s",
                                  "launches"}
    assert len(res["pallas"]["trial_s"]) == 2
    assert res["pallas"]["launches"] == {"K1": 0, "K3": 0, "K4": 0,
                                          "K6": 0, "K7": 0}


def test_payloads_equal_bench_py():
    sys.path.insert(0, REPO)
    import bench as jax_bench
    ours = bench.make_window_payloads(bench.N_WINDOWS,
                                      np.random.default_rng(0))
    theirs = jax_bench.make_window_payloads(bench.N_WINDOWS,
                                            np.random.default_rng(0))
    assert len(ours) == len(theirs) == 256
    for a, b in zip(ours, theirs):
        assert a.sequences == b.sequences
        assert list(a.read_ids) == list(b.read_ids)
        assert (a.flank_5, a.flank_3, a.record, a.flag) == \
            (b.flank_5, b.flank_3, b.record, b.flag)


def test_measured_host_records_equal_the_golden(small_run):
    """The measured host run's records equal the first 16 record hashes of
    the golden's bench256 (the JAX engine on all 256 windows: a window's
    record does not depend on the windows batched with it)."""
    assert small_run["golden"] == 16
    assert small_run["engines"]["host"]["golden"] == 16
    assert small_run["engines"]["host"]["somatic"] == 16
    assert bench.golden_counts(small_run) == {"headline": (16, 16),
                                              "host": (16, 16)}
    assert bench.golden_counts({**small_run, "golden": 15})["headline"] \
        == (15, 16)


def test_baseline_source(tmp_path):
    rec = bench.measure_reference_baseline(str(tmp_path / "absent"))
    assert rec == {"source": "recorded", "em_only": [2.2] * 3,
                   "poa_incl": None}
    assert bench.measure_reference_baseline(None)["source"] == "recorded"
    # a stand-in reference: its EMCluster is timed, then the POA bound
    (tmp_path / "ReadsCluster.py").write_text(
        "def EMCluster(x, initselection=1):\n    return x.sum()\n")
    sys.modules.pop("ReadsCluster", None)
    try:
        ref = bench.measure_reference_baseline(str(tmp_path), budget_s=0.5,
                                               n_runs=2)
    finally:
        sys.modules.pop("ReadsCluster", None)
    assert ref["source"] == "reference"
    med, lo, hi = ref["em_only"]
    assert 0 < lo <= med <= hi
    assert 0 < ref["poa_incl"] < med
    assert str(tmp_path) not in sys.path


def test_cuda_absent_fails_without_a_cpu_run():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    res = subprocess.run(
        [sys.executable, "-m", "svscope_tpu_torch.tools.bench", "--device",
         "cuda", "--small"], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=120)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert not any(l.startswith("{") for l in res.stdout.splitlines())


def test_stage_parts(small_run):
    """Every stage part >= 0; the pallas round's parts (plain K1 on the
    CPU) sum to at most its stage A."""
    st = small_run["stages"]
    assert st["n_windows"] == 16
    assert set(st["parts"]) == {"host"}
    assert set(st["parts"]["host"]) == set(stage_probe.PARTS)
    assert all(v >= 0 for v in st["parts"]["host"].values())
    assert min(st[k] for k in ("stage_a_poa_feat_s", "stage_b_em_device_s",
                               "stage_c_consensus_s")) >= 0
    res = bench.measure_stages(1, torch.device("cpu"), ("pallas",), **QUIET)
    assert set(res["parts"]) == {"pallas"}
    assert all(v >= 0 for v in res["parts"]["pallas"].values())
    rnd = res["pallas_round"]
    assert set(rnd) == {"stage_a_s", "gates", "poa_msa", "featsel",
                        *ROUND_PARTS}
    assert all(v >= 0 for v in rnd.values())
    assert 0 < sum(rnd[p] for p in ROUND_PARTS) <= rnd["poa_msa"] \
        <= rnd["stage_a_s"]


def test_main_small_fails_when_records_fall_short(tmp_path, capsys):
    """`--device cpu --small`: 64 windows, no heavy tier, one JSON line
    last; a golden the records do not match makes the run fail."""
    golden = lgg.load_golden()
    recs = golden["workloads"]["bench256"]["records"]
    recs[0] = "0" * 64
    path = tmp_path / "golden.json"
    path.write_text(json.dumps(golden))
    rc = bench.main(["--device", "cpu", "--small", "--golden", str(path)])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1
    assert out["n_windows"] == bench.SMALL_WINDOWS and "heavy_tier" not in out
    assert out["golden"] == out["engines"]["host"]["golden"] == 63
