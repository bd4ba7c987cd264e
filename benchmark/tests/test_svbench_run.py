"""run.py's refusals: no card, a checkout without the program, a process
that loaded JAX or the JAX package; and an added metric and traffic mix
taken up from new files alone."""
import json
import os
import shutil
import subprocess
import sys

from benchmark import harness, manifest

ARGS = ["--workload", "ont30x-default.typical", "--seed", "2147483700",
        "--seconds", "1", "--trace", "0"]


def run_py(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          env=env, timeout=300)


def test_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_py(manifest.ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = run_py(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    assert harness.forbidden_modules() == [] or \
        "svscope_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "svscope_tpu_torch_x", sys)
    assert "svscope_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "svscope_tpu.ops", sys)
    assert "svscope_tpu" in harness.forbidden_modules()


DUMMY_METRIC = '''"""Batch calls a window: a dummy reader added as a file of its own."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "calls/window", "engine.localgraph", "lower", "program_span",
    "windows_per_s")
SPANS = [("_stage_a", "svscope_tpu_torch.engine.localgraph:_stage_a",
          False)]


def read(run):
    return len(run.calls) / run.windows if run.windows else None
'''


def test_new_metric_and_mix_from_new_files_only(tmp_path):
    """A copy of the benchmark gains a metric file, a traffic file, a
    limits file and their BENCHMARK.json entries; no file it had changes,
    and a traced CPU run of the new cell reports the new metric."""
    from benchmark.tests.svbench_common import TINY, TINY_LIMITS
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest.load_manifest()
    (root / "benchmark/metrics/calls_per_window.py").write_text(DUMMY_METRIC)
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(TINY))
    cell = "ont30x-default.tiny"
    (root / f"benchmark/limits/{cell}.json").write_text(
        json.dumps(TINY_LIMITS))
    man["workloads"].append({"name": cell, "config": "ont30x-default",
                             "traffic": "tiny", "chips": 1,
                             "why": "a dummy mix"})
    man["per_layer"].append({"name": "calls_per_window",
                             "unit": "calls/window", "better": "lower",
                             "source": "program_span",
                             "layer": "engine.localgraph",
                             "moves": "windows_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    code = (
        "import json, sys; sys.path.insert(0, %r); sys.path.append(%r);"
        "from benchmark import harness, manifest;"
        "assert manifest.ROOT == %r;"
        "res, lines = harness.run(%r, 5, 0.2, True, 'cpu',"
        " log=lambda s: None);"
        "print(json.dumps(res))" % (str(root), manifest.ROOT, str(root),
                                    cell))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert res["metrics"]["calls_per_window"]["unit"] == "calls/window"
    assert 0 < res["metrics"]["calls_per_window"]["value"] <= 1
    assert "stage_a_ms_per_window" not in res["metrics"]
