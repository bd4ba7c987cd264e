"""BENCHMARK.json and every file it names load, keep to the contract's
shapes, and agree with each other."""
import json
import os
import re

import pytest

from benchmark import manifest

MAN = manifest.load_manifest()
NAME = manifest.NAME_RE
UNIT = manifest.UNIT_RE
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p)
        assert os.path.isdir(os.path.join(manifest.ROOT, p))


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and TEXT.match(c["why"])
    assert TEXT.match(c["source"])
    assert c["file"].startswith("benchmark/")
    cfg = manifest.config(MAN, c["name"])
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert all(NAME.match(k) for k in c["reduced"])
    assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for key in ("t_label", "readcutoff", "hcutoff", "scutoff", "em_dtype",
                "device_poa", "dp_kernels", "threads"):
        assert key in cfg


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
    manifest.traffic(w["traffic"])
    lim = manifest.limits(w["name"])
    assert set(lim) == {"sample", "rows_differing", "bic_gap"}
    _c, cfg = manifest.cell_config(MAN, w["name"])
    assert w["chips"] >= cfg.get("data_parallel", 1)
    e2e = manifest.end_to_end_for(MAN, w["name"])
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert manifest.per_layer_for(MAN, w["name"])


def test_names_unique():
    for key in ("configs", "workloads"):
        names = [x["name"] for x in MAN[key]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("m", MAN["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                       "source"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(m):
    assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                       "layer", "moves"}
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert TEXT.match(m["layer"])
    mod = manifest.metric_module(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        m["unit"], m["layer"], m["better"], m["source"], m["moves"])
    assert m["moves"] in [e["name"] for e in MAN["end_to_end"]]
    for w in m.get("workloads", []):
        assert w in [c["name"] for c in MAN["workloads"]]
    for name, target, _keep in mod.SPANS:
        assert target.startswith("svscope_tpu_torch.") and ":" in target
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


@pytest.mark.parametrize("path", sorted(
    os.path.relpath(os.path.join(d, f), manifest.ROOT)
    for d, _s, fs in os.walk(manifest.HERE) for f in fs
    if "__pycache__" not in d))
def test_file_names(path):
    assert re.fullmatch(r"[A-Za-z0-9_./\-]+", path), path
