"""BENCHMARK.json and the files it names: configurations, traffic mixes,
per-layer metric readers and the cells' correctness limits, each found by
name.  Imports nothing of the program."""
from __future__ import annotations

import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for c in manifest["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: str = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def cell_config(manifest: dict, name: str, root: str = ROOT):
    """(cell, its configuration); refuses a cell that asks for fewer chips
    than its configuration's data mesh (`data_parallel`, default 1)."""
    c = cell(manifest, name)
    cfg = config(manifest, c["config"], root)
    if int(c["chips"]) < int(cfg.get("data_parallel", 1)):
        raise ValueError(f"{name} asks for {c['chips']} chips, and its "
                         f"configuration {c['config']} splits over "
                         f"data_parallel = {cfg['data_parallel']} cards")
    return c, cfg


def traffic(name: str, here: str = HERE) -> dict:
    with open(os.path.join(here, "traffic", name + ".json")) as f:
        return json.load(f)


def limits(cell_name: str, here: str = HERE) -> dict:
    with open(os.path.join(here, "limits", cell_name + ".json")) as f:
        return json.load(f)


def metric_module(name: str):
    """benchmark/metrics/<name>.py (a metric name may hold '.' and '-':
    the file is found by its path, not as a dotted module name)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics._" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def end_to_end_for(manifest: dict, cell_name: str) -> list[dict]:
    return [m for m in manifest["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def per_layer_for(manifest: dict, cell_name: str) -> list[dict]:
    e2e = {m["name"] for m in end_to_end_for(manifest, cell_name)}
    return [m for m in manifest["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in e2e]
