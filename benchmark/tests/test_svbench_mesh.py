"""A configuration with `data_parallel` above 1: the harness installs the
port's own data mesh around the warm-up and the window, hands the
program the mesh's first device, clears the mesh afterwards, and reports
the mesh's cards.  On the CPU the mesh is the CPU twice
(make_dp_mesh(devices=...)): the program's sharded paths run as they do
across cards."""
import json

import pytest
import torch

from benchmark import harness, manifest
from benchmark.tests.svbench_common import tiny_run


def dp_manifest(tmp_path, n, chips):
    """BENCHMARK.json with ont30x-default's configuration at
    data_parallel = n, its file under tmp_path, and a cell of `chips`."""
    man = manifest.load_manifest()
    cfg = manifest.config(man, "ont30x-default")
    cfg["data_parallel"] = n
    path = tmp_path / "ont30x-default.json"
    path.write_text(json.dumps(cfg))
    for c in man["configs"]:
        if c["name"] == "ont30x-default":
            c["file"] = str(path)
    for w in man["workloads"]:
        if w["config"] == "ont30x-default":
            w["chips"] = chips
    return man


def test_cpu_mesh_run(tmp_path, monkeypatch):
    from svscope_tpu_torch.engine import localgraph
    from svscope_tpu_torch.parallel import dataparallel
    seen, shards = [], []
    orig = localgraph.process_window_batch

    def spy(wins, **kw):
        seen.append((dataparallel.data_mesh(), kw["device"]))
        out = orig(wins, **kw)
        shards.append(dataparallel.LAST_DISPATCH["n_shards"])
        return out
    monkeypatch.setattr(localgraph, "process_window_batch", spy)
    res, lines = tiny_run(man=dp_manifest(tmp_path, 2, 4))
    assert res["correct"], lines
    cpu = torch.device("cpu")
    assert len(seen) >= 2      # the warm-up and the window's calls
    assert all(mesh == (cpu, cpu) and dev == cpu for mesh, dev in seen)
    assert 2 in shards
    assert dataparallel.data_mesh() is None


def test_one_card_installs_no_mesh(monkeypatch):
    from svscope_tpu_torch.engine import localgraph
    from svscope_tpu_torch.parallel import dataparallel
    seen = []
    orig = localgraph.process_window_batch

    def spy(wins, **kw):
        seen.append(dataparallel.data_mesh())
        return orig(wins, **kw)
    monkeypatch.setattr(localgraph, "process_window_batch", spy)
    res, lines = tiny_run()
    assert res["correct"], lines
    assert seen and all(m is None for m in seen)


def test_a_cell_with_fewer_chips_than_its_mesh_is_refused(tmp_path):
    man = dp_manifest(tmp_path, 4, 1)
    with pytest.raises(ValueError, match="data_parallel = 4"):
        manifest.cell_config(man, "ont30x-default.typical")
    with pytest.raises(ValueError):
        tiny_run(man=man)
    man = dp_manifest(tmp_path, 4, 4)
    assert manifest.cell_config(man, "ont30x-default.typical")[1][
        "data_parallel"] == 4


def test_device_info_over_cards(monkeypatch):
    """count is the mesh's cards, memory_peak_bytes the fullest card's
    peak, each card's peak beside it; one card reports as before."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    dev = torch.device("cuda", 0)
    info = harness.device_info(dev, [5, 9, 7, 3], None)
    assert info == {"platform": "gpu", "kind": "card", "count": 4,
                    "memory_peak_bytes": 9,
                    "memory_peak_bytes_per_card": [5, 9, 7, 3]}
    assert harness.device_info(dev, [5], None) == {
        "platform": "gpu", "kind": "card", "count": 1,
        "memory_peak_bytes": 5}
