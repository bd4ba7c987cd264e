"""The plain reference equals the port on the CPU at a tiny size, and
imports nothing of the program or of JAX."""
import json
import os
import subprocess
import sys

import pytest

from benchmark import manifest
from benchmark.tests.svbench_common import tiny_run


@pytest.mark.parametrize("cell", ["ont30x-default.typical",
                                  "ont30x-fused.typical"])
def test_reference_equals_port(cell):
    """Every sampled window's row equal, the BICs within float32 of the
    float64 reference; the EM reached on most of them."""
    params = None
    if "fused" in cell:      # the fused build's plain versions are slow
        from benchmark.tests.svbench_common import TINY
        params = dict(TINY, windows_per_call=4, pool_calls=1)
    res, lines = tiny_run(cell, params=params)
    assert res["correct"], lines
    assert res["checks"]["rows_differing"]["value"] == 0
    assert 0 < res["checks"]["bic_gap"]["value"] < 1e-6
    assert res["failed"] == 0 and res["attempted"] > 0


def test_reference_imports_no_program():
    code = ("import sys; sys.path.insert(0, %r);"
            "import benchmark.reference.pipeline, benchmark.reference.em,"
            "benchmark.reference.msa, benchmark.check, benchmark.peaks,"
            "benchmark.generator;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % manifest.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=manifest.ROOT)
    mods = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert not mods & {"svscope_tpu_torch", "svscope_tpu", "jax", "jaxlib",
                       "flax"}


def test_reference_sources_name_no_program():
    here = os.path.join(manifest.HERE, "reference")
    for f in os.listdir(here):
        if f.endswith(".py"):
            src = open(os.path.join(here, f)).read()
            assert "import svscope" not in src and "from svscope" not in src
            assert "import jax" not in src
