"""The control on the card: the reference with its EM in float32 with TF32
products, put in the program's place, must come out not correct, while
the program, on the same windows, comes out correct.  A test-sized
version of what `benchmark/control.py` reads at each cell's own size:

  python -m pytest benchmark/tests/test_svbench_control.py -q -p no:cacheprovider
"""
import pytest

from benchmark import manifest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (TF32 exists only on the card)")
    return "cuda"


@pytest.mark.parametrize("cell", ["ont30x-default.typical",
                                  "ont30x-default.pileup",
                                  "ont30x-fused.typical",
                                  "ont30x-fused.pileup"])
def test_control_fails_and_program_passes(cuda, cell):
    from benchmark import harness
    params = dict(manifest.traffic(manifest.cell(
        manifest.load_manifest(), cell)["traffic"]), pool_calls=1)
    params["windows_per_call"] = min(params["windows_per_call"], 32)
    limits = manifest.limits(cell)
    res, lines = harness.run(cell, 2 ** 31 + 4242, 0.1, False, cuda,
                             params=params, limits=limits,
                             modes=("ref", "tf32"), log=lambda s: None)
    assert res["correct"], lines
    ctl = res["controls"]["tf32"]
    assert not ctl["correct"], ctl
    assert ctl["bic_gap"] > limits["bic_gap"] or \
        ctl["rows_differing"] > limits["rows_differing"]
