"""The slice end to end on the CPU: the port's localGraph engine against
svscope_tpu's on the bench workload.

The port runs with device POA (the CUDA kernel's plain torch version for
every alignment round, C++ fusion) and with host POA, each with the EM's
own torch.Generator; both must emit records identical to the JAX engine's
host path.
"""
import numpy as np
import pytest
import torch

from svscope_tpu.engine import localgraph as jlg
from svscope_tpu_torch.engine import localgraph as tlg
from svscope_tpu_torch.ops import poa_align

from bench import make_window_payloads

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bench16():
    wins = make_window_payloads(16, np.random.default_rng(0))
    return wins, jlg.process_window_batch(wins, device_poa=False)


@pytest.mark.parametrize("device_poa", [True, False])
def test_process_window_batch_matches_jax(bench16, device_poa):
    wins, want = bench16
    launches = poa_align.LAUNCHES
    got = tlg.process_window_batch(wins, device_poa=device_poa, device="cpu")
    assert got == want
    assert sum(str(r[9]).endswith("EMOutput") for r in got) >= 13
    assert poa_align.LAUNCHES == launches   # CPU tensors: plain version


def test_device_policy():
    cpu = torch.device("cpu")
    assert tlg.resolve_device_poa(None, cpu) is False
    assert tlg.resolve_device_poa(None, torch.device("cuda", 0)) == "pallas"
    assert tlg.resolve_device_poa("host", cpu) == "host"


def test_cuda_device_without_cuda_raises(bench16):
    wins, _ = bench16
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the refusal path does not apply")
    with pytest.raises(RuntimeError, match="CUDA"):
        tlg.process_window_batch(wins[:2], device="cuda")


def test_fused_engine_not_ported(bench16):
    wins, _ = bench16
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tlg.process_window_batch(wins[:4], device_poa="fused", device="cpu")
