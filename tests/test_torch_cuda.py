"""Tests that need an NVIDIA GPU: the CUDA kernel K1 against its plain torch
version, and the slice's device path, on the card.

Marked `cuda`; they skip without a card.  This file imports no JAX, so it
also runs on the GPU machine, which has none (and where tests/conftest.py,
which imports JAX, must be skipped):

    python -m pytest tests/test_torch_cuda.py --noconftest -q -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

import chip_smoke
from svscope_tpu_torch.engine.localgraph import process_window_batch
from svscope_tpu_torch.ops import poa_align, poa_device

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _kernel_and_plain(arrs, L, dev):
    args = poa_device.to_torch_packed(*arrs, dev)
    before = poa_align.LAUNCHES
    got = [t.cpu().numpy() for t in poa_align.align_batch(*args, L)]
    assert poa_align.LAUNCHES == before + 1
    want = [t.cpu().numpy()
            for t in poa_device.align_batch_reference(*args, L)]
    return got, want


@pytest.mark.parametrize("shape", [(128, 64, 9), (256, 128, 33),
                                   (512, 512, 64)])
def test_kernel_matches_plain_and_native(dev, shape):
    N, L, B = shape
    graphs, reads, packed, arrs = chip_smoke.random_graph_case(N, L, B, 1)
    got, want = _kernel_and_plain(arrs, L, dev)
    for g, w in zip(got, want):
        assert (g == w).all()
    an, asp, ke, _ = got
    for i, gr in enumerate(graphs):
        assert poa_device.unpack_alignment(an[i], asp[i], ke[i],
                                           packed[i][4]) == \
            gr.align_only(reads[i])


def test_kernel_edge_windows(dev):
    """An empty read, a read filling l_max exactly, and a window with no
    nodes, next to ordinary windows."""
    N, L, B = 128, 64, 9
    _g, _r, _p, arrs = chip_smoke.random_graph_case(N, L, B, 2)
    chars, preds, sinks, nn, seqs, lens = [a.copy() for a in arrs]
    rng = np.random.default_rng(0)
    lens[0] = 0
    seqs[1] = np.frombuffer(
        "".join(rng.choice(list("ACGT"), L)).encode(), np.uint8)
    lens[1] = L
    nn[2] = 0
    got, want = _kernel_and_plain((chars, preds, sinks, nn, seqs, lens),
                                  L, dev)
    for g, w in zip(got, want):
        assert (g == w).all()


def test_kernel_rejects_bad_input(dev):
    _g, _r, _p, arrs = chip_smoke.random_graph_case(128, 64, 8, 3)
    args = list(poa_device.to_torch_packed(*arrs, dev))
    with pytest.raises(ValueError):
        poa_align.align_batch_cuda(*args, 32)          # seqs wider than l_max
    args[3] = args[3].to(torch.int64)
    with pytest.raises(TypeError):
        poa_align.align_batch_cuda(*args, 64)


def test_slice_device_path_on_card(dev):
    from bench import make_window_payloads
    wins = make_window_payloads(8, np.random.default_rng(4))
    poa_align.reset_launches()
    recs = process_window_batch(wins, device=dev)
    assert poa_align.LAUNCHES > 0
    assert recs == process_window_batch(wins, device=dev, device_poa=False)
