"""The port's batched multi-window POA MSA: device rounds (the K1 plain
version on the CPU) against the host C++ engine, including the
device-memory gate that splits a bucket's batch."""
import numpy as np
import pytest
import torch

from svscope_tpu.ops.poa_batch import poa_msa_batch as jax_poa_msa_batch
from svscope_tpu_torch.ops import poa_align, poa_batch


torch.set_num_threads(1)


def _windows(seed=3, n=6, read_len=40, reads=5):
    rng = np.random.default_rng(seed)
    out = []
    for w in range(n):
        ref = "".join(rng.choice(list("ACGT"), read_len))
        rows = [ref]
        for r in range(reads):
            b = list(ref if r % 2 else ref[:20] + "GATTACA" + ref[20:])
            p = int(rng.integers(1, len(b) - 1))
            b[p] = str(rng.choice(list("ACGT")))
            rows.append("".join(b))
        out.append(rows)
    return out


@pytest.mark.parametrize("budget_windows", [None, 3])
def test_device_rounds_match_host(monkeypatch, budget_windows):
    wins = _windows()
    if budget_windows:
        # planes for 3 windows only: an 8-window padded batch splits in 3
        monkeypatch.setattr(poa_batch, "PLANE_BUDGET_BYTES",
                            poa_align.plane_bytes(budget_windows, 128, 64))
        assert poa_batch._split_batch(8, 128, 64) == 3
    want = poa_batch.poa_msa_batch(wins, use_device=False, device="cpu")
    got = poa_batch.poa_msa_batch(wins, use_device=True, device="cpu")
    assert got == want
    assert want == jax_poa_msa_batch(wins, use_device=False)


def test_largest_bucket_is_split():
    per = poa_align.plane_bytes(1, 2048, 2048)
    step = poa_batch._split_batch(256, 2048, 2048)
    assert step * per <= poa_batch.PLANE_BUDGET_BYTES < 256 * per
    assert poa_batch._split_batch(8, 128, 64) == 8


def test_unknown_engine_raises():
    with pytest.raises(ValueError):
        poa_batch.poa_msa_batch([["ACGT", "ACGT"]], use_device="bogus",
                                device="cpu")
