"""Example inputs of the scale-out checks (counterpart of the numpy part
of svscope_tpu/parallel/mesh.py).

The JAX module also factors its devices into a (dp, mp) grid
(`make_mesh`) and runs a deterministic EM scan over it
(`_local_em_scan`, `sharded_em_step`) that only its dry run calls.  They
are not ported: the port's read-parallel EM is the production one
(models/mixture's mp route over the installed data mesh, which both
splits the window axis of the batched chunks and the read axis of
windows past MP_READ_THRESHOLD), and graft_entry's dry run checks that.
"""
from __future__ import annotations

import numpy as np

from ..models.mixture import ALPHA, MAX_K


def make_example_batch(batch: int, n_reads: int, nf: int, seed: int = 0,
                       dtype=np.float32):
    """Synthetic padded window batch for compile checks and benchmarks."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, ALPHA, (batch, n_reads, nf))
    x_oh = np.eye(ALPHA, dtype=dtype)[codes]
    read_mask = np.ones((batch, n_reads), dtype)
    hard = rng.integers(0, 2, (batch, n_reads))
    gamma0 = np.zeros((batch, n_reads, MAX_K), dtype)
    b, r = np.meshgrid(np.arange(batch), np.arange(n_reads), indexing="ij")
    gamma0[b, r, hard] = 1.0
    kmask = np.zeros((batch, MAX_K), bool)
    kmask[:, :2] = True
    n_true = np.full((batch,), float(n_reads), dtype)
    return x_oh, read_mask, gamma0, kmask, n_true
