"""Public entry points of the port run on the card unless the caller asks
for the CPU: called without a device on a host without CUDA, each one
raises RuntimeError instead of running on the CPU unnoticed, and so does
each subcommand without --device."""
import os

import numpy as np
import pytest
import torch

from svscope_tpu_torch import cli
from svscope_tpu_torch.engine.decision import decision
from svscope_tpu_torch.models import mixture
from svscope_tpu_torch.ops import poa_batch, poa_fused
from svscope_tpu_torch.tools import workloads

FEAT = np.random.default_rng(0).integers(0, 4, (8, 12)).astype(np.int8)
SEQS = [["ACGTACGT", "ACGTTACGT", "ACGACGT"]]

CALLS = {
    "em_cluster_batch_dispatch":
        lambda: mixture.em_cluster_batch_dispatch([FEAT]),
    "em_cluster_batch": lambda: mixture.em_cluster_batch([FEAT]),
    "em_cluster": lambda: mixture.em_cluster(FEAT),
    "poa_msa_batch": lambda: poa_batch.poa_msa_batch(SEQS, use_device=True),
    "fused_msa_batch": lambda: poa_fused.fused_msa_batch(SEQS),
    "build_batch_pk": lambda: poa_fused.build_batch_pk(
        np.zeros((1, 2, 8), np.uint8), np.full((1, 2), 8, np.int32),
        np.array([2]), ncap=16),
    "decision": lambda: decision(workloads.make_window_payloads(
        1, np.random.default_rng(0))[0]),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_public_entry_points_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CALLS[name]()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("defaults"))
    ref, tumor, normal, recs, _ = workloads.make_test_pair(d)
    open(os.path.join(d, "repeats.bed"), "w").close()
    with open(os.path.join(d, "w.bed"), "w") as f:
        f.write(recs[0] + "\n")
    return d


SUBCOMMANDS = {
    "DataPrepare": ["-D", "repeats.bed", "--selectwindows"],
    "localGraph": ["-w", "w.bed"],
    "localGraph_npz": [],
    "viz": ["-w", "chr1:1000-1100"],
}


@pytest.mark.parametrize("sub", sorted(SUBCOMMANDS))
def test_subcommands_default_to_cuda(pair, sub):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the card")
    p = lambda name: os.path.join(pair, name)
    args = [a if not a.endswith(".bed") else p(a) for a in SUBCOMMANDS[sub]]
    if sub != "localGraph_npz":
        args += ["-T", p("tumor.bam"), "-N", p("normal.bam"), "-r",
                 p("ref.fa")]
    args += ["-t", "S", "-n", "S", "-s", p(f"out_{sub}")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([sub] + args)
    assert not os.path.exists(p(f"out_{sub}"))      # nothing ran
