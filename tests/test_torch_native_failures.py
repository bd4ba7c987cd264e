"""The port's native host paths have no Python fallback: a failing native
library reaches the caller (AlnFeature's scan, the lazy BAM reader of
localGraph / npz / viz, window selection's span sites, the C++ POA
engine's load). The Python readers and walkers stay as the tests' parity
oracles."""
import argparse
import subprocess

import numpy as np
import pytest

import svscope_tpu_torch.native.bam as nbam
import svscope_tpu_torch.native.poa as npoa
from svscope_tpu_torch import cli
from svscope_tpu_torch.engine import localgraph
from svscope_tpu_torch.io.bam import AlignmentTable
from svscope_tpu_torch.ops import poa_batch
from svscope_tpu_torch.select import windows
from svscope_tpu_torch.tools.workloads import make_test_pair


def _failing(*_a, **_k):
    raise OSError("libbamscan.so not loadable")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    ref, tumor, normal, _recs, _ = make_test_pair(str(d), seed=0)
    return ref, tumor, normal


def test_aln_feature_scan_failure_raises(monkeypatch):
    """AlnFeature's tables come from the native scan alone."""
    monkeypatch.setattr(nbam, "scan_alignment_table", _failing)
    args = argparse.Namespace(Tumorbam="t.bam", Normalbam="n.bam")
    with pytest.raises(OSError, match="libbamscan"):
        cli._load_tables(args)


def test_open_bam_failure_raises(monkeypatch):
    """localGraph's (and npz's, viz's) reader is the native lazy one."""
    monkeypatch.setattr(nbam, "LazyBamReader", _failing)
    with pytest.raises(OSError, match="libbamscan"):
        localgraph.open_bam("t.bam")


def test_span_sites_failure_raises(monkeypatch, pair):
    """Window selection's span sites come from the native batch walk."""
    table = AlignmentTable.from_bam(pair[1])
    monkeypatch.setattr(nbam, "span_sites", _failing)
    with pytest.raises(OSError, match="libbamscan"):
        windows.fetch_span_reads(table, "chr1", 950, 1150)


def test_poa_engine_load_failure_raises(monkeypatch):
    """poa_msa_batch reports the C++ engine loader's own cause."""
    def failing_build():
        raise subprocess.CalledProcessError(1, ["g++"])

    monkeypatch.setattr(npoa, "_lib", None)
    monkeypatch.setattr(npoa, "ensure_libpoa", failing_build)
    with pytest.raises(RuntimeError, match="CalledProcessError"):
        poa_batch.poa_msa_batch([["ACGT", "ACGT"]], device="cpu")


@pytest.mark.parametrize("start,end", [(950, 1150), (2900, 3200),
                                       (20_000, 30_000)])
def test_native_span_sites_equal_python_walk(pair, start, end):
    """The native span sites equal the Python walk, the parity oracle."""
    table = AlignmentTable.from_bam(pair[1])
    idx = table.fetch_idx("chr1", start, end)
    assert len(idx)
    blob, off = table.cig_arrays()
    s5, s3 = nbam.span_sites(blob, off[idx], off[idx + 1] - off[idx],
                             table.start[idx].astype(np.int64),
                             np.full(len(idx), start, np.int64),
                             np.full(len(idx), end, np.int64))
    want = [windows._read_span_sites(table.cigar[i], int(table.start[i]),
                                     start, end) for i in idx]
    assert list(zip(s5.tolist(), s3.tolist())) == want


def test_native_tables_equal_python_scan(pair):
    """The native scan's table equals the Python parser's."""
    for path in pair[1:]:
        got, want = nbam.scan_alignment_table(path), \
            AlignmentTable.from_bam(path)
        for col in ("chrom", "start", "end", "name", "mapq", "strand_rev",
                    "cigar"):
            np.testing.assert_array_equal(getattr(got, col),
                                          getattr(want, col))
