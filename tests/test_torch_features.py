"""The AlnFeature stage of the port (engine/features.py) against the JAX
package's on the synth pair: background statistics (both branches),
misscore_pipe (host DP and K2's plain version) and run_aln_feature.  Frames
and written files must be equal (integers exact, float64 bit for bit)."""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import alnfeature_golden as ag
import localgraph_golden as lgg
import torch_workloads as tw
from svscope_tpu.engine import features as jfeat
from svscope_tpu.native.bam import scan_alignment_table as jscan
from svscope_tpu_torch.engine import features
from svscope_tpu_torch.engine.localgraph import process_window_batch
from svscope_tpu_torch.native.bam import scan_alignment_table
from svscope_tpu_torch.ops import nw_batch

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The synth pair, the JAX and port alignment tables of each BAM, and
    the golden Raw.bed."""
    d = str(tmp_path_factory.mktemp("synth"))
    ref, tumor, normal, _recs = lgg.make_synth_pair(d)
    raw = os.path.join(d, ag.RAW_BED)
    with open(raw, "w") as f:
        f.write(ag.load_golden()["synth_pair"]["raw_bed"])
    tables = {p: (jscan(p), scan_alignment_table(p)) for p in (tumor, normal)}
    return d, ref, tumor, normal, raw, tables


@pytest.fixture(scope="module")
def raw_bed(tmp_path_factory, synth):
    """A Raw.bed of the port's own records for 6 bench windows, the synth
    pair's, and crafted rows: several consensuses on a side, and a pair
    past the largest K2 bucket."""
    rng = np.random.default_rng(1)
    recs = process_window_batch(lgg.make_workload("bench256")[:6],
                                device="cpu", device_poa=False)
    lines = [lgg.record_line(r) for r in recs]
    with open(synth[4]) as f:
        lines += f.read().splitlines()
    a, b, c = (tw.rand_seq(rng, n) for n in (300, 420, 4200))
    lines.append(f"chr2\t100\t400\t{a};{b}\tS_tumor|x1;S_tumor|x2\t2\t"
                 f"{b};{a[:250]}\tS_normal|y1;S_normal|y2\t2\t"
                 "NormalOutput|EMOutput")
    lines.append(f"chr2\t900\t1000\t{c}\tS_tumor|z1\t1\t{c[:4100]}\t"
                 "S_normal|z2\t1\tNormalOutput|EMOutput")
    path = str(tmp_path_factory.mktemp("raw") / "Raw.bed")
    with open(path, "w") as f:
        f.write("".join(l + "\n" for l in lines))
    return path


@pytest.mark.parametrize("size", [10_000, 500])
def test_background_stats_genome_grid(synth, size):
    """10 kb: 6 windows, the per-window loop; 500 bp: 120 windows, the
    vectorised branch."""
    d, ref, *_rest, tables = synth
    windows = features.make_genome_windows(ref + ".fai", size)
    assert windows == jfeat.make_genome_windows(ref + ".fai", size)
    for jt, tt in tables.values():
        got = features.background_stats(tt, windows)
        want = jfeat.background_stats(jt, windows)
        pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_background_stats_chrom_span(synth):
    *_head, tables = synth
    windows = [("chr1", 1000, 1100), ("chr1", 3000, 3100),
               ("chr1", 500, 500), ("chr9", 0, 100)]
    for jt, tt in tables.values():
        got = features.background_stats(tt, windows, show_chrom_span=True)
        want = jfeat.background_stats(jt, windows, show_chrom_span=True)
        pd.testing.assert_frame_equal(got, want, check_exact=True)
        assert features.window_info(tt, "chr1", 900, 1200) == \
            jfeat.window_info(jt, "chr1", 900, 1200)


def test_misscore_pipe_host_path(raw_bed):
    got = features.misscore_pipe(raw_bed, device="cpu")
    pd.testing.assert_frame_equal(
        got, jfeat.misscore_pipe(raw_bed, use_device=False), check_exact=True)
    assert len(got) == 9


def test_misscore_pipe_plain_k2_path(raw_bed):
    """use_device=True on the CPU: K2's plain version; the 4,200 bp pair
    goes to the host DP and is counted."""
    nw_batch.reset_counts()
    got = features.misscore_pipe(raw_bed, use_device=True, device="cpu")
    assert nw_batch.COUNTS["host_dp_pairs"] == 1
    want = jfeat.misscore_pipe(raw_bed, use_device=True)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    pd.testing.assert_frame_equal(
        got, features.misscore_pipe(raw_bed, device="cpu"), check_exact=True)


def test_call_allele_freq_matches_jax():
    for som, germ in (("a,b;c", "x,y"), ("a", "b;c,d;e")):
        assert features.call_allele_freq(som, germ) == \
            jfeat.call_allele_freq(som, germ)


def test_run_aln_feature_matches_jax(synth, tmp_path):
    d, ref, tumor, normal, raw, tables = synth
    windows = features.make_genome_windows(ref + ".fai")
    pools, files = [], []
    for name, fn, kw in (("jax", jfeat.run_aln_feature, {}),
                         ("port", features.run_aln_feature,
                          {"device": "cpu"})):
        k = 0 if name == "jax" else 1
        out = str(tmp_path / name)
        pool, som_bed, rf = fn(raw, windows, tables[tumor][k],
                               tables[normal][k], "S", out, **kw)
        pools.append(pool)
        files.append([open(p).read() for p in (som_bed, rf)])
    pd.testing.assert_frame_equal(pools[1], pools[0], check_exact=True)
    assert files[1] == files[0]
    assert len(pools[1]) == 1 and pools[1].yprob.dtype == np.float64
