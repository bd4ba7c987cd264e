"""The port's genome bench and WGS background sweep against the JAX
harnesses (tools/genome_bench.py, tools/wgs_bench.py) on the CPU, and the
JAX genome golden (tests/data/jax_genome_golden.json) against a fresh JAX
run: every output file (the BAMs included), the nine-class tier table,
the candidate count and both precision/recall pairs must be equal."""
import os
import subprocess

import pandas as pd
import pytest
import torch

import genome_golden as gg
from svscope_tpu_torch.tools import genome_bench, wgs_bench

torch.set_num_threads(1)


def test_port_small_config_equals_jax_golden(tmp_path):
    res = genome_bench.run(**gg.GENOME_SMALL, device="cpu",
                           savedir=str(tmp_path), log=lambda *_: None)
    want = gg.load_golden()["small"]
    assert gg.differences(res, want) == []
    assert {"ref.fa", "tumor.bam", "normal.bam", "classes.json",
            "T1.mergedSomatic.vcf"} <= set(res["hashes"])
    # all nine classes planted, each decoy tier dead where it should die
    tiers = res["tiers"]
    assert set(tiers) == set(genome_bench.SLOT_CLASSES)
    assert tiers["germ_comp"][1] > 0 == tiers["germ_comp"][2]
    assert tiers["germ_gate"][1] > 0 == tiers["germ_gate"][2]
    assert tiers["rf_trap"][2] > 0 == tiers["rf_trap"][3]
    assert res["vcf"]["decoys"][0] == 0
    assert set(res["stages"]) == {"synth", "scan", "select", "localGraph",
                                  "AlnFeature"}
    assert res["launches"] == {k: 0 for k in res["launches"]}   # the CPU


def test_small_golden_is_fresh():
    """A JAX run now equals the golden's small configuration."""
    got = gg.jax_genome(**gg.GENOME_SMALL)
    want = gg.load_golden()["small"]
    assert gg.differences(got, want) == []


def test_full_golden_holds_every_class():
    """The 20 Mb golden that chip_smoke.py holds the card to: 4 x 16 loci,
    every tier's candidates, rows and records."""
    full = gg.load_golden()["full"]
    assert {k: full[k] for k in gg.GENOME_FULL} == gg.GENOME_FULL
    assert sum(n for n, *_ in full["tiers"].values()) == 64
    assert full["vcf"]["precision"][0] == full["vcf"]["precision"][1]
    assert {"tumor.bam", "normal.bam", "T1.vs.N1.TandemRepeat.Raw.bed"} \
        <= set(full["hashes"])


def test_stream_runs_warmup_then_measured_run_once(monkeypatch, tmp_path,
                                                   capsys):
    """--stream: one warm-up (its exit code printed), one measured run
    whose exit code is the tool's; no retry."""
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 7 if len(calls) == 1 else 3)

    monkeypatch.setattr(genome_bench.subprocess, "run", fake_run)
    rc = genome_bench.main(["--stream", "--mb-per-chrom", "0.2", "--chroms",
                            "2", "--depth", "4", "--device", "cpu",
                            "--savedir", str(tmp_path)])
    assert rc == 3 and len(calls) == 2 and calls[0] == calls[1]
    assert "--pipeline-only" in calls[0]
    assert "[stream] warm-up exit 7" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "classes.json")


def test_rss_bound_is_the_jax_harness_bound(tmp_path):
    t, n = tmp_path / "t.bam", tmp_path / "n.bam"
    t.write_bytes(b"x" * 100)
    n.write_bytes(b"x" * 100)
    assert genome_bench.rss_bound_mb(str(t), str(n)) == 2048
    t.write_bytes(b"x" * 400_000_000)
    assert genome_bench.rss_bound_mb(str(t), str(n)) == \
        pytest.approx(0.75 * 400_000_200 * 8 / 1e6)


def test_wgs_background_stats_equal_jax():
    """background_stats on the port's table == JAX's frame on JAX's table
    at 2 x 1 Mb, and == the golden's hash."""
    rows, want = gg.jax_wgs_frame(**gg.WGS_SMALL)
    res = wgs_bench.run(**gg.WGS_SMALL, device="cpu", log=lambda *_: None)
    assert res["rows"] == rows == gg.load_golden()["wgs_small"]["rows"]
    pd.testing.assert_frame_equal(res["df"], want)
    assert res["sha256"] == wgs_bench.frame_sha256(want) == \
        gg.load_golden()["wgs_small"]["sha256"]
    assert res["covered"] == res["windows"] == 200


def test_wgs_main_checks_the_planted_coverage(monkeypatch):
    out = wgs_bench.main(["--chrom-mb", "0.5", "--n-chrom", "1",
                          "--device", "cpu"])
    assert "df" not in out and out["windows"] == 50
    assert abs(out["median_cov"] - 30) < 7.5
    # a 10x table checked against the 30x it claims: the sanity check raises
    real = wgs_bench.synth_table
    monkeypatch.setattr(wgs_bench, "synth_table",
                        lambda n, length, cov, seed=0: real(n, length, 10.0,
                                                            seed))
    with pytest.raises(RuntimeError, match="median COV"):
        wgs_bench.run(coverage=30.0, chrom_mb=0.5, n_chrom=1, device="cpu",
                      log=lambda *_: None)
