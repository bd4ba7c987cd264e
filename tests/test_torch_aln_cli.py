"""The port's `AlnFeature`, `callsomaticSV` and `adjustVCF` subcommands with
--device cpu against tests/data/jax_alnfeature_golden.json (the JAX CLI's
outputs on the synth pair, without the ##fileDate line), and the golden
against a fresh JAX run.  Text outputs must be equal."""
import os
import subprocess
import sys

import pytest
import torch

import alnfeature_golden as ag
import localgraph_golden as lgg
from svscope_tpu.out import adjust as jadjust
from svscope_tpu.out import vcf as jvcf
from svscope_tpu_torch import cli
from svscope_tpu_torch.out import adjust, vcf

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden():
    return ag.load_golden()


def test_golden_is_fresh(golden):
    fresh = ag.make_golden()
    assert fresh == golden
    assert lgg.sha256(golden["synth_pair"]["raw_bed"]) == \
        lgg.load_golden()["synth_pair"]["raw_bed_sha256"]


def test_aln_feature_and_adjust_vcf_match_golden(golden):
    out = ag.port_aln_outputs(golden["synth_pair"]["raw_bed"], "cpu")
    assert out == golden["synth_pair"]["outputs"]


def test_call_somatic_sv_matches_golden(golden):
    g = golden["synth_pair"]
    out = ag.port_call_somatic_outputs("cpu")
    assert out.pop(ag.RAW_BED) == g["raw_bed"]
    assert out == {k: g["outputs"][k] for k in ag.OUTPUTS[:4]}


def test_cli_entry_point_aln_feature(golden, tmp_path):
    """`python -m svscope_tpu_torch.cli AlnFeature --device cpu`, as a user
    runs it."""
    d = str(tmp_path)
    ref, tumor, normal, _recs = lgg.make_synth_pair(d)
    raw = os.path.join(d, ag.RAW_BED)
    with open(raw, "w") as f:
        f.write(golden["synth_pair"]["raw_bed"])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    res = subprocess.run(
        [sys.executable, "-m", "svscope_tpu_torch.cli",
         *ag.aln_args(d, ref, tumor, normal, raw), "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = ag.read_outputs(os.path.join(d, "out"), d, ag.OUTPUTS[:4])
    assert out == {k: golden["synth_pair"]["outputs"][k]
                   for k in ag.OUTPUTS[:4]}


def test_aln_feature_cuda_raises_without_cuda(golden, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d = str(tmp_path)
    ref, tumor, normal, _recs = lgg.make_synth_pair(d)
    raw = os.path.join(d, ag.RAW_BED)
    with open(raw, "w") as f:
        f.write(golden["synth_pair"]["raw_bed"])
    with pytest.raises(RuntimeError):
        cli.main(ag.aln_args(d, ref, tumor, normal, raw))   # default cuda


def _merged_vcf(path, header):
    rows = [("chr1", 100, "TDscope.INS.chr1_100-200"),
            ("chr1", 100, "TDscope.INS.chr1_100-200"),
            ("chr1", 5000, "TDscope.INS.chr1_5010-5020"),
            ("chr1", 7000, "TDscope.DEL.chr1_7000-7100"),
            ("chr1", 7000, "TDscope.DEL.chr1_7000-7100"),
            ("chrM", 10, "TDscope.INS.chrM_10-90"),
            ("chr2", 50, "TDscope.MisAlign.chr2_50-60"),
            ("chrUn_KI270302v1", 5, "TDscope.INS.chrUn_KI270302v1_5-9")]
    with open(path, "w") as f:
        f.write(header)
        for c, p, u in rows:
            f.write(f"{c}\t{p}\t{u}\tA\tAC\t.\tPASS\tX\tGT\t0/1\n")


def test_adjust_vcf_and_merge_match_jax(golden, tmp_path):
    """adjust_vcf's INS/DEL dedupe, chrM drop and RepeatMasker-window
    mapping, and merge_somatic_vcf's filter and sort, on crafted VCFs."""
    header = golden["synth_pair"]["outputs"]["S.mergedSomatic.vcf"]
    outs = []
    for name, adj, vc in (("jax", jadjust, jvcf), ("port", adjust, vcf)):
        d = tmp_path / name
        d.mkdir()
        _merged_vcf(str(d / "S.mergedSomatic.vcf"), header)
        (d / "CandidateSpan.tumorLC.merged.decision.somatic.bed").write_text(
            "chr1\t5000\t5100\tx\ty\tINS\nchr1\t90\t95\tx\ty\tINS\n")
        inner = d / "S.vcf"
        inner.write_text(header + "chr2\t9\tu1\tA\tC\t.\tPASS\t"
                         "DecisionSV=True\tGT\t0/1\nchr1\t3\tu2\tA\tC\t.\t"
                         "PASS\tDecisionSV=False\tGT\t0/1\n")
        inter = d / "InterALNSVs.vcf"
        inter.write_text("#h\nchr1\t7\tu3\tA\tC\t.\tPASS\tBND\tGT\t0/1\n")
        vc.merge_somatic_vcf(str(inner), str(inter), str(d / "m.vcf"))
        out = adj.adjust_vcf(str(d))
        outs.append(((d / "m.vcf").read_text(), open(out).read()))
    assert outs[1] == outs[0]
