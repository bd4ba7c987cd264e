"""The port's viz/research helpers against the JAX package's
(tests/test_research.py's six functions): equal results on the same
inputs, exact."""
import numpy as np
import pytest

import svscope_tpu.viz.research as jres
import svscope_tpu_torch.viz.research as tres


@pytest.mark.parametrize("rows", [["AC-T", "ACGT", "ACGT"],
                                  ["A--T", "A--T", "ACGT"],
                                  ["----", "-C--", "GC-A", "GT-A"]])
def test_consensus_by_majority(rows):
    assert tres.consensus_by_majority(rows) == \
        jres.consensus_by_majority(rows)


def test_bh_fdr():
    p = np.random.default_rng(0).random(40) ** 3
    np.testing.assert_array_equal(tres.bh_fdr(p), jres.bh_fdr(p))


def test_column_differential():
    rng = np.random.default_rng(1)
    som = rng.integers(0, 5, (8, 30))
    germ = som.copy()
    germ[:, :5] = 3
    germ[:4, 20:] = rng.integers(0, 5, (4, 10))
    for got, want in zip(tres.column_differential_test(som, germ),
                         jres.column_differential_test(som, germ)):
        np.testing.assert_array_equal(got, want)


def test_export_consensus_fasta(tmp_path):
    raw = tmp_path / "raw.bed"
    raw.write_text("chr1\t10\t20\tACGT;TTTT\tr1\t2\tAAAA\tr2\t1\t"
                   "NormalOutput|EMOutput\n"
                   "chr1\t30\t40\t-\t-\t0\t-\t-\t0\tNormalOutput\n"
                   "chr2\t5\t9\t-;" + "G" * 50 + "\tr3\t1\t-\t-\t0\t"
                   "NormalOutput|EMOutput\n")
    texts = []
    for mod, name in ((jres, "j.fa"), (tres, "t.fa")):
        n = mod.export_consensus_fasta(str(raw), str(tmp_path / name),
                                       max_len=30)
        texts.append((n, (tmp_path / name).read_text()))
    assert texts[1] == texts[0] and texts[0][0] == 3


def test_parse_repeatmasker_out(tmp_path):
    p = tmp_path / "rm.out"
    p.write_text("   SW  perc\n\n"
                 " 463 1.3 0.6 1.7 chr1 10001 10468 (248945954) + "
                 "(TAACCC)n Simple_repeat 1 463 (0) 1\n"
                 " 12 9.0 0.0 0.0 chr2 5 90 (1) C AluY SINE/Alu (2) 85 1 2\n")
    assert tres.parse_repeatmasker_out(str(p)) == \
        jres.parse_repeatmasker_out(str(p))


@pytest.mark.parametrize("positives", [(range(6),), (range(5), range(10, 15)),
                                       (range(0, 20, 3),)])
def test_cohort_enrichment(positives):
    ca = np.array(["HCC"] * 10 + ["LUAD"] * 10)
    rec = np.zeros(20)
    for r in positives:
        rec[list(r)] = 1
    cross = tres.som_td_cross_tab(rec, ca)
    np.testing.assert_array_equal(cross, jres.som_td_cross_tab(rec, ca))
    np.testing.assert_array_equal(tres.r_oe(cross), jres.r_oe(cross))
    assert tres.annotate_td_window(rec, ca) == \
        jres.annotate_td_window(rec, ca)
