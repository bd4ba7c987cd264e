"""The port's candidate-window selection (select/*, ops/dbscan) against the
JAX package's on the same inputs: every result and every file it writes
must be equal (InterALNSVs.vcf without its ##fileDate line)."""
import os

import numpy as np
import pandas as pd
import pytest

import svscope_tpu.select.breakpoints as jbp
import svscope_tpu.select.legacy as jlegacy
import svscope_tpu.select.windows as jwin
import svscope_tpu_torch.select.breakpoints as tbp
import svscope_tpu_torch.select.legacy as tlegacy
import svscope_tpu_torch.select.windows as twin
from svscope_tpu.io.bam import AlignmentTable as JTable
from svscope_tpu.native.bam import scan_with_breakpoints as jscan
from svscope_tpu.ops.dbscan import dbscan_labels as jdbscan
from svscope_tpu.select.interaln import write_interaln_vcf as jinteraln
from svscope_tpu_torch.io.bam import AlignmentTable as TTable
from svscope_tpu_torch.native.bam import scan_with_breakpoints as tscan
from svscope_tpu_torch.ops.dbscan import dbscan_labels as tdbscan
from svscope_tpu_torch.select.interaln import write_interaln_vcf as tinteraln

from dataprepare_golden import read_outputs
from synth import make_test_pair
from test_select import _plain_table, _split_read_table
from test_select_legacy import _random_clip_record


def _dir_text(d):
    """Every file under d, normalised (dataprepare_golden.read_outputs)."""
    return read_outputs(d, d)


def _port_table(t: JTable) -> TTable:
    return TTable(list(t.chrom), list(t.start), list(t.end), list(t.name),
                  list(t.mapq), list(t.strand_rev), list(t.cigar))


@pytest.mark.parametrize("strand,cigar", [
    ("+", "100M50D100M60I300M"), ("+", "100M30D400M"), ("+", "200S400M"),
    ("-", "200S400M"), ("-", "400M200S"), ("+", "400M200S"),
    ("+", "100M50D100M60I100M120S"), ("-", "150S300M45I20M90D10M30H")])
def test_span_breakpoints(strand, cigar):
    args = ("chr1", 1000, 1500, "r1", 60, strand, cigar)
    want = jbp.span_breakpoints(*args).asarrays()
    got = tbp.span_breakpoints(*args).asarrays()
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


CLIP_CASES = {
    "del": (["chr1", "chr1"], [5400, 55000], [400, 400],
            ["0-400", "400-800"], ["chr1:5000-5400", "chr1:55000-55400"],
            ["+", "+"], [60, 60], "rd"),
    "dup": (["chr1", "chr1"], [9000, 6000], [400, 400],
            ["0-400", "400-800"], ["chr1:5000-9000", "chr1:6000-9500"],
            ["+", "+"], [60, 60], "rd"),
    "inv": (["chr1", "chr1"], [5400, 8000], [400, 400],
            ["0-400", "400-800"], ["chr1:5000-5400", "chr1:8000-8400"],
            ["+", "-"], [60, 60], "rd"),
    "tra": (["chr1", "chr2"], [5400, 8000], [400, 400],
            ["0-400", "400-800"], ["chr1:5000-5400", "chr2:8000-8400"],
            ["+", "+"], [60, 60], "rd"),
    "tra_far": (["chr1", "chr1"], [5400, 905400], [400, 400],
                ["0-400", "400-800"], ["chr1:5000-5400",
                                       "chr1:905400-905800"],
                ["+", "+"], [60, 60], "rd"),
    "solo": (["chr1", "chr1"], [5400, 8000], [0, 0], ["0-400", "0-390"],
             ["chr1:5000-5400", "chr1:8000-8390"], ["+", "+"], [60, 60],
             "rd"),
}


@pytest.mark.parametrize("case", sorted(CLIP_CASES))
def test_classify_clip_pairs(case):
    args = CLIP_CASES[case]
    want = jbp.classify_clip_pairs(*args)
    assert want and tbp.classify_clip_pairs(*args) == want


def test_classify_clip_pairs_random_records():
    rng = np.random.default_rng(21)
    n = 0
    for _ in range(150):
        c, rs, rd, rr, fr, st, _rid = _random_clip_record(
            rng, int(rng.integers(1, 7)))
        args = (list(c), list(rs), list(rd), list(rr), list(fr), list(st),
                [60] * len(c), "rd")
        want = jbp.classify_clip_pairs(*args)
        assert tbp.classify_clip_pairs(*args) == want
        n += len(want)
    assert n > 100


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_dbscan_labels(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(0, 100, (20, 2)),
                          rng.normal(5000, 150, (15, 2)),
                          rng.uniform(0, 50000, (30 + 10 * seed, 2))])
    want = jdbscan(pts, eps=500, min_samples=3)
    assert (want >= 0).any()
    np.testing.assert_array_equal(tdbscan(pts, eps=500, min_samples=3), want)


def test_site_helpers(tmp_path):
    fai = tmp_path / "x.fa.fai"
    fai.write_text("chr1\t1000\t0\t60\t61\nchr2\t500\t0\t60\t61\n")
    off = tbp.chrom_offsets(str(fai))
    assert off == jbp.chrom_offsets(str(fai))
    for site in ("chr2:100_chr1:900", "chr1:5_chr1:6", "chr2:0_chr2:499"):
        np.testing.assert_array_equal(tbp.encode_site(site, off),
                                      jbp.encode_site(site, off))
        assert tbp.sort_breakpoint(site, off) == \
            jbp.sort_breakpoint(site, off)
    bps = [["chr1:100", "chr1:200"], ["chr1:110", "chr1:220"],
           ["chr1:131", "chr1:207"]]
    assert tbp.bp_arrange(bps) == jbp.bp_arrange(bps)
    for regs in (["0-400", "400-800"], ["0-400", "350-800"],
                 ["0-400", "250-800"], ["0-10"]):
        assert tbp.non_unique_reads(regs) == jbp.non_unique_reads(regs)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The synth pair (written by tests/synth.py), each package's tables
    and native breakpoint frames."""
    d = str(tmp_path_factory.mktemp("sel"))
    ref_path, tumor, normal, _recs, _ = make_test_pair(d)
    return {"fai": ref_path + ".fai",
            "jax": (*jscan(tumor), *jscan(normal)),
            "port": (*tscan(tumor), *tscan(normal))}


@pytest.mark.parametrize("start,end,svtype", [
    (950, 1150, "INS"), (1000, 1100, "INS"), (3000, 3100, "INS"),
    (3000, 3100, "DEL"), (58000, 58100, "INS")])
def test_fetch_span_reads_and_rough_compare(pair, start, end, svtype):
    jt, _jb, jn, _jnb = pair["jax"]
    tt, _tb, tn, _tnb = pair["port"]
    pd.testing.assert_frame_equal(
        twin.fetch_span_reads(tt, "chr1", start, end),
        jwin.fetch_span_reads(jt, "chr1", start, end))
    assert twin.rough_compare(tt, tn, "chr1", start, end, svtype) == \
        jwin.rough_compare(jt, jn, "chr1", start, end, svtype)


@pytest.mark.parametrize("breakpoints", ["native", "python"])
@pytest.mark.parametrize("repeats", ["empty", "lc"])
def test_find_candidate_windows_and_interaln(pair, tmp_path, repeats,
                                             breakpoints):
    """Selection on the synth pair: every bed it writes and
    InterALNSVs.vcf, with the breakpoint frames from the native scan or
    from parse_windows, with an empty RepeatMasker bed or one over the INS
    site (the LC channel)."""
    bed = tmp_path / "repeats.bed"
    bed.write_text("" if repeats == "empty" else "chr1\t1020\t1080\n")
    outs = {}
    for name, mod, inter in (("jax", jwin, jinteraln),
                             ("port", twin, tinteraln)):
        t, tb, n, nb = pair[name]
        if breakpoints == "python":
            tb = nb = None
        d = str(tmp_path / name)
        paths = mod.find_candidate_sv_windows(t, n, pair["fai"], str(bed), d,
                                              t_bp=tb, n_bp=nb)
        inter(d, pair["fai"], "tumor", paths)
        outs[name] = _dir_text(d)
    assert outs["port"] == outs["jax"]
    som = outs["jax"]["CandidateSpan.tumor.merged.decision.somatic.bed"]
    assert som.startswith("chr1\t10")          # the INS window was found


@pytest.mark.parametrize("pattern", ["DEL", "INV"])
def test_split_read_svs_to_interaln_vcf(tmp_path, pattern):
    """Split-read pairs 50 kb apart: the LargeDEL / INV clusters and their
    InterALNSVs.vcf record."""
    fai = tmp_path / "g.fa.fai"
    fai.write_text("chr1\t100000\t0\t60\t61\n")
    repeat = tmp_path / "rep.bed"
    repeat.write_text("")
    jt, jn = _split_read_table(pattern=pattern), _plain_table()
    outs = {}
    for name, mod, inter, t, n in (
            ("jax", jwin, jinteraln, jt, jn),
            ("port", twin, tinteraln, _port_table(jt), _port_table(jn))):
        d = str(tmp_path / name)
        paths = mod.find_candidate_sv_windows(t, n, str(fai), str(repeat), d)
        inter(d, str(fai), "S", paths)
        outs[name] = _dir_text(d)
    assert outs["port"] == outs["jax"]
    body = [l for l in outs["jax"]["InterALNSVs.vcf"].splitlines()
            if not l.startswith("#")]
    svtype = "LargeDEL" if pattern == "DEL" else "INV"
    assert len(body) == 1 and f"SVTYPE={svtype}" in body[0]


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_legacy_clip_classifiers(version):
    name = f"classify_clip_pairs_{version}"
    rng = np.random.default_rng(5 if version == "v2" else 9)
    n = 0
    for _ in range(200):
        rec = _random_clip_record(rng, int(rng.integers(1, 7)))
        want = getattr(jlegacy, name)(*rec)
        assert getattr(tlegacy, name)(*rec) == want
        n += len(want)
    assert n > 100


def test_legacy_span_helpers():
    rng = np.random.default_rng(3)
    for _ in range(50):
        regs, p = [], 0
        for _ in range(int(rng.integers(1, 6))):
            a = p + int(rng.integers(0, 100))
            b = a + int(rng.integers(10, 500))
            regs.append(f"{a}-{b}")
            p = max(b - int(rng.integers(0, 200)), 0)
        assert tlegacy.non_uniq_detail(regs) == jlegacy.non_uniq_detail(regs)
        np.testing.assert_array_equal(tlegacy.sort_read_span(regs),
                                      jlegacy.sort_read_span(regs))


def test_window_selection_v7(tmp_path):
    """v7 (no LC channel, no chrM exclusion) on a chr1 + chrM fixture."""
    from svscope_tpu_torch.io.bam import (BamRecord, BamWriter,
                                          parse_cigar_string)
    from svscope_tpu_torch.io.fasta import write_fasta
    rng = np.random.default_rng(0)
    clen = 8000
    refs = {c: "".join(rng.choice(list("ACGT"), clen))
            for c in ("chr1", "chrM")}
    ref_path = str(tmp_path / "ref.fa")
    write_fasta(ref_path, refs)
    ins = "".join(rng.choice(list("ACGT"), 80))

    def reads(chrom, prefix, with_ins):
        out = []
        for i in range(8):
            carrier = with_ins and i < 6
            base = refs[chrom][2000:6000]
            if carrier:
                base = base[:2000] + ins + base[2000:]
            ops, lens = parse_cigar_string(
                f"2000M{len(ins)}I2000M" if carrier else "4000M")
            out.append(BamRecord(f"{prefix}{i}", 0, list(refs).index(chrom),
                                 2000, 60, ops, lens, base))
        return out

    bams = {}
    for side, with_ins in (("t", True), ("n", False)):
        path = str(tmp_path / f"{side}.bam")
        recs = reads("chr1", f"{side}1_", with_ins) \
            + reads("chrM", f"{side}m_", with_ins)
        with BamWriter(path, list(refs), [clen, clen]) as w:
            for r in sorted(recs, key=lambda r: (r.ref_id, r.pos)):
                w.write(r)
        bams[side] = path
    outs = {}
    for name, mod, scan in (("jax", jlegacy, jscan),
                            ("port", tlegacy, tscan)):
        t, tb = scan(bams["t"])
        n, nb = scan(bams["n"])
        d = str(tmp_path / name)
        p = mod.window_selection_v7(t, n, ref_path + ".fai", d, t_bp=tb,
                                    n_bp=nb)
        outs[name] = _dir_text(d)
        assert "chrM" in outs[name][os.path.basename(p["somatic_bed"])]
    assert outs["port"] == outs["jax"]
