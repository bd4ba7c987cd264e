"""Inputs of the port's tests and of chip_smoke.py, free of the JAX package.

The same generators as `bench.make_window_payloads` (kept in the package,
svscope_tpu_torch/tools/workloads.py, for the kernel measurement tools)
and `tests/synth.make_test_pair`, built on the port's own WindowData, BAM
writer and FASTA writer, so the card's machine (which has no JAX) draws the
identical inputs: the same rng calls in the same order give the same
payloads and the same BAM bytes (tests/test_torch_imports.py holds them
equal).
"""
from __future__ import annotations

import numpy as np

from svscope_tpu_torch.io.bam import BamRecord, BamWriter, parse_cigar_string
from svscope_tpu_torch.io.fasta import write_fasta
from svscope_tpu_torch.tools.workloads import make_window_payloads  # noqa: F401

def rand_seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n))


def make_read(ref: str, name: str, aln_start: int, aln_end: int,
              sv: tuple | None = None, mapq: int = 60, flag: int = 0,
              ref_id: int = 0) -> BamRecord:
    """A read fully aligned over [aln_start, aln_end) with an optional SV:
    sv=("INS", pos, seq) inserts seq after ref pos; sv=("DEL", pos, length)
    deletes [pos, pos+length)."""
    if sv is None:
        seq = ref[aln_start:aln_end]
        cig = f"{aln_end - aln_start}M"
    elif sv[0] == "INS":
        _, pos, ins = sv
        assert aln_start < pos < aln_end
        seq = ref[aln_start:pos] + ins + ref[pos:aln_end]
        cig = f"{pos - aln_start}M{len(ins)}I{aln_end - pos}M"
    elif sv[0] == "DEL":
        _, pos, dlen = sv
        assert aln_start < pos and pos + dlen < aln_end
        seq = ref[aln_start:pos] + ref[pos + dlen:aln_end]
        cig = f"{pos - aln_start}M{dlen}D{aln_end - pos - dlen}M"
    else:
        raise ValueError(sv)
    ops, lens = parse_cigar_string(cig)
    return BamRecord(name, flag, ref_id, aln_start, mapq, ops, lens, seq)


def make_test_pair(tmpdir: str, seed: int = 0, ref_len: int = 60_000,
                   windows=None, bg_reads_per_10kb: int = 3):
    """Write ref.fa, tumor.bam, normal.bam into tmpdir.

    windows: list of dicts {start, end, svtype ('INS'|'DEL'), svlen,
    tumor_vaf_reads, depth}; default = one 60bp somatic INS window and one
    clean window.
    Returns (ref_path, tumor_bam, normal_bam, window_records, ref_seq).
    """
    rng = np.random.default_rng(seed)
    ref = rand_seq(rng, ref_len)
    ref_path = f"{tmpdir}/ref.fa"
    write_fasta(ref_path, {"chr1": ref})
    if windows is None:
        windows = [
            dict(start=1000, end=1100, svtype="INS", svlen=60, som_reads=5,
                 depth=12),
            dict(start=3000, end=3100, svtype=None, svlen=0, som_reads=0,
                 depth=10),
        ]
    t_recs, n_recs = [], []
    window_records = []
    for wi, w in enumerate(windows):
        s, e = w["start"], w["end"]
        mid = (s + e) // 2
        ins_seq = rand_seq(rng, w["svlen"]) if w["svtype"] == "INS" else ""
        jitter = int(w.get("jitter", 15))
        for i in range(w["depth"]):
            a0 = s - 300 + int(rng.integers(0, 50))
            a1 = e + 300 + int(rng.integers(0, 50))
            a0 = max(a0, 0)
            a1 = min(a1, ref_len)
            has_sv = i < w["som_reads"]
            sv = None
            if has_sv and w["svtype"]:
                # per-read breakpoint jitter like real ONT alignments, so
                # merged candidate windows get nonzero width
                m = mid + int(rng.integers(-jitter, jitter + 1))
                if w["svtype"] == "INS":
                    sv = ("INS", m, ins_seq)
                else:
                    sv = ("DEL", m - w["svlen"] // 2, w["svlen"])
            t_recs.append(make_read(ref, f"w{wi}t{i}", a0, a1, sv))
        for i in range(w["depth"]):
            a0 = max(s - 300 + int(rng.integers(0, 50)), 0)
            a1 = min(e + 300 + int(rng.integers(0, 50)), ref_len)
            n_recs.append(make_read(ref, f"w{wi}n{i}", a0, a1, None))
        window_records.append(f"chr1\t{s}\t{e}\t{w['depth']}\t{w['depth']}\t"
                              f"{w['svtype'] or 'INS'}")
    # scattered background coverage so genome-grid COV/mapQ stats vary
    for chunk in range(0, ref_len, 10_000):
        for i in range(int(rng.integers(max(bg_reads_per_10kb - 1, 1),
                                        bg_reads_per_10kb + 2))):
            a0 = chunk + int(rng.integers(0, 8000))
            a1 = min(a0 + int(rng.integers(1500, 4000)), ref_len)
            mq = 3 if rng.random() < 0.2 else 60  # some low-mapQ noise
            t_recs.append(make_read(ref, f"bgt{chunk}_{i}", a0, a1, None,
                                    mapq=mq))
            b0 = chunk + int(rng.integers(0, 8000))
            b1 = min(b0 + int(rng.integers(1500, 4000)), ref_len)
            mq = 3 if rng.random() < 0.2 else 60
            n_recs.append(make_read(ref, f"bgn{chunk}_{i}", b0, b1, None,
                                    mapq=mq))
    tumor = f"{tmpdir}/tumor.bam"
    normal = f"{tmpdir}/normal.bam"
    with BamWriter(tumor, ["chr1"], [ref_len]) as wtr:
        for r in sorted(t_recs, key=lambda r: r.pos):
            wtr.write(r)
    with BamWriter(normal, ["chr1"], [ref_len]) as wtr:
        for r in sorted(n_recs, key=lambda r: r.pos):
            wtr.write(r)
    return ref_path, tumor, normal, window_records, ref


ACGT = np.frombuffer(b"ACGT", np.uint8)


def mutate(rng, seq: str, sub_rate: float, n_indels: int,
           indel_len: tuple[int, int]) -> str:
    """`seq` with substitutions at `sub_rate`, then `n_indels` insertions
    or deletions of indel_len[0]..indel_len[1] bp at random positions."""
    b = np.frombuffer(seq.encode(), np.uint8).copy()
    hit = rng.random(len(b)) < sub_rate
    b[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
    s = b.tobytes().decode()
    for _ in range(n_indels):
        n = int(rng.integers(indel_len[0], indel_len[1] + 1))
        p = int(rng.integers(0, len(s) + 1))
        s = (s[:p] + rand_seq(rng, n) + s[p:] if rng.random() < 0.5
             else s[:p] + s[p + n:])
    return s


def nw_pairs(rng, n: int, len_lo: int, len_hi: int,
             sub_rate=(0.02, 0.10), n_indels=(0, 4),
             indel_len=(1, 20)) -> list[tuple[str, str]]:
    """`n` (a, b) pairs: a uniform in [len_lo, len_hi] bp, b = a mutated
    (a per-pair substitution rate drawn from `sub_rate`, up to n_indels[1]
    indels), cut to len_hi."""
    out = []
    for _ in range(n):
        a = rand_seq(rng, int(rng.integers(len_lo, len_hi + 1)))
        b = mutate(rng, a, float(rng.uniform(*sub_rate)),
                   int(rng.integers(n_indels[0], n_indels[1] + 1)),
                   indel_len)
        out.append((a, b[:len_hi]))
    return out


def bucket_pairs(rng, bucket: int, n: int) -> list[tuple[str, str]]:
    """Pairs whose longer side falls in (bucket / 2, bucket], with the edge
    cases first: both sides exactly `bucket` long, then an empty side."""
    lo = bucket // 2 + 1
    edge = rand_seq(rng, bucket)
    pairs = [(edge, mutate(rng, edge, 0.05, 0, (1, 1))), ("", edge[:lo]),
             (edge[:lo], "")]
    pairs += nw_pairs(rng, max(n - len(pairs), 0), lo, bucket,
                      indel_len=(1, max(2, bucket // 32)))
    return pairs[:n]


def misscore4096_pairs(seed: int = 11, n: int = 4096):
    """The size of a sample's somatic consensus pairs over tandem-repeat
    windows: `n` pairs of 100-4,000 bp, 2-10 % substitutions, indels of
    1-200 bp (every side cut to 4,096 bp, so all pairs fit K2's buckets)."""
    return nw_pairs(np.random.default_rng(seed), n, 100, 4000,
                    n_indels=(1, 6), indel_len=(1, 200))
