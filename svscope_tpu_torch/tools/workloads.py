"""Inputs of the kernel measurement tools and of the chromosome bench: the
bench workload's windows, one device round of K1 replayed from them, the
synthetic tumor/normal BAM pair and K2's seeded misscore4096 pairs.

`make_window_payloads` is the port's copy of `bench.make_window_payloads`
(the workload bench.py pinned across rounds), on the port's own
WindowData: the same rng calls in the same order draw the same payloads
(tests/test_torch_imports.py holds their sha256 equal to bench.py's).
`round_workload` packs the windows' graphs after a number of reads as one
per-round K1 call of the device POA path does; `heavy_round_workload` is
such a call of the heavy tier (32 windows x 400 reads) in its busiest
bucket, (N, L) = (1024, 512).  `make_test_pair` is the port's copy of
`tests/synth.make_test_pair` (the same BAM bytes, tested).
"""
from __future__ import annotations

import numpy as np

from ..engine.datamaker import WindowData
from ..io.bam import BamRecord, BamWriter, parse_cigar_string
from ..io.fasta import write_fasta
from ..native.poa import NativePoaGraph
from ..ops.poa_device import MAX_PREDS

# bench.py's window workload
N_READS = 24
WIN_LEN = 300
OFFSET = 50
INS_LEN = 60
# the heavy tier: 32 windows x 400 reads, 200 of them carrying the INS
HEAVY_WINDOWS = 32
HEAVY_READS = 400
HEAVY_SEED = 5
HEAVY_GRAPH_READS = 200   # ~840-850 nodes: mid-way through the 1024 bucket


def make_window_payloads(n, rng, n_reads=N_READS, ins_carriers=8):
    """WindowData payloads: ref window + reads, the first ins_carriers
    (tumor) reads carrying a 60 bp INS (bench.make_window_payloads on the
    port's WindowData)."""
    wins = []
    for w in range(n):
        ref = "".join(rng.choice(list("ACGT"), WIN_LEN + 2 * OFFSET))
        ins = "".join(rng.choice(list("ACGT"), INS_LEN))
        mid = len(ref) // 2
        reads = []
        for i in range(n_reads):
            base = ref
            if i < min(n_reads // 2, ins_carriers):
                base = ref[:mid] + ins + ref[mid:]
            b = list(base)
            for _ in range(4):          # light ONT-like noise
                p = int(rng.integers(1, len(b) - 1))
                op = int(rng.integers(0, 3))
                if op == 0:
                    b[p] = str(rng.choice(list("ACGT")))
                elif op == 1:
                    b.insert(p, str(rng.choice(list("ACGT"))))
                else:
                    b.pop(p)
            reads.append("".join(b))
        # both tags >= 3: first half tumor (with INS), second half normal
        ids = ([f"S_tumor|w{w}r{i}" for i in range(n_reads // 2)]
               + [f"S_normal|w{w}r{i}" for i in range(n_reads // 2, n_reads)])
        wins.append(WindowData([ref] + reads, np.array(ids),
                               ref[:OFFSET], ref[-OFFSET:],
                               f"chr1\t{1000 + w * 1000}\t{1000 + w * 1000 + WIN_LEN}",
                               "NormalOutput"))
    return wins


def round_workload(wins, graph_reads: int, N: int, L: int):
    """One per-round K1 call: each window's graph after its first
    `graph_reads` sequences, packed to N nodes, and its next sequence to
    align.  Returns (chars, preds, sinks, n_nodes, seqs, seq_lens) numpy
    arrays, as poa_batch's device round builds them."""
    b = len(wins)
    chars = np.zeros((b, N), np.uint8)
    preds = np.full((b, N, MAX_PREDS), -1, np.int32)
    sinks = np.zeros((b, N), bool)
    nn = np.zeros(b, np.int32)
    seqs = np.zeros((b, L), np.uint8)
    lens = np.zeros(b, np.int32)
    for i, w in enumerate(wins):
        g = NativePoaGraph()
        for s in w.sequences[:graph_reads]:
            g.add_sequence(s)
        packed = g.pack(N, MAX_PREDS)
        nxt = w.sequences[graph_reads]
        if packed is None or len(nxt) > L:
            raise RuntimeError(f"window {i} exceeds the ({N}, {L}) bucket")
        chars[i], preds[i], sinks[i], nn[i] = packed[:4]
        seqs[i, :len(nxt)] = np.frombuffer(nxt.encode(), np.uint8)
        lens[i] = len(nxt)
    return chars, preds, sinks, nn, seqs, lens


def heavy_round_workload(b: int = HEAVY_WINDOWS,
                         graph_reads: int = HEAVY_GRAPH_READS):
    """The heavy tier's K1 call at (B, N, L) = (32, 1024, 512): its windows'
    graphs after `graph_reads` sequences (the reference window and the
    first reads) and the next read.  Returns round_workload's arrays."""
    wins = make_window_payloads(b, np.random.default_rng(HEAVY_SEED),
                                n_reads=HEAVY_READS,
                                ins_carriers=HEAVY_READS // 2)
    return round_workload(wins, graph_reads, 1024, 512)


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


def misscore4096_pairs(seed: int = 11, n: int = 4096):
    """The size of a sample's somatic consensus pairs over tandem-repeat
    windows: `n` pairs of 100-4,000 bp, 2-10 % substitutions, indels of
    1-200 bp (every side cut to 4,096 bp, so all pairs fit K2's buckets)."""
    return nw_pairs(np.random.default_rng(seed), n, 100, 4000,
                    n_indels=(1, 6), indel_len=(1, 200))


def pad_pairs(pairs, l_max: int):
    """(a_codes, b_codes, la, lb) numpy arrays of `pairs` padded to l_max."""
    ac = np.zeros((len(pairs), l_max), np.uint8)
    bc = np.zeros((len(pairs), l_max), np.uint8)
    la = np.zeros(len(pairs), np.int32)
    lb = np.zeros(len(pairs), np.int32)
    for k, (a, b) in enumerate(pairs):
        ac[k, :len(a)] = np.frombuffer(a.encode(), np.uint8)
        bc[k, :len(b)] = np.frombuffer(b.encode(), np.uint8)
        la[k], lb[k] = len(a), len(b)
    return ac, bc, la, lb
