#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svscope_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its result and seconds; any failure exits
non-zero before the final line:

  1. setup: CUDA required; card name and power limit; every kernel (K1 and
     K1-int16, K2, K3, K4/K5, K6, K7, the three probes) is built from
     svscope_tpu_torch/csrc/ with nvcc, one process per source, all at
     once, beside the g++ builds of the port's three host C++ engines
     (svscope_tpu_torch/csrc/host/).
  2. K1 (csrc/poa_align.cu) against its plain torch version on the card at
     (N, L, B) = (128, 64, 9), (512, 512, 64), (1024, 512, 256),
     (2048, 2048, 8): identical outputs, identical to the C++ engine's own
     alignment; on hand-built edge windows (a rank with 8 distinct preds,
     more ranks than threads, a read longer than its graph, no sink) and
     on the heavy windows after 399 reads (B=32, N=2048, L=512): identical
     to the plain version.  Then timed, the kernel's calls queued ahead of
     the device (tools/timing.py) and, once, issued back to back (the
     earlier timing, host issue included): k1-time at B=64, N=512, L=512
     (random graphs); k1-time-heavy at the heavy tier's own call (B=32,
     N=1024, L=512, tools/workloads.heavy_round_workload), kernel == plain
     there too.
  3. the slice: the 256-window bench workload through the port's
     process_window_batch with device POA (the kernel): every record's
     sha256 equals tests/data/jax_localgraph_golden.json, the records
     equal the port's host-POA run, the kernel launch count of that run is
     > 0; poa_batch.COUNTS of that run printed, and a failure unless its
     per-window Python pack and fuse calls are 0 and the C++ batch
     entries ran; warm windows/s for device and host POA; then the device
     round's six parts (poa_msa_batch(timing=): pack, h2d, K1, d2h,
     unpack, fuse) over one MSA build of the first 128 windows, its MSAs
     == the host engine's.
  4. the heavy tier (32 windows x 400 reads): the same (golden 32/32, its
     K1 launches, the counts, w/s, the parts of a build of the 32
     windows); K1's main path is both runs, each counted from 0.
  5. the CLI: `localGraph --device cuda` (svscope_tpu_torch.cli's main in
     a subprocess, which then prints poa_fused.COUNTS["host_syncs"]) on
     the synthetic BAM pair; Raw.bed sha256 equals the golden, and the
     count is 0.
  6. pk-parity: K3, K4 and K5 against their plain versions (and K4 against
     K5, and the plain version against the CPU model of K4's phases,
     tests/torch_fusion_model.py) on operands captured from real rounds of
     the port's fused build: the first 128 bench256 windows at rounds 1, 12
     and 24, the heavy windows at round 200 (ncap 3073); K4 and K5 also on
     hand-built edge states (fusion_edge_case: a duplicate key, the trash
     row reached, overflow set on entry, 8 full pred slots, re-walked
     edges, runs of gaps, an empty alignment, a read longer than its
     graph), where K4's count of windows that took the serial walk must be
     the model's (3; printed for every round too); K3 also on hand-built
     edge windows (empty graph, empty read, 8 distinct preds beside padded
     slots, sources past rank 0, a read longer than its graph, no sink) and
     on random graphs at the widest bucket, ncap 3073 with l_max 512 and
     2048.  Exact.
  6b. pk-glue: K6 (csrc/poa_pk_prep.cu: the round's group-Kahn re-rank
     and operands; its order mode the build's final order) and K7
     (csrc/poa_pk_consensus.cu: the consensus walk) against their plain
     versions (ops/poa_fused.pk_round_prep_reference, toposort_reference,
     consensus_walk_reference) on every round pk-parity captured (K6 also
     == the operands the build recorded) and on glue_edge_case's windows
     at ncap 129, 1025 and 3073 (an empty graph, one node, 8 full
     in-slots, two cyclic windows, an empty read, ncap - 1 nodes, columns
     and branches, a head with over 32 blockers, duplicate edges, a run of
     over 32 columns over holes, one long chain, weights past 2^10 for
     K7's 64-bit keys): exact; then each timed (calls queued ahead of the
     device) beside its plain version and its bound (tools/bounds.py), at
     bench round 12 and heavy round 200, with K6's us a Kahn step and K7's
     ns a rank (the time over the batch's longest window's steps or
     nodes).
  7. pk-time: each of K3, K4, K5 and its plain version on the bench batch
     the port launches (128 windows, round 12) and at the heavy capture
     (32 windows, round 200); the kernels' calls queued ahead of the device
     (tools/timing.py), the plain versions as they run; K4 and K5 also one
     call at a time right after a fresh state clone, queued and with the
     host's issue.
  8. bench256 through process_window_batch(device_poa="fused"): golden
     256/256, records equal the device-POA run's, K3, K4, K6 and K7
     launched in that run, no host sync inside a build, no host fallback,
     the pk launches a round; warm windows/s best of 3; the MSA phase
     split of one stage-A batch with K6 and K7 and, in the same call,
     with their plain versions (the build before them), each build's
     device launches (torch.profiler), and the launches of a whole
     bench256 fused run; then one run with SVSCOPE_PK_FUSION=seq: golden
     256/256 and K5 launched.
  9. heavy32x400 fused: golden 32/32, windows/s (one run); K3's, K4's,
     K6's and K7's main path is this run and bench256's (each counted
     from 0).  Every fused path below (dataprepare-fused, the dp run,
     genome-bench-fused, the tools, bench) also fails on a host sync
     inside a build and prints its pk launches a round.
 10. the CLI with `--device-poa fused`: Raw.bed sha256 equals the golden,
     and no host sync inside its fused builds (the subprocess's count).
 11. k2-parity: K2 (csrc/nw_stats.cu) against its plain torch version at
     every bucket 128 ... 4096 under both score sets (MisScore (1, 0, -1),
     edit distance (0, -1, -1)), seeded pairs with substitutions and
     indels plus the edge cases (both sides at the bucket edge, an empty
     side; batches not a multiple of 8): identical; identical to the host
     DP (every pair up to 512, 16 per larger bucket) and to the JAX golden
     (tests/data/jax_alnfeature_golden.json); the band-edge pairs
     (k2_edge_pairs: `a` of 0, 1, a band's height and two bands +-1, the
     bucket; `b` empty, 1 bp, the bucket) == plain == host DP.  Then
     misscore4096: 4,096 pairs of 100-4,000 bp, kernel == plain in every
     bucket, and misscore_batch (MisScore's entry point) on the card gives
     the plain MisScores with one K2 launch per bucket and 0 host-DP pairs.
 12. k2-time: K2 (calls queued ahead; and issued back to back, the
     earlier timing) and its plain version per bucket of misscore4096, useful
     GCUPS = sum(la * lb) / t.
 13. misscore-pipe: a Raw.bed of the port's own bench256 and heavy32x400
     records; misscore_pipe on the card (K2) gives the host DP's MisScore
     column, K2 launched, 0 pairs sent to the host DP; pairs per bucket,
     and K2's time per launch at those buckets.
 14. cli-alnfeature: `AlnFeature --device cuda` on the synth pair with the
     golden Raw.bed, then `adjustVCF`: S.Somatic.bed, RandomForestResult.tsv,
     S.vcf, S.mergedSomatic.vcf and the adjusted VCF equal the golden
     (without the ##fileDate line); K2 launched.
 15. cli-callsomaticsv: `callsomaticSV --device cuda` on the synth pair:
     the Raw.bed and the same four files equal the golden; K2 launched.
 16. k1-int16-parity: K1-int16 (poa_align.cu, int16_mode) at the SHAPES
     with N, L <= 1024: kernel == plain int16 == K1 int32 on every output
     (every window has a sink), == the C++ engine's own alignment.
 17. k1-int16-bounds: a divergent 500 bp read against a 500-node chain, the
     ceiling N = l_max = 1024, a window with no sink (score -20000, the
     rest == K1 int32) and N = 2048 (ValueError).
 18. attached-bench (k1-int16-time): svscope_tpu_torch.tools.attached_bench's
     main on the card, K1-int16's main path (its launches counted from 0):
     K1 int32, K1-int16 and their plain versions on the tool's per-round
     workload (B=64, N=L=512), the kernels' calls queued ahead of the
     device (CUDA events, tools/timing.py).
 15b. the rest of the single-card CLI, each run with the launch counts
     set to 0 just before it (tests/data/jax_dataprepare_golden.json):
     dataprepare: the synth pair's `DataPrepare --selectwindows
     --FullProcess --device cuda` then `adjustVCF` (K1 and K2 launched):
     every file (CandidateSpan beds, InterALNSVs.vcf, Raw.bed, VCFs,
     adjusted VCF) equals the JAX golden; dataprepare-fused: the same with
     `--device-poa fused` (K3 and K4); npz-replay: `--saveData` then
     `localGraph_npz --device cuda` (K1): Raw.bed == golden == the direct
     run; viz-inputs: the figure inputs of the pair's somatic window
     (MSA, columns, cutoff, K, labels; BICs within float32's 1e-5);
     em-cluster: the per-K em_cluster on the card with its own generator,
     K and labels == JAX's on the golden windows without re-init;
     chrom-bench: svscope_tpu_torch.tools.chrom_bench at 2.1 Mb, 80
     planted SVs and 8 LargeDELs with the default device POA, each
     stage's wall printed, every output file's hash == the JAX run's,
     recall 80/80.  Their total is printed.
 19-21. row-probe, fusebody-probe, int16-probe: every variant or op of the
     three probes, kernel == plain at the tool's own shapes (the int16
     ops on (262144, 128) arrays) and at the edges of the row and
     fusion-body probes' layouts (the row probe, K1's tiles a thread:
     B = 1 and 300, one row, rows of 1, 33, 1025 and 4096 columns, 1025
     a partial tile of 3, 4096 four columns a thread; the fusion-body
     probe, a warp per window over 256-entry tiles: 1, 255, 256, 257 and
     all OUT_LEN entries, 1 and 9 windows); then each tool's main on the card (the probes' main path,
     launches counted from 0), which times every variant against its
     plain version, the kernels' calls queued ahead of the device, and
     max16 and roll16 beside torch.maximum and torch.roll.
 22. scale-out (svscope_tpu_torch/parallel, ops/poa_sharded, graft_entry,
     tools/dist_worker), over a two-shard device tuple, ("cuda:0",
     "cuda:0") on one GPU (and over every GPU where there are more): a
     path check, not a scaling measurement.  dp-bench256-pallas and
     dp-bench256-fused: process_window_batch with its dispatches split
     over the tuple, golden 256/256, records == the unsharded run, the
     last dispatch sharded in 2, K1 (K3 and K4) launched, w/s beside an
     unsharded run of the same call; mp-heavy32x400: golden 32/32 with the
     400-read EM split over the reads (LAST_MP_DISPATCH), the EM stage's
     wall read-parallel and batched, K and labels equal; oversize: the 4k
     tandem-repeat design point (banded, 2 shards) == the C++ engine's
     alignment, its seconds, rows and direction blocks, launches a row
     (torch.profiler, on a 1000-node chain), and a 2,500 bp window's MSA
     with every round on the wavefront == the host MSA; dryrun:
     graft_entry.entry() and dryrun_multichip(2) over the tuple;
     multi-process: two dist_worker processes on the card (gloo rendezvous
     on a file): merged Raw.bed == the single run == golden.
 23. genome-bench: svscope_tpu_torch.tools.genome_bench at 20 Mb (4 x 5
     Mb, depth 12, nine planted classes: four truth tiers and five decoy
     tiers, each built to die at one stage) on the cuda default POA (K1;
     K2 for MisScore): every output file's hash (the BAMs included), the
     tier table (n, candidate, Raw.bed, VCF per class), the candidate
     count and the Raw.bed and VCF precision/recall equal the JAX golden
     (tests/data/jax_genome_golden.json); stage walls and launches
     printed.
 24. genome-bench-fused: the same at the golden's small configuration (2 x
     1 Mb) with the fused POA (K3 and K4).
 25. tools: the port's measurement tools once each at their bench sizes,
     tables printed: wgs_bench at 2 x 1 Mb (its background_stats frame's
     hash == JAX's), roofline (native POA, K1 and its plain version, K2 on
     misscore4096 against the bound of tools/bounds.py, the batched EM),
     engine_ab (one engine source built twice: byte-identical, timed in
     turns), pipeline_probe, pk_phase_probe and fused_probe (MSAs == the
     host engine's).
 26. bench: svscope_tpu_torch.tools.bench (bench.py's measurement) on the
     card, bench256 with the heavy tier, its JSON line printed as
     `[bench] {...}`: the headline (host POA, the EM on the card), each
     POA engine (host, pallas: K1, fused: K3 and K4) with 256/256 records
     == the localGraph golden, the stage parts per engine and the device
     round's parts, the heavy tier (host and pallas) 32/32 == golden;
     its launches counted from 0 (launches_bench).

With `--ab TREE ...` (source trees' roots, relative to this script; "."
is this checkout), K1 at the k1-time and heavy shapes, K2 at every
misscore4096 bucket, K3, K4, K5, K6 (both modes) and K7 on the bench
round-12 and heavy round-200 captures, every row-probe variant at B=256, every fusion-body
variant on the replayed states (a fresh state clone per call), and every
int16 probe op at (262144, 128) with torch.maximum and torch.roll beside
them are then timed in each tree's own build, a process per tree, on the
same saved inputs, calls queued ahead, each tree twice in turns (phase
`ab`).  A tree whose K3 still takes the
chain-row flags gets them, rebuilt from the pk layout (chain_flags); a
tree without K6 and K7 shows "-" for them.

Then one JSON line listing every kernel with its launches on the main path,
error, times and bound (a probe's row: the sums over its variants, which
it lists under "variants", with the library call's time where there is
one; K1's, K2's, K3's and K4's rows add their launches per workload and
new CLI path (launches_dataprepare, launches_chrom, launches_genome_bench,
launches_bench, ...; launches_tools: the tools phase's, not in the
totals; K3, K4, K6 and K7 alike), K6's its order mode's times and the
Kahn steps a window, K6's the stage-A batch's fused build with the
kernels and with their plain versions, K1's the chrom
and genome runs' stage walls, K1's and
the pk kernels' the heavy shape as timed, K4's and K5's their single-call
times, K4's its serial-walk windows per round checked, K2's its time per
bucket launch; K1's, K3's and K4's their scale-out runs' launches), the card
line, and the last line
{"ok": true, "device": {...}}.  Imports nothing of JAX or of the JAX
package (checked at the end).
"""
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from svscope_tpu_torch.tools.bounds import (INT16X2_OPS_PER_S, bound,
                                            fusion_bound, k1_bound,
                                            k2_bound, k2_bound_all, poa_ops,
                                            tensor_bytes)
from svscope_tpu_torch.tools.workloads import HEAVY_WINDOWS, pad_pairs

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((128, 64, 9), (512, 512, 64), (1024, 512, 256), (2048, 2048, 8))
TIME_SHAPE = (512, 512, 64)
HEAVY_2048_READS = 399             # heavy graphs past 1024 nodes
KERNEL_REPLACES = "svscope_tpu/ops/poa_pallas.py:117"
PK_KERNELS = {
    "K3": ("align_tb (K3, pk round: DP + traceback)", "poa_pk_align.cu",
           "svscope_tpu/ops/poa_fused_kernel.py:129"),
    "K4": ("fusion lockstep (K4, pk round: graph fusion, a block per "
           "window in parallel phases)", "poa_pk_fusion.cu",
           "svscope_tpu/ops/poa_fused_kernel.py:298"),
    "K5": ("fusion seq (K5, pk round: graph fusion, the serial walk, a warp "
           "per window)", "poa_pk_fusion.cu",
           "svscope_tpu/ops/poa_fused_kernel.py:438"),
    # not Pallas kernels: the XLA loops the JAX package keeps on the device
    "K6": ("round prep (K6, pk round: the group-Kahn re-rank and the "
           "operands of K3 and the fusion, a block per window; its order "
           "mode the build's final order)", "poa_pk_prep.cu",
           "svscope_tpu/ops/poa_fused.py:139"),
    "K7": ("consensus walk (K7, pk build: the heaviest-bundle walk, a block "
           "per window)", "poa_pk_consensus.cu",
           "svscope_tpu/ops/poa_fused.py:585"),
}
PK_GLUE = ("K6", "K7")
PK_MAIN = ("K3", "K4", "K6", "K7")     # the fused build's default kernels
PK_BENCH_ROUNDS = (0, 11, 23)      # rounds 1, 12 and 24
PK_HEAVY_ROUND = 199               # round 200
PK_NCAP_MAX = 3073                 # the widest pk bucket (N_LADDER[-1] + 1)
PK_WIDE_SHAPES = ((512, 32), (2048, 8))   # (l_max, B) of K3 at that ncap
GLUE_NCAPS = (129, 1025, PK_NCAP_MAX)      # K6's and K7's edge states
INT16_ROWS = 262144                # the int16 probe's timing arrays
# The row probe's layout edges (B, nrows, l1): one window, more windows
# than SMs, one row, and rows of 1, 33, 1025 and 4096 columns (K1's tiles a
# thread 1, 1, 3 and 4, the last thread's tile partial at 1025; 4096 is
# the widest row K1 takes, 1024 threads and a ring of 8 rows).
ROW_PROBE_EDGES = ((1, 512, 513), (300, 512, 513), (8, 1, 513),
                   (8, 512, 1), (8, 512, 33), (8, 512, 1025),
                   (8, 512, 4096))
# The fusion-body probe's edges: entries walked (the tile edges of its
# 256-entry tiles, and all OUT_LEN = 1536), and window batches (windows
# of the replayed 8, by index).
FUSEBODY_EDGE_ENTRIES = (1, 255, 256, 257, 1536)
FUSEBODY_EDGE_WINDOWS = ((0,), (0, 1, 2, 3, 4, 5, 6, 7, 0))
PK_BATCH = 128                     # stage A's chunk (PIPELINE_CHUNK)
K2_NAME = "nw_stats (K2, batched NW alignment stats: score, matches, length)"
K2_REPLACES = "svscope_tpu/ops/nw_pallas.py:59"
K2_PARITY = {128: 61, 256: 61, 512: 37, 1024: 21, 2048: 17, 4096: 17}
K1_16_NAME = "poa_align int16 (K1-int16, int16 H plane, sentinel -20000)"
K1_16_REPLACES = "svscope_tpu/ops/poa_pallas.py:117"
INT16_MAX = 1024
ATTACHED_B = 64
PROBES = {
    "row": ("row probe (K1's chain row part by part, on K1's tiles a "
            "thread and one barrier a row)", "probe_row.cu",
            "tools/probe/row_probe.py:100"),
    "fusebody": ("fusion-body probe (the serial fusion step on replayed "
                 "states, on K5's layout: a warp per window, staged tiles, "
                 "lane 0 walking)",
                 "probe_fusebody.cu", "tools/probe/fusebody_probe.py:232"),
    "int16": ("int16 op probe (int16 ops and packed s16x2 intrinsics)",
              "probe_int16.cu", "tools/probe/int16_mosaic_probe.py:58"),
}
K2_HOST_LARGE = 16                 # host-DP subsample past the 512 bucket
# The row probe's ops per (row, column): loop and store 1 (the add), pfx
# and chmask 2 (add, scan max), row POA_OPS_PER_CELL.  The fusion-body and
# int16 probes are counted by bytes only (a few ops per entry or element).
# Every other bound comes from svscope_tpu_torch/tools/bounds.py.
ROW_PROBE_OPS = {"loop": 1, "store": 1, "pfx": 2, "chmask": 2, "row": 8}


def phase(name, t0, msg=""):
    print(f"[{name}] ok {msg} ({time.perf_counter() - t0:.3f} s)", flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def random_graph_case(N, L, B, seed):
    """B random POA graphs (native C++ engine) that pack into N nodes, and
    one read of length <= L per window."""
    import numpy as np
    from svscope_tpu_torch.native.poa import NativePoaGraph
    rng = np.random.default_rng(seed)
    ref_len = min(int(N * 0.6), L - L // 6 - 8)
    acgt = np.array(list("ACGT"))
    graphs, reads = [], []
    for w in range(B):
        ref = "".join(rng.choice(acgt, ref_len))
        ins = "".join(rng.choice(acgt, max(ref_len // 8, 4)))
        g = NativePoaGraph()
        g.add_sequence(ref)
        for r in range(6):
            base = ref
            if r % 3 == 0:
                m = ref_len // 2
                base = ref[:m] + ins + ref[m:]
            elif r % 3 == 1:
                m = ref_len // 3
                base = ref[:m] + ref[m + ref_len // 10:]
            b = list(base)
            for _ in range(max(4, ref_len // 50)):
                p = int(rng.integers(0, len(b) - 1))
                op = int(rng.integers(0, 3))
                if op == 0:
                    b[p] = str(rng.choice(acgt))
                elif op == 1:
                    b.insert(p, str(rng.choice(acgt)))
                else:
                    b.pop(p)
            g.add_sequence("".join(b))
        graphs.append(g)
        reads.append(ref if w % 2 else ref[:ref_len // 2] + ins
                     + ref[ref_len // 2:])
    packed = [g.pack(N, 8) for g in graphs]
    if any(p is None for p in packed):
        raise RuntimeError(f"random graphs do not pack into N={N}")
    chars = np.stack([p[0] for p in packed])
    preds = np.stack([p[1] for p in packed])
    sinks = np.stack([p[2] for p in packed])
    nn = np.array([p[3] for p in packed], np.int32)
    seqs = np.zeros((B, L), np.uint8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(reads):
        seqs[i, :len(s)] = np.frombuffer(s.encode(), np.uint8)
        lens[i] = len(s)
    return graphs, reads, packed, (chars, preds, sinks, nn, seqs, lens)


def k1_edge_case(B=4, N=512, L=64):
    """Hand-built windows at the edges of K1's layout (numpy arrays, as
    random_graph_case's last item): 0, a rank with 8 distinct preds (8
    sources fanning into one node, then a chain); 1, 500 ranks (more than
    the CTA's 96 threads) with a branch every 50 ranks and a read filling
    l_max; 2, a read longer than its 20-node chain; 3, window 0 with no
    sink."""
    import numpy as np
    rng = np.random.default_rng(17)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    chars = rng.choice(acgt, (B, N)).astype(np.uint8)
    preds = np.full((B, N, 8), -1, np.int32)
    sinks = np.zeros((B, N), bool)
    nn = np.array([60, 500, 20, 60][:B], np.int32)
    lens = np.array([50, L, 60, 50][:B], np.int32)
    for w in range(B):
        for r in range(1, int(nn[w])):
            preds[w, r, 0] = r - 1
            if w == 1 and r % 50 == 0:
                preds[w, r, 1] = r - 3
        sinks[w, nn[w] - 1] = True
    for w in (0, 3):
        preds[w, :8] = -1
        preds[w, 8] = np.arange(8)
    chars[3], preds[3] = chars[0], preds[0]
    sinks[3] = False
    seqs = np.zeros((B, L), np.uint8)
    for w in range(B):
        seqs[w, :lens[w]] = rng.choice(acgt, int(lens[w]))
    return chars, preds, sinks, nn, seqs, lens


def k3_edge_case(N=80, L=64):
    """Hand-built windows at the edges of K3's layout (numpy, K1's layout
    as random_graph_case's last item; pk_layout converts them), B = 8: 0,
    an empty graph (nn 0) under a 40 bp read; 1, an empty read (lb 0) on a
    30-node chain; 2, ranks 0-7 without preds (sources past rank 0), rank
    8 with those 8 distinct preds, rank 30 with 3 preds beside 5 padded
    slots; 3, a 60 bp read on a 20-node chain; 4, the graph of 2 with no
    sink; 5, a chain with a second source at rank 15 (rank 14 a sink);
    6-7, chains with a bubble every 10 ranks under reads filling l_max."""
    import numpy as np
    rng = np.random.default_rng(23)
    B = 8
    chars = rng.integers(0, 4, (B, N)).astype(np.uint8)
    preds = np.full((B, N, 8), -1, np.int32)
    sinks = np.zeros((B, N), bool)
    nn = np.array([0, 30, 60, 20, 60, 40, 70, 70], np.int32)
    lens = np.array([40, 0, 50, 60, 45, 40, L, L], np.int32)
    for w in range(B):
        for r in range(1, int(nn[w])):
            preds[w, r, 0] = r - 1
            if w >= 6 and r % 10 == 0:
                preds[w, r, 1] = r - 3
        if nn[w]:
            sinks[w, nn[w] - 1] = True
    for w in (2, 4):
        preds[w, :8] = -1
        preds[w, 8] = np.arange(8)
        preds[w, 30, :3] = (29, 27, 25)
    sinks[4] = False
    preds[5, 15] = -1
    sinks[5, 14] = True
    seqs = rng.integers(0, 4, (B, L)).astype(np.uint8)
    seqs[np.arange(L)[None, :] >= lens[:, None]] = 0
    return chars, preds, sinks, nn, seqs, lens


def pk_layout(chars, preds, sinks, nn, seqs, lens, l_max):
    """Windows in K1's layout (numpy, -1 in empty pred slots) as K3's
    operands, laid out as ops/poa_fused.pk_round_prep lays out a round:
    (charsr, sinksr, predsp, seqv, lb, nn_eff) int32, empty slots holding
    slot 0, seqv's column 0 the pad 255.  nn_eff is nn as given."""
    import numpy as np
    B, _N = chars.shape
    preds = np.asarray(preds, np.int32)
    seqv = np.full((B, l_max + 1), 255, np.int32)
    seqv[:, 1:1 + seqs.shape[1]] = seqs
    return tuple(np.ascontiguousarray(a, dtype=np.int32) for a in (
        chars, sinks, np.where(preds < 0, preds[..., :1], preds), seqv,
        lens, nn))


FUSION_EDGE_CASES = ("duplicate key", "reaches the trash row",
                     "overflow set on entry", "8 full pred slots",
                     "re-walked edges", "runs of gaps", "empty alignment",
                     "read longer than its graph")


def fusion_edge_case(ncap=48, l_max=40):
    """Hand-built fusion rounds at the edges of K4's parallel phases
    (numpy int32), B = 8, one case per window (FUSION_EDGE_CASES):
    0, ranks 5 and 6 in one column (gminr 5) under the same new read base
    (a duplicate key); 1, nn = trash - 3 and 5 insertions (the last two
    land on the trash row, ovf set); 2, ovf set on entry; 3, a new edge
    into a node whose 8 pred slots are full (ovf by the edge); 4, a read
    re-walking a chain (weights + 1) with one substitution (a creator
    joining a column); 5, runs of asx = -1 gaps between valid entries;
    6, an empty alignment (ke = out_len - 1); 7, a 30 bp read on an 8-node
    chain.  Ranks are node ids, each node its own column unless stated,
    and the rows past nn hold GraphState.empty's pattern.  Returns
    ((an, asx, ke, gminr, seqs5), (pn, pw, pt, gc, ch, gm, nn, tctr,
    ovf)); n_max = ncap."""
    import numpy as np
    rng = np.random.default_rng(31)
    B = 8
    out_len = ncap - 1 + l_max
    trash = ncap - 1
    pn = np.full((B, ncap, 8), -1, np.int32)
    pw = np.zeros((B, ncap, 8), np.int32)
    pt = np.zeros((B, ncap, 8), np.int32)
    gc = np.full((B, ncap, 5), -1, np.int32)
    ch = np.zeros((B, ncap), np.int32)
    gm = np.tile(np.arange(ncap, dtype=np.int32), (B, 1))
    nn, tctr, ovf = (np.zeros(B, np.int32) for _ in range(3))
    gminr = np.zeros((B, ncap), np.int32)
    an = np.full((B, out_len), -2, np.int32)
    asx = np.full((B, out_len), -2, np.int32)
    ke = np.full(B, out_len - 1, np.int32)
    seqs5 = np.zeros((B, l_max), np.int32)

    def node(w, base, preds=(), col=None):
        i = int(nn[w])
        nn[w] += 1
        col = i if col is None else col
        ch[w, i], gm[w, i], gminr[w, i] = base, col, col
        gc[w, col, base] = i
        for s, p in enumerate(preds):
            pn[w, i, s], pw[w, i, s], pt[w, i, s] = p, rng.integers(1, 5), \
                tctr[w]
            tctr[w] += 1
        return i

    def chain(w, n, first_preds=()):
        for j in range(n):
            node(w, int(rng.integers(0, 4)),
                 (nn[w] - 1,) if j else first_preds)

    def align(w, entries, read):
        """entries: (rank, read position) pairs in order, -1 a gap."""
        n = len(entries)
        ke[w] = out_len - 1 - n
        if n:
            an[w, out_len - n:], asx[w, out_len - n:] = zip(*entries)
        seqs5[w, :len(read)] = read

    def other(*bases):
        return next(b for b in range(4) if b not in bases)
    # 0: node 6 is node 5's alternative in column 5
    chain(0, 5)
    node(0, 0, (4,))
    node(0, 1, (4,), col=5)
    node(0, 2, (5, 6))
    chain(0, 4, (7,))
    read = ch[0, :12].copy()
    read[5] = read[6] = 3
    align(0, [(r, r) for r in range(12)], read)
    # 1: 44 nodes, trash 47
    chain(1, trash - 3)
    read = np.concatenate([ch[1, :10], rng.integers(0, 4, 5), ch[1, 10:20]])
    align(1, [(r, r) for r in range(10)] + [(-1, j) for j in range(10, 15)]
          + [(r, r + 5) for r in range(10, 20)], read)
    # 2: a substitution and an insertion, overflow already set
    chain(2, 15)
    read = list(ch[2, 2:10]) + [2] + list(ch[2, 10:13])
    read[4] = other(read[4])
    align(2, [(r, r - 2) for r in range(2, 10)] + [(-1, 8)]
          + [(r, r - 1) for r in range(10, 13)], read)
    ovf[2] = 1
    # 3: sources 0-7 into node 8, then a chain
    for _ in range(8):
        node(3, int(rng.integers(0, 4)))
    node(3, 1, tuple(range(8)))
    chain(3, 6, (8,))
    align(3, [(-1, 0)] + [(r, r - 7) for r in range(8, 13)],
          [0] + list(ch[3, 8:13]))
    # 4: ranks 3-15 again, rank 9 under another base
    chain(4, 20)
    read = ch[4, 3:16].copy()
    read[6] = other(read[6])
    align(4, [(r, r - 3) for r in range(3, 16)], read)
    # 5: matches, deletions, matches, deletions, matches
    chain(5, 30)
    ents = [(r, r) for r in range(8)] + [(r, -1) for r in range(8, 14)] \
        + [(r, r - 6) for r in range(14, 21)] \
        + [(r, -1) for r in range(21, 24)] \
        + [(r, r - 9) for r in range(24, 28)]
    read = np.zeros(19, np.int32)
    for r, j in ents:
        if j >= 0:
            read[j] = ch[5, r]
    align(5, ents, read)
    # 6: nothing to fuse
    chain(6, 10)
    seqs5[6, :10] = ch[6, :10]
    # 7: 5 + 17 insertions around an 8-node chain, one base N
    chain(7, 8)
    read = np.concatenate([rng.integers(0, 4, 5), ch[7, :8],
                           rng.integers(0, 4, 17)])
    read[20] = 4
    align(7, [(-1, j) for j in range(5)] + [(r, r + 5) for r in range(8)]
          + [(-1, j) for j in range(13, 30)], read)
    return (an, asx, ke, gminr, seqs5), (pn, pw, pt, gc, ch, gm, nn, tctr,
                                         ovf)


GLUE_EDGE_CASES = ("empty graph", "one node", "8 full in-slots",
                   "a back edge (cyclic)", "an empty read",
                   "two back edges (cyclic)", "ncap - 1 nodes",
                   "columns and branches", "a head with > 32 blockers",
                   "duplicate cross-column edges",
                   "a run of > 32 columns over holes",
                   "one chain of ncap - 1 nodes", "weights past 2^10")
GLUE_CYCLIC = (3, 5)                  # the cyclic windows of glue_edge_case
GLUE_WIDE = 12                        # its window with 64-bit K7 keys


def glue_edge_case(ncap, l_max=64, seed=0):
    """Hand-built window states at the edges of K6 and K7 (numpy), B = 13,
    one case per window (GLUE_EDGE_CASES), shaped as fusion leaves them: a
    backbone chain, then nodes with larger ids that either join a backbone
    node's column as its alternative (preds and successors around it) or
    are insertions between two backbone nodes (their own column, an edge
    into a smaller column id: what makes the Kahn loop take more steps),
    backbone skip edges, weights 1-24 and each window's edge stamps a
    permutation.  0, n = 0; 1, n = 1; 2, n = ncap / 2 and a node whose 8
    pred slots are all used; 3, one backbone back edge closing a cycle;
    4, a read of length 0; 5, two back edges; 6, n = ncap - 1 (the trash
    row's edge); 7, many columns and branches; 8, a column of 7 members
    with 8 preds each (over 32 distinct blocker columns, one of them an
    insertion with a larger id); 9, columns of two members joined to each
    other (the same column pair up to four times) and pred rows naming a
    tail twice; 10, a chain over three id blocks in the order 2, 1, 3,
    every 7th id an alternative (a first run of over 32 columns, then one
    across the placed block and the alternatives); 11, a plain chain of
    ncap - 1 nodes; 12, weights of 2^10 to 2^20 (K7's 64-bit keys).  Rows
    past n hold GraphState.empty's pattern.  Returns a dict: pn, pw, pt,
    gc, ch, gm, nn, tctr, ovf (GraphState's fields) and seq (B, l_max),
    slen (B,), int32."""
    import numpy as np
    rng = np.random.default_rng(1000 * seed + ncap)
    B = len(GLUE_EDGE_CASES)
    pn = np.full((B, ncap, 8), -1, np.int32)
    pw = np.zeros((B, ncap, 8), np.int32)
    pt = np.zeros((B, ncap, 8), np.int32)
    gm = np.tile(np.arange(ncap, dtype=np.int32), (B, 1))
    ch = np.zeros((B, ncap), np.int32)
    nn = np.zeros(B, np.int32)
    slen = rng.integers(1, l_max + 1, 8).astype(np.int32)
    seq = rng.integers(0, 5, (8, l_max)).astype(np.int32)

    def add(w, head, tail):
        row = pn[w, head]
        free = np.flatnonzero(row < 0)
        if free.size and not (row == tail).any():
            row[free[0]] = tail

    def graph(w, n, branch=0.3, skips=0, back=0, full=False):
        nn[w] = n
        ch[w, :n] = rng.integers(0, 5, n)
        m = max(n - int(branch * n), min(n, 4))       # the backbone
        for v in range(1, m):
            pn[w, v, 0] = v - 1
        for x in range(m, n):
            i = int(rng.integers(1, m - 1))
            if rng.random() < 0.5:                    # i's alternative
                gm[w, x] = gm[w, i]
                add(w, x, i - 1)
            else:                                     # an insertion
                add(w, x, i)
            add(w, i + 1, x)
        for _ in range(skips if m > 2 else 0):
            a = int(rng.integers(0, m - 2))
            add(w, int(rng.integers(a + 2, m)), a)
        if full:
            v = m // 2
            for t in rng.permutation(v - 1):
                add(w, v, int(t))
            assert (pn[w, v] >= 0).all()
        for _ in range(back):
            a = int(rng.integers(0, m - 3))
            add(w, a, int(rng.integers(a + 2, m)))
        weigh(w, n)

    def weigh(w, n, low=1, high=25):
        live = (pn[w, :n] >= 0)
        pw[w, :n][live] = rng.integers(low, high, int(live.sum()))
        pt[w, :n][live] = rng.permutation(int(live.sum()))
    graph(0, 0)
    graph(1, 1)
    graph(2, ncap // 2, skips=ncap // 16, full=True)
    graph(3, ncap // 2, skips=ncap // 16, back=1)
    graph(4, ncap // 3, skips=ncap // 16)
    slen[4] = 0
    graph(5, ncap // 2, skips=ncap // 8, back=2)
    graph(6, ncap - 1, skips=ncap // 16)
    graph(7, 3 * ncap // 4, branch=0.5, skips=ncap // 4)
    # 8: column c's 7 members (c and 6 alternatives), 8 preds each from
    # the backbone, one of them an insertion y > c, so c waits for y
    m = ncap // 2
    for v in range(1, m):
        pn[8, v, 0] = v - 1
    c, y = m - 2, m + 6
    pn[8, c, 1:] = rng.choice(c - 1, 7, replace=False)
    for x in range(m, y):
        gm[8, x] = c
        pn[8, x] = rng.choice(c, 8, replace=False)
        add(8, c + 1, x)
    pn[8, m, 7] = y
    pn[8, y, 0] = 3
    nn[8] = y + 1
    # 9: a backbone whose nodes from 2 on get an alternative while ids
    # last, each member joined to both members of the column before; every
    # fifth row from 3 names its first tail twice
    n9 = ncap // 2
    for v in range(1, n9 // 2):
        pn[9, v, 0] = v - 1
    alt = {}
    x = n9 // 2
    for i in range(2, n9 // 2 - 1):
        if x >= n9:
            break
        gm[9, x] = i
        alt[i] = x
        for h in (i, x):
            for t in (i - 1, alt.get(i - 1, -1)):
                if t >= 0:
                    add(9, h, t)
        add(9, i + 1, x)
        x += 1
    for v in range(3, x, 5):
        row = pn[9, v]
        free = np.flatnonzero(row < 0)
        if row[0] >= 0 and free.size:
            row[free[0]] = row[0]
    nn[9] = x
    # 10: a chain over the id blocks [b1, b2), [0, b1), [b2, n), every 7th
    # id (not 0) joining the column of the chain node below it
    n10 = ncap - 1
    ids = np.arange(n10)
    alts = ids[(ids % 7 == 6)]
    chain_ids = ids[ids % 7 != 6]
    b1, b2 = n10 // 3, 2 * n10 // 3
    walk = np.concatenate([chain_ids[(chain_ids >= b1) & (chain_ids < b2)],
                           chain_ids[chain_ids < b1],
                           chain_ids[chain_ids >= b2]])
    pred_of = {}
    for a, b in zip(walk[:-1], walk[1:]):
        pn[10, b, 0] = a
        pred_of[int(b)] = int(a)
    succ_of = {a: b for b, a in pred_of.items()}
    for x in alts:
        i = int(x) - 1
        gm[10, x] = i
        if i in pred_of:
            add(10, int(x), pred_of[i])
        if i in succ_of:
            add(10, succ_of[i], int(x))
    nn[10] = n10
    for w in (8, 9, 10):
        ch[w, :nn[w]] = rng.integers(0, 5, nn[w])
        weigh(w, nn[w])
    graph(11, ncap - 1, branch=0.0)
    graph(12, ncap // 2, skips=ncap // 16)
    weigh(12, ncap // 2, 1 << 10, 1 << 20)
    slen = np.concatenate([slen, rng.integers(1, l_max + 1, B - 8)]
                          ).astype(np.int32)
    seq = np.concatenate([seq, rng.integers(0, 5, (B - 8, l_max))]
                         ).astype(np.int32)
    seq[np.arange(l_max)[None, :] >= slen[:, None]] = 0
    gc = np.full((B, ncap, 5), -1, np.int32)
    tctr = (pn >= 0).sum((1, 2)).astype(np.int32)
    return {"pn": pn, "pw": pw, "pt": pt, "gc": gc, "ch": ch, "gm": gm,
            "nn": nn, "tctr": tctr, "ovf": np.zeros(B, np.int32),
            "seq": seq, "slen": slen}


def glue_edge_windows(batch):
    """Which of glue_edge_case's windows a batch of `batch` takes: the
    last first, then round again (numpy)."""
    import numpy as np
    n = len(GLUE_EDGE_CASES)
    return (n - 1 - np.arange(batch)) % n


def glue_edge_tensors(ncap, dev, l_max=64, seed=0, batch=None):
    """glue_edge_case's windows on `dev`, or a batch of `batch` of them
    (glue_edge_windows): (GraphState, seq, slen)."""
    import numpy as np
    import torch
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    c = glue_edge_case(ncap, l_max, seed)
    idx = np.arange(len(GLUE_EDGE_CASES)) if batch is None \
        else glue_edge_windows(batch)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[idx])).to(dev)
    return (tpk.GraphState(*[t(c[f]) for f in (
        "pn", "pw", "pt", "gc", "ch", "gm", "nn", "tctr", "ovf")]),
            t(c["seq"]), t(c["slen"]))


def chain_flags(predsp, nn_eff):
    """The chain-row flags that JAX's align_tb_call (and K3 before it
    found chain rows itself) takes, from pk-layout preds (numpy): one pred
    (slot 1 a copy of slot 0) of rank r-1, or rank 0 without preds, or a
    rank past nn_eff.  (B, N) int32."""
    import numpy as np
    ri = np.arange(predsp.shape[1])[None, :]
    p0 = predsp[..., 0]
    single = predsp[..., 1] == p0
    return ((single & ((p0 == ri - 1) | ((ri == 0) & (p0 < 0))))
            | (ri >= np.asarray(nn_eff).reshape(-1, 1))).astype(np.int32)


def k2_edge_pairs(bucket, seed):
    """Pairs at the edges of K2's bands for one bucket, mixed in one batch:
    `a` of 0 and 1 bp, a band's height and +-1, two bands and +-1, the
    bucket and -1 (those <= bucket), each against a mutated copy of itself
    (cut to the bucket), an empty `b`, 1 bp and a full `b` of `bucket` bp."""
    import numpy as np
    import torch_workloads as tw
    from svscope_tpu_torch.ops.nw_kernel import launch_config
    band = 32 * launch_config(bucket)[0]
    rng = np.random.default_rng(seed)
    las = sorted({n for n in (0, 1, band - 1, band, band + 1, 2 * band - 1,
                              2 * band, 2 * band + 1, bucket - 1, bucket)
                  if 0 <= n <= bucket})
    pairs = []
    for la in las:
        a = tw.rand_seq(rng, la)
        pairs += [(a, tw.mutate(rng, a, 0.05, 2, (1, 8))[:bucket]), (a, ""),
                  (a, tw.rand_seq(rng, 1)), (a, tw.rand_seq(rng, bucket))]
    return pairs


def cuda_ms(fn, reps, queued):
    """Mean ms of fn() over reps calls after a warm-up (CUDA events; with
    `queued` the calls are queued ahead of the device, tools/timing.py)."""
    import torch
    from svscope_tpu_torch.tools.timing import time_call
    return time_call(fn, torch.device("cuda", torch.cuda.current_device()),
                     reps, queued=queued)


def k1_parity(arrs, L, dev, what, graphs=None, reads=None, packed=None):
    """K1 == its plain version on one batch (and == the C++ engine's own
    alignment where the graphs are given); returns the max error (0)."""
    import numpy as np
    import torch
    from svscope_tpu_torch.ops import poa_align, poa_device
    args = poa_device.to_torch_packed(*arrs, dev)
    got = [t.cpu().numpy().astype(np.int64)
           for t in poa_align.align_batch_cuda(*args, L)]
    torch.cuda.synchronize()
    want = [t.cpu().numpy().astype(np.int64)
            for t in poa_device.align_batch_reference(*args, L)]
    err = max(int(np.abs(a - b).max()) for a, b in zip(got, want))
    if err:
        raise RuntimeError(f"kernel != plain on {what}")
    an, asp, ke, _sc = got
    for i, g in enumerate(graphs or ()):
        aln = poa_device.unpack_alignment(an[i], asp[i], ke[i], packed[i][4])
        if aln != g.align_only(reads[i]):
            raise RuntimeError(f"kernel != native engine, window {i} on "
                               f"{what}")
    return err


def k1_time(arrs, L, dev, name, t0):
    """K1 (calls queued ahead of the device, and issued back to back, the
    earlier timing) and its plain version on one batch; the bound from its
    inputs.  Returns {ms, ms_issued, plain_ms, bound}."""
    import numpy as np
    from svscope_tpu_torch.ops import poa_align, poa_device
    args = poa_device.to_torch_packed(*arrs, dev)
    B, N = arrs[0].shape
    cells = float((arrs[3].astype(np.int64) * arrs[5]).sum())
    k_ms = cuda_ms(lambda: poa_align.align_batch_cuda(*args, L), 20, True)
    k_issued = cuda_ms(lambda: poa_align.align_batch_cuda(*args, L), 20,
                       False)
    p_ms = cuda_ms(lambda: poa_device.align_batch_reference(*args, L), 3,
                   False)
    outs = poa_align.align_batch_cuda(*args, L)
    bnd = k1_bound(args, outs)
    phase(name, t0, f"B={B} N={N} L={L} (nodes {int(arrs[3].min())}-"
          f"{int(arrs[3].max())}): kernel {k_ms:.4f} ms "
          f"({cells / k_ms / 1e6:.3f} GCUPS; calls queued ahead of the "
          f"device), {k_issued:.4f} ms issued back to back; "
          f"plain {p_ms:.4f} ms ({cells / p_ms / 1e6:.3f} GCUPS), useful "
          f"cells {int(cells)}, bound {bnd[0]:.4f} ms ({bnd[1]})")
    return {"ms": k_ms, "ms_issued": k_issued, "plain_ms": p_ms,
            "bound": bnd}


def check_kernel(dev):
    """Phase 2: kernel == plain == native at every shape, on the edge
    windows and on heavy graphs past 1024 nodes; timings at the k1-time
    shape and the heavy shape (kernel == plain there too)."""
    import numpy as np
    from svscope_tpu_torch.tools import workloads as tw
    max_err = 0
    for N, L, B in SHAPES:
        t0 = time.perf_counter()
        graphs, reads, packed, arrs = random_graph_case(N, L, B, seed=N + B)
        max_err = max(max_err, k1_parity(arrs, L, dev, f"N={N} L={L} B={B}",
                                          graphs, reads, packed))
        phase("k1-parity", t0, f"N={N} L={L} B={B} max_nodes="
              f"{int(arrs[3].max())} kernel==plain==native")
    t0 = time.perf_counter()
    max_err = max(max_err, k1_parity(k1_edge_case(), 64, dev, "edge windows"))
    phase("k1-parity", t0, "edge windows N=512 L=64 B=4 (a rank with 8 "
          "distinct preds; 500 ranks on 96 threads; a 60 bp read on a "
          "20-node chain; no sink): kernel==plain")
    t0 = time.perf_counter()
    wins = tw.make_window_payloads(tw.HEAVY_WINDOWS, np.random.default_rng(
        tw.HEAVY_SEED), n_reads=tw.HEAVY_READS,
        ins_carriers=tw.HEAVY_READS // 2)
    arrs = tw.round_workload(wins, HEAVY_2048_READS, 2048, 512)
    max_err = max(max_err, k1_parity(arrs, 512, dev, "heavy N=2048"))
    phase("k1-parity", t0, f"heavy windows after {HEAVY_2048_READS} reads, "
          f"B={len(wins)} N=2048 L=512 nodes {int(arrs[3].min())}-"
          f"{int(arrs[3].max())}: kernel==plain")
    t0 = time.perf_counter()
    N, L, B = TIME_SHAPE
    _g, _r, _p, arrs = random_graph_case(N, L, B, seed=7)
    main = k1_time(arrs, L, dev, "k1-time", t0)
    t0 = time.perf_counter()
    arrs = tw.heavy_round_workload()
    max_err = max(max_err, k1_parity(arrs, 512, dev, "heavy N=1024"))
    heavy = k1_time(arrs, 512, dev, "k1-time-heavy", t0)
    return max_err, main, heavy


def run_workload(name, golden, dev, device_runs, host_runs):
    """Phases 3/4: golden check, launch count, the device rounds' counts
    (poa_batch.COUNTS: no per-window Python pack or fuse, the batch
    entries called), device/host equality, warm windows/s (best of the
    warm runs), then the device round's six parts over one MSA build of a
    pipeline chunk's windows."""
    import torch
    import localgraph_golden as lgg
    from svscope_tpu_torch.engine.localgraph import (PIPELINE_CHUNK,
                                                     process_window_batch,
                                                     record_line)
    from svscope_tpu_torch.ops import poa_align, poa_batch
    g = golden["workloads"][name]
    wins = lgg.make_workload(name)
    if lgg.payload_sha256(wins) != g["payload_sha256"]:
        raise RuntimeError(f"{name}: window payloads differ from the "
                           "golden's (numpy drew other inputs)")
    t0 = time.perf_counter()
    poa_align.reset_launches()
    poa_batch.reset_counts()
    recs = process_window_batch(wins, device=dev)   # policy: the kernel
    torch.cuda.synchronize()
    launches = poa_align.LAUNCHES
    counts = dict(poa_batch.COUNTS)
    cold = time.perf_counter() - t0
    hashes = [lgg.sha256(record_line(r)) for r in recs]
    same = sum(a == b for a, b in zip(hashes, g["records"]))
    n_em = sum(str(r[9]).endswith("EMOutput") for r in recs)
    if same != len(g["records"]) or len(recs) != len(wins):
        raise RuntimeError(f"{name}: golden {same}/{len(g['records'])}")
    if launches <= 0:
        raise RuntimeError(f"{name}: the main path launched no kernel")
    if n_em < 0.8 * len(wins):
        raise RuntimeError(f"{name}: only {n_em} EMOutput records")
    print(f"  [{name}] poa_batch.COUNTS {json.dumps(counts)}", flush=True)
    if counts["window_packs"] or counts["window_fuses"] \
            or not counts["chunks"]:
        raise RuntimeError(f"{name}: the device rounds packed or fused a "
                           f"window at a time, or not in batches: {counts}")
    phase(name, t0, f"golden {same}/{len(wins)}, kernel launches "
          f"{launches}, EMOutput {n_em}/{len(wins)}, cold {cold:.3f} s")
    t0 = time.perf_counter()
    dev_s, host_s = [], []
    for k in range(max(device_runs, host_runs)):
        if k < host_runs:
            t = time.perf_counter()
            host = process_window_batch(wins, device=dev, device_poa=False)
            torch.cuda.synchronize()
            host_s.append(time.perf_counter() - t)
            if host != recs:
                raise RuntimeError(f"{name}: host-POA records differ from "
                                   "device-POA records")
        if k < device_runs:
            t = time.perf_counter()
            again = process_window_batch(wins, device=dev)
            torch.cuda.synchronize()
            dev_s.append(time.perf_counter() - t)
            if again != recs:
                raise RuntimeError(f"{name}: device-POA run not repeatable")
    n = len(wins)
    phase(name + "-rate", t0,
          f"device POA {n / min(dev_s):.3f} w/s (runs "
          f"{[round(s, 4) for s in dev_s]}), host POA "
          f"{n / min(host_s):.3f} w/s (runs "
          f"{[round(s, 4) for s in host_s]}), records device == host")
    t0 = time.perf_counter()
    jobs = [w.sequences for w in wins[:PIPELINE_CHUNK]]
    parts = {}
    t = time.perf_counter()
    msa = poa_batch.poa_msa_batch(jobs, use_device="pallas", device=dev,
                                  timing=parts)
    wall = time.perf_counter() - t
    if msa != poa_batch.poa_msa_batch(jobs, device=dev):
        raise RuntimeError(f"{name}: the timed device MSA build differs "
                           "from the host engine's")
    phase(name + "-round-parts", t0,
          f"one MSA build of {len(jobs)} windows {wall * 1e3:.1f} ms, its "
          "rounds' parts " + ", ".join(
              f"{p} {parts.get(p, 0.0) * 1e3:.1f} ms"
              for p in poa_batch.ROUND_PARTS)
          + f" (sum {sum(parts.values()) * 1e3:.1f} ms); == host MSAs")
    return launches, recs


# The CLI as `python -m svscope_tpu_torch.cli` runs it, then the fused
# build's count of host checks (COUNTS["host_syncs"]) on its last line.
CLI_SNIPPET = """
import sys
from svscope_tpu_torch import cli
from svscope_tpu_torch.ops import poa_fused
cli.main(sys.argv[1:])
print("[host_syncs]", poa_fused.COUNTS["host_syncs"])
"""


def check_cli(golden, extra=(), name="cli"):
    """Phases 5 and 10: the CLI on the synthetic pair, Raw.bed vs the
    golden, and no host check inside a fused build (the subprocess reports
    COUNTS["host_syncs"]; 0 on the card).  Returns that count."""
    import localgraph_golden as lgg
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ref, tumor, normal, recs = lgg.make_synth_pair(d)
        bed = os.path.join(d, "windows.bed")
        with open(bed, "w") as f:
            f.write("".join(r + "\n" for r in recs))
        out = os.path.join(d, "out")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        res = subprocess.run(
            [sys.executable, "-c", CLI_SNIPPET, "localGraph",
             "--device", "cuda", *extra, "-w", bed, "-T", tumor, "-N",
             normal, "-t", "S", "-n", "S", "-r", ref, "-s", out],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"CLI failed (rc {res.returncode}):\n"
                               f"{res.stderr[-3000:]}")
        with open(os.path.join(out, "S.vs.S.TandemRepeat.Raw.bed"),
                  "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
    if sha != golden["synth_pair"]["raw_bed_sha256"]:
        raise RuntimeError(f"{name}: CLI Raw.bed differs from the golden")
    said = [ln for ln in res.stdout.splitlines()
            if ln.startswith("[host_syncs]")]
    if not said:
        raise RuntimeError(f"{name}: the CLI run reported no host_syncs")
    syncs = int(said[-1].split()[1])
    if syncs:
        raise RuntimeError(f"{name}: {syncs} host syncs inside fused builds")
    phase(name, t0, f"Raw.bed sha256 {sha[:16]} == golden; host syncs "
          f"inside fused builds {syncs}")
    return syncs


class _Captured(Exception):
    """Stops a build once the rounds asked for are captured."""


def capture_rounds(seq_lists, rounds, dev):
    """Operands of both pk kernels at the given rounds of the port's own
    fused build of `seq_lists` (one bucket): {round: (ops, state before
    fusion, an, asx, ke)}, clones."""
    from svscope_tpu_torch.ops import poa_fused as tpf
    _out, groups, fallback, enc = tpf.plan_buckets(seq_lists)
    if len(groups) != 1 or fallback:
        raise RuntimeError(f"expected one bucket, got {list(groups)} and "
                           f"{len(fallback)} host windows")
    (rb, lb, nb), idxs = next(iter(groups.items()))
    seqs, lens, nseq = tpf.chunk_arrays(idxs, enc, rb, lb)
    caps = {}

    def hook(r, ops, st, an, asx, ke):
        if r in rounds:
            caps[r] = ([o.clone() for o in ops], st.clone(), an.clone(),
                       asx.clone(), ke.clone())
            if len(caps) == len(rounds):
                raise _Captured
    try:
        tpf.build_batch_pk(seqs, lens, nseq, ncap=nb + 1, device=dev,
                           round_hook=hook)
    except _Captured:
        pass
    if len(caps) != len(rounds):
        raise RuntimeError(f"captured rounds {sorted(caps)} of {rounds}")
    return (rb, lb, nb), caps


def _max_err(got, want):
    return max(int((a.long() - b.long()).abs().max()) for a, b in
               zip(got, want))


def fusion_compare(an, asx, ke, gminr, seq5, st):
    """K4, K5 and both orders of their plain version on one round, and the
    CPU model of K4's phases (tests/torch_fusion_model.py) on copies.
    Returns ({pair: max abs error}, (K4's count of windows that took the
    serial walk, the model's count of flagged windows))."""
    import torch
    import torch_fusion_model as tfm
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    nflag = torch.zeros(1, dtype=torch.int32, device=an.device)
    out = {}
    for name, fn, order in (("K4", tpk.fusion_cuda, "lockstep"),
                            ("K5", tpk.fusion_cuda, "seq"),
                            ("P4", tpk.fusion_reference, "lockstep"),
                            ("P5", tpk.fusion_reference, "seq")):
        s2 = st.clone()
        extra = {"fallbacks": nflag} if name == "K4" else {}
        path = fn(an, asx, ke, gminr, seq5, s2, order, **extra)
        torch.cuda.synchronize()
        out[name] = [t.cpu() for t in [path] + s2.tensors()]
    sm = tpk.GraphState(*[t.cpu() for t in st.tensors()]).clone()
    path, flagged = tfm.fuse_parallel(
        *[t.cpu() for t in (an, asx, ke, gminr, seq5)], sm)
    out["model"] = [path] + sm.tensors()
    errs = {"K4": _max_err(out["K4"], out["P4"]),
            "K5": _max_err(out["K5"], out["P5"]),
            "K4-K5": _max_err(out["K4"], out["K5"]),
            "P4-P5": _max_err(out["P4"], out["P5"]),
            "model-P4": _max_err(out["model"], out["P4"])}
    return errs, (int(nflag.item()), int(flagged.sum()))


def pk_compare(ops, st, an, asx, ke):
    """K3 against its plain version (and the build's own K3 output) on one
    round's operands, then fusion_compare.  Returns ({kernel or pair: max
    abs error}, (K4's serial-walk windows, the model's flagged
    windows))."""
    import torch
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    *k3_ops, gminr = ops
    k3 = tpk.align_tb_cuda(*k3_ops)
    torch.cuda.synchronize()
    p3 = tpk.align_tb_reference(*k3_ops)
    if _max_err(k3, (an, asx, ke)):
        raise RuntimeError("K3 differs from the build's own K3 output")
    seq5 = k3_ops[3][:, 1:].contiguous()     # seqv without its pad column
    errs, flags = fusion_compare(an, asx, ke, gminr, seq5, st)
    return {"K3": _max_err(k3, p3), **errs}, flags


def glue_compare(st, seq, slen, build_ops=None):
    """K6 (its prep mode with the ovf update, on a clone, and its order
    mode) and K7 (on the plain order) against their plain versions on one
    window batch; with build_ops, K6's operands also against those a build
    recorded for this state.  Returns ({"K6", "K7": max abs error}, the
    number of cyclic windows)."""
    import torch
    from svscope_tpu_torch.ops import poa_fused as tpf
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    got_st, want_st = st.clone(), st.clone()
    ops, cyc = tpk.round_prep_cuda(got_st, seq, slen, update_ovf=True)
    order, rank, cyc2 = tpk.toposort_cuda(st.pn, st.gm, st.nn)
    torch.cuda.synchronize()
    w_ops, w_cyc = tpf.pk_round_prep_reference(want_st, seq, slen)
    want_st.ovf |= w_cyc.to(torch.int32)
    w_order, w_rank, w_cyc2 = tpf.toposort_reference(st.pn, st.gm, st.nn)
    k6 = _max_err([*ops, cyc, got_st.ovf, order, rank, cyc2],
                  [*w_ops, w_cyc, want_st.ovf, w_order, w_rank, w_cyc2])
    if build_ops is not None:
        k6 = max(k6, _max_err(ops, build_ops))
    walk = tpk.consensus_cuda(st.pn, st.pw, st.pt, st.nn, w_order)
    torch.cuda.synchronize()
    k7 = _max_err(walk, tpf.consensus_walk_reference(
        st.ch, st.pn, st.pw, st.pt, st.nn, w_order))
    return {"K6": k6, "K7": k7}, int(w_cyc.sum())


def fusion_edge_tensors(dev):
    """fusion_edge_case's round as tensors on `dev`: (an, asx, ke, gminr,
    seqs5) and the GraphState."""
    import torch
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    ops, state = fusion_edge_case()
    return ([torch.from_numpy(a).to(dev) for a in ops],
            tpk.GraphState(*[torch.from_numpy(a).to(dev) for a in state]))


def k3_parity(arrs, dev, what):
    """K3 == its plain version on pk-layout numpy operands (pk_layout's
    tuple); returns the max error (0)."""
    import torch
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    args = [torch.from_numpy(a).to(dev) for a in arrs]
    got = tpk.align_tb_cuda(*args)
    torch.cuda.synchronize()
    err = _max_err(got, tpk.align_tb_reference(*args))
    if err:
        raise RuntimeError(f"K3 != plain on {what} (max error {err})")
    return err


def check_pk_kernels(dev):
    """Phase 6: K3/K4/K5 == plain on captured real rounds, K4/K5 == plain
    on the fusion edge states, K4's serial-walk windows == the model's on
    all of them; K3 == plain on the edge windows and on random graphs at
    N = 3073.  Returns the max error per kernel, the bench round-12 and
    heavy round-200 captures for phase 7, K4's serial-walk windows per
    round checked, and every capture by name (for pk-glue)."""
    import localgraph_golden as lgg
    max_err = {"K3": 0, "K4": 0, "K5": 0}
    cases = (("bench256", PK_BATCH, PK_BENCH_ROUNDS),
             ("heavy32x400", None, (PK_HEAVY_ROUND,)))
    keep, serial_walks, every = {}, {}, {}

    def check(errs, flags, what):
        if any(errs.values()) or flags[0] != flags[1]:
            raise RuntimeError(f"pk kernel != plain or K4's serial-walk "
                               f"windows != the model's on {what}: {errs}, "
                               f"flagged (K4, model) {flags}")
        for k in max_err:
            max_err[k] = max(max_err[k], errs.get(k, 0))
        serial_walks[what] = flags[0]
    for name, n, rounds in cases:
        t0 = time.perf_counter()
        wins = lgg.make_workload(name)[:n]
        bucket, caps = capture_rounds([w.sequences for w in wins], rounds,
                                      dev)
        for r in rounds:
            ops, st, an, asx, ke = caps[r]
            every[f"{name} round {r + 1}"] = caps[r]
            errs, flags = pk_compare(ops, st, an, asx, ke)
            check(errs, flags, f"{name} round {r + 1}")
            phase("pk-parity", t0, f"{name} bucket (R, L, N)={bucket} "
                  f"B={len(wins)} round {r + 1}: max nodes "
                  f"{int(st.nn.max())}, windows with ovf set "
                  f"{int((st.ovf > 0).sum())}, K3==plain, K4==plain, "
                  f"K5==plain, K4==K5, model==plain (errors {errs}); K4's "
                  f"serial-walk windows {flags[0]} == the model's {flags[1]}")
        keep[name] = caps[PK_BENCH_ROUNDS[1] if name == "bench256"
                          else PK_HEAVY_ROUND]
    t0 = time.perf_counter()
    (an, asx, ke, gminr, seq5), st = fusion_edge_tensors(dev)
    errs, flags = fusion_compare(an, asx, ke, gminr, seq5, st)
    check(errs, flags, "edge states")
    if flags[0] != 3:
        raise RuntimeError(f"K4 took the serial walk in {flags[0]} edge "
                           "windows, expected 3 (cases 1-3)")
    phase("pk-parity", t0, f"K4/K5 edge states B=8 ncap=48 l_max=40 "
          f"({'; '.join(FUSION_EDGE_CASES)}): K4==plain, K5==plain, "
          f"K4==K5, model==plain (errors {errs}); K4's serial-walk windows "
          f"{flags[0]} == the model's {flags[1]}")
    t0 = time.perf_counter()
    err = k3_parity(pk_layout(*k3_edge_case(), 64), dev, "edge windows")
    max_err["K3"] = max(max_err["K3"], err)
    phase("pk-parity", t0, "K3 edge windows N=80 l_max=64 B=8 (empty "
          "graph; empty read; 8 distinct preds beside padded slots; sources "
          "past rank 0; a read longer than its graph; no sink): K3==plain")
    for l_max, B in PK_WIDE_SHAPES:
        t0 = time.perf_counter()
        arrs = random_graph_case(PK_NCAP_MAX, l_max, B, seed=l_max + B)[3]
        err = k3_parity(pk_layout(*arrs, l_max), dev, f"N={PK_NCAP_MAX} "
                        f"l_max={l_max}")
        max_err["K3"] = max(max_err["K3"], err)
        phase("pk-parity", t0, f"K3 random graphs N={PK_NCAP_MAX} "
              f"l_max={l_max} B={B} (nodes {int(arrs[3].min())}-"
              f"{int(arrs[3].max())}): K3==plain")
    return max_err, keep["bench256"], keep["heavy32x400"], serial_walks, \
        every


def check_glue(dev, caps, bench_cap, heavy_cap):
    """Phase pk-glue: K6 (prep mode with the ovf update, and order mode)
    and K7 against their plain versions, and K6 against the operands the
    build recorded, on every captured round (`caps`, pk-parity's), then on
    glue_edge_case's windows at ncap 129, 1025 and 3073 (cyclic states
    included): exact.  Then each timed, the kernels' calls queued ahead of
    the device, the plain versions as they run, on the bench round-12 and
    heavy round-200 captures, beside their bounds (tools/bounds.py).
    Returns ({kernel: max error}, {name: (ms, plain ms)}, {name: bound},
    {name: Kahn steps a window, mean and max}, {name: K6's us a Kahn step
    or K7's ns a rank})."""
    from svscope_tpu_torch.ops import poa_fused as tpf
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    from svscope_tpu_torch.tools.bounds import consensus_bound, prep_bound
    from svscope_tpu_torch.tools.timing import time_call
    max_err = {k: 0 for k in PK_GLUE}

    def check(errs, what):
        if any(errs.values()):
            raise RuntimeError(f"K6/K7 != plain on {what}: {errs}")
        for k in max_err:
            max_err[k] = max(max_err[k], errs[k])
    t0 = time.perf_counter()
    for what, (ops, st, _an, _asx, _ke) in caps.items():
        errs, n_cyc = glue_compare(st, ops[3][:, 1:].contiguous(), ops[4],
                                   build_ops=ops)
        check(errs, what)
        phase("pk-glue", t0, f"{what} B={st.nn.shape[0]} ncap="
              f"{st.ch.shape[1]}: K6 (prep, order) == plain == the build's "
              f"operands, K7 == plain (errors {errs}); cyclic windows "
              f"{n_cyc}")
    for ncap in GLUE_NCAPS:
        t0 = time.perf_counter()
        st, seq, slen = glue_edge_tensors(ncap, dev)
        errs, n_cyc = glue_compare(st, seq, slen)
        check(errs, f"edge states ncap={ncap}")
        if n_cyc != len(GLUE_CYCLIC):
            raise RuntimeError(f"edge states ncap={ncap}: {n_cyc} cyclic "
                               f"windows, expected {len(GLUE_CYCLIC)}")
        phase("pk-glue", t0, f"edge states B={st.nn.shape[0]} ncap={ncap} "
              f"({'; '.join(GLUE_EDGE_CASES)}): K6 == plain, K7 == plain "
              f"(errors {errs}); cyclic windows {n_cyc}")
    t0 = time.perf_counter()
    times, bounds, steps, ranks = {}, {}, {}, {}
    for sfx, cap, reps in (("", bench_cap, 2), (" heavy", heavy_cap, 1)):
        ops, st = cap[0], cap[1]
        seq, slen = ops[3][:, 1:].contiguous(), ops[4]
        l_max = seq.shape[1]
        order = tpf.toposort_reference(st.pn, st.gm, st.nn)[0]
        times["K6" + sfx] = (
            time_call(lambda: tpk.round_prep_cuda(st, seq, slen), dev, 20,
                      True),
            time_call(lambda: tpf.pk_round_prep_reference(st, seq, slen),
                      dev, reps, False))
        times["K6 order" + sfx] = (
            time_call(lambda: tpk.toposort_cuda(st.pn, st.gm, st.nn), dev,
                      20, True),
            time_call(lambda: tpf.toposort_reference(st.pn, st.gm, st.nn),
                      dev, reps, False))
        times["K7" + sfx] = (
            time_call(lambda: tpk.consensus_cuda(st.pn, st.pw, st.pt, st.nn,
                                                 order), dev, 20, True),
            time_call(lambda: tpf.consensus_walk_reference(
                st.ch, st.pn, st.pw, st.pt, st.nn, order), dev, 1, False))
        bounds["K6" + sfx], k = prep_bound(st.pn, st.gm, st.nn, l_max)
        bounds["K6 order" + sfx] = prep_bound(st.pn, st.gm, st.nn, l_max,
                                              order_only=True)[0]
        bounds["K7" + sfx] = consensus_bound(st.pn, st.nn, st.ch.shape[1])
        steps["K6" + sfx] = (float(k.mean()), int(k.max()))
        ranks["K7" + sfx] = int(st.nn.max())
    # a step's and a rank's cost: the kernel's time over the batch's
    # longest window (its Kahn steps; its node count, K7's score pass)
    per = {}
    for sfx in ("", " heavy"):
        for k in ("K6", "K6 order"):
            per[k + sfx] = 1e3 * times[k + sfx][0] / steps["K6" + sfx][1]
        per["K7" + sfx] = 1e6 * times["K7" + sfx][0] / ranks["K7" + sfx]
    phase("pk-glue-time", t0, "bench round 12 (B=128, ncap 1025) and heavy "
          "round 200 (B=32, ncap 3073) captures; kernel calls queued ahead "
          "of the device: " + ", ".join(
              f"{k} kernel {a:.4f} ms plain {b:.4f} ms bound "
              f"{bounds[k][0]:.6f} ms ({bounds[k][1]})" for k, (a, b) in
              times.items()) + "; Kahn steps a window (mean, max) "
          + ", ".join(f"{k} {v[0]:.1f}, {v[1]}" for k, v in steps.items())
          + "; us a Kahn step (the batch's most) " + ", ".join(
              f"{k} {v:.4f}" for k, v in per.items() if "K6" in k)
          + "; K7 ns a rank (the batch's largest nn: bench "
          f"{ranks['K7']}, heavy {ranks['K7 heavy']}) " + ", ".join(
              f"{k} {v:.2f}" for k, v in per.items() if "K7" in k))
    return max_err, times, bounds, steps, per


def k3_args(cap):
    """K3's operands of one captured round (pk_round_prep's ops but gminr)."""
    return cap[0][:6]


def k3_shape(cap):
    """B, N and l_max of one captured round."""
    charsr, _sinksr, _predsp, seqv, _lb, _nn_eff = k3_args(cap)
    return {"B": charsr.shape[0], "N": charsr.shape[1],
            "l_max": seqv.shape[1] - 1}


def k3_bound(cap):
    """K3's bound on one captured round: its inputs read once, an/asx/ke
    written once; integer ops of the DP over each window's own ranks and
    read."""
    _charsr, _sinksr, predsp, _seqv, lb, nn_eff = args = k3_args(cap)
    return bound(tensor_bytes(*args, *cap[2:]),
                 poa_ops(predsp, nn_eff, lb, slot0_copies=True))


def fusion_args(cap):
    """K4's and K5's operands of one captured round, the state last:
    (an, asx, ke, gminr, seq5, state)."""
    ops, st, an, asx, ke = cap
    return an, asx, ke, ops[6], ops[3][:, 1:].contiguous(), st


def single_call_ms(setup, fn, dev, reps, hold):
    """Mean ms of fn(*setup()) over `reps` calls, each timed alone by CUDA
    events right after setup() made its fresh inputs (still in L2): with
    `hold` the call is queued behind torch.cuda._sleep (device time
    alone), else the events bracket the host's issue of it too (the
    earlier single-call timing)."""
    import torch
    from svscope_tpu_torch.tools.timing import HOLD_CYCLES, HOLD_TRIES
    fn(*setup())
    total = 0.0
    cycles = HOLD_CYCLES
    for _ in range(reps):
        for _try in range(HOLD_TRIES):
            args = setup()
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if hold:
                torch.cuda._sleep(cycles)
            start.record()
            fn(*args)
            end.record()
            ahead = not start.query()
            torch.cuda.synchronize(dev)
            if ahead or not hold:
                break
            cycles *= 4                       # hold longer, call again
        else:
            raise RuntimeError("the host did not issue one call within a "
                               f"{cycles // 4}-cycle hold")
        total += start.elapsed_time(end)
    return total / reps


def time_pk_kernels(bench_cap, heavy_cap, dev):
    """Phase 7: each pk kernel and its plain version on the bench batch the
    port launches (128 windows, round 12) and at the heavy capture (32
    windows, round 200): kernel calls queued ahead of the device
    (tools/timing.py), plain versions as they run.  K4 and K5 also one call
    at a time right after a fresh state clone, queued and with the host's
    issue (single_call_ms).  Returns ({name: (kernel ms, plain ms)},
    {name: bound}, {name: (single queued ms, single issued ms)})."""
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    from svscope_tpu_torch.tools.timing import time_call, time_each
    t0 = time.perf_counter()
    times, bounds, singles, entries = {}, {}, {}, {}
    for sfx, cap, k3_plain, fuse_plain in (("", bench_cap, 2, (2, 1)),
                                           (" heavy", heavy_cap, 1, (1, 1))):
        args = k3_args(cap)
        times["K3" + sfx] = (
            time_call(lambda: tpk.align_tb_cuda(*args), dev, 20, True),
            time_call(lambda: tpk.align_tb_reference(*args), dev, k3_plain,
                      False))
        bounds["K3" + sfx] = k3_bound(cap)
        *fargs, st = fusion_args(cap)
        fb, entries[sfx] = fusion_bound(*fusion_args(cap))
        for k, order, reps in (("K4", "lockstep", fuse_plain[0]),
                               ("K5", "seq", fuse_plain[1])):
            def setup(order=order):
                return (*fargs, st.clone(), order)
            times[k + sfx] = (
                time_each(setup, tpk.fusion_cuda, dev, 20, True),
                time_each(setup, tpk.fusion_reference, dev, reps, False))
            singles[k + sfx] = tuple(
                single_call_ms(setup, tpk.fusion_cuda, dev, 20, hold)
                for hold in (True, False))
            bounds[k + sfx] = fb
    shapes = []
    for sfx, cap, r in (("", bench_cap, PK_BENCH_ROUNDS[1]),
                        (" heavy", heavy_cap, PK_HEAVY_ROUND)):
        s = k3_shape(cap)
        _c, _s, _p, _q, lb, nn_eff = k3_args(cap)
        shapes.append(f"{'bench' if not sfx else 'heavy'} B={s['B']} "
                      f"N={s['N']} l_max={s['l_max']} round {r + 1} "
                      f"({int((nn_eff.long() * lb.long()).sum())} DP cells, "
                      f"{entries[sfx]} alignment entries)")
    phase("pk-time", t0, "; ".join(shapes) + "; kernel calls queued ahead "
          "of the device: " + ", ".join(
              f"{k} kernel {a:.4f} ms plain {b:.4f} ms bound "
              f"{bounds[k][0]:.4f} ms ({bounds[k][1]})" for k, (a, b) in
              times.items()) + "; one call after a fresh state clone, "
          "queued / issued: " + ", ".join(
              f"{k} {a:.4f} / {b:.4f} ms" for k, (a, b) in singles.items()))
    return times, bounds, singles


def run_fused_workload(name, golden, dev, runs, device_recs=None,
                       need=PK_MAIN):
    """Phases 8/9: the workload with device_poa="fused"; each kernel of
    `need` must have launched in the run, the others not at all, and no
    build may have checked the host (COUNTS["host_syncs"] 0)."""
    import torch
    import localgraph_golden as lgg
    from svscope_tpu_torch.engine.localgraph import (process_window_batch,
                                                     record_line)
    from svscope_tpu_torch.ops import poa_fused as tpf
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    want = golden["workloads"][name]["records"]
    wins = lgg.make_workload(name)

    def run():
        tpk.reset_launches()
        tpf.reset_counts()
        t = time.perf_counter()
        recs = process_window_batch(wins, device=dev, device_poa="fused")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        same = sum(lgg.sha256(record_line(r)) == h
                   for r, h in zip(recs, want))
        if same != len(want) or len(recs) != len(wins):
            raise RuntimeError(f"{name} fused: golden {same}/{len(want)}")
        if tpf.COUNTS["fallbacks"]:
            raise RuntimeError(f"{name} fused: {tpf.COUNTS['fallbacks']} "
                               "windows fell back to the host engine")
        if tpf.COUNTS["host_syncs"]:
            raise RuntimeError(f"{name} fused: {tpf.COUNTS['host_syncs']} "
                               "host syncs inside the builds")
        return recs, dt, dict(tpk.LAUNCHES), dict(tpf.COUNTS)

    t0 = time.perf_counter()
    recs, cold, launches, counts = run()
    if device_recs is not None and recs != device_recs:
        raise RuntimeError(f"{name} fused: records differ from device POA")
    if any((launches[k] > 0) != (k in need) for k in launches):
        raise RuntimeError(f"{name} fused: main path launches {launches}, "
                           f"expected {need} only")
    phase(name + "-fused", t0, f"golden {len(want)}/{len(want)}, launches "
          f"{launches} ({pk_per_round(launches, counts)} a round), counts "
          f"{counts}, host syncs 0, host fallbacks 0, run {cold:.3f} s "
          f"({len(wins) / cold:.3f} w/s)")
    secs = [cold]
    if runs > 1:
        t0 = time.perf_counter()
        secs = []
        for _ in range(runs):
            again, dt, _l, _c = run()
            if again != recs:
                raise RuntimeError(f"{name} fused: run not repeatable")
            secs.append(dt)
        phase(name + "-fused-rate", t0, f"fused POA "
              f"{len(wins) / min(secs):.3f} w/s (runs "
              f"{[round(x, 4) for x in secs]})")
    return launches, recs, len(wins) / min(secs)


def pk_per_round(launches, counts):
    """The pk kernels' launches a build round, as text."""
    n = sum(launches.get(k, 0) for k in ("K3", "K4", "K5", *PK_GLUE))
    return f"{n / counts['rounds']:.3f}" if counts.get("rounds") else "-"


@contextlib.contextmanager
def plain_glue():
    """The fused build with K6's and K7's plain versions on the card in
    place of the kernels (the build before them), for comparisons made
    within one call."""
    import torch
    from svscope_tpu_torch.ops import poa_fused as tpf
    saved = (tpf.round_prep_cuda, tpf.toposort_cuda, tpf.consensus_cuda)

    def prep(st, seq, slen, update_ovf=False):
        ops, cyc = tpf.pk_round_prep_reference(st, seq, slen)
        if update_ovf:
            st.ovf |= cyc.to(torch.int32)
        return ops, cyc
    tpf.round_prep_cuda = prep
    tpf.toposort_cuda = tpf.toposort_reference
    tpf.consensus_cuda = lambda pn, pw, pt, nn, order: \
        tpf.consensus_walk_reference(None, pn, pw, pt, nn, order)
    try:
        yield
    finally:
        tpf.round_prep_cuda, tpf.toposort_cuda, tpf.consensus_cuda = saved


def fused_phase_split(dev):
    """Phase 8: seconds per phase of the fused build of one stage-A batch
    (the device is synchronised at each phase boundary), with K6 and K7
    and then, in the same call, with their plain versions (the build
    before them); each build's device launches and copies
    (torch.profiler, a run of its own) and host syncs; the launches of
    one whole bench256 fused run (process_window_batch); and the heavy
    tier's build split the same way, with the kernels.  Returns
    {mode: {"timing", "counts", "launches", "copies"}}, "bench256" and
    "heavy32x400"."""
    import torch
    import localgraph_golden as lgg
    from svscope_tpu_torch.engine.localgraph import process_window_batch
    from svscope_tpu_torch.ops import poa_fused as tpf
    t0 = time.perf_counter()
    wins = lgg.make_workload("bench256")
    jobs = [w.sequences for w in wins[:PK_BATCH]]
    out = {}
    for mode in ("kernels", "plain glue"):
        with plain_glue() if mode == "plain glue" else contextlib.nullcontext():
            timing = {}
            tpf.reset_counts()
            tpf.fused_msa_batch(jobs, device=dev, timing=timing)
            torch.cuda.synchronize()
            counts = dict(tpf.COUNTS)
            n, copies = launches_profiled(
                lambda: tpf.fused_msa_batch(jobs, device=dev))
        out[mode] = {"timing": timing, "counts": counts, "launches": n,
                     "copies": copies}
        phase("bench256-fused-split", t0, f"{mode}: stage-A batch of "
              f"{len(jobs)}: " + ", ".join(f"{k} {v:.4f} s" for k, v in
                                          timing.items())
              + f"; counts {counts}; device launches {n}, copies {copies} "
              "(torch.profiler, a run of its own)")
    whole, copies = launches_profiled(lambda: process_window_batch(
        wins, device=dev, device_poa="fused"))
    out["bench256"] = {"launches": whole, "copies": copies}
    phase("bench256-fused-launches", t0, f"process_window_batch(bench256, "
          f"fused): device launches {whole}, copies {copies} "
          "(torch.profiler)")
    # the heavy tier's 32 windows, one build of 400 rounds, with the kernels
    # (its plain glue would take minutes)
    jobs = [w.sequences for w in lgg.make_workload("heavy32x400")]
    timing = {}
    tpf.reset_counts()
    tpf.fused_msa_batch(jobs, device=dev, timing=timing)
    torch.cuda.synchronize()
    out["heavy32x400"] = {"timing": timing, "counts": dict(tpf.COUNTS)}
    phase("heavy32x400-fused-split", t0, f"kernels: {len(jobs)} windows: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in timing.items())
          + f"; counts {out['heavy32x400']['counts']}")
    return out


def k2_pair(pairs, bucket, dev, scoring):
    """(kernel, plain) stats (3, n) of `pairs` padded to `bucket`."""
    import torch
    from svscope_tpu_torch.ops import nw_kernel
    args = [torch.from_numpy(x).to(dev) for x in pad_pairs(pairs, bucket)]
    k = torch.stack(nw_kernel.nw_stats_cuda(*args, bucket, *scoring)).cpu()
    torch.cuda.synchronize()
    p = torch.stack(nw_kernel.nw_stats_reference(*args, bucket, *scoring))
    return k, p.cpu()


def check_k2(dev):
    """Phase 11: K2 == plain at every bucket and score set, == host DP on a
    subsample, == the JAX golden; then misscore4096: kernel == plain per
    bucket, and misscore_batch (the MisScore entry point) on the card,
    whose K2 launches its phase line prints.  Returns the max error and
    misscore4096's pairs grouped by bucket."""
    import numpy as np
    import torch
    import alnfeature_golden as ag
    import torch_workloads as tw
    from svscope_tpu_torch.ops.nw import nw_align_stats
    from svscope_tpu_torch.ops.nw_batch import bucket_of, misscore_batch
    gold = ag.load_golden()["nw"]["buckets"]
    max_err = 0
    for bucket, n in K2_PARITY.items():
        t0 = time.perf_counter()
        pairs = tw.bucket_pairs(np.random.default_rng(1000 + bucket), bucket,
                                n)
        gpairs, sha = ag.nw_case(bucket)
        if sha != gold[str(bucket)]["pairs_sha256"]:
            raise RuntimeError(f"k2 bucket {bucket}: golden pairs differ "
                               "(numpy drew other inputs)")
        n_host = len(pairs) if bucket <= 512 else K2_HOST_LARGE
        edges = k2_edge_pairs(bucket, 2000 + bucket)
        for name, sc in ag.SCORINGS.items():
            k, p = k2_pair(pairs, bucket, dev, sc)
            err = int((k - p).abs().max())
            max_err = max(max_err, err)
            if err:
                raise RuntimeError(f"K2 != plain at bucket {bucket} {sc}")
            host = torch.tensor([nw_align_stats(a, b, *sc)
                                 for a, b in pairs[:n_host]],
                                dtype=torch.int32).T
            if not torch.equal(k[:, :n_host], host):
                raise RuntimeError(f"K2 != host DP at bucket {bucket} {sc}")
            kg, _ = k2_pair(gpairs, bucket, dev, sc)
            if kg.T.tolist() != gold[str(bucket)][name]:
                raise RuntimeError(f"K2 != JAX golden at bucket {bucket} "
                                   f"{sc}")
            ke, pe = k2_pair(edges, bucket, dev, sc)
            err = int((ke - pe).abs().max())
            max_err = max(max_err, err)
            host = torch.tensor([nw_align_stats(a, b, *sc)
                                 for a, b in edges], dtype=torch.int32).T
            if err or not torch.equal(ke, host):
                raise RuntimeError(f"K2 != plain or host DP on the band-edge "
                                   f"pairs at bucket {bucket} {sc}")
        lens = [max(len(a), len(b)) for a, b in pairs]
        phase("k2-parity", t0, f"bucket {bucket}: {len(pairs)} pairs "
              f"(longer side {min(lens)}-{max(lens)} bp), score sets "
              f"{list(ag.SCORINGS.values())}: kernel==plain, ==host DP on "
              f"{n_host}, ==JAX golden on {len(gpairs)}; {len(edges)} "
              f"band-edge pairs (a of {sorted({len(a) for a, _ in edges})} "
              "bp): kernel==plain==host DP")
    t0 = time.perf_counter()
    pairs = tw.misscore4096_pairs()
    groups = {}
    for i, (a, b) in enumerate(pairs):
        groups.setdefault(bucket_of(max(len(a), len(b))), []).append(i)
    want = np.zeros(len(pairs), np.int64)
    for bucket, idxs in sorted(groups.items()):
        k, p = k2_pair([pairs[i] for i in idxs], bucket, dev,
                       ag.SCORINGS["misscore"])
        err = int((k - p).abs().max())
        max_err = max(max_err, err)
        if err:
            raise RuntimeError(f"K2 != plain on misscore4096 bucket {bucket}")
        want[idxs] = (p[2] - p[1]).numpy()
    tm = time.perf_counter()
    got, launches = k2_main_path("misscore4096", lambda: misscore_batch(
        pairs, device=dev))
    tm = time.perf_counter() - tm
    if not np.array_equal(got, want):
        raise RuntimeError("misscore_batch on misscore4096 != plain K2")
    phase("k2-misscore4096", t0, f"{len(pairs)} pairs, per bucket "
          f"{ {b: len(v) for b, v in sorted(groups.items())} }: "
          f"kernel==plain; misscore_batch on the card {tm:.3f} s, K2 "
          f"launches {launches}, host-DP pairs 0, == plain MisScores")
    return max_err, pairs, groups


def time_k2(pairs, groups, dev):
    """Phase 12: K2 (calls queued ahead of the device; and issued back to
    back, the earlier timing) and its plain version per bucket of
    misscore4096.
    Returns (kernel ms, plain ms, bound) summed over the bucket launches,
    and the per-bucket rows."""
    import torch
    from svscope_tpu_torch.ops import nw_kernel
    t0 = time.perf_counter()
    rows, k_tot, i_tot, p_tot, cells_all, launches = [], 0.0, 0.0, 0.0, 0, []
    per_bucket = {}
    for bucket, idxs in sorted(groups.items()):
        sub = [pairs[i] for i in idxs]
        args = [torch.from_numpy(x).to(dev) for x in pad_pairs(sub, bucket)]
        cells = sum(len(a) * len(b) for a, b in sub)
        k_ms = cuda_ms(lambda: nw_kernel.nw_stats_cuda(*args, bucket), 5,
                       True)
        i_ms = cuda_ms(lambda: nw_kernel.nw_stats_cuda(*args, bucket), 5,
                       False)
        p_ms = cuda_ms(lambda: nw_kernel.nw_stats_reference(*args, bucket), 1,
                       False)
        k_tot += k_ms
        i_tot += i_ms
        p_tot += p_ms
        cells_all += cells
        launches.append((args, sub))
        b_ms, b_by = k2_bound(args, sub)
        per_bucket[bucket] = {"pairs": len(sub), "ms": k_ms,
                              "ms_issued": i_ms, "plain_ms": p_ms,
                              "bound_ms": b_ms, "gcups": cells / k_ms / 1e6}
        rows.append(f"{bucket}: {len(sub)} pairs kernel {k_ms:.4f} ms "
                    f"({cells / k_ms / 1e6:.3f} GCUPS; issued back to back "
                    f"{i_ms:.4f}) plain {p_ms:.4f} ms bound {b_ms:.4f} ms "
                    f"({b_by})")
    all_bound = k2_bound_all(launches)
    phase("k2-time", t0, "misscore4096 per bucket (kernel calls queued ahead "
          "of the device): " + "; ".join(rows)
          + f"; all buckets kernel {k_tot:.4f} ms (issued back to back: "
          f"{i_tot:.4f}) plain {p_tot:.4f} ms bound "
          f"{all_bound[0]:.4f} ms ({all_bound[1]}), "
          f"{cells_all / k_tot / 1e6:.3f} GCUPS")
    return k_tot, p_tot, all_bound, per_bucket


def k2_main_path(name, fn):
    """Run fn() with the launch counts and the host-DP count set to 0 just
    before (path_launches); returns (fn's result, K2 launches).  Fails
    unless K2 launched and no pair went to the host DP."""
    out, launches = path_launches(name, fn, ("K2",))
    return out, launches["K2"]


def check_misscore_pipe(records, dev):
    """Phase 13: misscore_pipe on the card (K2) == on the host (DP) over a
    Raw.bed of the port's own records; then K2's time per launch at each of
    its buckets.  Returns K2's launches and {bucket: time and bound}."""
    import torch
    import localgraph_golden as lgg
    from svscope_tpu_torch.engine.features import misscore_pipe
    from svscope_tpu_torch.ops import nw_kernel
    from svscope_tpu_torch.ops.nw_batch import bucket_of
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        bed = os.path.join(d, "Raw.bed")
        with open(bed, "w") as f:
            f.write("".join(lgg.record_line(r) + "\n" for r in records))
        th = time.perf_counter()
        host = misscore_pipe(bed, device="cpu")
        th = time.perf_counter() - th
        td = time.perf_counter()
        got, launches = k2_main_path("misscore-pipe",
                                     lambda: misscore_pipe(bed, device=dev))
        td = time.perf_counter() - td
    if not got.equals(host):
        raise RuntimeError("misscore-pipe: card MisScore != host DP")
    groups = {}
    for r in records:
        if r[9] == "NormalOutput|EMOutput":
            for a in str(r[3]).split(";"):
                for b in str(r[6]).split(";"):
                    k = bucket_of(max(len(a), len(b)))
                    groups.setdefault(k, []).append((a, b))
    # K2's time per launch at the main path's own buckets
    launch = {}
    for k, pairs in sorted(groups.items()):
        args = [torch.from_numpy(x).to(dev) for x in pad_pairs(pairs, k)]
        k_ms = cuda_ms(lambda: nw_kernel.nw_stats_cuda(*args, k), 20, True)
        b_ms, b_by = k2_bound(args, pairs)
        launch[k] = {"pairs": len(pairs), "ms": k_ms, "bound_ms": b_ms,
                     "bound_by": b_by}
    phase("misscore-pipe", t0, f"{len(records)} records, {len(got)} "
          f"EMOutput rows, pairs per bucket "
          f"{ {k: len(v) for k, v in sorted(groups.items())} }: MisScore "
          f"card == host DP, K2 launches {launches}, host-DP pairs 0; card "
          f"{td:.3f} s, host DP {th:.3f} s; K2 per launch (calls queued "
          "ahead) " + ", ".join(
              f"bucket {k}: {v['ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
              f"({v['bound_by']})" for k, v in launch.items()))
    return launches, launch


def check_aln_cli(dev):
    """Phases 14 and 15: AlnFeature + adjustVCF, and callsomaticSV, on the
    card against the JAX golden.  Returns K2's launches."""
    import alnfeature_golden as ag
    g = ag.load_golden()["synth_pair"]
    total = 0
    t0 = time.perf_counter()
    out, launches = k2_main_path("cli-alnfeature", lambda: ag.port_aln_outputs(
        g["raw_bed"], dev.type))
    bad = [k for k, v in g["outputs"].items() if out.get(k) != v]
    if bad:
        raise RuntimeError(f"cli-alnfeature: {bad} differ from the golden")
    total += launches
    phase("cli-alnfeature", t0, f"{sorted(out)} == golden, K2 launches "
          f"{launches}")
    t0 = time.perf_counter()
    out, launches = k2_main_path("cli-callsomaticsv",
                                 lambda: ag.port_call_somatic_outputs(
                                     dev.type))
    want = dict(g["outputs"], **{ag.RAW_BED: g["raw_bed"]})
    bad = [k for k in out if out[k] != want[k]]
    if bad:
        raise RuntimeError(f"cli-callsomaticsv: {bad} differ from the golden")
    total += launches
    phase("cli-callsomaticsv", t0, f"{sorted(out)} == golden, K2 launches "
          f"{launches}")
    return total


def path_launches(name, fn, need):
    """Run fn() with the launch counts of K1, K2, K3-K7 and the host-DP,
    fused-fallback and fused-build counts set to 0 just before; returns
    (fn's result, {kernel: launches}).  Fails unless every kernel of
    `need` launched, and if a pair went to the host DP, a window fell back
    to the host POA engine or a fused build checked the host."""
    import torch
    from svscope_tpu_torch.ops import nw_batch, nw_kernel, poa_align
    from svscope_tpu_torch.ops import poa_fused as tpf
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    from svscope_tpu_torch.tools.genome_bench import launch_counts
    poa_align.reset_launches()
    nw_kernel.reset_launches()
    tpk.reset_launches()
    nw_batch.reset_counts()
    tpf.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = launch_counts()
    missing = [k for k in need if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"{name}: the main path launched no {missing} "
                           f"(launches {launches})")
    if nw_batch.COUNTS["host_dp_pairs"] or tpf.COUNTS["fallbacks"] \
            or tpf.COUNTS["host_syncs"]:
        raise RuntimeError(f"{name}: host DP pairs "
                           f"{nw_batch.COUNTS['host_dp_pairs']}, fused "
                           f"fallbacks {tpf.COUNTS['fallbacks']}, host syncs "
                           f"inside fused builds {tpf.COUNTS['host_syncs']}")
    if tpf.COUNTS["rounds"]:
        print(f"  [{name}] fused builds: {tpf.COUNTS['rounds']} rounds, "
              f"{pk_per_round(launches, tpf.COUNTS)} pk launches a round, "
              "host syncs 0", flush=True)
    return out, launches


def check_dataprepare(dev):
    """Phases dataprepare, dataprepare-fused and npz-replay: the synth
    pair's `DataPrepare --selectwindows --FullProcess --device cuda` then
    `adjustVCF` (default device POA: K1, and K2 for MisScore; then with
    `--device-poa fused`: K3 and K4), and `--saveData` then
    `localGraph_npz --device cuda` (K1), against the JAX golden
    (tests/data/jax_dataprepare_golden.json).  Returns the launches of
    each run."""
    import dataprepare_golden as dg
    g = dg.load_golden()
    want = g["synth_pair"]["outputs"]
    runs = {}
    for name, extra, need in (("dataprepare", (), ("K1", "K2")),
                              ("dataprepare-fused", ("--device-poa", "fused"),
                               (*PK_MAIN, "K2"))):
        t0 = time.perf_counter()
        out, launches = path_launches(
            name, lambda: dg.port_dataprepare(dev.type, extra), need)
        bad = sorted(k for k in set(out) | set(want)
                     if out.get(k) != want.get(k))
        if bad:
            raise RuntimeError(f"{name}: {bad} differ from the golden")
        runs[name] = launches
        phase(name, t0, f"{len(out)} files == golden (CandidateSpan beds, "
              f"InterALNSVs.vcf, Raw.bed, VCFs, adjusted VCF); launches "
              f"{launches}")
    t0 = time.perf_counter()
    raw, launches = path_launches("npz-replay",
                                  lambda: dg.port_npz_replay(dev.type),
                                  ("K1",))
    if raw != g["npz_replay"]["raw_bed"] or raw != want[dg.RAW_BED]:
        raise RuntimeError("npz-replay: Raw.bed differs from the golden")
    runs["npz-replay"] = launches
    phase("npz-replay", t0, f"Raw.bed == golden == the direct run; "
          f"launches {launches}")
    return runs


def check_viz_and_em(dev):
    """Phases viz-inputs and em-cluster: the figure inputs of the synth
    pair's somatic window on the card (K and labels equal the golden, BICs
    within float32's 1e-5 but for runs that restarted on one side only,
    dataprepare_golden.bics_match), and the per-K em_cluster on the card
    with its own generator on the golden's windows in which no re-init
    fires (K and labels equal JAX's)."""
    import numpy as np
    import dataprepare_golden as dg
    from svscope_tpu_torch.models.mixture import em_cluster
    g = dg.load_golden()
    t0 = time.perf_counter()
    got = dg.port_figure_inputs(dev.type)
    want = {k: v for k, v in g["viz"].items()
            if k not in ("record", "reinit_runs")}
    bad = [k for k in want if k != "bics" and got[k] != want[k]]
    if bad:
        raise RuntimeError(f"viz-inputs: {bad} differ from the golden")
    flips = dg.bics_match(want["bics"], got["bics"], want["K"], 1e-5)
    phase("viz-inputs", t0, f"MSA {got['enc_shape']}, {len(got['sel'])} "
          f"selected columns, K={got['K']} and labels == golden, BICs "
          f"within 1e-5 ({flips} runs restarted on one side only)")
    t0 = time.perf_counter()
    n = 0
    for i, e in enumerate(g["em_cluster"]["windows"]):
        if any(e["reinit_runs"]):
            continue
        K, _x, labels, *_rest = em_cluster(dg.decode_window(e["x"]),
                                           device=dev)
        if K != e["K"] or list(np.asarray(labels)) != e["labels"]:
            raise RuntimeError(f"em-cluster: window {i} K {K} labels "
                               f"{list(labels)} != golden {e['K']} "
                               f"{e['labels']}")
        n += 1
    if n == 0:
        raise RuntimeError("em-cluster: no golden window without re-init")
    phase("em-cluster", t0, f"{n} windows without re-init: K and labels == "
          f"golden (float32, the port's own generator)")


def run_chrom_bench(dev):
    """Phase chrom-bench: svscope_tpu_torch.tools.chrom_bench at 2.1 Mb and
    80 planted SVs (plus 8 LargeDELs) on the card with the default device
    POA: every output file's hash equals the JAX run's, recall 80/80, K1
    and K2 launched.  Returns its result and launches."""
    import dataprepare_golden as dg
    from svscope_tpu_torch.tools import chrom_bench
    g = dg.load_golden()["chrom"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        res, launches = path_launches("chrom-bench", lambda: chrom_bench.run(
            g["mb"], g["n_sv"], device=dev, savedir=d,
            log=lambda line: print("  " + line, flush=True)), ("K1", "K2"))
    bad = sorted(k for k in set(res["hashes"]) | set(g["hashes"])
                 if res["hashes"].get(k) != g["hashes"].get(k))
    if bad:
        raise RuntimeError(f"chrom-bench: {bad} differ from the JAX run")
    if res["recall"] != g["recall"] or res["recall"] != [g["n_sv"]] * 2:
        raise RuntimeError(f"chrom-bench: recall {res['recall']}")
    phase("chrom-bench", t0, f"{g['mb']} Mb, {res['windows']} candidate "
          f"windows, {res['somatic_rows']} EMOutput rows, LargeDEL "
          f"{res['large_del']}, recall {res['recall'][0]}/"
          f"{res['recall'][1]}, {len(res['hashes'])} files == JAX; "
          "stage walls " + ", ".join(f"{k} {v:.3f} s"
                                     for k, v in res["stages"].items())
          + f"; launches {launches}")
    return res, launches


def k1_int16_outputs(args, L):
    """(K1-int16, plain int16, K1 int32) outputs on one batch, int64 on the
    host; these launches compare, they are not K1-int16's main path."""
    import torch
    from svscope_tpu_torch.ops import poa_align, poa_device
    k16 = poa_align.align_batch_cuda(*args, L, int16_mode=True)
    k32 = poa_align.align_batch_cuda(*args, L)
    torch.cuda.synchronize()
    p16 = poa_device.align_batch_reference(*args, L, int16_mode=True)
    return [[t.cpu().long() for t in out] for out in (k16, p16, k32)]


def divergent_case(B=16):
    """A divergent 500 bp read against a 500-node chain (N = L = 512): the
    most negative scores the int16 gate leaves room for."""
    import numpy as np
    from svscope_tpu_torch.native.poa import NativePoaGraph
    rng = np.random.default_rng(29)
    acgt = np.array(list("ACGT"))
    ref = "".join(rng.choice(acgt, 500))
    read = "".join(rng.choice(acgt, 500))
    g = NativePoaGraph()
    g.add_sequence(ref)
    p = g.pack(512, 8)
    seqs = np.zeros((B, 512), np.uint8)
    seqs[:, :len(read)] = np.frombuffer(read.encode(), np.uint8)
    arrs = (np.stack([p[0]] * B), np.stack([p[1]] * B),
            np.stack([p[2]] * B), np.full(B, p[3], np.int32), seqs,
            np.full(B, len(read), np.int32))
    return [g] * B, [read] * B, [p] * B, arrs


def check_k1_int16(dev):
    """Phases 16 and 17: K1-int16 == plain int16 == K1 int32 == native, and
    the int16 score bounds.  Returns the max error (kernel vs plain)."""
    import numpy as np
    from svscope_tpu_torch.ops import poa_align, poa_device
    from svscope_tpu_torch.ops.poa_device import NEG, NEG16
    max_err = 0

    def compare(name, graphs, reads, packed, arrs, L):
        nonlocal max_err
        args = poa_device.to_torch_packed(*arrs, dev)
        k16, p16, k32 = k1_int16_outputs(args, L)
        err = _max_err(k16, p16)
        max_err = max(max_err, err)
        if err or _max_err(k16, k32):
            raise RuntimeError(f"{name}: K1-int16 != plain int16 or != K1 "
                               f"int32 (kernel vs plain error {err})")
        for i, g in enumerate(graphs):
            aln = poa_device.unpack_alignment(k16[0][i], k16[1][i],
                                              k16[2][i], packed[i][4])
            if aln != g.align_only(reads[i]):
                raise RuntimeError(f"{name}: K1-int16 != native engine, "
                                   f"window {i}")
        return k16
    for N, L, B in SHAPES:
        if N > INT16_MAX or L > INT16_MAX:
            continue
        t0 = time.perf_counter()
        compare(f"N={N} L={L} B={B}",
                *random_graph_case(N, L, B, seed=N + B), L)
        phase("k1-int16-parity", t0, f"N={N} L={L} B={B}: kernel==plain=="
              "K1 int32==native")
    t0 = time.perf_counter()
    k16 = compare("divergent read", *divergent_case(), 512)
    low = int(k16[3].min())
    graphs, reads, packed, arrs = random_graph_case(INT16_MAX, INT16_MAX, 8,
                                                    seed=11)
    compare("ceiling", graphs, reads, packed, arrs, INT16_MAX)
    sinks = arrs[2].copy()
    sinks[0] = False
    args = poa_device.to_torch_packed(arrs[0], arrs[1], sinks, *arrs[3:],
                                      dev)
    k16, p16, k32 = k1_int16_outputs(args, INT16_MAX)
    max_err = max(max_err, _max_err(k16, p16))
    if _max_err(k16, p16) or k16[3][0] != NEG16 or k32[3][0] != NEG:
        raise RuntimeError("no-sink window: K1-int16 score "
                           f"{k16[3][0]} (want {NEG16}) or != plain")
    k32[3][0] = NEG16
    if _max_err(k16, k32):
        raise RuntimeError("no-sink window: K1-int16 != K1 int32")
    big = poa_device.to_torch_packed(
        np.zeros((2, 2048), np.uint8), np.full((2, 2048, 8), -1, np.int32),
        np.zeros((2, 2048), bool), np.full(2, 4, np.int32),
        np.zeros((2, 8), np.uint8), np.full(2, 4, np.int32), dev)
    try:
        poa_align.align_batch(*big, 8, int16_mode=True)
    except ValueError:
        pass
    else:
        raise RuntimeError("K1-int16 took N=2048 (the gate is 1024)")
    phase("k1-int16-bounds", t0, f"divergent 500 bp read vs 500-node chain "
          f"(lowest score {low}), N=L={INT16_MAX} B=8 (max nodes "
          f"{int(arrs[3].max())}): kernel==plain==K1 int32==native; no-sink "
          f"window scores {NEG16}; N=2048 raises ValueError")
    return max_err


def run_attached_bench():
    """Phase 18: the attached_bench tool's main on the card, K1-int16's main
    path: K1 int32, K1-int16 and their plain versions on its per-round
    workload (B=64, N=L=512).  Returns K1-int16's launches in it, its ms,
    the plain int16 ms and K1-int16's bound."""
    import numpy as np
    import torch
    from svscope_tpu_torch.ops import poa_align
    from svscope_tpu_torch.tools import attached_bench as tab
    t0 = time.perf_counter()
    poa_align.reset_launches()
    res = tab.main(["--device", "cuda", "--b", str(ATTACHED_B), "--reps",
                    "32"])
    torch.cuda.synchronize()
    launches = poa_align.LAUNCHES16
    if launches <= 0:
        raise RuntimeError("attached-bench: K1-int16 never launched")
    chars, preds, sinks, nn, seqs, lens, N, L = tab.build_round_workload(
        ATTACHED_B, np.random.default_rng(0))
    B = len(nn)
    # inputs read once; an, asp (B, N + L) and k_end, score (B,) written
    nbytes = sum(a.nbytes for a in (chars, preds, sinks, nn, seqs, lens)) \
        + 4 * B * (2 * (N + L) + 2)
    bnd = bound(nbytes, poa_ops(preds, nn, lens), INT16X2_OPS_PER_S)
    k16, p16 = res["align_batch int16"], res["align_batch_reference int16"]
    cells = float((nn.astype(np.int64) * lens).sum())
    phase("attached-bench", t0, "ms/call " + ", ".join(
        f"{k} {v:.4f}" for k, v in res.items()) + f"; K1-int16 "
        f"{cells / k16 / 1e6:.3f} GCUPS, bound {bnd[0]:.4f} ms ({bnd[1]}); "
        f"H plane {poa_align.plane_bytes(B, N, L, True)} B int16 vs "
        f"{poa_align.plane_bytes(B, N, L)} B int32 (with the direction "
        f"plane); launches K1-int16 {launches}, K1 {poa_align.LAUNCHES}")
    return launches, k16, p16, bnd


def probe_main_path(name, mod, argv):
    """Run a probe tool's main on the card with its launch counts set to 0
    just before; fails unless every variant launched.  Returns (main's
    results, launches per variant)."""
    import torch
    mod.reset_launches()
    res = mod.main(argv)
    torch.cuda.synchronize()
    launches = dict(mod.LAUNCHES)
    if any(n <= 0 for n in launches.values()):
        raise RuntimeError(f"{name}: main path launches {launches}")
    return res, launches


def probe_summary(res, launches, bounds, libraries=None):
    """A probe's `kernels` entry numbers: sums over its variants, and the
    per-variant rows."""
    libraries = libraries or {}
    rows = [{"name": v, "launches": launches[v], "max_abs_err":
             r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": bounds[v][0], "bound_by": bounds[v][1],
             "library_ms": libraries.get(v)} for v, r in res.items()]
    return {"launches": sum(launches.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "variants": rows}


def row_probe_edge_inputs(b, nrows, l1, dev):
    """Row-probe inputs of any shape: chars (b, nrows) and seqs (b, l1)
    int32 in 65..68, seeded by the shape."""
    import numpy as np
    import torch
    rng = np.random.default_rng([b, nrows, l1])
    return (torch.from_numpy(rng.integers(65, 69, (b, nrows), np.int32))
            .to(dev),
            torch.from_numpy(rng.integers(65, 69, (b, l1), np.int32)).to(dev))


def fusebody_windows(ops, st, idx):
    """The fusion-body probe's operands and state for windows `idx` (any
    count, repeats allowed), as new contiguous tensors."""
    import torch
    from svscope_tpu_torch.ops.poa_fused_kernel import GraphState
    i = torch.tensor(idx, device=ops[0].device)
    return ([t.index_select(0, i) for t in ops],
            GraphState(*[t.index_select(0, i) for t in st.tensors()]))


def check_row_probe(dev):
    """Phase 19: every row-probe variant, kernel == plain (B=256); then the
    tool's main on the card."""
    import torch
    from svscope_tpu_torch.tools.probe import row_probe as rp
    t0 = time.perf_counter()
    b = rp.B
    chars, seqs = rp.make_inputs(b, dev)
    errs = {}
    for v in rp.VARIANTS:
        k = rp.row_probe_cuda(chars, seqs, v)
        torch.cuda.synchronize()
        errs[v] = _max_err([k], [rp.row_probe_reference(chars, seqs, v)])
    for shape in ROW_PROBE_EDGES:
        ec, es = row_probe_edge_inputs(*shape, dev)
        for v in rp.VARIANTS:
            k = rp.row_probe_cuda(ec, es, v)
            torch.cuda.synchronize()
            errs[v] = max(errs[v], _max_err(
                [k], [rp.row_probe_reference(ec, es, v)]))
    if any(errs.values()):
        raise RuntimeError(f"row probe kernel != plain: {errs}")
    phase("row-probe-parity", t0, f"B={b}, variants {list(rp.VARIANTS)}, "
          f"and (B, nrows, l1) {list(ROW_PROBE_EDGES)} (tiles, threads "
          f"{[rp.launch_config(e[2]) for e in ROW_PROBE_EDGES]}): "
          f"kernel==plain (errors {errs})")
    t0 = time.perf_counter()
    res, launches = probe_main_path("row-probe", rp, ["--device", "cuda"])
    cells = b * rp.NROWS * rp.L1
    io = tensor_bytes(chars, seqs) + b * rp.L1 * 4
    bounds = {v: bound(io, cells * ROW_PROBE_OPS[v]) for v in res}
    out = probe_summary(res, launches, bounds)
    out["bound"] = bound(io * len(res), cells * sum(ROW_PROBE_OPS[v]
                                                    for v in res))
    phase("row-probe", t0, "us/row " + ", ".join(
        f"{v} {r['ms'] * 1e3 / rp.NROWS:.4f}" for v, r in res.items())
        + f"; launches {launches}")
    return out


def check_fusebody_probe(dev):
    """Phase 20: every fusion-body variant, kernel == plain on the replayed
    round-13 states (nn_out, path, the whole state); then the tool's
    main."""
    import torch
    from svscope_tpu_torch.tools.probe import fusebody_probe as fp
    t0 = time.perf_counter()
    *ops, st0 = fp.device_inputs(fp.build_states(), dev)
    k0 = fp.OUT_LEN - fp.STEPS
    errs, nbytes = {}, {}
    for v in fp.VARIANTS:
        sk, sp = st0.clone(), st0.clone()
        k = [*fp.fusebody_cuda(v, *ops, sk, k0), *sk.tensors()]
        torch.cuda.synchronize()
        p = [*fp.fusebody_reference(v, *ops, sp, k0), *sp.tensors()]
        errs[v] = _max_err(k, p)
        nbytes[v] = fp.variant_bytes(v, st0, sk, k0)
    edges = [(list(range(fp.W)), fp.OUT_LEN - n)
             for n in FUSEBODY_EDGE_ENTRIES]
    edges += [(list(idx), k0) for idx in FUSEBODY_EDGE_WINDOWS]
    for idx, ek0 in edges:
        eops, est = fusebody_windows(ops, st0, idx)
        for v in fp.VARIANTS:
            sk, sp = est.clone(), est.clone()
            k = [*fp.fusebody_cuda(v, *eops, sk, ek0), *sk.tensors()]
            torch.cuda.synchronize()
            p = [*fp.fusebody_reference(v, *eops, sp, ek0), *sp.tensors()]
            errs[v] = max(errs[v], _max_err(k, p))
    if any(errs.values()):
        raise RuntimeError(f"fusion-body probe kernel != plain: {errs}")
    phase("fusebody-probe-parity", t0, f"{fp.W} windows x {fp.STEPS} "
          f"entries, {FUSEBODY_EDGE_ENTRIES} entries, "
          f"{[len(i) for i in FUSEBODY_EDGE_WINDOWS]} windows, variants "
          f"{list(fp.VARIANTS)}: kernel==plain (errors {errs})")
    t0 = time.perf_counter()
    res, launches = probe_main_path("fusebody-probe", fp,
                                    ["--device", "cuda"])
    bounds = {v: bound(nbytes[v], 0) for v in res}
    out = probe_summary(res, launches, bounds)
    out["bound"] = bound(sum(nbytes[v] for v in res), 0)
    phase("fusebody-probe", t0, "us/step " + ", ".join(
        f"{v} {r['ms'] * 1e3 / fp.STEPS:.4f}" for v, r in res.items())
        + f"; launches {launches}")
    return out


def check_int16_probe(dev):
    """Phase 21: every int16 op, kernel == plain on the large arrays; then
    the tool's main (its OK/FAIL lines and timings)."""
    import torch
    from svscope_tpu_torch.tools.probe import int16_probe as ip
    t0 = time.perf_counter()
    rows = INT16_ROWS
    big = ip.large_inputs(rows, dev)
    errs = {}
    for op in ip.ALL_OPS:
        k = ip.int16_op_cuda(op, *big)
        torch.cuda.synchronize()
        errs[op] = _max_err([k], [ip.int16_op_reference(op, *big)])
    if any(errs.values()):
        raise RuntimeError(f"int16 probe kernel != plain: {errs}")
    phase("int16-probe-parity", t0, f"({rows}, {ip.WIDTH}) int16, ops "
          f"{list(ip.ALL_OPS)}: kernel==plain (errors {errs})")
    t0 = time.perf_counter()
    res, launches = probe_main_path("int16-probe", ip,
                                    ["--device", "cuda", "--rows", str(rows)])
    bad = [op for op, r in res.items() if not r["ok"]]
    if bad:
        raise RuntimeError(f"int16 probe: FAIL for {bad}")
    bounds = {op: bound(ip.op_bytes(op, rows), 0) for op in res}
    # library_ms: torch.maximum for max16, torch.roll for roll16; no single
    # PyTorch call computes the other ops (or the sweep as a whole)
    out = probe_summary(res, launches, bounds,
                        {op: r["library_ms"] for op, r in res.items()})
    out["bound"] = bound(sum(ip.op_bytes(op, rows) for op in res), 0)
    phase("int16-probe", t0, "ms " + ", ".join(
        f"{op} {r['ms']:.4f}" for op, r in res.items())
        + f"; all OK; launches {launches}")
    return out


# A/B of the redesigned kernels between source trees (--ab): each tree's
# own wrappers and kernels, in a process of its own, on inputs this script
# saved; only align_batch_cuda, nw_stats_cuda, align_tb_cuda, fusion_cuda,
# GraphState, int16_op_cuda, row_probe_cuda, fusebody_cuda and
# tools.timing.time_call / time_each, which every tree with the kernel
# measurement tools (tools/timing.py) has with these signatures, are used;
# a tree whose align_tb_cuda still takes the chain-row flags gets them as
# its fourth argument (the K3 cases carry them last).  K4, K5 and the
# fusion-body probe update the state in place: every call gets a fresh
# clone, all made before the timing.  The int16 cases carry torch.maximum
# and torch.roll on the same arrays beside them.
def _golden_count(recs, want):
    import localgraph_golden as lgg
    from svscope_tpu_torch.engine.localgraph import record_line
    return sum(lgg.sha256(record_line(r)) == h for r, h in zip(recs, want))


def _timed(fn):
    import torch
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def oversize_window(rng, unit_len=60, length=2500, n_reads=3):
    """One window past the 2048 buckets: a tandem-repeat reference of
    `length` bp and noisy copies of it (substitutions and 1 bp indels)."""
    unit = "".join(rng.choice(list("ACGT"), unit_len))
    ref = (unit * (length // unit_len + 1))[:length]
    out = [ref]
    for _ in range(n_reads):
        b = list(ref)
        for _ in range(length // 60):
            p = int(rng.integers(1, len(b) - 1))
            op = int(rng.integers(0, 3))
            if op == 0:
                b[p] = str(rng.choice(list("ACGT")))
            elif op == 1:
                b.insert(p, str(rng.choice(list("ACGT"))))
            else:
                b.pop(p)
        out.append("".join(b))
    return out


def design_point(rng):
    """The 4k tandem-repeat design point of tests/test_poa_sharded.py:206:
    a C++ graph of a 3,900 bp repeat and two noisy copies (3,900-4,096
    nodes), and a read past 4,096 bp."""
    from svscope_tpu_torch.native.poa import NativePoaGraph
    reads = oversize_window(rng, 60, 3900, 2)
    g = NativePoaGraph()
    for r in reads:
        g.add_sequence(r)
    read = oversize_window(rng, 60, 4300, 1)[1]
    return g, read


def launches_profiled(fn):
    """fn()'s kernel launches and device copies, read from torch.profiler's
    runtime-call counts; None where the profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = {e.key: e.count for e in prof.key_averages()}
    n = counts.get("cudaLaunchKernel", 0) + counts.get("cuLaunchKernel", 0)
    return (n or None), counts.get("cudaMemcpyAsync", 0)


def check_scale_out(golden, dev, bench_recs, heavy_recs):
    """Phase scale-out: the JAX package's scale-out ported
    (svscope_tpu_torch/parallel, ops/poa_sharded, graft_entry, the
    dist_worker tool) on a device tuple of two shards: ("cuda:0",
    "cuda:0") on a one-GPU card, and over every GPU too where there are
    more.  A path check, not a scaling measurement: two shards on one card
    share it.  Returns the K1/K3/K4 launches of each run."""
    import numpy as np
    import torch
    import localgraph_golden as lgg
    from svscope_tpu_torch import graft_entry
    from svscope_tpu_torch.engine import localgraph as tlg
    from svscope_tpu_torch.models import mixture as mx
    from svscope_tpu_torch.native.poa import NativePoaGraph
    from svscope_tpu_torch.ops import poa_batch as pb
    from svscope_tpu_torch.ops import poa_sharded as ps
    from svscope_tpu_torch.parallel import dataparallel as dpm
    from svscope_tpu_torch.tools import multihost_demo
    t_all = time.perf_counter()
    n_gpu = torch.cuda.device_count()
    meshes = [(dev, dev)]
    if n_gpu > 1:
        meshes.append(dpm.make_dp_mesh())
    print(f"[scale-out] meshes {[[str(d) for d in m] for m in meshes]} "
          f"({n_gpu} GPU)", flush=True)
    runs = {}
    bench = lgg.make_workload("bench256")
    want = golden["workloads"]["bench256"]["records"]
    for mesh in meshes:
        tag = "" if mesh == meshes[0] else f"-{len(mesh)}gpu"
        for engine, need, ref_recs in (("pallas", ("K1",), bench_recs),
                                       ("fused", PK_MAIN, bench_recs)):
            name = f"dp-bench256-{engine}{tag}"
            t0 = time.perf_counter()
            _, base_s = _timed(lambda: tlg.process_window_batch(
                bench, device=dev, device_poa=engine))
            with dpm.data_mesh_installed(mesh):
                (recs, dp_s), launches = path_launches(
                    name, lambda: _timed(lambda: tlg.process_window_batch(
                        bench, device=dev, device_poa=engine)), need)
                disp = dict(dpm.LAST_DISPATCH)
            same = _golden_count(recs, want)
            if same != len(want) or recs != ref_recs:
                raise RuntimeError(f"{name}: golden {same}/{len(want)}, "
                                   f"== unsharded {recs == ref_recs}")
            if disp != {"sharded": True, "n_shards": len(mesh)}:
                raise RuntimeError(f"{name}: last dispatch {disp}")
            runs[name] = launches
            phase(name, t0, f"golden {same}/{len(want)}, records == "
                  f"unsharded, last dispatch {disp}, launches {launches}; "
                  f"{len(bench) / dp_s:.3f} w/s over {len(mesh)} shards, "
                  f"{len(bench) / base_s:.3f} w/s unsharded (a path check: "
                  "the shards share the card)")

    # mp-heavy32x400: the heavy windows' 400-read EM split over the reads
    t0 = time.perf_counter()
    mesh = meshes[0]
    heavy = lgg.make_workload("heavy32x400")
    hwant = golden["workloads"]["heavy32x400"]["records"]
    _entries, ready = tlg._stage_a(heavy, "tumor", 3, 0.05, "pallas", None,
                                   dev)
    feats = [f for (_w, _e, _r, f, _t) in ready]
    em = lambda: mx.em_cluster_batch_dispatch(feats, labels_only=True,
                                              device=dev)()
    base_em, em_s = _timed(em)
    with dpm.data_mesh_installed(mesh):
        got_em, mp_em_s = _timed(em)
        mp = dict(mx.LAST_MP_DISPATCH)
        (recs, mp_s), launches = path_launches(
            "mp-heavy32x400", lambda: _timed(lambda: tlg.process_window_batch(
                heavy, device=dev)), ("K1",))
        mp_run = dict(mx.LAST_MP_DISPATCH)
    same = _golden_count(recs, hwant)
    if same != len(hwant) or recs != heavy_recs:
        raise RuntimeError(f"mp-heavy32x400: golden {same}/{len(hwant)}")
    if not (mp["used"] and mp_run["used"]) or mp["n_shards"] != len(mesh):
        raise RuntimeError(f"mp-heavy32x400: mp EM not engaged {mp}")
    if any(a[0] != b[0] or not np.array_equal(a[2], b[2])
           for a, b in zip(base_em, got_em)):
        raise RuntimeError("mp-heavy32x400: mp EM K or labels differ")
    runs["mp-heavy32x400"] = launches
    phase("mp-heavy32x400", t0, f"golden {same}/{len(hwant)}, records == "
          f"unsharded, LAST_MP_DISPATCH {mp_run} (EM alone: {mp}); EM "
          f"stage of {len(feats)} windows {mp_em_s:.4f} s read-parallel, "
          f"{em_s:.4f} s batched, K and labels equal; run {mp_s:.3f} s "
          f"({len(heavy) / mp_s:.3f} w/s); launches {launches}")

    # oversize: the design point, banded, over the two shards
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    g, read = design_point(rng)
    n = g.n_nodes()
    packed = g.pack(4096, ps.MAX_PREDS)
    host_aln, host_s = _timed(lambda: g.align_only(read))
    ps.reset_counts()
    (aln, _score), wall = _timed(lambda: ps.align_sharded_packed(
        *packed, read, mesh, traceback="auto"))
    counts = dict(ps.COUNTS)
    if aln != host_aln or counts["dir_blocks"] == 0:
        raise RuntimeError(f"oversize: design point != C++ engine "
                           f"(dir blocks {counts['dir_blocks']})")
    # launches: profiled on a 1000-node chain (the same per-row ops)
    small = oversize_window(np.random.default_rng(1), 48, 1000, 1)
    sg = NativePoaGraph()
    sg.add_sequence(small[0])
    ps.reset_counts()
    n_launch, n_copy = launches_profiled(lambda: ps.align_sharded_packed(
        *sg.pack(1024, ps.MAX_PREDS), small[1], mesh, traceback="banded"))
    sub_rows = ps.COUNTS["rows"]
    per_row = n_launch / sub_rows if n_launch else None
    # one oversize window's MSA, every round on the wavefront
    win = oversize_window(np.random.default_rng(2))
    host_msa = pb.poa_msa_batch([win], use_device=False, device=dev)
    pb.set_default_oversize_mesh(mesh)
    try:
        ps.reset_counts()
        (msa, msa_s) = _timed(lambda: pb.poa_msa_batch(
            [win], use_device=True, device=dev))
        msa_rows = ps.COUNTS["rows"]
    finally:
        pb.set_default_oversize_mesh(None)
    if msa != host_msa or msa_rows == 0:
        raise RuntimeError("oversize: wavefront MSA != host MSA")
    phase("oversize", t0, f"design point N={n} nodes x {len(read)} bp read, "
          f"2 shards, banded: == C++ engine; {wall:.3f} s ({counts['rows']} "
          f"device rows, {counts['dir_blocks']} direction blocks; the C++ "
          f"engine {host_s:.3f} s); launches "
          + (f"{per_row:.2f} per device row profiled on a 1000-node chain "
             f"({n_launch} launches, {n_copy} copies, {sub_rows} rows), "
             f"~{per_row * counts['rows']:.0f} at the design point"
             if per_row else "not measured (profiler recorded none)")
          + f"; one {len(win[0])} bp window's MSA with use_device=True == "
          f"host MSA, {msa_s:.3f} s ({msa_rows} device rows)")

    # dryrun: graft_entry's seven assertions over the two shards
    t0 = time.perf_counter()
    fn, args = graft_entry.entry(dev)
    bics, _gam = fn(*args)
    if not bool(torch.isfinite(bics).all()):
        raise RuntimeError("graft entry: non-finite BICs")
    _out, launches = path_launches(
        "dryrun", lambda: graft_entry.dryrun_multichip(len(mesh), mesh),
        ("K1", *PK_MAIN))
    runs["dryrun"] = launches
    phase("dryrun", t0, f"entry (16, 32, 64) finite; dryrun_multichip("
          f"{len(mesh)}) over {[str(d) for d in mesh]} passed; launches "
          f"{launches}")

    # multi-process: two dist_worker processes on the card, gloo rendezvous
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ref, tumor, normal, recs = lgg.make_synth_pair(d)
        wb = os.path.join(d, "windows.bed")
        with open(wb, "w") as f:
            f.write("\n".join(recs) + "\n")
        single, single_s = _timed(lambda: tlg.run_local_graph(
            recs, ref, [tumor], [normal], ["S"], ["S"],
            os.path.join(d, "single"), offset=50, device=dev,
            data_parallel=False))
        t = time.perf_counter()
        res = multihost_demo.launch_workers(
            2, f"file://{d}/rendezvous", ref, tumor, normal, wb,
            os.path.join(d, "dist"), [str(dev)] * 2)
        procs_s = time.perf_counter() - t
        for rc, out in res:
            if rc != 0:
                raise RuntimeError(f"multi-process: worker rc {rc}:\n"
                                   f"{out[-3000:]}")
        with open(single, "rb") as f:
            a = f.read()
        with open(os.path.join(d, "dist", os.path.basename(single)),
                  "rb") as f:
            b = f.read()
    if a != b or hashlib.sha256(a).hexdigest() != \
            golden["synth_pair"]["raw_bed_sha256"]:
        raise RuntimeError("multi-process: merged Raw.bed != single run")
    phase("multi-process", t0, f"2 dist_worker processes on {dev} (gloo "
          f"rendezvous, block-cyclic shards): merged Raw.bed == the single "
          f"run == golden; workers {procs_s:.3f} s (start-up included), "
          f"single {single_s:.3f} s")
    print(f"[scale-out-total] {time.perf_counter() - t_all:.3f} s",
          flush=True)
    return runs


def run_genome_bench(dev):
    """Phases genome-bench and genome-bench-fused: the port's genome bench
    (svscope_tpu_torch/tools/genome_bench.py) at the JAX golden's 20 Mb
    configuration (4 x 5 Mb at depth 12) on the cuda default POA (K1; K2
    for MisScore), then at the golden's small configuration (2 x 1 Mb)
    with the fused POA (K3 and K4): every output file's hash, the
    nine-class tier table, the candidate count and both precision/recall
    pairs equal the JAX golden (tests/data/jax_genome_golden.json); each
    run's launches counted from 0.  Returns {run: (result, launches)}."""
    import genome_golden as gg
    from svscope_tpu_torch.tools import genome_bench
    g = gg.load_golden()
    out = {}
    for name, cfg, poa, need in (
            ("genome-bench", g["full"], None, ("K1", "K2")),
            ("genome-bench-fused", g["small"], "fused", (*PK_MAIN, "K2"))):
        t0 = time.perf_counter()
        kw = {k: cfg[k] for k in gg.GENOME_FULL}
        with tempfile.TemporaryDirectory() as d:
            res, launches = path_launches(name, lambda: genome_bench.run(
                **kw, device=dev, device_poa=poa, savedir=d,
                log=lambda line: print("  " + line, flush=True)), need)
        bad = gg.differences(res, cfg)
        if bad:
            raise RuntimeError(f"{name}: {bad} differ from the JAX golden")
        sc = {k: res[k] for k in ("raw_bed", "vcf")}
        phase(name, t0, f"{kw}: {res['candidates']} candidate windows, "
              f"Raw.bed {sc['raw_bed']}, VCF {sc['vcf']} ([hit, of] "
              f"precision, recall, decoys), tier table (n, candidate, "
              f"Raw.bed, VCF) {res['tiers']}, {len(res['hashes'])} files "
              "== JAX golden; stage walls " + ", ".join(
                  f"{k} {v:.3f} s" for k, v in res["stages"].items())
              + f"; launches {launches}")
        out[name] = (res, launches)
    return out


def run_tools(dev, golden):
    """Phase tools: the port's measurement tools once each at their bench
    sizes, tables printed: wgs_bench at the golden's small configuration
    (its frame's hash == JAX's), roofline, engine_ab (the engine source
    twice: byte-identical), pipeline_probe, pk_phase_probe and fused_probe
    (MSAs == the host engine's); the bench phase runs stage_probe and
    e2e_probe for every engine.  Returns the launches of the whole
    phase."""
    import genome_golden as gg
    from svscope_tpu_torch.tools import roofline, wgs_bench
    from svscope_tpu_torch.tools.probe import (engine_ab, fused_probe,
                                               pipeline_probe,
                                               pk_phase_probe)
    t0 = time.perf_counter()
    log = lambda line: print("  " + line, flush=True)
    n_bench = len(golden["workloads"]["bench256"]["records"])

    def tools():
        want = gg.load_golden()["wgs_small"]
        w = wgs_bench.run(**gg.WGS_SMALL, device=dev, log=log)
        if (w["rows"], w["sha256"]) != (want["rows"], want["sha256"]):
            raise RuntimeError("wgs_bench: background_stats differ from JAX")
        roofline.run(dev, log=log)
        if not engine_ab.run(device=dev, log=log)["identical"]:
            raise RuntimeError("engine_ab: one source, two outputs")
        pipeline_probe.run(trials=1, device=dev, log=log)
        pk_phase_probe.run(reps=3, device=dev, log=log)
        fp = fused_probe.run(trials=1, device=dev, log=log)
        if fp["identical"] != n_bench:
            raise RuntimeError(f"fused_probe: {fp['identical']} identical")

    _, launches = path_launches("tools", tools, ("K1", "K2", *PK_MAIN))
    phase("tools", t0, "wgs_bench (== JAX), roofline, engine_ab, "
          f"pipeline_probe, pk_phase_probe, fused_probe; launches "
          f"{launches}")
    return launches


def run_bench(dev, golden):
    """Phase bench: svscope_tpu_torch/tools/bench.py's run_measurement on
    bench256 with the heavy tier, its JSON line printed; every engine's
    records 256/256 and the heavy tier's 32/32 == the localGraph golden;
    K1, K3 and K4 launched (counted from 0), no host-DP pair and no fused
    fallback.  Returns the phase's launches."""
    from svscope_tpu_torch.tools import bench
    t0 = time.perf_counter()
    out, launches = path_launches("bench", lambda: bench.run_measurement(
        bench.N_WINDOWS, heavy=True, device=dev, golden=golden,
        engines=bench.ENGINES, log=lambda line: print("  " + line,
                                                       flush=True)),
        ("K1", *PK_MAIN))
    print("[bench] " + json.dumps(out), flush=True)
    heavy = out["heavy_tier"]
    counts = bench.golden_counts(out)
    n = len(golden["workloads"]["bench256"]["records"])
    want = {"headline": n, **{k: n for k in bench.ENGINES},
            "heavy_tier": HEAVY_WINDOWS, "heavy_tier.pallas": HEAVY_WINDOWS}
    if {k: c for k, (c, _n) in counts.items()} != want:
        raise RuntimeError(f"bench: records == golden {counts}, want {want}")
    phase("bench", t0, f"{out['value']} w/s (host POA, EM on the card), "
          + ", ".join(f"{k} {r['w_per_s']:.3f} w/s {r['golden']}/"
                      f"{out['n_windows']}" for k, r in out["engines"].items())
          + f"; heavy host {heavy['w_per_s']} w/s, pallas "
          f"{heavy['pallas']['w_per_s']} w/s, {HEAVY_WINDOWS}/"
          f"{HEAVY_WINDOWS} == golden; launches {launches}")
    return launches


AB_SNIPPET = """
import inspect, json, sys, torch
sys.path.insert(0, sys.argv[1])
from svscope_tpu_torch.ops import nw_kernel, poa_align, poa_fused_kernel
from svscope_tpu_torch.tools.probe import fusebody_probe, int16_probe
from svscope_tpu_torch.tools.probe import row_probe
from svscope_tpu_torch.tools.timing import time_call, time_each
dev = torch.device("cuda", 0)
pfk = poa_fused_kernel
k3 = pfk.align_tb_cuda
k3_chainw = "chainw" in inspect.signature(k3).parameters
fns = {"k1": lambda a, w: poa_align.align_batch_cuda(*a, w),
       "k2": lambda a, w: nw_kernel.nw_stats_cuda(*a, w),
       "k3": lambda a, w: (k3(*a[:3], a[6], *a[3:6]) if k3_chainw
                           else k3(*a[:6])),
       "i16": lambda a, w: int16_probe.int16_op_cuda(w, *a),
       "rowp": lambda a, w: row_probe.row_probe_cuda(*a, w),
       "torch.maximum": lambda a, w: torch.maximum(a[0], a[1]),
       "torch.roll": lambda a, w: torch.roll(a[0], 1, 1)}
out = {}
for name, (kind, args, width, reps) in torch.load(sys.argv[2]).items():
    a = [t.to(dev) for t in args]
    if kind in ("k4", "k5"):
        out[name] = time_each(lambda: (*a[:5], pfk.GraphState(*[
            t.clone() for t in a[5:]]), width), pfk.fusion_cuda, dev, reps,
            queued=True)
    elif kind in ("k6", "k6o", "k7"):
        if not hasattr(pfk, "round_prep_cuda"):     # a tree before K6/K7
            out[name] = None
            continue
        st = pfk.GraphState(*a[2:])
        if kind == "k6":
            fn = lambda: pfk.round_prep_cuda(st, a[0], a[1])
        elif kind == "k6o":
            fn = lambda: pfk.toposort_cuda(st.pn, st.gm, st.nn)
        else:
            order = pfk.toposort_cuda(st.pn, st.gm, st.nn)[0]
            fn = lambda: pfk.consensus_cuda(st.pn, st.pw, st.pt, st.nn,
                                            order)
        out[name] = time_call(fn, dev, reps, queued=True)
    elif kind == "fbp":
        k0 = fusebody_probe.OUT_LEN - fusebody_probe.STEPS
        out[name] = time_each(lambda: (*a[:5], pfk.GraphState(*[
            t.clone() for t in a[5:]]), k0), lambda *x:
            fusebody_probe.fusebody_cuda(width, *x), dev, reps, queued=True)
    else:
        out[name] = time_call(lambda: fns[kind](a, width), dev, reps,
                              queued=True)
print(json.dumps(out))
"""


def ab_inputs(path, misscore_groups, misscore_pairs, pk_cases):
    """Save the A/B cases (CPU tensors): K1 at the k1-time and heavy
    shapes, K2 per bucket of misscore4096, K3 (its chain-row flags last,
    for trees that take them), K4 and K5 on the captured rounds of
    `pk_cases` ({name: (K3's operands, fusion_args with the state's
    tensors)}), every row-probe variant on the tool's inputs (B=256), every
    fusion-body variant on the replayed states, every int16 probe op and
    torch.maximum / torch.roll on the probe's (262144, 128) timing
    arrays."""
    import numpy as np
    import torch
    from svscope_tpu_torch.ops import poa_device
    from svscope_tpu_torch.tools import workloads as tw
    from svscope_tpu_torch.tools.probe import fusebody_probe as fp
    from svscope_tpu_torch.tools.probe import int16_probe as ip
    from svscope_tpu_torch.tools.probe import row_probe as rp
    N, L, B = TIME_SHAPE
    cases = {}
    for name, arrs, width in (
            ("k1 B=64 N=L=512", random_graph_case(N, L, B, seed=7)[3], L),
            ("k1 heavy B=32 N=1024 L=512", tw.heavy_round_workload(), 512)):
        cases[name] = ("k1", poa_device.to_torch_packed(*arrs, "cpu"), width,
                       20)
    for bucket, idxs in sorted(misscore_groups.items()):
        sub = [misscore_pairs[i] for i in idxs]
        cases[f"k2 misscore4096 bucket {bucket}"] = (
            "k2", [torch.from_numpy(np.ascontiguousarray(x))
                   for x in pad_pairs(sub, bucket)], bucket, 5)
    for name, (args, fargs) in pk_cases.items():
        chainw = chain_flags(args[2].numpy(), args[5].numpy())
        cases[f"k3 {name}"] = ("k3", [*args, torch.from_numpy(chainw)], 0,
                               20)
        cases[f"k4 {name}"] = ("k4", fargs, "lockstep", 20)
        cases[f"k5 {name}"] = ("k5", fargs, "seq", 20)
        glue = [fargs[4], args[4], *fargs[5:]]   # read, its length, state
        for kind in ("k6", "k6o", "k7"):
            cases[f"{kind} {name}"] = (kind, glue, 0, 20)
    chars, seqs = rp.make_inputs(rp.B, "cpu")
    for v in rp.VARIANTS:
        cases[f"row probe {v}"] = ("rowp", [chars, seqs], v, 5)
    *ops, st = fp.device_inputs(fp.build_states(), "cpu")
    for v in fp.VARIANTS:
        cases[f"fusebody probe {v}"] = ("fbp", [*ops, *st.tensors()], v, 10)
    big = ip.large_inputs(INT16_ROWS, "cpu")
    for op in ip.ALL_OPS:
        cases[f"i16 {op}"] = ("i16", big, op, 20)
    for lib in ("torch.maximum", "torch.roll"):
        cases[f"i16 {lib}"] = (lib, big, 0, 20)
    torch.save(cases, path)


def _ms(v):
    """A time in ms as text; "-" for a case a tree does not have."""
    return "-" if v is None else f"{v:.4f}"


def run_ab(trees, misscore_groups, misscore_pairs, pk_cases):
    """The A/B cases' times in each tree of `trees` (this checkout is ".")
    on the same inputs, in turns: each tree, then each again in reverse
    order.  Prints one line per turn and the per-case times."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ab_inputs.pt")
        ab_inputs(path, misscore_groups, misscore_pairs, pk_cases)
        res = {}
        for tree in list(trees) + list(reversed(trees)):
            root = os.path.abspath(os.path.join(HERE, tree))
            out = subprocess.run([sys.executable, "-c", AB_SNIPPET, root,
                                  path], cwd=root, capture_output=True,
                                 text=True, timeout=900)
            if out.returncode != 0:
                raise RuntimeError(f"A/B run in {tree} failed:\n"
                                   f"{out.stderr[-3000:]}")
            times = json.loads(out.stdout.strip().splitlines()[-1])
            print(f"  [ab] {tree}: " + ", ".join(
                f"{k} {_ms(v)} ms" for k, v in times.items()), flush=True)
            for k, v in times.items():
                res.setdefault(tree, {}).setdefault(k, []).append(v)
    phase("ab", t0, "ms per call, calls queued ahead, each tree twice: "
          + "; ".join(f"{k}: " + ", ".join(
              f"{tree} {' / '.join(_ms(v) for v in res[tree][k])}"
              for tree in trees) for k in res[trees[0]]))
    return res


def build_all():
    """Every CUDA kernel (nvcc, one process per source) and the three host
    C++ engines (g++), all at once.  Returns the sources and wall seconds."""
    from svscope_tpu_torch.native import ensure_libpoa, hcluster
    from svscope_tpu_torch.native import bam as native_bam
    from svscope_tpu_torch.ops import nw_kernel, poa_align
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    from svscope_tpu_torch.tools.probe import (fusebody_probe, int16_probe,
                                               row_probe)
    from svscope_tpu_torch.utils.cuda_build import load_cuda_libs
    t0 = time.perf_counter()
    sources = (poa_align.SOURCE, *tpk.SOURCES, nw_kernel.SOURCE,
               row_probe.SOURCE, fusebody_probe.SOURCE, int16_probe.SOURCE)
    host = (ensure_libpoa, hcluster.ensure_lib, native_bam.lib)
    with ThreadPoolExecutor(len(host) + 1) as pool:
        jobs = [pool.submit(load_cuda_libs, sources)]
        jobs += [pool.submit(f) for f in host]
        for j in jobs:
            j.result()
    return sources, time.perf_counter() - t0


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                 "GPU (see the module docstring).")
    ap.add_argument("--ab", nargs="+", metavar="TREE", default=None,
                    help="after the phases, time K1-K5 and the three "
                    "probes of each source tree (a checkout's root, "
                    "relative to this script; '.' is this one) in turns on "
                    "the same inputs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available on this host",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}",
          flush=True)
    from svscope_tpu_torch.utils.cuda_build import BUILD_LOG
    from svscope_tpu_torch.utils.device import resolve_device
    import localgraph_golden as lgg
    dev = resolve_device("cuda")
    sources, build_s = build_all()
    for src in sources:
        for line in BUILD_LOG[src]["ptxas"].splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                print(f"  ptxas {src}:", line.strip(), flush=True)
    phase("setup", t0, f"{torch.cuda.get_device_name(0)}; built "
          + ", ".join(f"{s} {BUILD_LOG[s]['seconds']:.2f} s" for s in sources)
          + f" and the host C++ engines (all at once, {build_s:.2f} s)")

    max_err, k1_main, k1_heavy = check_kernel(dev)
    golden = lgg.load_golden()
    # K1's main path: both workloads with device POA, each counted from 0
    bench_launches, bench_recs = run_workload("bench256", golden, dev, 3, 3)
    heavy_launches, heavy_recs = run_workload("heavy32x400", golden, dev, 2,
                                              1)
    launches = bench_launches + heavy_launches
    check_cli(golden)

    pk_err, bench_cap, heavy_cap, serial_walks, caps = check_pk_kernels(dev)
    glue_err, glue_ms, glue_bounds, glue_steps, glue_per = check_glue(
        dev, caps, bench_cap, heavy_cap)
    del caps
    pk_ms, pk_bounds, pk_single = time_pk_kernels(bench_cap, heavy_cap, dev)
    pk_err.update(glue_err)
    pk_ms.update(glue_ms)
    pk_bounds.update(glue_bounds)
    pk_ab = {}
    for name, r, cap in (("bench256", PK_BENCH_ROUNDS[1], bench_cap),
                         ("heavy32x400", PK_HEAVY_ROUND, heavy_cap)):
        s = k3_shape(cap)
        *fargs, st = fusion_args(cap)
        pk_ab[f"{name} round {r + 1} B={s['B']} N={s['N']} "
              f"l_max={s['l_max']}"] = (
            [t.cpu() for t in k3_args(cap)],
            [t.cpu() for t in (*fargs, *st.tensors())])
    heavy_shape = k3_shape(heavy_cap)
    del bench_cap, heavy_cap
    pk_launches, _recs, _ws = run_fused_workload("bench256", golden, dev, 3,
                                                 bench_recs)
    split = fused_phase_split(dev)
    os.environ["SVSCOPE_PK_FUSION"] = "seq"
    try:
        seq_launches, _recs, _ws = run_fused_workload(
            "bench256", golden, dev, 1, bench_recs,
            need=("K3", "K5", *PK_GLUE))
    finally:
        os.environ.pop("SVSCOPE_PK_FUSION")
    pk_launches["K5"] = seq_launches["K5"]
    heavy_pk, _recs, _ws = run_fused_workload("heavy32x400", golden, dev, 1)
    check_cli(golden, ("--device-poa", "fused"), "cli-fused")

    k2_err, k2_pairs, k2_groups = check_k2(dev)
    k2_ms, k2_plain_ms, k2_bnd, k2_buckets = time_k2(k2_pairs, k2_groups,
                                                     dev)
    # K2's launches on its main path: MisScore of a Raw.bed, then the two
    # CLI runs (each counted from 0 just before it).
    k2_launches, k2_launch = check_misscore_pipe(bench_recs + heavy_recs,
                                                 dev)
    k2_launches += check_aln_cli(dev)

    # the rest of the single-card CLI: DataPrepare, its npz replay, the
    # figure's inputs, the per-K EM and the chromosome run
    t_cli = time.perf_counter()
    dp_runs = check_dataprepare(dev)
    check_viz_and_em(dev)
    chrom, chrom_launches = run_chrom_bench(dev)
    new_paths = {**dp_runs, "chrom": chrom_launches}
    print(f"[cli-slice-total] {time.perf_counter() - t_cli:.3f} s "
          "(dataprepare, dataprepare-fused, npz-replay, viz-inputs, "
          "em-cluster, chrom-bench)", flush=True)
    launches += sum(r["K1"] for r in new_paths.values())
    k2_launches += sum(r["K2"] for r in new_paths.values())

    k16_err = check_k1_int16(dev)
    k16_launches, k16_ms, k16_plain_ms, k16_bound = run_attached_bench()
    probes = {"row": check_row_probe(dev),
              "fusebody": check_fusebody_probe(dev),
              "int16": check_int16_probe(dev)}
    # the scale-out: dp, mp, the oversize wavefront, the dry run and two
    # processes; K1's, K3's and K4's launches of each run counted from 0
    scale = check_scale_out(golden, dev, bench_recs, heavy_recs)
    launches += sum(r["K1"] for r in scale.values())
    # this slice: the genome bench at 20 Mb (K1, K2) and fused (K3, K4),
    # then the measurement tools; launches of each run counted from 0
    genome = run_genome_bench(dev)
    tool_launches = run_tools(dev, golden)
    for name, (_res, n) in genome.items():
        launches += n["K1"]
        k2_launches += n["K2"]
    # this slice: bench.py's measurement on the card (K1, K3, K4)
    bench_k = run_bench(dev, golden)
    launches += bench_k["K1"]
    if args.ab:
        run_ab(args.ab, k2_groups, k2_pairs, pk_ab)

    imported = sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "svscope_tpu"))
    if imported:
        raise RuntimeError(f"imported the JAX package or JAX: {imported[:8]}")

    def row(name, src, replaces, n, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda",
                "source": f"svscope_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None}
    # library_ms is null for K1-K7: no single PyTorch call computes a POA
    # alignment, a POA graph fusion, a group-Kahn order, a heaviest-bundle
    # walk or NW alignment statistics; null for
    # each probe as a whole (its variants list the int16 probe's
    # torch.maximum and torch.roll beside max16 and roll16).
    k1 = row("poa_align (K1, batched POA graph-vs-read NW)", "poa_align.cu",
             KERNEL_REPLACES, launches, max_err, k1_main["ms"],
             k1_main["plain_ms"], k1_main["bound"])
    # the main path's two workloads, and K1 at the heavy shape
    k1["launches_bench256"] = bench_launches
    k1["launches_heavy32x400"] = heavy_launches
    for path, r in new_paths.items():
        if path != "dataprepare-fused":
            k1[f"launches_{path.replace('-', '_')}"] = r["K1"]
    k1["launches_scale_out"] = {p: r["K1"] for p, r in scale.items()}
    k1["chrom_stage_s"] = chrom["stages"]
    k1["launches_genome_bench"] = genome["genome-bench"][1]["K1"]
    k1["genome_bench_stage_s"] = genome["genome-bench"][0]["stages"]
    k1["launches_tools"] = tool_launches["K1"]
    k1["launches_bench"] = bench_k["K1"]
    k1["heavy_shape"] = {"B": 32, "N": 1024, "L": 512,
                         "ms": k1_heavy["ms"],
                         "plain_ms": k1_heavy["plain_ms"],
                         "bound_ms": k1_heavy["bound"][0],
                         "bound_by": k1_heavy["bound"][1]}
    kernels = [k1,
               row(K1_16_NAME, "poa_align.cu", K1_16_REPLACES, k16_launches,
                   k16_err, k16_ms, k16_plain_ms, k16_bound)]
    for k, (name, src, replaces) in PK_KERNELS.items():
        entry = row(name, src, replaces, pk_launches[k], pk_err[k],
                    pk_ms[k][0], pk_ms[k][1], pk_bounds[k])
        if k in PK_MAIN:
            # the main path: both fused workloads (lockstep, the default)
            # and DataPrepare with --device-poa fused
            fused_dp = new_paths["dataprepare-fused"][k]
            entry["launches"] += heavy_pk[k] + fused_dp
            entry["launches_bench256"] = pk_launches[k]
            entry["launches_heavy32x400"] = heavy_pk[k]
            entry["launches_dataprepare_fused"] = fused_dp
            entry["launches_scale_out"] = {p: r[k] for p, r in scale.items()}
            entry["launches"] += sum(r[k] for r in scale.values())
            fused_genome = genome["genome-bench-fused"][1][k]
            entry["launches"] += fused_genome
            entry["launches_genome_bench_fused"] = fused_genome
            entry["launches_tools"] = tool_launches[k]
            entry["launches"] += bench_k[k]
            entry["launches_bench"] = bench_k[k]
        # each pk kernel at the heavy capture, as timed
        entry["heavy_shape"] = {**heavy_shape, "round": PK_HEAVY_ROUND + 1,
                                "ms": pk_ms[k + " heavy"][0],
                                "plain_ms": pk_ms[k + " heavy"][1],
                                "bound_ms": pk_bounds[k + " heavy"][0],
                                "bound_by": pk_bounds[k + " heavy"][1]}
        if k in ("K4", "K5"):
            # one call after a fresh state clone: queued, and issued
            entry["single_call_ms"] = {
                sh: {"queued": pk_single[k + sfx][0],
                     "issued": pk_single[k + sfx][1]}
                for sh, sfx in (("bench", ""), ("heavy", " heavy"))}
        if k == "K4":
            entry["serial_walk_windows"] = serial_walks
        if k == "K7":
            entry["ns_per_rank"] = {"bench": glue_per["K7"],
                                    "heavy": glue_per["K7 heavy"]}
        if k == "K6":
            # its order mode (the build's final order) and the Kahn steps
            entry["order_mode"] = {
                sh: {"ms": pk_ms["K6 order" + sfx][0],
                     "plain_ms": pk_ms["K6 order" + sfx][1],
                     "bound_ms": pk_bounds["K6 order" + sfx][0],
                     "bound_by": pk_bounds["K6 order" + sfx][1]}
                for sh, sfx in (("bench", ""), ("heavy", " heavy"))}
            entry["kahn_steps_mean_max"] = {"bench": glue_steps["K6"],
                                            "heavy": glue_steps["K6 heavy"]}
            entry["us_per_kahn_step"] = {
                sh: {"prep": glue_per["K6" + sfx],
                     "order": glue_per["K6 order" + sfx]}
                for sh, sfx in (("bench", ""), ("heavy", " heavy"))}
            # one stage-A batch's fused build, with the kernels and with
            # their plain versions (the build before them), same call
            entry["bench256_batch_build"] = split
        kernels.append(entry)
    k2 = row(K2_NAME, "nw_stats.cu", K2_REPLACES, k2_launches, k2_err, k2_ms,
             k2_plain_ms, k2_bnd)
    # ms is misscore4096's six bucket launches; per launch at each bucket of
    # misscore4096 and of the main path (misscore-pipe)
    k2["misscore4096_buckets"] = k2_buckets
    k2["main_path_launch"] = k2_launch
    for path in ("dataprepare", "dataprepare-fused", "chrom"):
        k2[f"launches_{path.replace('-', '_')}"] = new_paths[path]["K2"]
    for path, (_res, n) in genome.items():
        k2[f"launches_{path.replace('-', '_')}"] = n["K2"]
    k2["launches_tools"] = tool_launches["K2"]
    kernels.append(k2)
    for k, (name, src, replaces) in PROBES.items():
        p = probes[k]
        entry = row(name, src, replaces, p["launches"], p["max_abs_err"],
                    p["ms"], p["plain_ms"], p["bound"])
        entry["variants"] = p["variants"]
        kernels.append(entry)
    print(f"[total] {time.perf_counter() - t0:.3f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
