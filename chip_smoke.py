#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svscope_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its result and seconds; any failure exits
non-zero before the final line:

  1. setup: CUDA required; card name and power limit; every kernel (K1 and
     K1-int16, K2, K3, K4/K5, the three probes) is built from
     svscope_tpu_torch/csrc/ with nvcc, one process per source, all at
     once, beside the g++ builds of the port's three host C++ engines
     (svscope_tpu_torch/csrc/host/).
  2. K1 (csrc/poa_align.cu) against its plain torch version on the card at
     (N, L, B) = (128, 64, 9), (512, 512, 64), (1024, 512, 256),
     (2048, 2048, 8): identical outputs, identical to the C++ engine's own
     alignment; then both timed at B=64, N=512, L=512 (CUDA events).
  3. the slice: the 256-window bench workload through the port's
     process_window_batch with device POA (the kernel): every record's
     sha256 equals tests/data/jax_localgraph_golden.json, the records
     equal the port's host-POA run, the kernel launch count of that run is
     > 0; warm windows/s for device and host POA.
  4. the heavy tier (32 windows x 400 reads): golden 32/32, windows/s.
  5. the CLI: `python -m svscope_tpu_torch.cli localGraph --device cuda`
     on the synthetic BAM pair; Raw.bed sha256 equals the golden.
  6. pk-parity: K3, K4 and K5 against their plain versions (and K4 against
     K5) on operands captured from real rounds of the port's fused build:
     the first 128 bench256 windows at rounds 1, 12 and 24, the heavy
     windows at round 200 (ncap 3073).  Exact.
  7. pk-time: each of K3, K4, K5 and its plain version on the bench batch
     the port launches (128 windows, round 12), CUDA events.
  8. bench256 through process_window_batch(device_poa="fused"): golden
     256/256, records equal the device-POA run's, K3 and K4 launched in
     that run, no host fallback; warm windows/s best of 3; the MSA phase
     split of one stage-A batch; then one run with SVSCOPE_PK_FUSION=seq:
     golden 256/256 and K5 launched.
  9. heavy32x400 fused: golden 32/32, windows/s (one run).
 10. the CLI with `--device-poa fused`: Raw.bed sha256 equals the golden.
 11. k2-parity: K2 (csrc/nw_stats.cu) against its plain torch version at
     every bucket 128 ... 4096 under both score sets (MisScore (1, 0, -1),
     edit distance (0, -1, -1)), seeded pairs with substitutions and
     indels plus the edge cases (both sides at the bucket edge, an empty
     side; batches not a multiple of 8): identical; identical to the host
     DP (every pair up to 512, 16 per larger bucket) and to the JAX golden
     (tests/data/jax_alnfeature_golden.json).  Then misscore4096: 4,096
     pairs of 100-4,000 bp, kernel == plain in every bucket, and
     misscore_batch (MisScore's entry point) on the card gives the plain
     MisScores with one K2 launch per bucket and 0 host-DP pairs.
 12. k2-time: K2 and its plain version per bucket of misscore4096 (CUDA
     events), useful GCUPS = sum(la * lb) / t.
 13. misscore-pipe: a Raw.bed of the port's own bench256 and heavy32x400
     records; misscore_pipe on the card (K2) gives the host DP's MisScore
     column, K2 launched, 0 pairs sent to the host DP; pairs per bucket.
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
 19-21. row-probe, fusebody-probe, int16-probe: every variant or op of the
     three probes, kernel == plain at the tool's own shapes; then each
     tool's main on the card (the probes' main path, launches counted from
     0), which times every variant against its plain version, the
     kernels' calls queued ahead of the device.

Then one JSON line listing every kernel with its launches on the main path,
error, times and bound (a probe's row: the sums over its variants, which
it lists under "variants"), the card line, and the last line
{"ok": true, "device": {...}}.  Imports nothing of JAX or of the JAX
package (checked at the end).
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((128, 64, 9), (512, 512, 64), (1024, 512, 256), (2048, 2048, 8))
TIME_SHAPE = (512, 512, 64)
KERNEL_REPLACES = "svscope_tpu/ops/poa_pallas.py:117"
PK_KERNELS = {
    "K3": ("align_tb (K3, pk round: DP + traceback)", "poa_pk_align.cu",
           "svscope_tpu/ops/poa_fused_kernel.py:129"),
    "K4": ("fusion lockstep (K4, pk round: graph fusion, thread/window)",
           "poa_pk_fusion.cu", "svscope_tpu/ops/poa_fused_kernel.py:298"),
    "K5": ("fusion seq (K5, pk round: graph fusion, 8 windows/thread)",
           "poa_pk_fusion.cu", "svscope_tpu/ops/poa_fused_kernel.py:438"),
}
PK_BENCH_ROUNDS = (0, 11, 23)      # rounds 1, 12 and 24
PK_HEAVY_ROUND = 199               # round 200
PK_BATCH = 128                     # stage A's chunk (PIPELINE_CHUNK)
K2_NAME = "nw_stats (K2, batched NW alignment stats: score, matches, length)"
K2_REPLACES = "svscope_tpu/ops/nw_pallas.py:59"
K2_PARITY = {128: 61, 256: 61, 512: 37, 1024: 21, 2048: 17, 4096: 17}
K1_16_NAME = "poa_align int16 (K1-int16, int16 H plane, sentinel -20000)"
K1_16_REPLACES = "svscope_tpu/ops/poa_pallas.py:117"
INT16_MAX = 1024
ATTACHED_B = 64
PROBES = {
    "row": ("row probe (K1's row loop, part by part)", "probe_row.cu",
            "tools/probe/row_probe.py:100"),
    "fusebody": ("fusion-body probe (K4's fusion body on replayed states)",
                 "probe_fusebody.cu", "tools/probe/fusebody_probe.py:232"),
    "int16": ("int16 op probe (int16 ops and packed s16x2 intrinsics)",
              "probe_int16.cu", "tools/probe/int16_mosaic_probe.py:58"),
}
K2_HOST_LARGE = 16                 # host-DP subsample past the 512 bucket
# The bound of a kernel (the least time the card could take for the same
# work) is max(bytes / memory rate, integer ops / int32 rate) for an H100
# SXM at 700 W: HBM3 3.35 TB/s (data sheet); int32 64 lanes per SM (half
# the 128 fp32 lanes behind the data sheet's 67 TFLOP/s) x 132 SMs x
# 1.98 GHz = 16.7e12 ops/s.  Integer ops counted per DP cell: K2 11 (char
# compare, score select, 3 adds, 2 max, 2 tie compares, M and A adds); K1
# and K3 8 per (node, column) (score select, base, gap chain, direction)
# plus 3 per (pred edge, column) (pred-row max, diag and up compares).
# K1-int16's DP ops (max, add, compare, select on int16 values) run at the
# packed s16x2 rate, two per int32 lane (VIMNMX.S16x2, the DPX
# __viaddmax_s16x2 and __vimax3_s16x2 that the int16 probe checks).
# The row probe's ops per (row, column): loop and store 1 (the add), pfx
# and chmask 2 (add, scan max), row POA_OPS_PER_CELL.  The fusion-body and
# int16 probes are counted by bytes only (a few ops per entry or element).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT16X2_OPS_PER_S = 2 * INT32_OPS_PER_S
K2_OPS_PER_CELL = 11
POA_OPS_PER_CELL = 8
POA_OPS_PER_EDGE_CELL = 3
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


def bound(nbytes, ops, ops_per_s=INT32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of moving `nbytes` at the memory
    rate and doing `ops` integer operations at `ops_per_s`."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / ops_per_s * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def tensor_bytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def poa_ops(preds, n_nodes, seq_lens, slot0_copies=False):
    """Integer ops of a POA DP: POA_OPS_PER_CELL per (node, column) plus
    POA_OPS_PER_EDGE_CELL per (pred edge, column), over each window's own
    nodes and read.  preds (B, N, 8): -1 for an empty slot, or (pk layout,
    slot0_copies) empty slots holding slot 0's value."""
    import torch
    preds = torch.as_tensor(preds).long().cpu()
    n_nodes = torch.as_tensor(n_nodes).long().cpu().reshape(-1)
    lens = torch.as_tensor(seq_lens).long().cpu().reshape(-1)
    live = torch.arange(preds.shape[1])[None, :] < n_nodes[:, None]
    edge = preds >= 0
    if slot0_copies:
        slot = torch.arange(preds.shape[2])
        edge = torch.where(slot > 0, preds != preds[..., :1], edge)
    edges = (edge & live[..., None]).sum((1, 2))
    return int((n_nodes * lens).sum()) * POA_OPS_PER_CELL \
        + int((edges * lens).sum()) * POA_OPS_PER_EDGE_CELL


def cuda_ms(fn, reps):
    """Mean ms of fn() over reps calls after a warm-up (CUDA events)."""
    import torch
    from svscope_tpu_torch.tools.timing import time_call
    return time_call(fn, torch.device("cuda", torch.cuda.current_device()),
                     reps, queued=False)


def check_kernel(dev):
    """Phase 2: kernel == plain == native at every shape; timings."""
    import numpy as np
    import torch
    from svscope_tpu_torch.ops import poa_align, poa_device
    max_err = 0
    for N, L, B in SHAPES:
        t0 = time.perf_counter()
        graphs, reads, packed, arrs = random_graph_case(N, L, B, seed=N + B)
        args = poa_device.to_torch_packed(*arrs, dev)
        got = [t.cpu().numpy().astype(np.int64)
               for t in poa_align.align_batch_cuda(*args, L)]
        torch.cuda.synchronize()
        want = [t.cpu().numpy().astype(np.int64)
                for t in poa_device.align_batch_reference(*args, L)]
        err = max(int(np.abs(a - b).max()) for a, b in zip(got, want))
        max_err = max(max_err, err)
        if err:
            raise RuntimeError(f"kernel != plain at N={N} L={L} B={B}")
        an, asp, ke, _sc = got
        for i, g in enumerate(graphs):
            aln = poa_device.unpack_alignment(an[i], asp[i], ke[i],
                                              packed[i][4])
            if aln != g.align_only(reads[i]):
                raise RuntimeError(f"kernel != native engine, window {i} "
                                   f"at N={N} L={L} B={B}")
        phase("k1-parity", t0, f"N={N} L={L} B={B} max_nodes="
              f"{int(arrs[3].max())} kernel==plain==native")
    t0 = time.perf_counter()
    N, L, B = TIME_SHAPE
    graphs, reads, packed, arrs = random_graph_case(N, L, B, seed=7)
    args = poa_device.to_torch_packed(*arrs, dev)
    cells = float((arrs[3].astype(np.int64) * arrs[5]).sum())
    k_ms = cuda_ms(lambda: poa_align.align_batch_cuda(*args, L), 20)
    p_ms = cuda_ms(lambda: poa_device.align_batch_reference(*args, L), 3)
    outs = poa_align.align_batch_cuda(*args, L)
    k1_bound = bound(tensor_bytes(*args, *outs),
                     poa_ops(arrs[1], arrs[3], arrs[5]))
    phase("k1-time", t0, f"B={B} N={N} L={L}: kernel {k_ms:.4f} ms "
          f"({cells / k_ms / 1e6:.3f} GCUPS), plain {p_ms:.4f} ms "
          f"({cells / p_ms / 1e6:.3f} GCUPS), useful cells {int(cells)}, "
          f"bound {k1_bound[0]:.4f} ms ({k1_bound[1]})")
    return max_err, k_ms, p_ms, k1_bound


def run_workload(name, golden, dev, device_runs, host_runs):
    """Phases 3/4: golden check, launch count, device/host equality,
    warm windows/s (best of the warm runs)."""
    import torch
    import localgraph_golden as lgg
    from svscope_tpu_torch.engine.localgraph import (process_window_batch,
                                                     record_line)
    from svscope_tpu_torch.ops import poa_align
    g = golden["workloads"][name]
    wins = lgg.make_workload(name)
    if lgg.payload_sha256(wins) != g["payload_sha256"]:
        raise RuntimeError(f"{name}: window payloads differ from the "
                           "golden's (numpy drew other inputs)")
    t0 = time.perf_counter()
    poa_align.reset_launches()
    recs = process_window_batch(wins, device=dev)   # policy: the kernel
    torch.cuda.synchronize()
    launches = poa_align.LAUNCHES
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
    return launches, recs


def check_cli(golden, extra=(), name="cli"):
    """Phases 5 and 10: the CLI on the synthetic pair, Raw.bed vs the
    golden."""
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
            [sys.executable, "-m", "svscope_tpu_torch.cli", "localGraph",
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
    phase(name, t0, f"Raw.bed sha256 {sha[:16]} == golden")


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


def pk_compare(ops, st, an, asx, ke):
    """K3, K4, K5 against their plain versions on one round's operands, and
    K4 against K5.  Returns {kernel: max abs error}."""
    import torch
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    charsr, sinksr, predsp, chainw, gminr, seqv, lb, nn_eff = ops
    k3 = tpk.align_tb_cuda(charsr, sinksr, predsp, chainw, seqv, lb, nn_eff)
    torch.cuda.synchronize()
    p3 = tpk.align_tb_reference(charsr, sinksr, predsp, chainw, seqv, lb,
                                nn_eff)
    errs = {"K3": _max_err(k3, p3)}
    if _max_err(k3, (an, asx, ke)):
        raise RuntimeError("K3 differs from the build's own K3 output")
    seq5 = seqv[:, 1:].contiguous()
    out = {}
    for name, fn, order in (("K4", tpk.fusion_cuda, "lockstep"),
                            ("K5", tpk.fusion_cuda, "seq"),
                            ("P4", tpk.fusion_reference, "lockstep"),
                            ("P5", tpk.fusion_reference, "seq")):
        s2 = st.clone()
        path = fn(an, asx, ke, gminr, seq5, s2, order)
        torch.cuda.synchronize()
        out[name] = [path] + s2.tensors()
    errs["K4"] = _max_err(out["K4"], out["P4"])
    errs["K5"] = _max_err(out["K5"], out["P5"])
    errs["K4-K5"] = _max_err(out["K4"], out["K5"])
    errs["P4-P5"] = _max_err(out["P4"], out["P5"])
    return errs


def check_pk_kernels(dev):
    """Phase 6: K3/K4/K5 == plain on captured real rounds.  Returns the max
    error per kernel and the bench round-12 capture for phase 7."""
    import localgraph_golden as lgg
    max_err = {"K3": 0, "K4": 0, "K5": 0}
    cases = (("bench256", PK_BATCH, PK_BENCH_ROUNDS),
             ("heavy32x400", None, (PK_HEAVY_ROUND,)))
    bench_cap = None
    for name, n, rounds in cases:
        t0 = time.perf_counter()
        wins = lgg.make_workload(name)[:n]
        bucket, caps = capture_rounds([w.sequences for w in wins], rounds,
                                      dev)
        for r in rounds:
            ops, st, an, asx, ke = caps[r]
            errs = pk_compare(ops, st, an, asx, ke)
            if any(errs.values()):
                raise RuntimeError(f"pk kernel != plain on {name} round "
                                   f"{r + 1}: {errs}")
            for k in max_err:
                max_err[k] = max(max_err[k], errs[k])
            phase("pk-parity", t0, f"{name} bucket (R, L, N)={bucket} "
                  f"B={len(wins)} round {r + 1}: max nodes "
                  f"{int(st.nn.max())}, K3==plain, K4==plain, K5==plain, "
                  f"K4==K5 (errors {errs})")
        if name == "bench256":
            bench_cap = caps[PK_BENCH_ROUNDS[1]]
    return max_err, bench_cap


def cuda_ms_each(setup, fn, reps):
    """Mean ms of fn() over reps, CUDA events around each call only
    (setup() runs outside the timed span), after one warm-up call."""
    import torch
    fn(*setup())
    total = 0.0
    for _ in range(reps):
        args = setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def time_pk_kernels(cap):
    """Phase 7: each pk kernel and its plain version on the bench batch."""
    from svscope_tpu_torch.ops import poa_fused_kernel as tpk
    t0 = time.perf_counter()
    ops, st, an, asx, ke = cap
    charsr, sinksr, predsp, chainw, gminr, seqv, lb, nn_eff = ops
    seq5 = seqv[:, 1:].contiguous()
    k3_args = (charsr, sinksr, predsp, chainw, seqv, lb, nn_eff)
    times = {"K3": (cuda_ms_each(lambda: k3_args, tpk.align_tb_cuda, 20),
                    cuda_ms_each(lambda: k3_args, tpk.align_tb_reference,
                                 2))}

    def fuse_setup(order):
        return lambda: (an, asx, ke, gminr, seq5, st.clone(), order)
    for k, order, reps in (("K4", "lockstep", 2), ("K5", "seq", 1)):
        times[k] = (cuda_ms_each(fuse_setup(order), tpk.fusion_cuda, 20),
                    cuda_ms_each(fuse_setup(order), tpk.fusion_reference,
                                 reps))
    cells = int((nn_eff.long() * lb.long()).sum())
    entries = int((an.shape[1] - 1 - ke.long()).sum())
    bounds = {"K3": bound(tensor_bytes(*k3_args, an, asx, ke),
                          poa_ops(predsp, nn_eff, lb, slot0_copies=True))}
    # fusion: alignment and graph state read once, path (B, l_max) int32
    # and graph state written once; its integer work is a few ops per entry
    state = st.tensors()
    fuse_bytes = tensor_bytes(an, asx, ke, gminr, seq5, *state, *state) \
        + seq5.numel() * 4
    bounds["K4"] = bounds["K5"] = bound(fuse_bytes, 0)
    phase("pk-time", t0, f"B={charsr.shape[0]} N={charsr.shape[1]} "
          f"l_max={seqv.shape[1] - 1} round 12 ({cells} DP cells, "
          f"{entries} alignment entries): " + ", ".join(
              f"{k} kernel {a:.4f} ms plain {b:.4f} ms bound "
              f"{bounds[k][0]:.4f} ms ({bounds[k][1]})" for k, (a, b) in
              times.items()))
    return times, bounds


def run_fused_workload(name, golden, dev, runs, device_recs=None,
                       need=("K3", "K4")):
    """Phases 8/9: the workload with device_poa="fused"; each kernel of
    `need` must have launched in the run, the others not at all."""
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
        return recs, dt, dict(tpk.LAUNCHES), dict(tpf.COUNTS)

    t0 = time.perf_counter()
    recs, cold, launches, counts = run()
    if device_recs is not None and recs != device_recs:
        raise RuntimeError(f"{name} fused: records differ from device POA")
    if any((launches[k] > 0) != (k in need) for k in launches):
        raise RuntimeError(f"{name} fused: main path launches {launches}, "
                           f"expected {need} only")
    phase(name + "-fused", t0, f"golden {len(want)}/{len(want)}, launches "
          f"{launches}, counts {counts}, host fallbacks 0, run "
          f"{cold:.3f} s ({len(wins) / cold:.3f} w/s)")
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


def fused_phase_split(dev):
    """Phase 8: seconds per phase of the fused build of one stage-A batch
    (the device is synchronised at each phase boundary)."""
    import torch
    import localgraph_golden as lgg
    from svscope_tpu_torch.ops import poa_fused as tpf
    t0 = time.perf_counter()
    jobs = [w.sequences for w in lgg.make_workload("bench256")[:PK_BATCH]]
    timing = {}
    tpf.reset_counts()
    tpf.fused_msa_batch(jobs, device=dev, timing=timing)
    torch.cuda.synchronize()
    phase("bench256-fused-split", t0, f"stage-A batch of {len(jobs)}: "
          + ", ".join(f"{k} {v:.4f} s" for k, v in timing.items())
          + f"; counts {dict(tpf.COUNTS)}")


def k2_pair(pairs, bucket, dev, scoring):
    """(kernel, plain) stats (3, n) of `pairs` padded to `bucket`."""
    import torch
    import alnfeature_golden as ag
    from svscope_tpu_torch.ops import nw_kernel
    args = [torch.from_numpy(x).to(dev) for x in ag.pad_pairs(pairs, bucket)]
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
        lens = [max(len(a), len(b)) for a, b in pairs]
        phase("k2-parity", t0, f"bucket {bucket}: {len(pairs)} pairs "
              f"(longer side {min(lens)}-{max(lens)} bp), score sets "
              f"{list(ag.SCORINGS.values())}: kernel==plain, ==host DP on "
              f"{n_host}, ==JAX golden on {len(gpairs)}")
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
    """Phase 12: K2 and its plain version per bucket of misscore4096.
    Returns (kernel ms, plain ms, bound) summed over the bucket launches."""
    import torch
    import alnfeature_golden as ag
    from svscope_tpu_torch.ops import nw_kernel
    t0 = time.perf_counter()
    rows, k_tot, p_tot, nbytes, ops = [], 0.0, 0.0, 0, 0
    for bucket, idxs in sorted(groups.items()):
        sub = [pairs[i] for i in idxs]
        args = [torch.from_numpy(x).to(dev) for x in ag.pad_pairs(sub, bucket)]
        cells = sum(len(a) * len(b) for a, b in sub)
        k_ms = cuda_ms(lambda: nw_kernel.nw_stats_cuda(*args, bucket), 5)
        p_ms = cuda_ms(lambda: nw_kernel.nw_stats_reference(*args, bucket), 1)
        k_tot += k_ms
        p_tot += p_ms
        nbytes += tensor_bytes(*args) + 3 * 4 * len(sub)
        ops += cells * K2_OPS_PER_CELL
        b_ms, b_by = bound(tensor_bytes(*args) + 12 * len(sub),
                           cells * K2_OPS_PER_CELL)
        rows.append(f"{bucket}: {len(sub)} pairs kernel {k_ms:.4f} ms "
                    f"({cells / k_ms / 1e6:.3f} GCUPS) plain {p_ms:.4f} ms "
                    f"bound {b_ms:.4f} ms ({b_by})")
    k2_bound = bound(nbytes, ops)
    phase("k2-time", t0, "misscore4096 per bucket: " + "; ".join(rows)
          + f"; all buckets kernel {k_tot:.4f} ms plain {p_tot:.4f} ms bound "
          f"{k2_bound[0]:.4f} ms ({k2_bound[1]}), "
          f"{ops / K2_OPS_PER_CELL / k_tot / 1e6:.3f} GCUPS")
    return k_tot, p_tot, k2_bound


def k2_main_path(name, fn):
    """Run fn() with K2's launch count and the host-DP count set to 0 just
    before; returns (fn's result, K2 launches).  Fails unless K2 launched
    and no pair went to the host DP."""
    import torch
    from svscope_tpu_torch.ops import nw_batch, nw_kernel
    nw_kernel.reset_launches()
    nw_batch.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches, host_dp = nw_kernel.LAUNCHES, nw_batch.COUNTS["host_dp_pairs"]
    if launches <= 0:
        raise RuntimeError(f"{name}: the main path launched no K2")
    if host_dp:
        raise RuntimeError(f"{name}: {host_dp} pairs went to the host DP")
    return out, launches


def check_misscore_pipe(records, dev):
    """Phase 13: misscore_pipe on the card (K2) == on the host (DP) over a
    Raw.bed of the port's own records.  Returns K2's launches."""
    import localgraph_golden as lgg
    from svscope_tpu_torch.engine.features import misscore_pipe
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
    per_bucket = {}
    for r in records:
        if r[9] == "NormalOutput|EMOutput":
            for a in str(r[3]).split(";"):
                for b in str(r[6]).split(";"):
                    k = bucket_of(max(len(a), len(b)))
                    per_bucket[k] = per_bucket.get(k, 0) + 1
    phase("misscore-pipe", t0, f"{len(records)} records, {len(got)} "
          f"EMOutput rows, pairs per bucket {dict(sorted(per_bucket.items()))}"
          f": MisScore card == host DP, K2 launches {launches}, host-DP "
          f"pairs 0; card {td:.3f} s, host DP {th:.3f} s")
    return launches


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
    if any(errs.values()):
        raise RuntimeError(f"row probe kernel != plain: {errs}")
    phase("row-probe-parity", t0, f"B={b}, variants {list(rp.VARIANTS)}: "
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
    if any(errs.values()):
        raise RuntimeError(f"fusion-body probe kernel != plain: {errs}")
    phase("fusebody-probe-parity", t0, f"{fp.W} windows x {fp.STEPS} "
          f"entries, variants {list(fp.VARIANTS)}: kernel==plain (errors "
          f"{errs})")
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
    rows = 262144
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


def main():
    import torch
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
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}:", line.strip(), flush=True)
    phase("setup", t0, f"{torch.cuda.get_device_name(0)}; built "
          + ", ".join(f"{s} {BUILD_LOG[s]['seconds']:.2f} s" for s in sources)
          + f" and the host C++ engines (all at once, {build_s:.2f} s)")

    max_err, k_ms, p_ms, k1_bound = check_kernel(dev)
    golden = lgg.load_golden()
    launches, bench_recs = run_workload("bench256", golden, dev, 3, 3)
    _l, heavy_recs = run_workload("heavy32x400", golden, dev, 2, 1)
    check_cli(golden)

    pk_err, bench_cap = check_pk_kernels(dev)
    pk_ms, pk_bounds = time_pk_kernels(bench_cap)
    del bench_cap
    pk_launches, _recs, _ws = run_fused_workload("bench256", golden, dev, 3,
                                                 bench_recs)
    fused_phase_split(dev)
    os.environ["SVSCOPE_PK_FUSION"] = "seq"
    try:
        seq_launches, _recs, _ws = run_fused_workload(
            "bench256", golden, dev, 1, bench_recs, need=("K3", "K5"))
    finally:
        os.environ.pop("SVSCOPE_PK_FUSION")
    pk_launches["K5"] = seq_launches["K5"]
    run_fused_workload("heavy32x400", golden, dev, 1)
    check_cli(golden, ("--device-poa", "fused"), "cli-fused")

    k2_err, k2_pairs, k2_groups = check_k2(dev)
    k2_ms, k2_plain_ms, k2_bound = time_k2(k2_pairs, k2_groups, dev)
    # K2's launches on its main path: MisScore of a Raw.bed, then the two
    # CLI runs (each counted from 0 just before it).
    k2_launches = check_misscore_pipe(bench_recs + heavy_recs, dev)
    k2_launches += check_aln_cli(dev)

    k16_err = check_k1_int16(dev)
    k16_launches, k16_ms, k16_plain_ms, k16_bound = run_attached_bench()
    probes = {"row": check_row_probe(dev),
              "fusebody": check_fusebody_probe(dev),
              "int16": check_int16_probe(dev)}

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
    # library_ms is null for K1-K5: no single PyTorch call computes a POA
    # alignment, a POA graph fusion or NW alignment statistics; null for
    # each probe as a whole (its variants list the int16 probe's
    # torch.maximum and torch.roll beside max16 and roll16).
    kernels = [row("poa_align (K1, batched POA graph-vs-read NW)",
                   "poa_align.cu", KERNEL_REPLACES, launches, max_err, k_ms,
                   p_ms, k1_bound),
               row(K1_16_NAME, "poa_align.cu", K1_16_REPLACES, k16_launches,
                   k16_err, k16_ms, k16_plain_ms, k16_bound)]
    for k, (name, src, replaces) in PK_KERNELS.items():
        kernels.append(row(name, src, replaces, pk_launches[k], pk_err[k],
                           pk_ms[k][0], pk_ms[k][1], pk_bounds[k]))
    kernels.append(row(K2_NAME, "nw_stats.cu", K2_REPLACES, k2_launches,
                       k2_err, k2_ms, k2_plain_ms, k2_bound))
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
