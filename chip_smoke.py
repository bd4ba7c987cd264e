#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svscope_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its result and seconds; any failure exits
non-zero before the final line:

  1. setup: CUDA required; card name and power limit; the K1 kernel is built
     from svscope_tpu_torch/csrc/ with nvcc.
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

Then one JSON line per kernel, the card line, and the last line
{"ok": true, "device": {...}}.  Imports no JAX.
"""
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((128, 64, 9), (512, 512, 64), (1024, 512, 256), (2048, 2048, 8))
TIME_SHAPE = (512, 512, 64)
KERNEL_REPLACES = "svscope_tpu/ops/poa_pallas.py:117"


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
    from svscope_tpu.native.poa import NativePoaGraph
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


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    phase("k1-time", t0, f"B={B} N={N} L={L}: kernel {k_ms:.4f} ms "
          f"({cells / k_ms / 1e6:.3f} GCUPS), plain {p_ms:.4f} ms "
          f"({cells / p_ms / 1e6:.3f} GCUPS), useful cells {int(cells)}")
    return max_err, k_ms, p_ms


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
    return launches


def check_cli(golden):
    """Phase 5: the CLI on the synthetic pair, Raw.bed vs the golden."""
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
             "--device", "cuda", "-w", bed, "-T", tumor, "-N", normal,
             "-t", "S", "-n", "S", "-r", ref, "-s", out],
            cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"CLI failed (rc {res.returncode}):\n"
                               f"{res.stderr[-3000:]}")
        with open(os.path.join(out, "S.vs.S.TandemRepeat.Raw.bed"),
                  "rb") as f:
            sha = hashlib.sha256(f.read()).hexdigest()
    if sha != golden["synth_pair"]["raw_bed_sha256"]:
        raise RuntimeError("CLI Raw.bed differs from the golden")
    phase("cli", t0, f"Raw.bed sha256 {sha[:16]} == golden")


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
    from svscope_tpu_torch.ops import poa_align
    from svscope_tpu_torch.utils.cuda_build import BUILD_LOG
    from svscope_tpu_torch.utils.device import resolve_device
    import localgraph_golden as lgg
    dev = resolve_device("cuda")
    tb = time.perf_counter()
    poa_align._kernel()
    build = BUILD_LOG[poa_align.SOURCE]
    for line in build["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    phase("setup", t0, f"{torch.cuda.get_device_name(0)}; K1 built in "
          f"{build['seconds']:.2f} s (load {time.perf_counter() - tb:.2f} s)")

    max_err, k_ms, p_ms = check_kernel(dev)
    golden = lgg.load_golden()
    launches = run_workload("bench256", golden, dev, 3, 3)
    run_workload("heavy32x400", golden, dev, 2, 1)
    check_cli(golden)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    print(json.dumps({"kernels": [{
        "name": "poa_align (K1, batched POA graph-vs-read NW)",
        "route": "cuda", "source": "svscope_tpu_torch/csrc/poa_align.cu",
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
