"""K6's and K7's time split into their parts, from clock64() stamps in the
kernels.

Builds csrc/poa_pk_prep.cu and csrc/poa_pk_consensus.cu a second time with
-DPK_GLUE_SPLIT, which keeps each kernel as it is and adds thread 0's
clock64() stamps at the end of each part of a block's run (PREP_PARTS,
CONSENSUS_PARTS), written per block by the entry points
`pk_prep_split_launch` and `pk_consensus_split_launch`.  A barrier belongs
to the part it ends, so a part counts thread 0's wait for the slowest
thread too; K6's Kahn steps run on thread 0's warp.

Per workload and kernel (K6 in its prep and its order mode, K7 on K6's
order) it prints the slowest block's cycles and microseconds per part
(the block that bounds the launch; microseconds at the H100 SXM's 1.98
GHz boost clock), the mean share of each part over the blocks, K6's
cycles per Kahn step (the steps part over the window's steps,
tools/bounds.kahn_work) and, the slowest block's, per part of a step
(STEP_PARTS: lane 0's own stamps inside the loop, so they add up to a
little more than the steps part), and K7's per rank (the score pass over
the window's node count), the kernel's own time (calls queued ahead of
the device, tools/timing.py) and the stamped build's, and checks that
the stamped build's outputs equal the kernel's.

Workloads: `bench`, round 12 of the fused build of 128 bench windows
(B=128, ncap 1025); `heavy`, round 200 of the heavy tier's (B=32, ncap
3073): the states chip_smoke.py's pk-glue-time phase times.

    python -m svscope_tpu_torch.tools.glue_split [--workload bench heavy]
        [--reps 20]

Needs the card: the stamps exist only in the kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from ..ops import poa_fused_kernel as pfk
from ..utils.cuda_build import load_cuda_lib
from ..utils.device import resolve_device
from .bounds import kahn_work
from .timing import time_call
from .workloads import (HEAVY_READS, HEAVY_SEED, HEAVY_WINDOWS,
                        make_window_payloads)

PREP_PARTS = ("setup", "kahn steps", "order", "rank-space")
STEP_PARTS = ("gstar search", "word test", "placement", "step close")
CONSENSUS_PARTS = ("setup", "score pass", "start node", "best out-edges",
                   "walks")
DEFINES = ("PK_GLUE_SPLIT",)
SM_HZ = 1.98e9
# (windows, seed, reads, INS carriers, the round captured): the golden
# workloads bench256 (its first stage-A chunk) and heavy32x400
WORKLOADS = {"bench": (128, 0, 24, 8, 11),
             "heavy": (HEAVY_WINDOWS, HEAVY_SEED, HEAVY_READS,
                       HEAVY_READS // 2, 199)}
_fns: dict[str, object] = {}


class _Captured(Exception):
    pass


def capture(name: str, dev):
    """The graph state before round r's fusion and that round's read and
    its length, on `dev`: (GraphState, seq, slen)."""
    from ..ops.poa_fused import build_batch_pk, chunk_arrays, plan_buckets
    n, seed, reads, carriers, r = WORKLOADS[name]
    wins = make_window_payloads(n, np.random.default_rng(seed),
                                n_reads=reads, ins_carriers=carriers)
    _out, groups, fallback, enc = plan_buckets([w.sequences for w in wins])
    if len(groups) != 1 or fallback:
        raise RuntimeError(f"{name}: expected one pk bucket, got "
                           f"{list(groups)} and {len(fallback)} host windows")
    (rb, lb, nb), idxs = next(iter(groups.items()))
    seqs, lens, nseq = chunk_arrays(idxs, enc, rb, lb)
    got = {}

    def hook(k, ops, st, an, asx, ke):
        if k == r:
            got["cap"] = (st.clone(), ops[3][:, 1:].contiguous(),
                          ops[4].clone())
            raise _Captured

    try:
        build_batch_pk(seqs, lens, nseq, ncap=nb + 1, device=dev,
                       round_hook=hook)
    except _Captured:
        pass
    return got["cap"]


def _split_fns():
    if not _fns:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        prep = load_cuda_lib(pfk.PREP_SOURCE, DEFINES).pk_prep_split_launch
        prep.argtypes = [vp] * 17 + [ci] * 3 + [vp, vp]
        walk = load_cuda_lib(pfk.CONSENSUS_SOURCE,
                             DEFINES).pk_consensus_split_launch
        walk.argtypes = [vp] * 9 + [ci] * 2 + [vp, vp]
        for fn in (prep, walk):
            fn.restype = ci
        _fns.update(prep=prep, walk=walk)
    return _fns


def split_prep(st, seq, slen, order_mode: bool):
    """One launch of K6's stamped build (prep or order mode): its outputs
    and the (B, len(PREP_PARTS) + len(STEP_PARTS)) cycles per block, int64
    numpy."""
    B, ncap = st.gm.shape
    dev = st.gm.device
    split = torch.zeros((B, len(PREP_PARTS) + len(STEP_PARTS)),
                        dtype=torch.int64, device=dev)
    cyclic = torch.empty(B, dtype=torch.bool, device=dev)
    if order_mode:
        order = torch.empty((B, ncap), dtype=torch.long, device=dev)
        rank = torch.empty_like(order)
        outs = (order, rank, cyclic)
        ptrs = [st.pn, st.gm, st.nn, None, None, None, None, cyclic, order,
                rank] + [None] * 7
        l_max = 0
    else:
        l_max = seq.shape[1]
        i32 = torch.int32
        ops = [torch.empty(s, dtype=i32, device=dev) for s in (
            (B, ncap), (B, ncap), (B, ncap, 8), (B, l_max + 1), (B,), (B,),
            (B, ncap))]
        outs = (*ops, cyclic)
        ptrs = [st.pn, st.gm, st.nn, st.ch, seq, slen, None, cyclic, None,
                None, *ops]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _split_fns()["prep"](*[0 if t is None else t.data_ptr()
                                    for t in ptrs], B, ncap, l_max,
                                  split.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"pk_prep_split_launch failed: CUDA error {rc}")
    torch.cuda.synchronize(dev)
    return outs, split.cpu().numpy()


def split_consensus(st, order):
    """One launch of K7's stamped build: its outputs and the (B,
    len(CONSENSUS_PARTS)) cycles per block, int64 numpy."""
    B, ncap = order.shape
    dev = order.device
    split = torch.zeros((B, len(CONSENSUS_PARTS)), dtype=torch.int64,
                        device=dev)
    outs = (torch.empty((B, ncap), dtype=torch.long, device=dev),
            torch.empty(B, dtype=torch.long, device=dev),
            torch.empty((B, ncap), dtype=torch.long, device=dev),
            torch.empty(B, dtype=torch.long, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _split_fns()["walk"](
            *[t.data_ptr() for t in (st.pn, st.pw, st.pt, st.nn, order,
                                     *outs)], B, ncap, split.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"pk_consensus_split_launch failed: CUDA error "
                           f"{rc}")
    torch.cuda.synchronize(dev)
    return outs, split.cpu().numpy()


def summarize(cyc, parts, per, unit: str) -> dict:
    """The slowest block's cycles and us per part, the blocks' mean share
    per part, and `per` (the work units of each block, for the part they
    divide: {part: units}) as cycles and ns a unit over the blocks."""
    total = cyc.sum(1).astype(np.float64)
    slow = int(np.argmax(total))
    share = (cyc / np.maximum(total, 1)[:, None]).mean(0)
    res = {"slowest_block": slow,
           "slowest_us": float(total[slow] / SM_HZ * 1e6),
           "parts": {p: {"slowest_cycles": int(cyc[slow, k]),
                         "slowest_us": float(cyc[slow, k] / SM_HZ * 1e6),
                         "mean_share": float(share[k])}
                     for k, p in enumerate(parts)}}
    for p, units in per.items():
        k = parts.index(p)
        u = np.maximum(units.astype(np.float64), 1)
        c = float(cyc[slow, k] / u[slow])
        res[f"cycles_per_{unit}"] = c
        res[f"ns_per_{unit}"] = c / SM_HZ * 1e9
        res[f"mean_cycles_per_{unit}"] = float((cyc[:, k] / u).mean())
    return res


def measure(name: str, dev, reps: int) -> dict:
    st, seq, slen = capture(name, dev)
    steps = kahn_work(st.pn, st.gm, st.nn)[0]
    nn = st.nn.cpu().numpy()
    res = {"workload": name, "B": int(st.nn.shape[0]),
           "ncap": int(st.gm.shape[1]), "kahn_steps_max": int(steps.max()),
           "nn_max": int(nn.max())}
    want_ops = pfk.round_prep_cuda(st, seq, slen)
    want_order = pfk.toposort_cuda(st.pn, st.gm, st.nn)
    want_walk = pfk.consensus_cuda(st.pn, st.pw, st.pt, st.nn,
                                   want_order[0])
    for key, run, want, fn, parts, per, unit in (
            ("K6", lambda: split_prep(st, seq, slen, False),
             (*want_ops[0], want_ops[1]),
             lambda: pfk.round_prep_cuda(st, seq, slen), PREP_PARTS,
             {"kahn steps": steps}, "step"),
            ("K6 order", lambda: split_prep(st, seq, slen, True), want_order,
             lambda: pfk.toposort_cuda(st.pn, st.gm, st.nn), PREP_PARTS,
             {"kahn steps": steps}, "step"),
            ("K7", lambda: split_consensus(st, want_order[0]), want_walk,
             lambda: pfk.consensus_cuda(st.pn, st.pw, st.pt, st.nn,
                                        want_order[0]), CONSENSUS_PARTS,
             {"score pass": nn}, "rank")):
        got, cyc = run()
        if any(not torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"{name} {key}: the stamped build's outputs "
                               "differ from the kernel's")
        r = summarize(cyc[:, :len(parts)], parts, per, unit)
        if unit == "step":
            slow = r["slowest_block"]
            r["step_parts"] = {
                p: float(cyc[slow, len(parts) + k] / max(int(steps[slow]), 1))
                for k, p in enumerate(STEP_PARTS)}
        r["kernel_ms"] = time_call(fn, dev, reps, queued=True)
        r["stamped_ms"] = time_call(run, dev, 3, queued=False)
        res[key] = r
        print(f"[{name}] {key} B={res['B']} ncap={res['ncap']}: kernel "
              f"{r['kernel_ms']:.4f} ms, stamped build {r['stamped_ms']:.4f} "
              f"ms; slowest block {r['slowest_us']:.2f} us: " + ", ".join(
                  f"{p} {v['slowest_us']:.2f} us ({v['mean_share'] * 100:.1f}"
                  f" % mean share)" for p, v in r["parts"].items())
              + f"; {r[f'ns_per_{unit}']:.1f} ns a {unit} (slowest block), "
              f"{r[f'mean_cycles_per_{unit}']:.0f} cycles a {unit} (mean)"
              + ("; cycles a step (slowest block): " + ", ".join(
                  f"{p} {c:.0f}" for p, c in r["step_parts"].items())
                 if "step_parts" in r else ""), flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", default=list(WORKLOADS))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}", flush=True)
    out = {w: measure(w, dev, args.reps) for w in args.workload}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
