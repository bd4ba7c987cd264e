"""The fused `pk` build's phases with the inputs already on the device
(counterpart of tools/probe/pk_phase_probe.py).

  1. RECORD: one real ops/poa_fused.build_batch_pk on bench windows (one
     bucket), its round hook cloning every round's pre-fusion graph state
     (the operands of each round are then exactly the build's own).
  2. REPLAY, three loops over the recorded rounds, every input on the
     device:
       glue   pk_round_prep (K6 on the card: the group-Kahn re-rank and
              the operands) on each recorded state;
       gA     glue + K3 (align_tb) on its operands;
       gAB    glue + K3 + K4/K5 (fusion), the state threaded through the
              rounds from an empty one, as the build runs them (K6 sets
              ovf; after each round the state must equal the next
              recorded one).
     Inside each gAB replay every K6, K3 and fusion call is a span on the
     device's clock (utils/spans: CUDA events around the call, read after
     the replay); the phase costs are those of the fastest gAB replay:
     K6, K3 and fusion the sums of their spans, "glue" the replay less the
     three (the host's issue and the gaps between the launches). The JAX
     probe takes the costs as differences of replays (K3 = gA - glue,
     fusion = gAB - gA); replays timed one by one spread by more than K3
     and fusion take, so the differences are printed beside the spans
     only where they exceed the spread of the replays they compare (at
     least two turns), and are "unresolved" otherwise. Nothing in a round
     reads the device back (K6 runs the whole Kahn loop), so a replay's
     calls are all queued before it ends. Each replay is timed alone,
     events around the whole loop after a synchronise, the three in
     turns, `--reps` turns.
Compare the sum with chip_smoke.py's bench256-fused-split (the same batch
size, its phases synchronised at every boundary) and with the full build
timed here.

    python -m svscope_tpu_torch.tools.probe.pk_phase_probe [--b 128]
        [--reads 24] [--reps 3] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

PHASES = ("glue", "gA", "gAB")


def bench_arrays(b: int, n_reads: int):
    """(seqs, lens, n_seqs, ncap) of b bench windows, one pk bucket."""
    from ...ops.poa_fused import chunk_arrays, plan_buckets
    from ..workloads import make_window_payloads
    wins = make_window_payloads(b, np.random.default_rng(0), n_reads=n_reads)
    _out, groups, fallback, encoded = plan_buckets([w.sequences
                                                    for w in wins])
    if len(groups) != 1 or fallback:
        raise RuntimeError(f"expected one pk bucket, got {list(groups)} "
                           f"and {len(fallback)} host windows")
    (rb, lb, nb), idxs = next(iter(groups.items()))
    return (*chunk_arrays(idxs, encoded, rb, lb), nb + 1)


def record(seqs, lens, n_seqs, ncap: int, dev):
    """Every round's pre-fusion state of one real build (clones), the
    round operands' sequence tensors and the build's outputs (on the
    device)."""
    from ...ops.poa_fused import build_batch_pk
    states = []

    def hook(r, ops, st, an, asx, ke):
        states.append(st.clone())

    out = build_batch_pk(seqs, lens, n_seqs, ncap=ncap, device=dev,
                         round_hook=hook, fetch=False)
    seqs_d = torch.from_numpy(np.ascontiguousarray(
        np.transpose(seqs, (1, 0, 2)), np.int32)).to(dev)
    lens_d = torch.from_numpy(np.ascontiguousarray(
        np.transpose(lens), np.int32)).to(dev)
    rounds = [(seqs_d[r], lens_d[r]) for r in range(len(states))]
    return states, rounds, out


def replay(phase: str, states, rounds, empty, spans=None):
    """One replay loop (PHASES); returns the threaded state for gAB.
    spans (utils/spans.Spans): each K6, K3 and fusion call marked as a
    span."""
    from ...ops.poa_fused import pk_round_prep
    from ...ops.poa_fused_kernel import align_tb, fusion
    st = empty
    for r, (seq, slen) in enumerate(rounds):
        src = st if phase == "gAB" else states[r]
        m = spans.mark(seq.device) if spans else None
        ops, _cyclic = pk_round_prep(src, seq, slen,
                                     update_ovf=phase == "gAB")
        if spans:
            spans.add("K6", m, seq.device)
        if phase == "glue":
            continue
        *k3_ops, gminr = ops
        m = spans.mark(seq.device) if spans else None
        an, asx, ke = align_tb(*k3_ops)
        if spans:
            spans.add("K3", m, seq.device)
        if phase == "gA":
            continue
        m = spans.mark(seq.device) if spans else None
        fusion(an, asx, ke, gminr, seq, st)
        if spans:
            spans.add("fusion", m, seq.device)
    return st


def timed_replay(phase: str, states, rounds, empty, dev):
    """ms of one replay on the device's clock (the device synchronised
    first, the fresh gAB state made before the start) and, for gAB, the
    ms of its K6, K3 and fusion spans: ({"replay", "K6", "K3",
    "fusion"})."""
    from ...utils.spans import Spans
    st = empty() if phase == "gAB" else None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    calls, whole = Spans(), Spans()
    m = whole.mark(dev)
    replay(phase, states, rounds, st, calls if phase == "gAB" else None)
    whole.add("replay", m, dev)
    secs = calls.read(whole.read({}))
    return {k: v * 1e3 for k, v in secs.items()}


def resolved(a: list, b: list):
    """min(b) - min(a) where it exceeds the spread of both trial lists
    (two or more each), else None."""
    spread = max(max(a) - min(a), max(b) - min(b))
    d = min(b) - min(a)
    return d if len(a) > 1 and len(b) > 1 and d > spread else None


def check_threaded(states, rounds, st, out) -> None:
    """gAB's state after each round equals the next recorded state (but
    ovf, which the build ORs with the next round's cycle flags before the
    hook sees it), and after the last round the build's graph (ch, gm,
    nn); raises otherwise."""
    for r in range(len(rounds)):
        replay("gAB", None, rounds[r:r + 1], st)
        want = states[r + 1].tensors()[:-1] if r + 1 < len(states) else \
            [out["ch"], out["gm"], out["nn"]]
        got = st.tensors()[:-1] if r + 1 < len(states) else \
            [st.ch, st.gm, st.nn]
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            raise RuntimeError(f"the threaded replay's state after round "
                               f"{r + 1} differs from the build's")


def run(b: int = 128, reads: int = 24, reps: int = 3, device="cuda",
        log=print) -> dict:
    """ms of the full build and of each replay, the phase costs (K6, K3,
    fusion from the fastest gAB replay's spans, glue its rest), the
    differences of the replays where they resolve, and the build's
    counts."""
    from ...ops import poa_fused as tpf
    from ...ops.poa_fused import build_batch_pk
    from ...ops.poa_fused_kernel import GraphState
    from ...utils.device import resolve_device
    from ..timing import time_call
    dev = resolve_device(device)
    seqs, lens, n_seqs, ncap = bench_arrays(b, reads)
    full_ms = time_call(lambda: build_batch_pk(seqs, lens, n_seqs,
                                               ncap=ncap, device=dev),
                        dev, reps, queued=False)
    tpf.reset_counts()
    states, rounds, out = record(seqs, lens, n_seqs, ncap, dev)
    counts = dict(tpf.COUNTS)
    log(f"[record] B={b} reads={reads} ncap={ncap} l_max={seqs.shape[2]}: "
        f"{len(rounds)} rounds, states "
        f"{sum(sum(t.numel() * 4 for t in s.tensors()) for s in states) / 1e6:.0f}"
        f" MB on {dev}; counts {counts}")

    def empty():
        return GraphState.empty(b, ncap, dev)
    check_threaded(states, rounds, empty(), out)
    # the phases in turns (glue gA gAB, then gAB gA glue, ...), each
    # replay timed alone
    trials = {p: [] for p in PHASES}
    spans = []
    for turn in range(reps):
        for phase in PHASES if turn % 2 == 0 else PHASES[::-1]:
            t = timed_replay(phase, states, rounds, empty, dev)
            trials[phase].append(t["replay"])
            if phase == "gAB":
                spans.append(t)
    ms = {p: min(v) for p, v in trials.items()}
    best = min(spans, key=lambda t: t["replay"])
    costs = {"glue": best["replay"] - best["K6"] - best["K3"]
             - best["fusion"], "K6": best["K6"], "K3": best["K3"],
             "fusion": best["fusion"]}
    diffs = {"K3": resolved(trials["glue"], trials["gA"]),
             "fusion": resolved(trials["gA"], trials["gAB"])}
    log("[replays] " + ", ".join(
        f"{p} {[round(t, 3) for t in v]}" for p, v in trials.items())
        + " ms")
    log(f"[phases] rounds={len(rounds)}, the fastest gAB replay "
        f"{best['replay']:.3f} ms: K6 {costs['K6']:.3f} ms, K3 "
        f"{costs['K3']:.3f} ms and fusion {costs['fusion']:.3f} ms (their "
        f"calls' spans), glue {costs['glue']:.3f} ms (the rest); the full "
        f"build "
        f"{full_ms:.3f} ms adds the upload, the final toposort, the "
        f"consensus walk and the download")
    log("[differences] " + ", ".join(
        f"{k} " + (f"{v:.3f} ms" if v is not None else
                   "unresolved (below the replays' spread)")
        for k, v in diffs.items()))
    log("[share] " + ", ".join(f"{k} {100 * v / best['replay']:.1f} %"
                                for k, v in costs.items()))
    return {"b": b, "reads": reads, "ncap": ncap, "rounds": len(rounds),
            "full_ms": full_ms, "replay_ms": ms, "replay_trials": trials,
            "phase_ms": costs, "diff_ms": diffs, "counts": counts}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b", type=int, default=128)
    ap.add_argument("--reads", type=int, default=24)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    return run(args.b, args.reads, args.reps, args.device)


if __name__ == "__main__":
    main()
