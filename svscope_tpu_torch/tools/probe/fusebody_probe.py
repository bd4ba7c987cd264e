"""Fusion-body probe: K4's per-entry cost on real graph states (counterpart
of tools/probe/fusebody_probe.py, kernel csrc/probe_fusebody.cu).

`build_states()` replays the bench workload's first 8 windows through the
port's NumPy oracle (ops/poa.py) up to round 13 and returns the JAX
probe's seven arrays: the lane-structured graph state gs (8, NCAP, 128),
the round-13 alignments an/asx (OUT_LEN, 8), the 14th reads' base codes
seqs5 (8, L_MAX), the topological order, the column id by rank gminr and
the node counts nn (8, 1).  `device_inputs` turns them into K4's layout: a
GraphState (graph_state_from_jax) and (8, OUT_LEN) alignments.

`fusebody(variant, ...)` runs the probe's fusion body over the last 480
entries (from OUT_LEN - 480) of every window, one thread per window on the
card and the plain torch version (`fusebody_reference`) on CPU tensors,
and returns what the JAX variant returns: (nn_out (8,), the graph state,
updated in place, path (8, L_MAX)).  Variants:

  full        the whole body
  nowrite     every graph-state write dropped (reads + logic)
  noread      the state reads replaced by constants (logic + edge writes)
  logic       no state traffic at all
  empty       a counter-only loop
  scal16      a counter plus one scalar read per step
  noveccarry  the counter loop; nn_out gets the step count

`LAUNCHES` counts kernel launches per variant; `variant_bytes` is the
bytes a variant must move, for its bound.

    python -m svscope_tpu_torch.tools.probe.fusebody_probe [variants ...]
        [--device cuda|cpu] [--reps 10]
"""
from __future__ import annotations

import argparse
import ctypes
import threading

import numpy as np
import torch

from ...ops.poa import PoaGraph, _fused_path
from ...ops.poa_align import check_tensor
from ...ops.poa_fused_kernel import (ALPHA5, GS_LANES, L_CH, L_GC, L_GM,
                                     L_PN, L_PT, L_PW, GraphState,
                                     graph_state_from_jax)
from ...ops.poa_device import MAX_PREDS
from ...utils.cuda_build import load_cuda_lib
from ...utils.device import resolve_device
from ..timing import time_each
from ..workloads import make_window_payloads

SOURCE = "probe_fusebody.cu"
VARIANTS = ("full", "nowrite", "noread", "logic", "empty", "scal16",
            "noveccarry")
W = 8                   # windows
NCAP = 1025
L_MAX = 512
OUT_LEN = NCAP - 1 + L_MAX
STEPS = 480             # entries fused per window, from OUT_LEN - STEPS
ROUND_READS = 13        # reads in each graph; the 14th read is fused

LAUNCHES = {v: 0 for v in VARIANTS}
_count_lock = threading.Lock()
_fns: dict[str, object] = {}


def reset_launches() -> None:
    with _count_lock:
        for v in LAUNCHES:
            LAUNCHES[v] = 0


def build_states():
    """Real mid-build graph states and round-13 alignments from the port's
    NumPy oracle: (gs, an, asx, seqs5, order, gminr, nn), the JAX probe's
    arrays (int32, its layouts)."""
    wins = make_window_payloads(W, np.random.default_rng(0))
    jobs = [w.sequences for w in wins]
    gs = np.zeros((W, NCAP, GS_LANES), np.int32)
    gs[..., L_PN:L_PN + 8] = -1
    gs[..., L_GC:L_GC + 8] = -1
    gs[..., L_GM] = np.arange(NCAP)
    an = np.full((OUT_LEN, W), -2, np.int32)
    asx = np.full((OUT_LEN, W), -2, np.int32)
    seqs5 = np.zeros((W, L_MAX), np.int32)
    order = np.zeros((W, NCAP), np.int32)
    gminr = np.zeros((W, NCAP), np.int32)
    nn = np.zeros((W, 1), np.int32)
    code = {c: i for i, c in enumerate("ACGTN")}
    for w, seqs in enumerate(jobs):
        g = PoaGraph()
        for s in seqs[:ROUND_READS]:
            if not s or g.n_nodes() == 0:
                prev = -1
                for ch in s:
                    cur = g._add_node(ch)
                    if prev >= 0:
                        g._add_edge(prev, cur)
                    prev = cur
                g.seq_begin.append(0)
            else:
                _fused_path(g, g.align(s), s)
        n = g.n_nodes()
        nn[w, 0] = n
        grp, _ = g._columns()
        colmin = {}
        for v in range(n):
            colmin[grp[v]] = min(colmin.get(grp[v], v), v)
        for v in range(n):
            gs[w, v, L_CH] = code[g.chars[v]]
            gs[w, v, L_GM] = colmin[grp[v]]
        for v in range(n):          # gchar: one member per base per column
            gs[w, colmin[grp[v]], L_GC + code[g.chars[v]]] = v
        for v in range(n):
            for k, p in enumerate(g.in_edges[v][:8]):
                gs[w, v, L_PN + k] = p
                gs[w, v, L_PW + k] = g.edge_w.get((p, v), 1)
                gs[w, v, L_PT + k] = k
        topo = g.topo_order()
        rank = {v: i for i, v in enumerate(topo)}
        for i, v in enumerate(topo):
            order[w, i] = v
            gminr[w, i] = colmin[grp[v]]
        s13 = jobs[w][ROUND_READS]
        for i, ch in enumerate(s13[:L_MAX]):
            seqs5[w, i] = code[ch]
        aln = g.align(s13)
        k0 = OUT_LEN - len(aln)
        for k, (node, spos) in enumerate(aln):
            an[k0 + k, w] = rank[node] if node >= 0 else -1
            asx[k0 + k, w] = spos
    return gs, an, asx, seqs5, order, gminr, nn


def device_inputs(states, device="cpu"):
    """build_states()'s arrays in K4's layout on `device`: (an, asx (W,
    OUT_LEN), seqs5 (W, L_MAX), gminr (W, NCAP), nn (W,), GraphState)."""
    gs, an, asx, seqs5, _order, gminr, nn = states

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    zeros = np.zeros(len(nn), np.int32)
    st = graph_state_from_jax(gs, nn, zeros, zeros, device)
    return (t(an.T), t(asx.T), t(seqs5), t(gminr), t(nn.reshape(-1)), st)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")


def fusebody_reference(variant, an, asx, seqs5, gminr, nn, st: GraphState,
                       k0: int):
    """Plain torch version: every window at once, one entry per step.
    Updates `st` in place; returns (nn_out (B,), path (B, l_max))."""
    _check_variant(variant)
    B, out_len = an.shape
    ncap = st.ch.shape[1]
    n_max = gminr.shape[1]
    l_max = seqs5.shape[1]
    dev = an.device
    path = torch.full((B, l_max + 1), 0 if variant == "noveccarry" else -1,
                      dtype=torch.int32, device=dev)
    if variant in ("empty", "scal16", "noveccarry"):
        # counter loops: no state or path traffic
        nn_out = torch.full_like(nn, out_len - k0) \
            if variant == "noveccarry" else nn.clone()
        return nn_out, path[:, :l_max].contiguous()
    trash, dump = ncap - 1, ncap
    reads = variant in ("full", "nowrite")

    def pad(t):
        extra = torch.zeros((B, 1) + tuple(t.shape[2:]), dtype=t.dtype,
                            device=dev)
        return torch.cat([t, extra], dim=1)
    pn, pw, pt, gc, ch, gm = (pad(t) for t in (st.pn, st.pw, st.pt, st.gc,
                                               st.ch, st.gm))
    w = torch.arange(B, device=dev)
    slots8 = torch.arange(MAX_PREDS, device=dev)
    nnc = nn.long()
    tc = torch.zeros(B, dtype=torch.long, device=dev)
    prev = torch.full((B,), -1, dtype=torch.long, device=dev)
    for k in range(k0, out_len):
        if variant == "logic":
            aspv = torch.full((B,), k % 400, dtype=torch.long, device=dev)
            anv = torch.full((B,), k % 700, dtype=torch.long, device=dev)
        else:
            aspv, anv = asx[:, k].long(), an[:, k].long()
        valid = aspv >= 0
        sposc = aspv.clamp(0, l_max - 1)
        c5 = seqs5[w, sposc].long()
        has_node = valid & (anv >= 0)
        anc = anv.clamp(0, n_max - 1)
        gid_old = gminr[w, anc].long()
        if reads:
            grow = torch.where(has_node, gid_old, 0).clamp(0, trash)
            pre = torch.where(has_node, gc[w, grow, c5].long(), -1)
        else:
            pre = torch.where(has_node & (c5 > 2), anc, -1)
        creator = valid & (pre < 0)
        newid = nnc.clamp(max=trash)
        cur = torch.where(creator, newid, pre)
        gid = torch.where(has_node, gid_old, newid)
        if variant == "full":           # the masked-lane row write
            crow = torch.where(creator, newid, dump)
            ch[w, crow] = c5.to(torch.int32)
            gm[w, crow] = gid.to(torch.int32)
            gc[w, torch.where(creator & (gid == newid), newid, dump),
               c5] = newid.to(torch.int32)
        nnc = (nnc + creator.long()).clamp(max=trash)
        add_e = valid & (prev >= 0)
        curc = cur.clamp(0, trash)
        if reads:
            prow = pn[w, curc].long()
            ehit = prow == prev[:, None]
            has_e = add_e & ehit.any(1)
            eslot = torch.where(ehit, slots8, MAX_PREDS).amin(1).clamp(
                max=MAX_PREDS - 1)
            nvalid = (prow >= 0).sum(1)
            newe = add_e & ~has_e & (nvalid < MAX_PREDS)
            slot = torch.where(has_e, eslot, nvalid.clamp(max=MAX_PREDS - 1))
            w_old = pw[w, curc, slot].long()
        else:
            has_e = add_e & (c5 < 3)
            slot = c5.clamp(0, MAX_PREDS - 1)
            w_old = tc
            newe = add_e & ~has_e
        if variant in ("full", "noread"):
            erow = torch.where(has_e | newe, curc, dump)
            pn[w, erow, slot] = prev.to(torch.int32)
            pw[w, erow, slot] = torch.where(has_e, w_old + 1, 1).to(
                torch.int32)
            pt[w, torch.where(newe, curc, dump), slot] = tc.to(torch.int32)
        tc = tc + newe.long()
        path[w, torch.where(valid, sposc, l_max)] = cur.to(torch.int32)
        prev = torch.where(valid, cur, prev)
    for name, t in (("pn", pn), ("pw", pw), ("pt", pt), ("gc", gc),
                    ("ch", ch), ("gm", gm)):
        getattr(st, name).copy_(t[:, :ncap])
    return nnc.to(torch.int32), path[:, :l_max].contiguous()


def _kernel():
    if "k" not in _fns:
        fn = load_cuda_lib(SOURCE).fusebody_probe_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 13 + [ci] * 7 + [vp]
        fn.restype = ci
        _fns["k"] = fn
    return _fns["k"]


def fusebody_cuda(variant, an, asx, seqs5, gminr, nn, st: GraphState,
                  k0: int):
    """Launch the probe kernel of `variant` on CUDA tensors (see
    fusebody_reference)."""
    _check_variant(variant)
    dev = an.device
    if dev.type != "cuda":
        raise ValueError(f"fusebody_cuda needs CUDA tensors, got {dev}")
    B, out_len = an.shape
    ncap = st.ch.shape[1]
    n_max = gminr.shape[1]
    l_max = seqs5.shape[1]
    i32 = torch.int32
    for name, t, shape in (("an", an, (B, out_len)),
                           ("asx", asx, (B, out_len)),
                           ("seqs5", seqs5, (B, l_max)),
                           ("gminr", gminr, (B, n_max)), ("nn", nn, (B,)),
                           ("pn", st.pn, (B, ncap, MAX_PREDS)),
                           ("pw", st.pw, (B, ncap, MAX_PREDS)),
                           ("pt", st.pt, (B, ncap, MAX_PREDS)),
                           ("gc", st.gc, (B, ncap, ALPHA5)),
                           ("ch", st.ch, (B, ncap)), ("gm", st.gm, (B, ncap))):
        check_tensor(name, t, i32, shape, dev)
    if not 0 <= k0 <= out_len:
        raise ValueError(f"k0 {k0} outside 0..{out_len}")
    nn_out = torch.empty((B,), dtype=i32, device=dev)
    path = torch.empty((B, l_max), dtype=i32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(an.data_ptr(), asx.data_ptr(), seqs5.data_ptr(),
                gminr.data_ptr(), nn.data_ptr(), st.pn.data_ptr(),
                st.pw.data_ptr(), st.pt.data_ptr(), st.gc.data_ptr(),
                st.ch.data_ptr(), st.gm.data_ptr(), nn_out.data_ptr(),
                path.data_ptr(), B, ncap, n_max, l_max, out_len, k0,
                VARIANTS.index(variant), stream)
    if rc != 0:
        raise RuntimeError(f"fusebody_probe_launch failed: CUDA error {rc} "
                           f"(variant {variant}, B={B})")
    with _count_lock:
        LAUNCHES[variant] += 1
    return nn_out, path


def fusebody(variant, an, asx, seqs5, gminr, nn, st: GraphState,
             k0: int = OUT_LEN - STEPS):
    """(nn_out, path) of `variant`, `st` updated in place: the kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if an.device.type == "cuda":
        return fusebody_cuda(variant, an, asx, seqs5, gminr, nn, st, k0)
    if an.device.type == "cpu":
        return fusebody_reference(variant, an, asx, seqs5, gminr, nn, st, k0)
    raise ValueError(f"unsupported device {an.device}")


# int32 reads per entry: an + asx (2), the read's base (1), gminr (1), the
# column's gchar member (1), the target's pred row (8) and its weight (1)
ENTRY_READS = {"full": 14, "nowrite": 14, "noread": 4, "logic": 2,
               "scal16": 1, "empty": 0, "noveccarry": 0}


def variant_bytes(variant, before: GraphState, after: GraphState,
                  k0: int = OUT_LEN - STEPS) -> int:
    """Bytes `variant` must move over entries k0 .. OUT_LEN-1 of every
    window: ENTRY_READS per entry, the state elements that a call changed
    (`before` against `after` it), nn in, and nn_out and path out."""
    _check_variant(variant)
    B = before.ch.shape[0]
    changed = sum(int((a != b).sum()) for a, b in
                  zip(before.tensors(), after.tensors()))
    return 4 * (B * (OUT_LEN - k0) * ENTRY_READS[variant] + changed
                + B * (L_MAX + 2))


def main(argv=None) -> dict:
    """Run the probe; returns {variant: {ms, plain_ms, max_abs_err}}.  Each
    variant's first call is checked against the plain version (nn_out,
    path and the whole graph state); a difference raises.  Every call
    starts from a fresh copy of the replayed state, made outside the
    timing on the card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    *ops, st0 = device_inputs(build_states(), dev)
    print(f"fusion-body probe on {dev}: {W} windows, {STEPS} entries each "
          "from round 13" + ("" if dev.type == "cuda" else
                             " (cpu: the plain version)"), flush=True)
    res = {}
    for v in args.variants:
        st = st0.clone()
        got = [*fusebody(v, *ops, st), *st.tensors()]
        sp = st0.clone()
        want = [*fusebody_reference(v, *ops, sp, OUT_LEN - STEPS),
                *sp.tensors()]
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, want))
        if err:
            raise RuntimeError(f"fusion-body probe {v}: kernel != plain "
                               f"(max abs error {err})")
        fresh = lambda: (*ops, st0.clone())      # noqa: E731
        ms = time_each(fresh, lambda *a: fusebody(v, *a), dev, args.reps,
                       queued=True)
        p_ms = time_each(fresh, lambda *a: fusebody_reference(
            v, *a, OUT_LEN - STEPS), dev, 1, queued=False)
        res[v] = {"ms": ms, "plain_ms": p_ms, "max_abs_err": err}
        print(f"{v:10s}: {ms:.4f} ms/call, {ms * 1e3 / STEPS:.4f} us/step "
              f"(lockstep over {W} windows); plain {p_ms:.4f} ms/call; "
              "kernel == plain", flush=True)
    return res


if __name__ == "__main__":
    main()
