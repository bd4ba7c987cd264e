"""The fused `pk` POA MSA build on one device (counterpart of the `pk`
engine of svscope_tpu/ops/poa_fused.py).

The per-round device path (ops/poa_batch.py) sends every graph to the host
each round: C++ pack, copies, C++ fuse.  Here the graphs stay on the device
for the whole build.  Each read round of a window batch is:

  1. `pk_round_prep` (torch ops): the canonical group-aware Kahn order
     (`toposort`), the rank-space view of every graph (chars, preds with
     empty slots copied from slot 0, sinks, pre-round column ids) and the
     read staged for the aligner;
  2. K3 (`poa_fused_kernel.align_tb`): the DP and the traceback;
  3. K4 or K5 (`poa_fused_kernel.fusion`): the alignment fused into the
     graph state in place, and the read's node path.

The host drives the round loop up to the batch's largest read count; state
stays on the device.  After the last round: one more `toposort`, the
heaviest-bundle `consensus_walk`, one copy to the host, and `emit_window`
(numpy) turns each window's state into (consensus, msa_rows).  Results are
identical to ops/poa.poa and the C++ engine (the same scoring, the same
group-Kahn order, the same fusion rules and consensus tie-breaks).

Windows the device build cannot hold go to the host C++ engine, as in the
JAX package: a graph that outgrows its node bucket, gets a node with more
than 8 in-edges or a cycle (the overflow flag), a non-ACGTN base, or a
window past the bucket ladders.  `COUNTS["fallbacks"]` counts them.

Not ported (the JAX package's XLA engines and TPU plumbing): the non-pk
XLA build (`_build_batch_impl`, `_fuse_alignment`), the per-round Pallas
engine (`_pallas_align_round`), the mesh branch of `_dispatch_build`, the
probe knobs, the 64-window chunk cap and the 8-window batch padding.
"""
from __future__ import annotations

import logging
import threading
import time

import numpy as np
import torch

from .poa_device import MAX_PREDS
from .poa_fused_kernel import ALPHA5, GraphState, align_tb, fusion
from ..utils.device import resolve_device

log = logging.getLogger("svscope_tpu_torch.poa_fused")

CODE_OF = np.full(256, 255, np.uint8)
for _i, _b in enumerate(b"ACGTN"):
    CODE_OF[_b] = _i
DECODE = np.frombuffer(b"ACGTN", np.uint8)
BIG = 1 << 30
R_LADDER = (4, 8, 16, 32, 64, 128, 256, 512)
N_LADDER = (128, 256, 512, 1024, 2048, 3072)
L_LADDER = (64, 128, 256, 512, 1024, 2048)
# device bytes one chunk of windows may take (see window_bytes)
BUDGET_BYTES = 4 << 30
KAHN_CHECK_EVERY = 8     # Kahn steps between two host convergence checks
WALK_CHECK_EVERY = 64    # consensus walk steps between two checks

COUNTS = {"fallbacks": 0, "windows": 0, "chunks": 0, "rounds": 0,
          "kahn_steps": 0, "host_syncs": 0, "consensus_steps": 0}
_count_lock = threading.Lock()


def reset_counts() -> None:
    with _count_lock:
        for k in COUNTS:
            COUNTS[k] = 0


def _count(key: str, n: int = 1) -> None:
    with _count_lock:
        COUNTS[key] += n


class _Phases:
    """Seconds per build phase, taken only when a `timing` dict is given
    (it synchronises the device at every phase boundary)."""

    def __init__(self, timing, device):
        self.timing = timing
        self.cuda = torch.device(device).type == "cuda"
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        if self.timing is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.timing[name] = self.timing.get(name, 0.0) + now - self.t
        self.t = now


# ------------------------------------------------------------ toposort ----

def kahn_step(st, is_grp, ev, tails, heads, ids, it: int):
    """One group-Kahn step over a batch (svscope_tpu/ops/poa_fused.py
    `_toposort`'s loop body): place the maximal gid-consecutive run of
    ready column groups starting at the smallest ready gid.

    st = (grp_placed (B, ncap) bool, it_placed (B, ncap) int64); the
    edges (B, E) are tails/heads as column ids, ev their mask.  Per group,
    the min and max column id of its unplaced blockers are scatter
    reductions over the edge list.  Returns the new st and `place`, the
    groups placed by this step: once a window places nothing it never will
    again, and further steps leave its st as it is."""
    grp_placed, it_placed = st
    B, ncap = grp_placed.shape
    live = ev & ~grp_placed.gather(1, tails)
    bmax = torch.full((B, ncap), -1, dtype=torch.long, device=ids.device)
    bmax.scatter_reduce_(1, heads, torch.where(live, tails, -1), "amax")
    bmin = torch.full((B, ncap), BIG, dtype=torch.long, device=ids.device)
    bmin.scatter_reduce_(1, heads, torch.where(live, tails, BIG), "amin")
    unplaced = is_grp & ~grp_placed
    ready = unplaced & (bmax < 0)
    gstar = torch.where(ready, ids, BIG).amin(1, keepdim=True)
    cand = unplaced & ((bmax < 0) | ((bmin >= gstar) & (bmax < ids)))
    transparent = ~unplaced | (ids < gstar)
    first_fail = torch.where(cand | transparent, BIG, ids).amin(
        1, keepdim=True)
    place = unplaced & (ids >= gstar) & cand & (ids < first_fail)
    it_placed = torch.where(place, it, it_placed)
    return (grp_placed | place, it_placed), place


def toposort(pn, gm, nn, check_every: int = KAHN_CHECK_EVERY):
    """Group-aware Kahn order of every window's graph (`_toposort` of the
    JAX package: aligned columns emit adjacently, members in id order,
    the smallest ready column id first), batched over windows.

    pn (B, ncap, 8), gm (B, ncap), nn (B,).  Returns (order, rank, cyclic):
    order (B, ncap) int64 node ids in rank order (inactive ids trailing),
    rank its inverse, cyclic (B,) bool.  The loop runs `check_every` steps
    between host checks; the extra steps past a window's end are no-ops
    (see kahn_step), so the order does not depend on `check_every`."""
    B, ncap = gm.shape
    dev = gm.device
    ids = torch.arange(ncap, device=dev)
    gm64 = gm.long()
    active = ids < nn.long()[:, None]
    is_grp = active & (gm64 == ids)
    pnc = pn.long().clamp(0, ncap - 1).reshape(B, -1)
    tails = gm64.gather(1, pnc)                         # (B, ncap*8)
    heads = gm64.repeat_interleave(MAX_PREDS, dim=1)
    ev = ((pn >= 0) & active[:, :, None]).reshape(B, -1) & (tails != heads)
    st = (torch.zeros((B, ncap), dtype=torch.bool, device=dev),
          torch.full((B, ncap), BIG, dtype=torch.long, device=dev))
    it = 0
    while it < ncap:
        for _ in range(check_every):
            st, place = kahn_step(st, is_grp, ev, tails, heads, ids, it)
            it += 1
        _count("kahn_steps", check_every)
        _count("host_syncs")
        if not bool(place.any()):
            break
    grp_placed, it_g = st
    cyclic = (is_grp & ~grp_placed).any(1)
    it_node = it_g.gather(1, gm64)
    placed = active & grp_placed.gather(1, gm64) & (it_node < BIG)
    # lexicographic (step, column id), then node id (stable sort)
    key = torch.where(placed, it_node * ncap + gm64, BIG)
    order = torch.argsort(key, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(1, order, ids.expand(B, ncap))
    return order, rank, cyclic


# ---------------------------------------------------------- round prep ----

def pk_round_prep(st: GraphState, seq, slen):
    """Operands of one round's kernels (`_pk_round_prep` of the JAX
    package, without its TPU packing and its chain flags, which only the
    TPU kernel reads): returns (ops, cyclic) with ops = (charsr, sinksr,
    predsp, seqv, lb, nn_eff, gminr), int32: K3's six operands, then the
    fusion's gminr.

    seq (B, l_max) int32 base codes of the round's reads, slen (B,)."""
    B, ncap = st.ch.shape
    dev = st.ch.device
    l_max = seq.shape[1]
    i32 = torch.int32
    order, rank, cyclic = toposort(st.pn, st.gm, st.nn)
    pnc = st.pn.long().clamp(0, ncap - 1)
    rank_of = torch.where(st.pn >= 0,
                          rank.gather(1, pnc.reshape(B, -1)).reshape(
                              B, ncap, MAX_PREDS), -1)
    charsr = st.ch.gather(1, order)
    preds_r = rank_of.gather(1, order[:, :, None].expand(-1, -1, MAX_PREDS))
    gminr = st.gm.gather(1, order)
    ids = torch.arange(ncap, device=dev)
    valid = (st.pn >= 0) & (ids < st.nn[:, None])[:, :, None]
    outdeg = torch.zeros((B, ncap), dtype=i32, device=dev)
    outdeg.scatter_add_(1, pnc.reshape(B, -1), valid.reshape(B, -1).to(i32))
    sinksr = (outdeg == 0).to(i32).gather(1, order)
    nn_eff = torch.where(slen > 0, st.nn, 0).to(i32)
    predsp = torch.where(preds_r < 0, preds_r[:, :, :1], preds_r).to(i32)
    seqv = torch.full((B, l_max + 1), 255, dtype=i32, device=dev)
    seqv[:, 1:] = seq
    ops = (charsr.to(i32).contiguous(), sinksr.contiguous(),
           predsp.contiguous(), seqv, slen.to(i32).contiguous(),
           nn_eff.contiguous(), gminr.to(i32).contiguous())
    return ops, cyclic


# ----------------------------------------------------------- consensus ----

def consensus_walk(ch, pn, pw, pt, nn, order):
    """Heaviest-bundle consensus path of every window (`_consensus_walk`
    of the JAX package): scores in rank order, back from the first
    max-score node over best in-edges, forward over heaviest out-edges.

    Returns (back_buf (B, ncap), back_start (B,), fwd_buf (B, ncap),
    fwd_cnt (B,)), int64.  The score pass is sequential over the batch's
    largest node count, one step per rank (`COUNTS["consensus_steps"]`)."""
    B, ncap, P = pn.shape
    dev = pn.device
    i64 = torch.long
    ids = torch.arange(ncap, device=dev)
    slots = torch.arange(P, device=dev)
    bidx = torch.arange(B, device=dev)
    nn = nn.long()
    pn64, pw64, pt64 = pn.long(), pw.long(), pt.long()
    valid_e = (pn64 >= 0) & (ids < nn[:, None])[:, :, None]
    pnc = pn64.clamp(0, ncap - 1)
    score = torch.zeros((B, ncap), dtype=i64, device=dev)
    best_in = torch.full((B, ncap), -1, dtype=i64, device=dev)
    steps = int(nn.max()) if B else 0
    _count("host_syncs")
    _count("consensus_steps", steps)
    for i in range(steps):
        # (weight, tail score) lexicographic, first max slot; ranks past a
        # window's nn hold inactive ids, which keep score 0 / best_in -1
        v = order[:, i]
        vm = valid_e[bidx, v]
        sc = score.gather(1, pnc[bidx, v])
        key = torch.where(vm, pw64[bidx, v] * (1 << 21) + sc, -1)
        b = torch.where(key == key.amax(1, keepdim=True), slots, P).amin(1)
        has = vm.any(1)
        score[bidx, v] = torch.where(has, pw64[bidx, v, b] + sc[bidx, b], 0)
        best_in[bidx, v] = torch.where(has, pn64[bidx, v, b], -1)
    # first max-score node in rank order
    s_ord = torch.where(ids < nn[:, None], score.gather(1, order), -1)
    first = torch.where(s_ord == s_ord.amax(1, keepdim=True), ids,
                        ncap).amin(1)
    vmax = torch.where(nn > 0, order[bidx, first.clamp(max=ncap - 1)], -1)
    # per node, the best out-edge: max (weight, head score), then the
    # earliest created (smallest stamp)
    tails = pnc.reshape(B, -1)
    heads = ids.repeat_interleave(P).expand(B, -1)
    ve = valid_e.reshape(B, -1)
    key1 = torch.where(ve, pw64.reshape(B, -1) * (1 << 21)
                       + score.gather(1, heads), -1)
    mx = torch.full((B, ncap), -1, dtype=i64, device=dev)
    mx.scatter_reduce_(1, tails, key1, "amax")
    match = ve & (key1 == mx.gather(1, tails))
    tcap = ncap * P
    tmv = pt64.reshape(B, -1).clamp(0, tcap - 1)
    tmn = torch.full((B, ncap), BIG, dtype=i64, device=dev)
    tmn.scatter_reduce_(1, tails, torch.where(match, tmv, BIG), "amin")
    time_head = torch.full((B, tcap + 1), -1, dtype=i64, device=dev)
    time_head.scatter_(1, torch.where(ve, tmv, tcap), heads)
    best_out = torch.where(tmn < BIG, time_head.gather(1, tmn.clamp(0, tcap)),
                           -1)

    # backward walk (includes vmax), buffer filled right to left; the
    # bound on idx and cnt is the JAX package's cycle safety net
    back = torch.full((B, ncap + 1), -1, dtype=i64, device=dev)
    v = vmax.clone()
    idx = torch.full((B,), ncap - 1, dtype=i64, device=dev)
    for step in range(ncap):
        act = (v >= 0) & (idx >= 0)
        if step % WALK_CHECK_EVERY == 0:
            _count("host_syncs")
            if not bool(act.any()):
                break
        back[bidx, torch.where(act, idx, ncap)] = v
        v = torch.where(act, best_in.gather(1, v.clamp(0, ncap - 1)[:, None])
                        [:, 0], v)
        idx = idx - act.to(i64)
    back_start = (idx + 1).clamp(min=0)
    fwd = torch.full((B, ncap + 1), -1, dtype=i64, device=dev)
    v = vmax.clone()
    cnt = torch.zeros((B,), dtype=i64, device=dev)
    for step in range(ncap):
        nv = best_out.gather(1, v.clamp(0, ncap - 1)[:, None])[:, 0]
        act = (v >= 0) & (cnt < ncap) & (nv >= 0)
        if step % WALK_CHECK_EVERY == 0:
            _count("host_syncs")
            if not bool(act.any()):
                break
        fwd[bidx, torch.where(act, cnt, ncap)] = nv
        v = torch.where(act, nv, v)
        cnt = cnt + act.to(i64)
    return back[:, :ncap], back_start, fwd[:, :ncap], cnt


# --------------------------------------------------------------- build ----

def build_batch_pk(seqs, lens, n_seqs, *, ncap: int, device="cuda",
                   round_hook=None, timing=None) -> dict:
    """Whole MSA build of a window batch on `device`.

    seqs (B, R, l_max) uint8 base codes, lens (B, R), n_seqs (B,): numpy.
    Returns numpy arrays: ch, gm, nn, path (B, R, l_max), order,
    back_buf, back_start, fwd_buf, fwd_cnt, overflow (B,) bool.

    round_hook(r, ops, state, an, asx, ke), when given, is called after
    K3 and before the fusion of round r (it sees the real operands of
    both kernels); `timing`, when a dict, gets seconds per phase (the
    device is synchronised at every phase boundary)."""
    dev = resolve_device(device)
    B, R, l_max = seqs.shape
    ph = _Phases(timing, dev)
    seqs_d = torch.from_numpy(np.ascontiguousarray(seqs)).to(dev)
    lens_d = torch.from_numpy(np.ascontiguousarray(lens, np.int32)).to(dev)
    st = GraphState.empty(B, ncap, dev)
    path = torch.full((B, R, l_max), -1, dtype=torch.int32, device=dev)
    rounds = int(np.max(n_seqs)) if B else 0
    ph.mark("upload")
    for r in range(rounds):
        seq = seqs_d[:, r].to(torch.int32)
        slen = lens_d[:, r].contiguous()
        ops, cyclic = pk_round_prep(st, seq, slen)
        st.ovf |= cyclic.to(torch.int32)
        ph.mark("prep")
        *k3_ops, gminr = ops
        an, asx, ke = align_tb(*k3_ops)
        ph.mark("align")
        if round_hook is not None:
            round_hook(r, ops, st, an, asx, ke)
        path[:, r] = fusion(an, asx, ke, gminr, seq, st)
        ph.mark("fusion")
    _count("rounds", rounds)
    order, _rank, cyclic = toposort(st.pn, st.gm, st.nn)
    overflow = (st.ovf > 0) | cyclic
    walk = consensus_walk(st.ch, st.pn, st.pw, st.pt, st.nn, order)
    ph.mark("consensus")
    out = {"ch": st.ch, "gm": st.gm, "nn": st.nn, "path": path,
           "order": order, "back_buf": walk[0], "back_start": walk[1],
           "fwd_buf": walk[2], "fwd_cnt": walk[3], "overflow": overflow}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    ph.mark("download")
    return out


def emit_window(ch, gm, nn, path, order, back_buf, back_start, fwd_buf,
                fwd_cnt, n_seqs: int):
    """(consensus, msa_rows) from one fetched window state (numpy;
    `_emit_window` of the JAX package)."""
    n = int(nn)
    if n == 0:
        return "", ["" for _ in range(n_seqs)]
    order_n = order[:n]
    gm_ord = gm[order_n]
    uniq, first = np.unique(gm_ord, return_index=True)
    colrank = np.empty(len(uniq), np.int64)
    colrank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    col_of_gm = np.zeros(gm.shape[0], np.int64)
    col_of_gm[uniq] = colrank
    ncol = len(uniq)
    rows = []
    for r in range(n_seqs):
        rowbuf = np.full(ncol, ord("-"), np.uint8)
        p = path[r]
        nodes = p[p >= 0]
        rowbuf[col_of_gm[gm[nodes]]] = DECODE[ch[nodes]]
        rows.append(rowbuf.tobytes().decode())
    cons_nodes = np.concatenate([back_buf[int(back_start):],
                                 fwd_buf[:int(fwd_cnt)]])
    consensus = DECODE[ch[cons_nodes]].tobytes().decode()
    return consensus, rows


def estimate_nodes(seqs: list[str]) -> int:
    """Bucket guess for the final node count: backbone plus headroom for
    per-read novel bases.  Overflow falls back to the host engine, so the
    guess only trades a rare re-run against padding waste."""
    lmax = max(len(s) for s in seqs)
    return lmax + max(32, lmax // 2) + 4 * len(seqs)


def _bucket(x, ladder):
    for b in ladder:
        if x <= b:
            return b
    return None


def window_bytes(ncap: int, l_max: int, r_max: int) -> int:
    """Device bytes one window takes in a build: K3's H (int32) and
    direction (int8) planes, the graph state, the toposort edge lists and
    their temporaries (int64), the paths and the reads."""
    l1 = l_max + 1
    planes = (ncap + 1) * l1 * 4 + ncap * l1
    state = ncap * (3 * MAX_PREDS + ALPHA5 + 2) * 4
    edges = 6 * ncap * MAX_PREDS * 8
    return planes + state + edges + r_max * l_max * 5


def plan_buckets(seq_lists: list[list[str]]):
    """Bucket windows by (reads, length, node estimate) as the JAX package
    does.  Returns (out, groups, fallback, encoded): `out` holds the
    results of windows with nothing to align, `groups` maps (rb, lb, nb)
    to window indices, `fallback` lists the host engine's windows and
    `encoded` the base codes of the device's."""
    out: list = [None] * len(seq_lists)
    groups: dict[tuple[int, int, int], list[int]] = {}
    fallback: list[int] = []
    encoded: dict[int, list[np.ndarray]] = {}
    for i, seqs in enumerate(seq_lists):
        if not seqs or all(len(s) == 0 for s in seqs):
            out[i] = ("", ["" for _ in seqs])
            continue
        rb = _bucket(len(seqs), R_LADDER)
        lb = _bucket(max(len(s) for s in seqs), L_LADDER)
        nb = _bucket(estimate_nodes(seqs), N_LADDER)
        if rb is None or lb is None or nb is None:
            fallback.append(i)
            continue
        codes = [CODE_OF[np.frombuffer(s.encode(), np.uint8)] for s in seqs]
        if any((c == 255).any() for c in codes):    # non-ACGTN base
            fallback.append(i)
            continue
        encoded[i] = codes
        groups.setdefault((rb, lb, nb), []).append(i)
    return out, groups, fallback, encoded


def chunk_arrays(chunk: list[int], encoded, r_max: int, l_max: int):
    """(seqs (B, r_max, l_max) uint8, lens (B, r_max), n_seqs (B,)) of a
    chunk of bucketed windows."""
    seqs_a = np.zeros((len(chunk), r_max, l_max), np.uint8)
    lens_a = np.zeros((len(chunk), r_max), np.int32)
    nseq_a = np.zeros(len(chunk), np.int32)
    for bi, wi in enumerate(chunk):
        nseq_a[bi] = len(encoded[wi])
        for ri, c in enumerate(encoded[wi]):
            seqs_a[bi, ri, :len(c)] = c
            lens_a[bi, ri] = len(c)
    return seqs_a, lens_a, nseq_a


def fused_msa_batch(seq_lists: list[list[str]], device="cuda",
                    timing=None):
    """spoa-equivalent poa(seqs, 1) over many windows with the whole MSA
    build on `device` (K3 and K4/K5 on a CUDA device, their plain versions
    on the CPU).  Returns [(consensus, msa_rows)] per window, identical to
    ops.poa.poa and the host C++ engine."""
    from ..native.poa import poa_msa_batch_native, poa_native
    device = resolve_device(device)
    out, groups, fallback, encoded = plan_buckets(seq_lists)
    for (rb, lb, nb), idxs in groups.items():
        ncap = nb + 1
        bcap = max(1, BUDGET_BYTES // window_bytes(ncap, lb, rb))
        for off in range(0, len(idxs), bcap):
            chunk = idxs[off:off + bcap]
            seqs_a, lens_a, nseq_a = chunk_arrays(chunk, encoded, rb, lb)
            res = build_batch_pk(seqs_a, lens_a, nseq_a, ncap=ncap,
                                 device=device, timing=timing)
            _count("chunks")
            _count("windows", len(chunk))
            for bi, wi in enumerate(chunk):
                if res["overflow"][bi]:
                    fallback.append(wi)
                    continue
                out[wi] = emit_window(
                    res["ch"][bi], res["gm"][bi], res["nn"][bi],
                    res["path"][bi], res["order"][bi], res["back_buf"][bi],
                    res["back_start"][bi], res["fwd_buf"][bi],
                    res["fwd_cnt"][bi], len(seq_lists[wi]))
    if fallback:
        _count("fallbacks", len(fallback))
        log.info("fused POA: %d/%d windows go to the host C++ engine "
                 "(overflow, non-ACGTN base or past the buckets)",
                 len(fallback), len(seq_lists))
        if len(fallback) > 1:
            for i, r in zip(fallback, poa_msa_batch_native(
                    [seq_lists[i] for i in fallback])):
                out[i] = r
        else:
            out[fallback[0]] = poa_native(seq_lists[fallback[0]])
    return out
