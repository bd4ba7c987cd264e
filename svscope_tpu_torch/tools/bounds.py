"""The H100 bound of a kernel: the least time the card could take for the
same work, the larger of moving its bytes at the memory rate and doing its
integer operations at the integer rate. chip_smoke.py's "bound_ms" and
tools/roofline.py's table both come from here, so the two cannot disagree.

Rates of an H100 SXM at 700 W: HBM3 3.35 TB/s (data sheet); int32 64 lanes
per SM (half the 128 fp32 lanes behind the data sheet's 67 TFLOP/s) x 132
SMs x 1.98 GHz = 16.7e12 ops/s. Integer ops counted per DP cell: K2 11
(char compare, score select, 3 adds, 2 max, 2 tie compares, M and A adds);
K1 and K3 8 per (node, column) (score select, base, gap chain, direction)
plus 3 per (pred edge, column) (pred-row max, diag and up compares).
K1-int16's DP ops (max, add, compare, select on int16 values) run at the
packed s16x2 rate, two per int32 lane (VIMNMX.S16x2, the DPX
__viaddmax_s16x2 and __vimax3_s16x2 that the int16 probe checks). Bytes:
each input read once, each output written once; where the work depends on
the data, what these inputs need.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
INT16X2_OPS_PER_S = 2 * INT32_OPS_PER_S
K2_OPS_PER_CELL = 11
POA_OPS_PER_CELL = 8
POA_OPS_PER_EDGE_CELL = 3


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


def k1_bound(args, outs):
    """K1's bound on one call: args = (chars, preds, sinks, n_nodes, seqs,
    seq_lens) tensors, outs its outputs."""
    return bound(tensor_bytes(*args, *outs),
                 poa_ops(args[1], args[3], args[5]))


def k2_work(args, pairs):
    """(bytes, ops) of K2 on one bucket launch: args its padded input
    tensors, pairs the (a, b) strings; (score, matches, length) int32
    written per pair, K2_OPS_PER_CELL per cell of each pair's own
    lengths."""
    cells = sum(len(a) * len(b) for a, b in pairs)
    return tensor_bytes(*args) + 12 * len(pairs), cells * K2_OPS_PER_CELL


def k2_bound(args, pairs):
    """K2's bound on one bucket launch (k2_work)."""
    return bound(*k2_work(args, pairs))


def k2_bound_all(launches):
    """K2's bound over several bucket launches, [(args, pairs)] as
    k2_bound takes them: their bytes and ops summed."""
    work = [k2_work(args, pairs) for args, pairs in launches]
    return bound(sum(b for b, _ in work), sum(o for _, o in work))


def fusion_bound(an, asx, ke, gminr, seq5, st):
    """K4's and K5's bound on one round (data-dependent: what this round's
    in-place update must move): the window's entries (an, asx) and ke read
    once, a base per valid entry, a column id and a gc lookup per node
    entry, the pred row (32 bytes) of each valid entry that creates no
    node; the state elements the round changes, the path (B, l_max) and
    the counters written once.  Its integer work is a few ops per entry,
    below the bytes' time.  Runs the round on a clone of `st` (K4 on CUDA
    tensors, the plain version on CPU ones) to see what changes.  Returns
    (bound, live entries)."""
    import torch
    from ..ops import poa_fused_kernel as tpk
    after = st.clone()
    if an.is_cuda:
        tpk.fusion_cuda(an, asx, ke, gminr, seq5, after)
        torch.cuda.synchronize()
    else:
        tpk.fusion_reference(an, asx, ke, gminr, seq5, after)
    B, out_len = an.shape
    live = torch.arange(out_len, device=an.device)[None, :] > \
        ke.long()[:, None]
    valid = live & (asx >= 0)
    n_valid = int(valid.sum())
    n_new = int((after.nn.long() - st.nn.long()).sum())
    changed = sum(int((a != b).sum()) for a, b in
                  zip(st.tensors(), after.tensors()))
    nbytes = 8 * int(live.sum()) + 4 * B + 4 * n_valid \
        + 8 * int((valid & (an >= 0)).sum()) + 32 * max(n_valid - n_new, 0) \
        + 4 * changed + 4 * seq5.numel()
    return bound(nbytes, 0), int(live.sum())


# K6 and K7 (the pk build's group-Kahn re-rank and consensus walk):
# integer ops per live edge and per unplaced column of each Kahn step (the
# blocker min and max; the ready, candidate and run tests), per pred slot
# of the re-rank (the rank lookup, the slot-0 copy), per node of the sort
# (a compare per level), per pred slot of the score pass and of the best
# out-edge (the key, the max, the match, the stamp min).
KAHN_OPS_PER_LIVE_EDGE = 2
KAHN_OPS_PER_COLUMN = 4
RERANK_OPS_PER_SLOT = 2
WALK_OPS_PER_SLOT = 8


def kahn_work(pn, gm, nn):
    """Per window of a (pn, gm, nn) batch, the group-Kahn loop's work as
    this state needs it: (steps, live edges summed over the steps,
    unplaced columns summed over the steps), numpy int64 each.  A window
    runs steps until one places nothing or no column is left, as K6 does;
    the steps are the plain version's kahn_step."""
    import numpy as np
    import torch
    from ..ops.poa_fused import BIG, MAX_PREDS, kahn_step
    pn, gm, nn = (torch.as_tensor(x).cpu() for x in (pn, gm, nn))
    B, ncap = gm.shape
    ids = torch.arange(ncap)
    gm64 = gm.long()
    active = ids < nn.long()[:, None]
    is_grp = active & (gm64 == ids)
    tails = gm64.gather(1, pn.long().clamp(0, ncap - 1).reshape(B, -1))
    heads = gm64.repeat_interleave(MAX_PREDS, dim=1)
    ev = ((pn >= 0) & active[:, :, None]).reshape(B, -1) & (tails != heads)
    st = (torch.zeros((B, ncap), dtype=torch.bool),
          torch.full((B, ncap), BIG, dtype=torch.long))
    steps, edges, cols = (np.zeros(B, np.int64) for _ in range(3))
    running = (is_grp & ~st[0]).any(1)
    it = 0
    while bool(running.any()) and it < ncap:
        run = running.numpy()
        unplaced = is_grp & ~st[0]
        live = ev & ~st[0].gather(1, tails)
        steps += run
        edges += np.where(run, live.sum(1).numpy(), 0)
        cols += np.where(run, unplaced.sum(1).numpy(), 0)
        st, place = kahn_step(st, is_grp, ev, tails, heads, ids, it)
        running = running & place.any(1) & (is_grp & ~st[0]).any(1)
        it += 1
    return steps, edges, cols


def prep_bound(pn, gm, nn, l_max: int, order_only: bool = False):
    """K6's bound on one call: bytes, the active nodes' pred rows, column
    ids and (prep mode) bases read once, the read and the counters; every
    output row written once (order mode: order and rank, int64; prep mode:
    charsr, sinksr, gminr, predsp, seqv, lb, nn_eff, ovf); ops, the Kahn
    loop's work on this state (kahn_work), the sort's n log2 n, the
    re-rank's slots.  Returns (bound, Kahn steps per window)."""
    steps, edges, cols = kahn_work(pn, gm, nn)
    B, ncap = gm.shape[:2]
    n = _active(nn, ncap)
    log2 = max(ncap - 1, 1).bit_length()
    ops = int((KAHN_OPS_PER_LIVE_EDGE * edges + KAHN_OPS_PER_COLUMN * cols
               ).sum()) + B * ncap * log2
    if order_only:
        nbytes = int(36 * n.sum()) + B * (4 + 16 * ncap + 1)
    else:
        ops += int(RERANK_OPS_PER_SLOT * 8 * n.sum())
        nbytes = int(40 * n.sum()) + B * (4 * l_max + 12 + 44 * ncap
                                          + 4 * (l_max + 1) + 8 + 4 + 1)
    return bound(nbytes, ops), steps


def consensus_bound(pn, nn, ncap: int):
    """K7's bound on one call: the active nodes' three pred rows and their
    ranks of the order read once, the two int64 buffers and the two
    counters written once; ops, WALK_OPS_PER_SLOT per pred slot of the
    active nodes (the score pass and the best out-edge)."""
    B = pn.shape[0]
    n = _active(nn, ncap)
    nbytes = int((3 * 32 + 8) * n.sum()) + B * (4 + 16 * ncap + 16)
    return bound(nbytes, int(WALK_OPS_PER_SLOT * 8 * n.sum()))


def _active(nn, ncap: int):
    """Active nodes per window, numpy int64 (nn clipped to [0, ncap])."""
    import torch
    return torch.as_tensor(nn).cpu().long().clamp(0, ncap).numpy()
