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
