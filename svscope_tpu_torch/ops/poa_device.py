"""Plain PyTorch version of the batched POA graph-vs-read aligner.

Counterpart of svscope_tpu/ops/poa_device.py and the plain version of the
hand-written CUDA kernel in csrc/poa_align.cu (wrapper: ops/poa_align.py).
Same recurrence, scoring and tie-breaks as
svscope_tpu/ops/poa_pallas.py::_poa_kernel and native/poa_engine.cpp:

  * NW semantics in topological-rank space, m=5 n=-4 g=-8; H row 0 is the
    virtual start row, H row r+1 is node rank r;
  * a rank's predecessor row is the max over its pred slots' H rows
    (empty slots are padded with slot 0's rank, a rank with no preds reads
    the virtual row: `max(pr, -1) + 1`);
  * the in-row gap chain H[j] = max(base[j], H[j-1] + g) is
    `cummax(base - g*j) + g*j`;
  * directions: first diag slot, else first graph-gap (up) slot, else
    seq-gap (left) — codes 0-7, 8-15, 16;
  * best sink at column seq_len with strict `>` in rank order from
    (NEG, rank 0); traceback from (brank+1, seq_len) into right-aligned
    (node_rank, seq_pos) pairs, -1 = gap, -2 = pad.

`int16_mode=True` is the counterpart of K1's int16 variant
(`align_batch_pallas(..., int16_mode=True)`): H stored in int16, sentinel
NEG16, N and l_max at most 1024.

The row loop runs in Python over the batch; the traceback is batched over
windows (one loop of at most N + L steps).
"""
from __future__ import annotations

import numpy as np
import torch

from .poa import PoaGraph

MATCH = 5
MISMATCH = -4
GAP = -8
NEG = -(2 ** 29)
NEG16 = -20000          # int16 sentinel (svscope_tpu/ops/poa_pallas.py:57)
INT16_MAX_SHAPE = 1024  # int16 mode: N, l_max <= 1024
MAX_PREDS = 8
DIR_LEFT = 16


def pack_graph(graph: PoaGraph, n_max: int, p_max: int = MAX_PREDS):
    """Pack a NumPy-oracle PoaGraph into padded arrays in topological-rank
    space (svscope_tpu/ops/poa_device.py::pack_graph)."""
    order = graph.topo_order()
    n = len(order)
    if n > n_max:
        raise ValueError(f"graph has {n} nodes > bucket {n_max}")
    pos_of = {node: i for i, node in enumerate(order)}
    chars = np.zeros(n_max, np.uint8)
    preds = np.full((n_max, p_max), -1, np.int32)
    is_sink = np.zeros(n_max, bool)
    node_of_rank = np.full(n_max, -1, np.int32)
    for i, node in enumerate(order):
        chars[i] = ord(graph.chars[node])
        node_of_rank[i] = node
        ps = graph.in_edges[node]
        if len(ps) > p_max:
            raise ValueError(f"node in-degree {len(ps)} > {p_max}")
        for k, p in enumerate(ps):
            preds[i, k] = pos_of[p]
        is_sink[i] = not graph.out_edges[node]
    return chars, preds, is_sink, np.int32(n), node_of_rank


def to_torch_packed(chars, preds, sinks, n_nodes, seqs, seq_lens, device):
    """Packed numpy arrays (NativePoaGraph.pack / pack_graph, stacked over
    windows) -> the aligner's tensors on `device`:
    chars (B, N) uint8, preds (B, N, P) int32, sinks (B, N) bool,
    n_nodes (B,) int32, seqs (B, L) uint8, seq_lens (B,) int32."""
    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    return (t(chars, np.uint8), t(preds, np.int32), t(sinks, np.bool_),
            t(np.asarray(n_nodes).reshape(-1), np.int32), t(seqs, np.uint8),
            t(np.asarray(seq_lens).reshape(-1), np.int32))


def pad_pred_slots(preds: torch.Tensor) -> torch.Tensor:
    """(B, N, P<=8) -> (B, N, 8) int32, missing slots -1."""
    B, N, P = preds.shape
    if P > MAX_PREDS:
        raise ValueError(f"in-degree bucket {P} > {MAX_PREDS}")
    if P == MAX_PREDS:
        return preds.to(torch.int32)
    pad = torch.full((B, N, MAX_PREDS - P), -1, dtype=torch.int32,
                     device=preds.device)
    return torch.cat([preds.to(torch.int32), pad], dim=2)


def check_int16_shape(n_max: int, l_max: int) -> None:
    """Raise ValueError where int16 mode cannot hold the scores: a legal H
    value is >= -8 * (n_max + l_max) >= -16384 only up to 1024 each."""
    if n_max > INT16_MAX_SHAPE or l_max > INT16_MAX_SHAPE:
        raise ValueError(f"int16 mode needs N, l_max <= {INT16_MAX_SHAPE} "
                         f"(got {n_max}, {l_max})")


def _shift_right(v: torch.Tensor, fill: int) -> torch.Tensor:
    """v[..., j-1] at column j, `fill` at column 0."""
    return torch.nn.functional.pad(v[..., :-1], (1, 0), value=fill)


def align_batch_reference(chars, preds, sinks, n_nodes, seqs, seq_lens,
                          l_max: int, int16_mode: bool = False):
    """Plain torch K1: same contract as
    svscope_tpu.ops.poa_pallas.align_batch_pallas.

    chars (B, N) uint8; preds (B, N, P<=8) int32 (-1 empty); sinks (B, N)
    bool; n_nodes (B,); seqs (B, L<=l_max) uint8; seq_lens (B,).
    Returns (aln_nodes, aln_spos, k_end, score): (B, N + l_max) int32 twice,
    then (B,) int32 twice, on the inputs' device.

    int16_mode: the H plane is int16 and the sentinel NEG16; N or l_max past
    1024 raises ValueError before anything runs.  A window with no valid
    sink scores NEG16 (the int32 mode: NEG).  Rows are computed in int32
    and masked with `torch.where` (an additive mask would wrap in int16),
    so every stored value lies in [NEG16, 5 * l_max].  The outputs cannot
    differ from JAX's int16 kernel, nor from the int32 mode apart from
    that score: every value the traceback and the best sink read (columns
    0..seq_len of the window's own ranks, their pred rows and the virtual
    row) is a legal score >= -8 * (N + l_max) >= -16384 > NEG16, so no
    sentinel floor binds there and the arithmetic is the int32 one; a
    valid sink always beats the start value NEG16.  Columns past seq_len
    hold other values than the TPU kernel's (it floors them at NEG16 - 8j
    through its prefix-max fill) and than the int32 mode's; no traceback
    step, direction or best sink reads them."""
    dev = chars.device
    B, N = chars.shape
    L = seqs.shape[1]
    if int16_mode:
        check_int16_shape(N, l_max)
    if L > l_max:
        raise ValueError(f"seqs width {L} > l_max {l_max}")
    neg = NEG16 if int16_mode else NEG
    hdt = torch.int16 if int16_mode else torch.int32
    l1 = l_max + 1
    p8 = pad_pred_slots(preds)
    # empty slots -> slot 0's rank (after which every slot is a valid
    # gather and duplicate matches collapse to the lowest slot)
    pp = torch.where(p8 < 0, p8[:, :, :1], p8).long()
    prow = pp.clamp(min=-1) + 1                       # H row per pred slot
    # slots worth scanning per rank: the batch's largest in-degree there
    deg = np.maximum((p8 >= 0).sum(dim=2).amax(dim=0).cpu().numpy(), 1) \
        if B else np.ones(N, np.int64)
    i32 = torch.int32
    j = torch.arange(l1, device=dev, dtype=i32)
    decay = GAP * j
    lb = seq_lens.to(dev).long().reshape(B, 1)
    nn = n_nodes.to(dev).long().reshape(B)
    seq_sh = torch.full((B, l1), 255, dtype=i32, device=dev)
    seq_sh[:, 1:L + 1] = seqs.to(i32)
    jvalid = (j >= 1) & (j <= lb)                     # (B, l1)
    in_seq = j <= lb
    # masked cells are set to the sentinel: column 0 is never masked, so
    # the gap chain takes its max from cells <= seq_len, and valid rows
    # never drop below g*(N+L+1) > neg, so h matches no masked diag.
    # Rows a window never computes are never read (see below).
    H = torch.empty((B, N + 1, l1), dtype=hdt, device=dev)
    H[:, 0] = torch.where(in_seq, decay, neg)
    Hf = H.view(B * (N + 1), l1)
    D = torch.empty((B, N, l1), dtype=torch.int8, device=dev)
    bidx = torch.arange(B, device=dev)
    rowflat = bidx[:, None, None] * (N + 1) + prow    # (B, N, 8) rows of Hf
    slots = torch.arange(MAX_PREDS, dtype=i32, device=dev)
    # substitution rows per distinct node char, picked per (window, rank)
    uch = torch.unique(chars).long()
    subf = torch.where(seq_sh[None] == uch.to(i32)[:, None, None], MATCH,
                       MISMATCH).to(i32).reshape(-1, l1)
    subrow = torch.searchsorted(uch, chars.long()) * B + bidx[:, None]
    n_rows = int(nn.max()) if B else 0
    # Rows past a window's own n_nodes are computed but never read: valid
    # ranks only have valid preds, the traceback treats them as left moves
    # and they are no sinks.
    for r in range(n_rows):
        k = int(deg[r])
        if k == 1:
            mp = Hf.index_select(0, rowflat[:, r, 0]).to(i32)    # (B, l1)
        else:
            V = Hf.index_select(0, rowflat[:, r, :k].reshape(-1)).view(
                B, k, l1).to(i32)
            mp = V.amax(dim=1)
        sub = subf.index_select(0, subrow[:, r])
        diag = torch.where(jvalid, _shift_right(mp, 0) + sub, neg)
        up = mp + GAP
        # diag is masked at j = 0, so max(diag, up) is up there
        base = torch.where(in_seq, torch.maximum(diag, up), neg)
        h = torch.cummax(base - decay, dim=1).values + decay
        H[:, r + 1] = h
        if k == 1:
            code = (h != diag) * (DIR_LEFT - 8 * (h == up))
        else:
            # lowest matching slot wins
            hk = h[:, None]
            slot = slots[:k, None]
            dslot = torch.where((hk == _shift_right(V, neg) + sub[:, None])
                                & jvalid[:, None], slot, DIR_LEFT).amin(1)
            uslot = torch.where(hk == V + GAP, slot + 8, DIR_LEFT).amin(1)
            code = torch.where(dslot < DIR_LEFT, dslot, uslot)
        D[:, r] = code.to(torch.int8)
    # best sink at column seq_len: the first rank holding the max over
    # valid sinks, if that max beats NEG (== strict > in rank order)
    # (in int16 mode from (NEG16, 0): a window with no valid sink scores
    # NEG16)
    ranks = torch.arange(N, device=dev)
    ends = H[:, 1:].gather(2, lb[:, :, None].expand(B, N, 1))[..., 0].to(i32)
    ends = torch.where(sinks.bool() & (ranks[None, :] < nn[:, None]), ends,
                       neg)
    bval = ends.amax(dim=1)
    first = torch.where(ends == bval[:, None], ranks[None, :], N).amin(dim=1)
    brank = torch.where(bval > neg, first, 0)

    # batched traceback: finished windows write to a dump column (out_len)
    out_len = N + l_max
    an = torch.full((B, out_len + 1), -2, dtype=i32, device=dev)
    asx = torch.full((B, out_len + 1), -2, dtype=i32, device=dev)
    an_flat, as_flat = an.view(-1), asx.view(-1)
    d_flat = D.view(-1)
    pp_flat = pp.reshape(-1)
    row_base = bidx * N                               # window's first rank
    out_base = bidx * (out_len + 1)
    iv = brank + 1
    jv = lb.reshape(B).clone()
    kv = torch.full((B,), out_len - 1, dtype=torch.long, device=dev)
    for _ in range(out_len):
        active = (jv > 0) & (kv >= 0)
        if not bool(active.any()):
            break
        rr = (iv - 1).clamp(min=0)
        d = d_flat[(row_base + rr) * l1 + jv].long()
        code = torch.where((iv == 0) | (rr >= nn), DIR_LEFT, d)
        is_left = code == DIR_LEFT
        is_up = (code >= 8) & ~is_left
        pr = pp_flat[(row_base + rr) * MAX_PREDS + (code & 7)]
        slot = out_base + torch.where(active, kv, out_len)
        an_flat[slot] = torch.where(is_left, -1, iv - 1).to(i32)
        as_flat[slot] = torch.where(is_up, -1, jv - 1).to(i32)
        iv = torch.where(active & ~is_left, pr + 1, iv)
        jv = torch.where(active & ~is_up, jv - 1, jv)
        kv = torch.where(active, kv - 1, kv)
    return (an[:, :out_len].contiguous(), asx[:, :out_len].contiguous(),
            kv.to(i32), bval)


def unpack_alignment_arrays(aln_nodes, aln_spos, k_end, node_of_rank):
    """Aligner output row -> (node ids, seq positions): int32 arrays of the
    alignment path in graph node ids, -1 = gap."""
    r = np.asarray(aln_nodes)[int(k_end) + 1:]
    s = np.asarray(aln_spos)[int(k_end) + 1:]
    keep = r != -2
    r, s = r[keep], s[keep]
    nodes = np.where(r >= 0, np.asarray(node_of_rank)[np.maximum(r, 0)], -1)
    return nodes.astype(np.int32), s.astype(np.int32)


def unpack_alignment(aln_nodes, aln_spos, k_end, node_of_rank):
    """Aligner output row -> [(node_id, seq_pos)] in graph node ids."""
    nodes, spos = unpack_alignment_arrays(aln_nodes, aln_spos, k_end,
                                          node_of_rank)
    return list(zip(nodes.tolist(), spos.tolist()))
