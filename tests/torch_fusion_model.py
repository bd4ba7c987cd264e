"""A torch model of K4's parallel fusion round (csrc/poa_pk_fusion.cu,
`pk_fusion_parallel_kernel`) on CPU tensors.

The kernel fuses a window's round in fixed phases instead of entry after
entry: it stages every entry's read position, base, old column and lookup
gc[gid][c5] from the round-start state, numbers the creators by a scan,
takes `prev` from a scan of the valid entries, classifies each edge against
its target's round-start pred row, numbers the new edges by a scan, and
writes.  A window for which that is not the serial result — two node
entries on one key (gid, c5), two valid entries on one cur or one read
position, a lookup of a row at or past nn, a new id reaching the trash row,
or overflow already set — is flagged before anything is written and takes
the serial walk.  This module runs the same phases with torch ops over
every window and entry at once, and the serial walk as
`fusion_reference`, so the CPU tests can hold the parallel algorithm to
the serial fusion and the card's flagged counts to the model's.  It
imports no JAX (chip_smoke.py imports it on the card's machine).
"""
from __future__ import annotations

import torch

from svscope_tpu_torch.ops import poa_fused_kernel as tpk
from svscope_tpu_torch.ops.poa_device import MAX_PREDS

ALPHA5 = tpk.ALPHA5


def _has_duplicate(vals, mask, size):
    """(B,) bool: two masked entries of a row of `vals` (values in
    [0, size)) are equal."""
    counts = torch.zeros((vals.shape[0], size), dtype=torch.long)
    counts.scatter_add_(1, torch.where(mask, vals, 0), mask.long())
    return (counts > 1).any(1)


def fuse_parallel(an, asx, ke, gminr, seqs5, st: tpk.GraphState):
    """K4's round on CPU tensors (fusion_reference's arguments): updates
    `st` in place and returns (path (B, l_max) int32, flagged (B,) bool).
    Flagged windows get fusion_reference's serial result."""
    B, out_len = an.shape
    ncap = st.ch.shape[1]
    trash = ncap - 1
    n_max = gminr.shape[1]
    l_max = seqs5.shape[1]
    i32 = torch.int32
    bidx = torch.arange(B)[:, None]
    e = torch.arange(out_len)[None, :]
    nn0, tc0 = st.nn.long(), st.tctr.long()

    # 1. stage: entry e of window b is alignment index ke[b] + 1 + e
    k0 = ke.long() + 1
    ne = (out_len - k0).clamp(0, out_len)
    k = (k0[:, None] + e).clamp(0, out_len - 1)
    anv = an.long().gather(1, k)
    aspv = asx.long().gather(1, k)
    valid = (e < ne[:, None]) & (aspv >= 0)
    sp = aspv.clamp(0, l_max - 1)
    c5 = seqs5.long().gather(1, sp)
    has_node = valid & (anv >= 0)
    gid = gminr.long().gather(1, anv.clamp(0, n_max - 1))
    row = gid.clamp(0, trash)
    key = torch.where(has_node, row * ALPHA5 + c5, 0)
    pre = torch.where(has_node,
                      st.gc.reshape(B, -1).long().gather(1, key), -1)
    flagged = (st.ovf > 0) | _has_duplicate(sp, valid, l_max) \
        | _has_duplicate(key, has_node, ncap * ALPHA5) \
        | (has_node & (row >= nn0[:, None])).any(1)

    # 2. creators' ids
    creator = valid & (pre < 0)
    n_new = creator.sum(1)
    cur = torch.where(creator,
                      nn0[:, None] + creator.cumsum(1) - creator.long(), pre)
    flagged |= (n_new > 0) & (nn0 + n_new - 1 >= trash)

    # 3. distinct curs, prev, edges against the round-start pred rows
    curc = cur.clamp(0, trash)
    flagged |= _has_duplicate(curc, valid, ncap)
    last = torch.where(valid, e, -1).cummax(1).values
    prev_at = torch.cat([torch.full((B, 1), -1), last[:, :-1]], 1)
    prev = torch.where(prev_at >= 0, cur.gather(1, prev_at.clamp(min=0)), -1)
    add_e = valid & (prev >= 0)
    prow = st.pn.long()[bidx, curc]                        # (B, E, 8)
    ehit = prow == prev[..., None]
    slots = torch.arange(MAX_PREDS)
    hit = add_e & ~creator & ehit.any(-1)
    eslot = torch.where(ehit, slots, MAX_PREDS).amin(-1)
    nvalid = torch.where(creator, 0, (prow >= 0).sum(-1))
    ovf_e = add_e & ~hit & (nvalid >= MAX_PREDS)
    newe = add_e & ~hit & ~ovf_e
    slot = torch.where(hit, eslot, nvalid).clamp(max=MAX_PREDS - 1)
    stamp = tc0[:, None] + newe.cumsum(1) - newe.long()

    # 4. writes, in the windows that are not flagged (no two entries of a
    # window touch one row, key or read position there)
    ok = ~flagged
    path = torch.full((B, l_max), -1, dtype=i32)
    cm = creator & ok[:, None]
    cb, ce = cm.nonzero(as_tuple=True)
    ids = cur[cb, ce]
    cg = torch.where(has_node[cb, ce], gid[cb, ce], ids)
    cc5 = c5[cb, ce]
    ep = newe[cb, ce]
    st.pn[cb, ids] = -1
    st.pw[cb, ids] = 0
    st.pt[cb, ids] = 0
    st.pn[cb, ids, 0] = torch.where(ep, prev[cb, ce], -1).to(i32)
    st.pw[cb, ids, 0] = ep.to(i32)
    st.pt[cb, ids, 0] = torch.where(ep, stamp[cb, ce], 0).to(i32)
    own = (torch.arange(ALPHA5) == cc5[:, None]) & (cg == ids)[:, None]
    st.gc[cb, ids] = torch.where(own, ids[:, None], -1).to(i32)
    st.ch[cb, ids] = cc5.to(i32)
    st.gm[cb, ids] = cg.to(i32)
    jm = has_node[cb, ce]
    st.gc[cb[jm], row[cb, ce][jm], cc5[jm]] = ids[jm].to(i32)
    hm = hit & ok[:, None]
    hb, he = hm.nonzero(as_tuple=True)
    st.pw[hb, curc[hb, he], slot[hb, he]] += 1
    nm = newe & ~creator & ok[:, None]
    nb, nx = nm.nonzero(as_tuple=True)
    at = (nb, curc[nb, nx], slot[nb, nx])
    st.pn[at] = prev[nb, nx].to(i32)
    st.pw[at] = 1
    st.pt[at] = stamp[nb, nx].to(i32)
    vm = valid & ok[:, None]
    vb, ve = vm.nonzero(as_tuple=True)
    path[vb, sp[vb, ve]] = cur[vb, ve].to(i32)
    st.nn[ok] = (nn0 + n_new)[ok].to(i32)
    st.tctr[ok] = (tc0 + newe.sum(1))[ok].to(i32)
    st.ovf[ok] = ovf_e.any(1)[ok].to(i32)

    # flagged windows: the serial walk from their round-start state
    fw = flagged.nonzero(as_tuple=True)[0]
    if len(fw):
        sub = tpk.GraphState(*[t[fw].clone() for t in st.tensors()])
        path[fw] = tpk.fusion_reference(an[fw], asx[fw], ke[fw], gminr[fw],
                                        seqs5[fw], sub)
        for t, s in zip(st.tensors(), sub.tensors()):
            t[fw] = s
    return path, flagged
