"""A CPU model of K6 and K7 (svscope_tpu_torch/csrc/poa_pk_prep.cu and
poa_pk_consensus.cu): each kernel's per-window loop transcribed in numpy,
one window at a time, phase by phase as the block runs it.

The shared-memory reductions become numpy reductions over the same sets
(`np.maximum.at` for the atomics, order-free like them), the bitonic sort
becomes np.sort of the same 64-bit words, and the walks are the kernel's
loops.  The tests hold the model against the JAX package and against the
port's batched plain versions; on the card the kernels are held against
the plain versions, so the three agree."""
import numpy as np

P = 8
BIG = 1 << 30
ID_BITS = 16
WEIGHT_SHIFT = 1 << 21


def prep_window(pn, gm, nn, ch=None, seq=None, slen=None):
    """K6 on one window: pn (ncap, 8), gm (ncap,), nn; with ch, seq (l_max,)
    and slen also the round's operands.  Returns a dict: order, rank
    (int64), cyclic, steps (the Kahn steps the block runs) and, with ch,
    charsr, sinksr, predsp, seqv, lb, nn_eff, gminr (int32)."""
    n = gm.shape[0]
    nact = min(max(int(nn), 0), n)
    gm = gm.astype(np.int64)
    placed = np.zeros(n, bool)
    itg = np.full(n, BIG, np.int64)
    # the cross-column edges of the active nodes
    p = pn[:nact].astype(np.int64)
    heads = np.repeat(gm[:nact], P).reshape(nact, P)
    tails = gm[np.clip(p, 0, n - 1)]
    keep = (p >= 0) & (tails != heads)
    et, eh = tails[keep], heads[keep]
    ids = np.arange(n)
    is_grp = (ids < nact) & (gm == ids)
    remaining = int(is_grp.sum())
    steps = 0
    it = 0
    while it < n and remaining > 0:
        steps += 1
        live = ~placed[et]
        bmax = np.full(n, -1, np.int64)
        bmin = np.full(n, BIG, np.int64)
        np.maximum.at(bmax, eh[live], et[live])
        np.minimum.at(bmin, eh[live], et[live])
        unplaced = is_grp & ~placed
        ready = unplaced & (bmax < 0)
        gstar = int(ids[ready].min()) if ready.any() else BIG
        cand = (bmax < 0) | ((bmin >= gstar) & (bmax < ids))
        fails = unplaced & (ids >= gstar) & ~cand
        fail = int(ids[fails].min()) if fails.any() else BIG
        place = unplaced & (ids >= gstar) & (ids < fail)
        placed |= place
        itg[place] = it
        cnt = int(place.sum())
        remaining -= cnt
        it += 1
        if cnt == 0:
            break
    cyclic = remaining > 0
    # the sort's words: key << 16 | node id
    key = np.full(n, BIG, np.int64)
    g = np.clip(gm[:nact], 0, n - 1)
    ok = placed[g] & (itg[g] < BIG)
    key[:nact] = np.where(ok, itg[g] * n + gm[:nact], BIG)
    words = np.sort((key.astype(np.uint64) << np.uint64(ID_BITS))
                    | ids.astype(np.uint64))
    order = (words & np.uint64((1 << ID_BITS) - 1)).astype(np.int64)
    rank = np.empty(n, np.int64)
    rank[order] = ids
    out = {"order": order, "rank": rank, "cyclic": cyclic, "steps": steps}
    if ch is None:
        return out
    deg = np.zeros(n, np.int64)
    pa = pn[:nact].astype(np.int64).ravel()
    np.add.at(deg, np.clip(pa[pa >= 0], 0, n - 1), 1)
    prow = pn[order].astype(np.int64)
    pr = np.where(prow >= 0, rank[np.clip(prow, 0, n - 1)], -1)
    pr[:, 1:] = np.where(pr[:, 1:] < 0, pr[:, :1], pr[:, 1:])
    sl = int(slen)
    out.update(charsr=ch[order].astype(np.int32),
               sinksr=(deg[order] == 0).astype(np.int32),
               predsp=pr.astype(np.int32),
               seqv=np.concatenate([[255], seq]).astype(np.int32),
               lb=np.int32(sl), nn_eff=np.int32(int(nn) if sl > 0 else 0),
               gminr=gm[order].astype(np.int32))
    return out


def consensus_window(pn, pw, pt, nn, order, steps):
    """K7 on one window: pn, pw, pt (ncap, 8), nn, order (ncap,), and
    `steps`, the batch's largest node count.  Returns (back_buf,
    back_start, fwd_buf, fwd_cnt), int64."""
    n = pn.shape[0]
    nn = int(nn)
    order = np.clip(order.astype(np.int64), 0, n - 1)
    pn, pw, pt = (x.astype(np.int64) for x in (pn, pw, pt))
    score = np.zeros(n, np.int64)
    best_in = np.full(n, -1, np.int64)
    # score pass, a rank at a time, a slot a lane
    for i in range(min(max(steps, 0), n)):
        v = order[i]
        p = pn[v]
        vm = (p >= 0) & (v < nn)
        sc = score[np.clip(p, 0, n - 1)]
        key = np.where(vm, pw[v] * WEIGHT_SHIFT + sc, -1)
        b = int(np.flatnonzero(key == key.max())[0])
        has = vm.any()
        score[v] = pw[v, b] + sc[b] if has else 0
        best_in[v] = p[b] if has else -1
    # the first max-score node in rank order
    s_ord = np.where(np.arange(n) < nn, score[order], -1)
    first = int(np.flatnonzero(s_ord == s_ord.max())[0])
    vmax = int(order[min(first, n - 1)]) if nn > 0 else -1
    # per node the best out-edge: max key, then min stamp, then last slot
    e = np.arange(n * P)
    v_of = e // P
    p = pn.ravel()
    valid = (p >= 0) & (v_of < nn)
    t = np.clip(p, 0, n - 1)
    key1 = pw.ravel() * WEIGHT_SHIFT + score[v_of]
    mx = np.full(n, -1, np.int64)
    np.maximum.at(mx, t[valid], key1[valid])
    match = valid & (key1 == mx[t])
    tmv = np.clip(pt.ravel(), 0, n * P - 1)
    tmn = np.full(n, BIG, np.int64)
    np.minimum.at(tmn, t[match], tmv[match])
    win = match & (tmv == tmn[t])
    best_e = np.full(n, -1, np.int64)
    np.maximum.at(best_e, t[win], e[win])
    best_out = np.where(best_e >= 0, best_e // P, -1)
    # the walks
    back = np.full(n, -1, np.int64)
    v, idx = vmax, n - 1
    while v >= 0 and idx >= 0:
        back[idx] = v
        v = int(best_in[min(max(v, 0), n - 1)])
        idx -= 1
    fwd = np.full(n, -1, np.int64)
    v, c = vmax, 0
    while v >= 0 and c < n:
        nv = int(best_out[v])
        if nv < 0:
            break
        fwd[c] = nv
        v = nv
        c += 1
    return back, max(idx + 1, 0), fwd, c
