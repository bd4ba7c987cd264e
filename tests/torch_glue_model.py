"""A CPU model of K6 and K7 (svscope_tpu_torch/csrc/poa_pk_prep.cu and
poa_pk_consensus.cu): each kernel's per-window loop transcribed in numpy,
one window at a time, part by part as the block runs it.

K6: the edge lists by counting sort (duplicates kept), the unplaced and
ready founder masks, the warp's Kahn steps (gstar the first ready bit of
an unplaced column from the lowest word that can hold one; the run
scanned a 32-column word at a time over the unplaced founders, each column
testing its blocker list, the columns before the first failure placed and
appended to the placement list, their heads' counts of unplaced blocker
edges decremented and a head made ready at 0, a ready bit staying set on
a placed column), then the order without a sort (member counts scanned
over the placement list, a member's rank within its column by id, the
BIG keys by id) and the rank-space view.  The kernel keeps each list's
first four entries inline (blk4, out4), which changes no result.  K7:
the window's own ranks, the 32- or 64-bit key choice and the score pass
as the warp runs it (the forwarded score equals the stored one), then
the start node, the best out-edges and the walks.  Shared-memory atomics become order-free
numpy reductions over the same sets.  The tests hold the model against
the JAX package and against the port's batched plain versions; on the
card the kernels are held against the plain versions, so the three
agree."""
import numpy as np

P = 8
BIG = 1 << 30
WORD = 32
WEIGHT_BITS = 21
WEIGHT_SHIFT = 1 << WEIGHT_BITS
SCORE_MASK = WEIGHT_SHIFT - 1
NARROW_WEIGHTS = 1 << 10          # 32-bit keys: every weight below this
NO_SLOT = -(1 << 30)              # a 32-bit key below any valid one


def _csr(keys, vals, n):
    """Offsets (n + 1) and values of a counting sort of vals by keys."""
    off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=off[1:])
    return off, vals[np.argsort(keys, kind="stable")]


def _first_set(mask, start):
    """Index of the first True of mask at or after start, or -1."""
    hit = np.flatnonzero(mask[start:])
    return int(start + hit[0]) if hit.size else -1


def kahn(pn, gm, nn):
    """K6's setup and Kahn steps on one window.  Returns a dict: placed
    (per column), plist (the placed columns in placement order), cyclic,
    steps, and what the window asks of the design: blockers (the most
    distinct blocker columns of a founder), duplicates (raw edges past the
    distinct column pairs), max_run (most columns placed by one step),
    max_span (the widest [gstar, last placed] of a step) and max_words
    (most 32-column words one step's run scanned)."""
    n = gm.shape[0]
    nact = min(max(int(nn), 0), n)
    gmc = np.clip(gm.astype(np.int64), 0, n - 1)
    ids = np.arange(n)
    # setup: the cross-column edges by counting sort, duplicates kept
    p = pn[:nact].astype(np.int64)
    heads = np.repeat(gmc[:nact], P).reshape(nact, P)
    tails = gmc[np.clip(p, 0, n - 1)]
    keep = (p >= 0) & (tails != heads)
    et, eh = tails[keep], heads[keep]
    hoff, blk = _csr(eh, et, n)
    toff, outh = _csr(et, eh, n)
    cnt = np.diff(hoff)                       # unplaced blocker edges
    founder = (ids < nact) & (gmc == ids)
    pend = founder.copy()
    ready = founder & (cnt == 0)
    placed = np.zeros(n, bool)
    plist = []
    remaining = int(founder.sum())
    rlo = 0
    steps = max_run = max_span = max_words = 0
    it = 0
    while it < n and remaining > 0:
        steps += 1
        gstar = _first_set(ready & pend, rlo * WORD)
        if gstar < 0:
            break                              # nothing ready
        rlo = gstar // WORD
        newmin = -(-n // WORD)
        placed_now = words = 0
        start = gstar
        while True:
            c = _first_set(pend, start)        # the next unplaced founder
            if c < 0:
                break
            found = c // WORD
            words += 1
            lanes = [g for g in range(max(found * WORD, start),
                                      min((found + 1) * WORD, n)) if pend[g]]
            bad = [g for g in lanes if any(
                not placed[t] and (t < gstar or t >= g)
                for t in blk[hoff[g]:hoff[g + 1]])]
            take = [g for g in lanes if not bad or g < bad[0]]
            for g in take:
                placed[g] = True
                plist.append(g)
                pend[g] = False
            for g in take:                     # the heads' counts
                for h in outh[toff[g]:toff[g + 1]]:
                    cnt[h] -= 1
                    if cnt[h] == 0:
                        ready[h] = True
                        newmin = min(newmin, h // WORD)
            placed_now += len(take)
            if take:
                max_span = max(max_span, take[-1] - gstar + 1)
            if bad:
                break
            start = (found + 1) * WORD
        max_run = max(max_run, placed_now)
        max_words = max(max_words, words)
        rlo = min(rlo, newmin)
        remaining -= placed_now
        it += 1
        if placed_now == 0:
            break
    pairs = np.unique(et * n + eh)
    distinct = np.bincount(pairs % n, minlength=n)
    return {"placed": placed, "plist": np.array(plist, np.int64),
            "cyclic": remaining > 0, "steps": steps,
            "blockers": int(distinct[founder].max()) if founder.any() else 0,
            "duplicates": int(et.size - pairs.size), "max_run": max_run,
            "max_span": max_span, "max_words": max_words}


def prep_window(pn, gm, nn, ch=None, seq=None, slen=None):
    """K6 on one window: pn (ncap, 8), gm (ncap,), nn; with ch, seq (l_max,)
    and slen also the round's operands.  Returns kahn's dict with order,
    rank (int64) and, with ch, charsr, sinksr, predsp, seqv, lb, nn_eff,
    gminr (int32)."""
    n = gm.shape[0]
    nact = min(max(int(nn), 0), n)
    ids = np.arange(n)
    out = kahn(pn, gm, nn)
    gmc = np.clip(gm.astype(np.int64), 0, n - 1)
    # the order: each placed column's members by id, in placement order,
    # then the BIG keys by id
    keyed = (ids < nact) & out["placed"][gmc]
    mcnt = np.bincount(gmc[keyed], minlength=n)
    tmp = mcnt[out["plist"]]
    cstart = np.zeros(n, np.int64)
    cstart[out["plist"]] = np.cumsum(tmp) - tmp
    nkeyed = int(tmp.sum())
    big_before = np.cumsum(~keyed) - ~keyed
    pos = nkeyed + big_before
    below = np.zeros(n, np.int64)      # members of the column with smaller id
    for v in ids[keyed]:
        pos[v] = cstart[gmc[v]] + below[gmc[v]]
        below[gmc[v]] += 1
    order = np.empty(n, np.int64)
    order[pos] = ids
    out.update(order=order, rank=pos)
    if ch is None:
        return out
    deg = np.zeros(n, np.int64)
    pa = pn[:nact].astype(np.int64).ravel()
    np.add.at(deg, np.clip(pa[pa >= 0], 0, n - 1), 1)
    prow = pn[order].astype(np.int64)
    pr = np.where(prow >= 0, pos[np.clip(prow, 0, n - 1)], -1)
    pr[:, 1:] = np.where(pr[:, 1:] < 0, pr[:, :1], pr[:, 1:])
    sl = int(slen)
    out.update(charsr=ch[order].astype(np.int32),
               sinksr=(deg[order] == 0).astype(np.int32),
               predsp=pr.astype(np.int32),
               seqv=np.concatenate([[255], seq]).astype(np.int32),
               lb=np.int32(sl), nn_eff=np.int32(int(nn) if sl > 0 else 0),
               gminr=gm[order].astype(np.int32))
    return out


def score_plan(pn, pw, nn, order, batch):
    """K7's plan of a window's score pass: (steps, key_bits).  steps: one
    past the last rank below `batch` (the batch's largest node count)
    holding an active node; key_bits 32 when every weight of those ranks'
    valid slots is in [0, 2^10) and the sum of their largest in-weights
    (a bound on every score) is below 2^21, else 64."""
    n = pn.shape[0]
    nn = int(nn)
    order = np.clip(order.astype(np.int64), 0, n - 1)
    steps, wide, bound = 0, False, 0
    for i in range(min(max(batch, 0), n)):
        v = order[i]
        if v >= nn:
            continue
        steps = i + 1
        w = pw[v][pn[v] >= 0].astype(np.int64)
        wide |= bool(((w < 0) | (w >= NARROW_WEIGHTS)).any())
        bound += int(max(w.max(initial=0), 0))
    return steps, 64 if wide or bound > SCORE_MASK else 32


def consensus_window(pn, pw, pt, nn, order, batch, key_bits=None):
    """K7 on one window: pn, pw, pt (ncap, 8), nn, order (ncap,), and
    `batch`, the batch's largest node count; key_bits, when given, in
    place of score_plan's choice.  Returns (back_buf, back_start, fwd_buf,
    fwd_cnt), int64."""
    n = pn.shape[0]
    steps, plan_bits = score_plan(pn, pw, nn, order, batch)
    key_bits = key_bits or plan_bits
    nn = int(nn)
    order = np.clip(order.astype(np.int64), 0, n - 1)
    pn, pw, pt = (x.astype(np.int64) for x in (pn, pw, pt))
    score = np.zeros(n, np.int64)
    best_in = np.full(n, -1, np.int64)
    # score pass, a rank at a time, a slot a lane
    for i in range(steps):
        v = order[i]
        p = pn[v]
        vm = (p >= 0) & (v < nn)
        sc = score[np.clip(p, 0, n - 1)]
        if key_bits == 32:                     # the max key holds the score
            key = np.where(vm, pw[v] << WEIGHT_BITS, NO_SLOT) + sc
            m = max(int(key.max()), 0)
            score[v] = (m >> WEIGHT_BITS) + (m & SCORE_MASK)
            b = int(np.flatnonzero(key == key.max())[0])
            best_in[v] = p[b] if key.max() >= 0 else -1
        else:
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
