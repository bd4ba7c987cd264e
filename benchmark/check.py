"""How `correct` is decided: every window of the window's batch calls must
come back with its own row, and a sample of them, drawn from the seed
over every class and length quartile of window, must match the plain
reference (reference/): the Raw.bed row exactly, and the selected K's
BIC within a relative gap.  A control put in the program's place is
decided by the same limits.

Numbers compared, each with its limit from limits/<cell>.json:
  records_missing  windows with no row of their own (limit 0: exact)
  rows_differing   sampled windows whose row differs from the reference's
  bic_gap          widest |BIC - BIC_ref| / |BIC_ref| of the reference's
                   selected K over the sampled windows that reach the EM
                   (1.0 where one side has no EM result or a NaN)
"""
from __future__ import annotations

import numpy as np

from . import generator
from .reference import pipeline

NO_RESULT = 1.0


def coords(win) -> list[str]:
    return win.record.strip().split("\t")[:3]


def records_missing(calls, pool) -> int:
    """Windows of each call without a 10-column row at its position whose
    first three columns are its own."""
    bad = 0
    for b, _t0, _t1, recs in calls:
        for i, win in enumerate(pool[b]):
            rec = recs[i] if i < len(recs) else None
            if (not isinstance(rec, (list, tuple)) or len(rec) != 10
                    or [str(x) for x in rec[:3]] != coords(win)):
                bad += 1
    return bad


def sample(calls, pool, seed: int, k: int) -> list[tuple[int, int]]:
    """k (call, window) pairs drawn from the seed over every window of the
    completed calls, by stratum (the window's class and length quartile,
    generator.Window.stratum): k // strata from each, at least one, and
    the rest from strata drawn at random, so that no class or size of
    window goes unjudged."""
    pairs = [(ci, wi) for ci, (b, *_r) in enumerate(calls)
             for wi in range(len(pool[b]))]
    rng = generator.rng_for(seed, 2)
    strata: dict[str, list[int]] = {}
    for i, (ci, wi) in enumerate(pairs):
        strata.setdefault(pool[calls[ci][0]][wi].stratum, []).append(i)
    names = sorted(strata)
    take = dict.fromkeys(names, max(k // max(len(names), 1), 1))
    for name in rng.permutation(names)[:max(k - sum(take.values()), 0)]:
        take[str(name)] += 1
    pick = []
    for name in names:
        idx = strata[name]
        pick += rng.choice(idx, size=min(take[name], len(idx)),
                           replace=False).tolist()
    return [pairs[i] for i in sorted(pick)]


def bic_gap(ref: dict, got) -> float | None:
    """Relative gap of the selected K's BIC; None where neither side ran
    the EM, NO_RESULT where only one did or a BIC is NaN."""
    if ref["k"] is None:
        return None if got is None else NO_RESULT
    if got is None:
        return NO_RESULT
    sel = ref["k"] - 1
    b_ref, b_got = float(ref["bics"][sel]), float(np.asarray(got)[sel])
    gap = abs(b_got - b_ref) / max(abs(b_ref), 1e-300)
    return NO_RESULT if not np.isfinite(gap) else gap


def compare(picked, rows_of, bics_of, refs) -> dict:
    """The compared numbers of `picked` pairs: rows_of(pair) the judged
    side's row, bics_of(pair) its BICs or None, refs[pair] the
    reference's result."""
    differ, gaps, em = 0, [], 0
    for pair in picked:
        ref = refs[pair]
        if [str(x) for x in rows_of(pair)] != ref["row"]:
            differ += 1
        g = bic_gap(ref, bics_of(pair))
        if g is not None:
            gaps.append(g)
        em += ref["k"] is not None
    return {"rows_differing": differ,
            "bic_gap": max(gaps) if gaps else 0.0, "em_compared": em}


def judge(calls, pool, prog_pool, em_results, cfg, limits, seed, device,
          modes=("ref",)) -> dict:
    """Numbers, limits and verdict of one run.  calls: (batch, t0, t1,
    records) per completed call; pool: generator windows; prog_pool: the
    program's windows; em_results[(call, id(program window))] the EM's
    BICs."""
    picked = sample(calls, pool, seed, int(limits["sample"]))
    keys = sorted({(calls[ci][0], wi) for ci, wi in picked})
    out = pipeline.rows([pool[b][wi] for b, wi in keys], cfg, device,
                        modes=modes)
    by_mode = {m: dict(zip(keys, res)) for m, res in out.items()}
    refs = {p: by_mode["ref"][(calls[p[0]][0], p[1])] for p in picked}

    def prog_row(p):
        recs = calls[p[0]][3]
        return recs[p[1]] if p[1] < len(recs) else []

    def prog_bics(p):
        return em_results.get((p[0], id(prog_pool[calls[p[0]][0]][p[1]])))

    numbers = {"records_missing": records_missing(calls, pool)}
    numbers.update(compare(picked, prog_row, prog_bics, refs))
    em_compared = numbers.pop("em_compared")
    controls = {}
    for mode in modes:
        if mode == "ref":
            continue
        alt = {p: by_mode[mode][(calls[p[0]][0], p[1])] for p in picked}
        controls[mode] = compare(picked, lambda p: alt[p]["row"],
                                 lambda p: alt[p]["bics"], refs)
        controls[mode].pop("em_compared")
    lim = {"records_missing": 0, "rows_differing": limits["rows_differing"],
           "bic_gap": limits["bic_gap"]}
    correct = all(numbers[k] <= lim[k] for k in lim)
    for ctl in controls.values():
        # the control stands in the program's place: the same limits
        # decide it (it leaves no window without a row)
        ctl["correct"] = all(ctl[k] <= lim[k] for k in ctl)
    return {"correct": correct, "numbers": numbers, "limits": lim,
            "sampled": len(picked), "em_compared": em_compared,
            "controls": controls}
