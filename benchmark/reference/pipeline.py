"""The reference's Raw.bed rows for a sample of windows: stage A and the
cluster consensus in child processes (worker.py; NumPy alone, the slow
part), the
EM on `device` in this process, then each row as the localGraph engine
must write it (src/DecisionMaker.py:126-190).

`rows(windows, ...)` returns, per EM mode ("ref" float64; "tf32" the
control), one result per window: {"row": the 10 columns as strings,
"k", "bics" (None where the window never reaches the EM)}."""
from __future__ import annotations

import os

import numpy as np

from . import msa
from .worker import map_jobs

MODES = {"ref": {"dtype": "float64", "tf32": False},
         "tf32": {"dtype": "float32", "tf32": True}}


def clusters(labels, tags, t_label: str, readcutoff: int):
    """(somatic, germline) member lists, in label order: a cluster of
    readcutoff reads or more is somatic when all its reads are t_label's,
    else germline."""
    som, germ = [], []
    for lab in np.unique(labels):
        members = np.flatnonzero(labels == lab)
        if members.size < readcutoff:
            continue
        mtags = np.unique(tags[members])
        if mtags.shape[0] == 1 and mtags[0] == t_label:
            som.append(members)
        else:
            germ.append(members)
    return som, germ


def base_row(win) -> list[str]:
    c = win.record.strip().split("\t")
    return [c[0], c[1], c[2], "-", "-", "0", "-", "-", "0", win.flag]


def rows(windows, cfg: dict, device, modes=("ref",)):
    import torch
    procs = min(8, os.cpu_count() or 1)
    stage = map_jobs("stage_a", [
        (list(w.sequences), list(w.read_ids), w.flank_5, w.flank_3,
         cfg["hcutoff"], cfg["scutoff"]) for w in windows], procs)
    plans = {}
    jobs: dict[tuple, int] = {}
    for mode in modes:
        spec = MODES[mode]
        from .em import em_window
        plan = []
        for w, (enc, feat) in zip(windows, stage):
            if feat is None:
                plan.append(None)
                continue
            em = em_window(feat, device, getattr(torch, spec["dtype"]),
                           spec["tf32"])
            tags = msa.tags_of(w.read_ids)
            som, germ = clusters(em["labels"], tags, cfg["t_label"],
                                 cfg["readcutoff"])
            dec = msa.decode_degapped(enc[1:])
            groups = []
            for kind, idxs in (("som", som), ("germ", germ)):
                for members in idxs:
                    rws = tuple(dec[i] for i in members)
                    key = rws if max(map(len, rws)) > 0 else None
                    if key is not None:
                        jobs.setdefault(key, len(jobs))
                    groups.append((kind, members, key))
            plan.append((em, groups))
        plans[mode] = plan
    cons_list = map_jobs("consensus", list(jobs), procs)
    out = {}
    for mode in modes:
        res = []
        for w, p in zip(windows, plans[mode]):
            if p is None:
                res.append({"row": base_row(w), "k": None, "bics": None})
                continue
            em, groups = p
            som = [(m, k) for kind, m, k in groups if kind == "som"]
            germ = [(m, k) for kind, m, k in groups if kind == "germ"]
            row = base_row(w)
            if som and germ:
                seq = lambda k: "-" if k is None else cons_list[jobs[k]]
                ids = lambda m: ",".join(w.read_ids[i] for i in m)
                row[3:10] = [";".join(seq(k) for _m, k in som),
                             ";".join(ids(m) for m, _k in som),
                             str(len(som)),
                             ";".join(seq(k) for _m, k in germ),
                             ";".join(ids(m) for m, _k in germ),
                             str(len(germ)),
                             w.flag + "|EMOutput"]
            res.append({"row": row, "k": em["k"], "bics": em["bics"]})
        out[mode] = res
    return out
