"""The one traffic generator: a pool of window batches from a traffic
mix's parameters (traffic/<name>.json) and a seed.

A window is what the localGraph stage hands the POA and the EM: the
reference window with its flanks, then the spanning reads' slices over
it, tumor first.  Sizes are stratified within each batch and only their
order, the bases and the edits come from the seed, so every seed and
every batch asks for the same amount of work.  Imports nothing of the
program: the harness wraps each window in the program's own type.

Parameters (see traffic/*.json):
  windows_per_call, pool_calls   batch size and the number of distinct
                                 batches the window cycles through
  tumor_reads, normal_reads      spanning reads per window
  window_len                     {"dist": "fixed", "value"} or
                                 {"dist": "loguniform", "lo", "hi"} (bp)
  flank                          bp on each side (the CLI's offset)
  classes                        [{name, share, tumor_carriers: [lo, hi],
                                 normal_carriers: [lo, hi],
                                 low_complexity?}]: reads carrying the SV
  sv                             {"types": {"INS": w, "DEL": w},
                                 "len": as window_len}
  edits                          {"rate": r} (Binomial(len, r) per read)
                                 or {"per_read": n}; "ops" weights of
                                 substitution, insertion, deletion
  low_complexity                 {"motif": [lo, hi], "divergence": d}
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


class Window(NamedTuple):
    sequences: list          # [reference window, read slices...]
    read_ids: list           # "<sample>_<tumor|normal>|<name>" per read
    flank_5: str
    flank_3: str
    record: str              # "chrom\tstart\tend"
    flag: str
    stratum: str = ""        # "<class>.<length quartile>" (check.sample)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of `seed` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def _stratified(spec: dict, n: int) -> np.ndarray:
    """n sizes at the spec's evenly spaced quantiles (order: ascending)."""
    if spec["dist"] == "fixed":
        return np.full(n, int(spec["value"]), np.int64)
    if spec["dist"] != "loguniform":
        raise ValueError(f"unknown size distribution {spec['dist']!r}")
    q = (np.arange(n) + 0.5) / max(n, 1)
    lo, hi = np.log(spec["lo"]), np.log(spec["hi"])
    return np.rint(np.exp(lo + q * (hi - lo))).astype(np.int64)


def _spread(lo_hi, n: int) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi] (ascending)."""
    lo, hi = int(lo_hi[0]), int(lo_hi[1])
    return lo + (np.arange(n) * (hi - lo + 1)) // max(n, 1)


def _class_counts(classes, n: int) -> list[int]:
    counts = [int(np.floor(c["share"] * n)) for c in classes]
    for i in range(n - sum(counts)):
        counts[i % len(counts)] += 1
    return counts


def _random_seq(rng, n: int) -> bytes:
    return BASES[rng.integers(0, 4, n)].tobytes()


def _low_complexity(rng, n: int, spec: dict) -> bytes:
    """A tandem repeat of a short motif with `divergence` of its bases
    substituted (a RepeatMasker low-complexity stretch)."""
    k = int(rng.integers(spec["motif"][0], spec["motif"][1] + 1))
    motif = BASES[rng.integers(0, 4, k)]
    s = np.resize(motif, n).copy()
    hit = rng.random(n) < spec["divergence"]
    s[hit] = BASES[rng.integers(0, 4, int(hit.sum()))]
    return s.tobytes()


def _edit(rng, base: bytes, n_edits: int, op_cdf: np.ndarray) -> str:
    """`base` with n_edits edits applied one after another, each at a
    position in [1, len - 1): a substitution, an insertion or a deletion
    of one base (bench.py's read noise model)."""
    b = bytearray(base)
    u = rng.random((n_edits, 3))
    ops = np.searchsorted(op_cdf, u[:, 0], side="right")
    new = BASES[(u[:, 2] * 4).astype(np.int64)]
    for op, up, nb in zip(ops.tolist(), u[:, 1].tolist(), new.tolist()):
        p = 1 + int(up * (len(b) - 2))
        if op == 0:
            b[p] = nb
        elif op == 1:
            b.insert(p, nb)
        else:
            del b[p]
    return b.decode()


def plan(params: dict, rng: np.random.Generator) -> dict:
    """A batch's sizes, stratified, then shuffled by `rng`: per window its
    length, class, tumor and normal carriers, SV type and SV length."""
    n = int(params["windows_per_call"])
    win_len = rng.permutation(_stratified(params["window_len"], n))
    cls = np.concatenate([np.full(c, i) for i, c in
                          enumerate(_class_counts(params["classes"], n))])
    cls = rng.permutation(cls)
    t_car = np.zeros(n, np.int64)
    n_car = np.zeros(n, np.int64)
    for ci, c in enumerate(params["classes"]):
        idx = np.flatnonzero(cls == ci)
        t_car[idx] = rng.permutation(_spread(c["tumor_carriers"], len(idx)))
        n_car[idx] = rng.permutation(_spread(c["normal_carriers"], len(idx)))
    sv_idx = np.flatnonzero((t_car + n_car) > 0)
    sv_len = np.zeros(n, np.int64)
    sv_len[sv_idx] = rng.permutation(
        _stratified(params["sv"]["len"], len(sv_idx)))
    types = list(params["sv"]["types"])
    tw = np.array([params["sv"]["types"][t] for t in types], float)
    per_type = _class_counts([{"share": w} for w in tw / tw.sum()],
                             len(sv_idx))
    sv_type = np.full(n, "", object)
    sv_type[sv_idx] = rng.permutation(np.concatenate(
        [np.full(c, t, object) for t, c in zip(types, per_type)]))
    return {"win_len": win_len, "cls": cls, "t_car": t_car, "n_car": n_car,
            "sv_len": sv_len, "sv_type": sv_type}


def make_batch(params: dict, seed: int, batch: int) -> list[Window]:
    """Batch `batch` of the pool: windows_per_call windows."""
    rng = rng_for(seed, 1, batch)
    n = int(params["windows_per_call"])
    flank = int(params["flank"])
    n_t, n_n = int(params["tumor_reads"]), int(params["normal_reads"])
    edits = params["edits"]
    op_w = np.array([edits["ops"][k] for k in ("sub", "ins", "del")], float)
    op_cdf = np.cumsum(op_w / op_w.sum())[:-1]
    pl = plan(params, rng)
    win_len, cls, sv_len, sv_type = (pl["win_len"], pl["cls"], pl["sv_len"],
                                     pl["sv_type"])
    t_car, n_car = pl["t_car"], pl["n_car"]
    has_sv = (t_car + n_car) > 0
    len_bin = np.searchsorted(np.quantile(win_len, [0.25, 0.5, 0.75]),
                              win_len, side="right")
    wins = []
    for w in range(n):
        L = int(win_len[w])
        c = params["classes"][cls[w]]
        body = (_low_complexity(rng, L, params["low_complexity"])
                if c.get("low_complexity") else _random_seq(rng, L))
        ref = _random_seq(rng, flank) + body + _random_seq(rng, flank)
        alt = ref
        if has_sv[w]:
            mid = flank + L // 2
            if sv_type[w] == "INS":
                alt = ref[:mid] + _random_seq(rng, int(sv_len[w])) + ref[mid:]
            else:
                dl = min(int(sv_len[w]), L - 20)    # keep 10 bp either side
                s0 = flank + (L - dl) // 2
                alt = ref[:s0] + ref[s0 + dl:]
        carrier = np.concatenate([np.arange(n_t) < t_car[w],
                                  np.arange(n_n) < n_car[w]])
        k = (np.full(n_t + n_n, int(edits["per_read"]))
             if "per_read" in edits else
             rng.binomial(np.where(carrier, len(alt), len(ref)),
                          edits["rate"]))
        reads, ids = [], []
        for i in range(n_t + n_n):
            tumor = i < n_t
            reads.append(_edit(rng, alt if carrier[i] else ref, int(k[i]),
                               op_cdf))
            ids.append(f"S{batch}_{'tumor' if tumor else 'normal'}|w{w}r{i}")
        start = 1000 + w * 2000
        wins.append(Window([ref.decode()] + reads, ids,
                           ref[:flank].decode(), ref[-flank:].decode(),
                           f"chr{batch + 1}\t{start}\t{start + L}",
                           "NormalOutput", f"{c['name']}.{len_bin[w]}"))
    return wins


def make_pool(params: dict, seed: int) -> list[list[Window]]:
    """pool_calls distinct batches, the same for the same seed."""
    return [make_batch(params, seed, b) for b in range(int(params["pool_calls"]))]
