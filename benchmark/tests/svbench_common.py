"""Shared inputs of the benchmark's tests: a traffic mix small enough for
the CPU (8 windows of 16 reads), limits for it, and a harness run on it."""
from __future__ import annotations

import copy

TINY = {
    "windows_per_call": 8, "pool_calls": 2, "tumor_reads": 8,
    "normal_reads": 8,
    "window_len": {"dist": "loguniform", "lo": 80, "hi": 160}, "flank": 30,
    "classes": [
        {"name": "somatic", "share": 0.5, "tumor_carriers": [4, 6],
         "normal_carriers": [0, 0]},
        {"name": "germline", "share": 0.25, "tumor_carriers": [4, 4],
         "normal_carriers": [4, 4]},
        {"name": "none", "share": 0.25, "tumor_carriers": [0, 0],
         "normal_carriers": [0, 0], "low_complexity": True}],
    "sv": {"types": {"INS": 1, "DEL": 1},
           "len": {"dist": "loguniform", "lo": 20, "hi": 60}},
    "edits": {"rate": 0.01, "ops": {"sub": 1, "ins": 1, "del": 1}},
    "low_complexity": {"motif": [2, 6], "divergence": 0.1},
}
TINY_LIMITS = {"sample": 8, "rows_differing": 0, "bic_gap": 1e-4}
SEED = 2 ** 31 + 99


def tiny_run(cell="ont30x-default.typical", seed=SEED, trace=False,
             params=None, log=lambda s: None, **kw):
    from benchmark import harness
    return harness.run(cell, seed, 0.2, trace, "cpu",
                       params=copy.deepcopy(params or TINY),
                       limits=dict(TINY_LIMITS), log=log, **kw)
