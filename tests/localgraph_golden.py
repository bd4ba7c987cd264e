"""The JAX localGraph golden: what the PyTorch port must reproduce.

`tests/data/jax_localgraph_golden.json` holds, for each workload, the
sha256 of every record the JAX engine (svscope_tpu, host C++ POA, float32
EM) emits, as the tab-joined Raw.bed line, plus the sha256 of the whole
Raw.bed that JAX `run_local_graph` writes for `synth.make_test_pair`.  The
window payloads are rebuilt from the recorded arguments of
`bench.make_window_payloads`; `payload_sha256` fingerprints them, so a
machine whose numpy draws other payloads is told so instead of failing on
the records.

Regenerate (CPU, JAX installed):  python tests/localgraph_golden.py
tests/test_torch_golden.py recomputes it from JAX so it cannot go stale;
chip_smoke.py checks the port on the GPU against it without JAX.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_PATH = os.path.join(HERE, "data", "jax_localgraph_golden.json")

# bench.make_window_payloads(n, numpy.random.default_rng(seed), ...)
WORKLOADS = {
    "bench256": {"n": 256, "seed": 0, "n_reads": 24, "ins_carriers": 8},
    "heavy32x400": {"n": 32, "seed": 5, "n_reads": 400,
                    "ins_carriers": 200},
}
SYNTH = {"seed": 0, "offset": 50, "t_ids": ["S"], "n_ids": ["S"]}


def sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def record_line(record) -> str:
    """Tab-joined record, as it appears in Raw.bed."""
    return "\t".join(str(x) for x in record)


def make_workload(name: str):
    """Window payloads of a golden workload (JAX-free)."""
    import numpy as np
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from bench import make_window_payloads
    w = WORKLOADS[name]
    return make_window_payloads(w["n"], np.random.default_rng(w["seed"]),
                                n_reads=w["n_reads"],
                                ins_carriers=w["ins_carriers"])


def payload_sha256(wins) -> str:
    h = hashlib.sha256()
    for w in wins:
        for part in (w.record, w.flag, w.flank_5, w.flank_3,
                     *w.sequences, *[str(r) for r in w.read_ids]):
            h.update(part.encode())
            h.update(b"\n")
    return h.hexdigest()


def make_synth_pair(tmpdir: str):
    """(ref_path, tumor_bam, normal_bam, window_records) of the synth
    pair (JAX-free)."""
    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from synth import make_test_pair
    ref, tumor, normal, recs, _ = make_test_pair(tmpdir, seed=SYNTH["seed"])
    return ref, tumor, normal, recs


def jax_workload_records(name: str) -> list[str]:
    """Record hashes of the JAX engine on a workload (no data mesh)."""
    from svscope_tpu.engine.localgraph import process_window_batch
    from svscope_tpu.parallel.dataparallel import set_data_mesh
    set_data_mesh(None)
    recs = process_window_batch(make_workload(name), device_poa=False)
    return [sha256(record_line(r)) for r in recs]


def jax_synth_raw_bed_sha() -> str:
    from svscope_tpu.engine.localgraph import run_local_graph
    from svscope_tpu.parallel.dataparallel import set_data_mesh
    with tempfile.TemporaryDirectory() as d:
        ref, tumor, normal, recs = make_synth_pair(d)
        try:
            out = run_local_graph(recs, ref, [tumor], [normal],
                                  SYNTH["t_ids"], SYNTH["n_ids"],
                                  os.path.join(d, "out"),
                                  offset=SYNTH["offset"])
        finally:
            set_data_mesh(None)
        with open(out, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()


def make_golden() -> dict:
    out = {"record_hash": "sha256 of the tab-joined record (Raw.bed line)",
           "workloads": {}, "synth_pair": dict(SYNTH)}
    for name, args in WORKLOADS.items():
        out["workloads"][name] = {
            **args,
            "payload_sha256": payload_sha256(make_workload(name)),
            "records": jax_workload_records(name)}
    out["synth_pair"]["raw_bed_sha256"] = jax_synth_raw_bed_sha()
    return out


def load_golden() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_enable_x64", True)
    golden = make_golden()
    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    with open(GOLDEN_PATH, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(GOLDEN_PATH)
