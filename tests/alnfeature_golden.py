"""The JAX AlnFeature golden: what the port's AlnFeature, callsomaticSV and
adjustVCF must reproduce, and K2's statistics at every bucket.

`tests/data/jax_alnfeature_golden.json` holds:
  * `synth_pair.raw_bed`: the Raw.bed that JAX run_local_graph writes for
    the synth pair (its sha256 is jax_localgraph_golden.json's);
  * `synth_pair.outputs`: the text of every file that the JAX CLI's
    `AlnFeature` (on that Raw.bed) and then `adjustVCF` write, normalised:
    the `##fileDate=` line (the wall clock) is dropped and the run's
    directory is written as `<dir>`;
  * `nw`: JAX nw_stats_batch's (score, matches, align_len) for seeded pairs
    (torch_workloads.bucket_pairs) at every K2 bucket, under both score
    sets, with the sha256 of the pairs.

Regenerate (CPU, JAX installed):  python tests/alnfeature_golden.py
tests/test_torch_aln_cli.py recomputes it from JAX so it cannot go stale;
chip_smoke.py checks the port on the GPU against it without JAX.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_PATH = os.path.join(HERE, "data", "jax_alnfeature_golden.json")

OUTPUTS = ("S.Somatic.bed", "RandomForestResult.tsv", "S.vcf",
           "S.mergedSomatic.vcf", "S.mergedSomatic.adjusted.vcf")
RAW_BED = "S.vs.S.TandemRepeat.Raw.bed"
BUCKETS = (128, 256, 512, 1024, 2048, 4096)
NW_PAIRS = {128: 12, 256: 12, 512: 8, 1024: 6, 2048: 4, 4096: 4}
NW_SEED = 7
SCORINGS = {"misscore": (1, 0, -1), "edit": (0, -1, -1)}


def _helpers():
    for p in (REPO, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch_workloads
    return torch_workloads


def normalise(text: str, run_dir: str) -> str:
    """Output text without the wall clock and the run's directory."""
    return "".join(l for l in text.replace(run_dir, "<dir>")
                   .splitlines(keepends=True)
                   if not l.startswith("##fileDate="))


def read_outputs(out_dir: str, run_dir: str, names=OUTPUTS) -> dict:
    out = {}
    for name in names:
        with open(os.path.join(out_dir, name)) as f:
            out[name] = normalise(f.read(), run_dir)
    return out


def aln_args(d: str, ref: str, tumor: str, normal: str, raw_bed: str):
    """`AlnFeature` arguments of the synth pair (output in d/out)."""
    return ["AlnFeature", "-B", raw_bed, "-T", tumor, "-N", normal, "-t",
            "S", "-n", "S", "-r", ref, "-s", os.path.join(d, "out")]


def nw_case(bucket: int):
    """The seeded pairs of one bucket and their sha256."""
    import numpy as np
    pairs = _helpers().bucket_pairs(np.random.default_rng(NW_SEED + bucket),
                                    bucket, NW_PAIRS[bucket])
    sha = hashlib.sha256("\n".join(f"{a}\t{b}" for a, b in pairs).encode())
    return pairs, sha.hexdigest()


def pad_pairs(pairs, l_max: int):
    """(a_codes, b_codes, la, lb) numpy arrays of `pairs` padded to l_max."""
    import numpy as np
    ac = np.zeros((len(pairs), l_max), np.uint8)
    bc = np.zeros((len(pairs), l_max), np.uint8)
    la = np.zeros(len(pairs), np.int32)
    lb = np.zeros(len(pairs), np.int32)
    for k, (a, b) in enumerate(pairs):
        ac[k, :len(a)] = np.frombuffer(a.encode(), np.uint8)
        bc[k, :len(b)] = np.frombuffer(b.encode(), np.uint8)
        la[k], lb[k] = len(a), len(b)
    return ac, bc, la, lb


def jax_nw_stats(pairs, l_max: int, scoring) -> list[list[int]]:
    import numpy as np
    from svscope_tpu.ops.nw_batch import nw_stats_batch
    s, m, al = nw_stats_batch(*pad_pairs(pairs, l_max), l_max, *scoring)
    return np.stack([np.asarray(s), np.asarray(m), np.asarray(al)],
                    1).tolist()


def jax_aln_outputs() -> tuple[str, dict]:
    """(Raw.bed text, normalised outputs) of the JAX CLI on the synth pair:
    localGraph's Raw.bed, then `AlnFeature` on it and `adjustVCF`."""
    import tempfile
    import localgraph_golden as lgg
    from svscope_tpu import cli
    with tempfile.TemporaryDirectory() as d:
        raw_bed = lgg.jax_synth_raw_bed(d)
        with open(raw_bed) as f:
            raw = f.read()
        ref, tumor, normal = (os.path.join(d, x) for x in
                              ("ref.fa", "tumor.bam", "normal.bam"))
        cli.main(aln_args(d, ref, tumor, normal, raw_bed))
        cli.main(["adjustVCF", "-s", os.path.join(d, "out")])
        return raw, read_outputs(os.path.join(d, "out"), d)


def port_aln_outputs(raw_bed_text: str, device: str) -> dict:
    """Normalised outputs of the port's CLI on the synth pair (written by
    the port's copy of synth.make_test_pair): `AlnFeature --device
    <device>` on the given Raw.bed text, then `adjustVCF`."""
    import tempfile
    import localgraph_golden as lgg
    from svscope_tpu_torch import cli
    with tempfile.TemporaryDirectory() as d:
        ref, tumor, normal, _recs = lgg.make_synth_pair(d)
        raw_bed = os.path.join(d, RAW_BED)
        with open(raw_bed, "w") as f:
            f.write(raw_bed_text)
        cli.main(aln_args(d, ref, tumor, normal, raw_bed)
                 + ["--device", device])
        cli.main(["adjustVCF", "-s", os.path.join(d, "out")])
        return read_outputs(os.path.join(d, "out"), d)


def port_call_somatic_outputs(device: str) -> dict:
    """Normalised Raw.bed and AlnFeature outputs of the port's
    `callsomaticSV --device <device>` on the synth pair."""
    import tempfile
    import localgraph_golden as lgg
    from svscope_tpu_torch import cli
    with tempfile.TemporaryDirectory() as d:
        ref, tumor, normal, recs = lgg.make_synth_pair(d)
        bed = os.path.join(d, "windows.bed")
        with open(bed, "w") as f:
            f.write("".join(r + "\n" for r in recs))
        cli.main(["callsomaticSV", "--device", device, "-w", bed, "-T",
                  tumor, "-N", normal, "-t", "S", "-n", "S", "-r", ref,
                  "-s", os.path.join(d, "out")])
        return read_outputs(os.path.join(d, "out"), d,
                            (RAW_BED,) + OUTPUTS[:4])


def make_golden() -> dict:
    raw, outputs = jax_aln_outputs()
    nw = {"seed": NW_SEED, "buckets": {}}
    for bucket in BUCKETS:
        pairs, sha = nw_case(bucket)
        nw["buckets"][str(bucket)] = {
            "pairs": len(pairs), "pairs_sha256": sha,
            **{k: jax_nw_stats(pairs, bucket, sc)
               for k, sc in SCORINGS.items()}}
    return {"synth_pair": {"raw_bed": raw, "outputs": outputs}, "nw": nw}


def load_golden() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


if __name__ == "__main__":
    sys.path[:0] = [REPO, HERE]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_enable_x64", True)
    golden = make_golden()
    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    with open(GOLDEN_PATH, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(GOLDEN_PATH)
