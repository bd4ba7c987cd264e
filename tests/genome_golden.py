"""The JAX genome golden: what the port's genome bench
(svscope_tpu_torch/tools/genome_bench.py) must reproduce.

`tests/data/jax_genome_golden.json` holds, for two configurations of the
JAX harness (tools/genome_bench.py, host POA, on the CPU under x64):
  * `small` (GENOME_SMALL: 2 x 1 Mb at depth 12): all nine planted classes
    and a second chromosome for rf_trap's cross-chromosome alignments;
    the CPU tests recompute it from JAX, so it cannot go stale;
  * `full` (GENOME_FULL: 4 x 5 Mb at depth 12, the harness's default),
    generated once; chip_smoke.py holds the card to it.
Each holds the candidate window count, `raw_bed` and `vcf` as
genome_bench.score gives them (precision [calls on truth, calls], recall
[truth hit, truth], decoys [decoys hit, decoys]), the per-class `tiers`
(n, candidate, Raw.bed, VCF) and the sha256 of every file the run leaves
(chrom_bench.output_hashes: the BAMs as bytes).
`wgs_small` holds the JAX wgs harness (tools/wgs_bench.py) at WGS_SMALL
(2 x 1 Mb at 30x, 10 kb windows): the table's row count and the sha256 of
its background_stats frame (svscope_tpu_torch.tools.wgs_bench.frame_sha256).

Regenerate (CPU, JAX installed, ~1 min):  python tests/genome_golden.py
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import re
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_PATH = os.path.join(HERE, "data", "jax_genome_golden.json")

GENOME_SMALL = {"mb_per_chrom": 1.0, "chroms": 2, "depth": 12}
GENOME_FULL = {"mb_per_chrom": 5.0, "chroms": 4, "depth": 12}
WGS_SMALL = {"coverage": 30.0, "chrom_mb": 1.0, "n_chrom": 2, "window_kb": 10}
_SCORE = re.compile(r"^\[(Raw\.bed|mergedVCF)\] precision [\d.]+ \((\d+)/"
                    r"(\d+) calls on truth\), recall [\d.]+ \((\d+)/(\d+)\),"
                    r" decoys called (\d+)/(\d+)$")


def parse_jax_log(text: str) -> dict:
    """Candidate count, scores and tier table from the JAX harness's
    printout."""
    out = {"tiers": {}}
    for line in text.splitlines():
        m = _SCORE.match(line)
        if m:
            n = [int(x) for x in m.groups()[1:]]
            key = "raw_bed" if m.group(1) == "Raw.bed" else "vcf"
            out[key] = {"precision": n[0:2], "recall": n[2:4],
                        "decoys": n[4:6]}
        elif line.startswith("[select]"):
            out["candidates"] = int(line.split()[2])
        elif line.startswith("[tiers] ") and not line.startswith(
                "[tiers] class"):
            parts = line.split()
            out["tiers"][parts[1]] = [int(x) for x in parts[2:6]]
    return out


def jax_genome(mb_per_chrom: float, chroms: int, depth: int) -> dict:
    """The JAX genome bench at one configuration: parse_jax_log's fields
    and the output hashes."""
    for p in (REPO, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    import runpy
    from dataprepare_golden import _jax_run
    from svscope_tpu_torch.tools.chrom_bench import output_hashes
    with tempfile.TemporaryDirectory() as d, _jax_run():
        argv = sys.argv
        sys.argv = ["genome_bench.py", "--mb-per-chrom", str(mb_per_chrom),
                    "--chroms", str(chroms), "--depth", str(depth),
                    "--savedir", d]
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(os.path.join(REPO, "tools", "genome_bench.py"),
                               run_name="__main__")
        finally:
            sys.argv = argv
        return {"mb_per_chrom": mb_per_chrom, "chroms": chroms,
                "depth": depth, **parse_jax_log(buf.getvalue()),
                "hashes": output_hashes(d)}


def _jax_tool(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_wgs_frame(coverage: float, chrom_mb: float, n_chrom: int,
                  window_kb: int):
    """(rows, frame) of JAX background_stats on the JAX wgs harness's table
    and its genome grid."""
    from svscope_tpu.engine.features import background_stats
    from svscope_tpu_torch.tools.wgs_bench import genome_grid
    chrom_len = int(chrom_mb * 1e6)
    table = _jax_tool("wgs_bench").synth_table(n_chrom, chrom_len, coverage)
    return len(table), background_stats(
        table, genome_grid(n_chrom, chrom_len, window_kb))


def jax_wgs(**cfg) -> dict:
    from svscope_tpu_torch.tools.wgs_bench import frame_sha256
    rows, df = jax_wgs_frame(**cfg)
    return {**cfg, "rows": rows, "sha256": frame_sha256(df)}


def result_fields(res: dict) -> dict:
    """The fields of a port run (genome_bench.run) that the golden holds."""
    return {k: res[k] for k in ("candidates", "raw_bed", "vcf", "tiers",
                                "hashes")}


def differences(got: dict, want: dict) -> list[str]:
    """Golden fields (and output files, by name) on which got differs."""
    bad = [k for k in ("candidates", "raw_bed", "vcf", "tiers")
           if got[k] != want[k]]
    bad += sorted(k for k in set(got["hashes"]) | set(want["hashes"])
                  if got["hashes"].get(k) != want["hashes"].get(k))
    return bad


def load_golden() -> dict:
    with open(GOLDEN_PATH) as f:
        return json.load(f)


if __name__ == "__main__":
    sys.path[:0] = [REPO, HERE]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_enable_x64", True)
    golden = {"small": jax_genome(**GENOME_SMALL),
              "full": jax_genome(**GENOME_FULL),
              "wgs_small": jax_wgs(**WGS_SMALL)}
    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    with open(GOLDEN_PATH, "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    print(GOLDEN_PATH)
