"""The JAX DataPrepare golden: what the port's DataPrepare, localGraph_npz,
viz and per-K em_cluster must reproduce, and the chromosome run's outputs.

`tests/data/jax_dataprepare_golden.json` holds:
  * `synth_pair.outputs`: the text of every file that the JAX CLI's
    `DataPrepare --selectwindows --FullProcess` (an empty RepeatMasker bed)
    and then `adjustVCF` write for the synth pair, normalised as
    tests/alnfeature_golden.py does (`##fileDate=` dropped, the run's
    directory written as `<dir>`): the Candidate*.bed files,
    InterALNSVs.vcf, the Raw.bed, S.Somatic.bed, RandomForestResult.tsv,
    S.vcf, S.mergedSomatic.vcf and the adjusted VCF;
  * `npz_replay.raw_bed`: the Raw.bed of `DataPrepare --saveData` then
    `localGraph_npz` on the same pair;
  * `viz`: the figure inputs of the pair's somatic window (FIG_RECORD):
    the MSA encoding's shape and sha256, the flank, kept and selected
    columns, the cutoff, and the EM's K, labels and BICs, with the K-runs
    in which a Dirichlet re-init fired (`reinit_runs`: their BICs move
    with the seed, so only the other runs' BICs compare across random
    streams);
  * `em_cluster`: seeded feature windows (em_windows) with JAX
    em_cluster's K, labels, BICs and `reinit_runs` in float32;
  * `chrom`: the JAX chromosome run (tools/chrom_bench.py at 2.1 Mb, 80
    SVs): the sha256 of every file it leaves (chrom_bench.output_hashes)
    and its recall.

Regenerate (CPU, JAX installed):  python tests/dataprepare_golden.py
The CPU tests recompute every case but the full-size chromosome run from
JAX, so the golden cannot go stale; chip_smoke.py checks the port on the
GPU against it without JAX.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN_PATH = os.path.join(HERE, "data", "jax_dataprepare_golden.json")

RAW_BED = "S.vs.S.TandemRepeat.Raw.bed"
FIG_RECORD = "chr1\t1000\t1100"
EM_SEED = 31
EM_WINDOWS = 10
CHROM_FULL = {"mb": 2.1, "n_sv": 80}
CHROM_SMALL = {"mb": 0.5, "n_sv": 16}


def _paths():
    for p in (REPO, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)


def read_outputs(out_dir: str, run_dir: str) -> dict:
    """Every file under out_dir but the npz payloads, normalised as
    alnfeature_golden.normalise does."""
    _paths()
    from alnfeature_golden import normalise
    out = {}
    for name in sorted(os.listdir(out_dir)):
        if "npz" in name:
            continue
        with open(os.path.join(out_dir, name)) as f:
            out[name] = normalise(f.read(), run_dir)
    return out


def dp_args(d: str, savedir: str, *extra) -> list[str]:
    """`DataPrepare` arguments of the synth pair written under d."""
    return ["DataPrepare", "-D", os.path.join(d, "repeats.bed"), "-T",
            os.path.join(d, "tumor.bam"), "-N", os.path.join(d, "normal.bam"),
            "-t", "S", "-n", "S", "-r", os.path.join(d, "ref.fa"), "-s",
            savedir, "--selectwindows", *extra]


def _write_pair(d: str, make_test_pair):
    make_test_pair(d, seed=0)
    open(os.path.join(d, "repeats.bed"), "w").close()


# --------------------------------------------------------------- JAX side --

@contextlib.contextmanager
def _jax_run():
    """A JAX run that leaves no data mesh behind (ROADMAP Queue C 3)."""
    from svscope_tpu.parallel.dataparallel import set_data_mesh
    try:
        yield
    finally:
        set_data_mesh(None)


def jax_dataprepare() -> tuple[dict, str]:
    """(normalised outputs of DataPrepare --FullProcess + adjustVCF,
    Raw.bed text of --saveData + localGraph_npz) of the JAX CLI."""
    _paths()
    from svscope_tpu import cli
    from synth import make_test_pair
    with tempfile.TemporaryDirectory() as d, _jax_run():
        _write_pair(d, make_test_pair)
        out = os.path.join(d, "out")
        cli.main(dp_args(d, out, "--FullProcess"))
        cli.main(["adjustVCF", "-s", out])
        npz = os.path.join(d, "npz")
        cli.main(dp_args(d, npz, "--saveData"))
        cli.main(["localGraph_npz", "-t", "S", "-n", "S", "-s", npz])
        with open(os.path.join(npz, RAW_BED)) as f:
            return read_outputs(out, d), f.read()


def figure_summary(enc, flank_cols, keep_cols, sel, cutoff, K, labels,
                   bics) -> dict:
    import numpy as np
    enc = np.ascontiguousarray(np.asarray(enc, np.int8))
    return {"enc_shape": list(enc.shape),
            "enc_sha256": hashlib.sha256(enc.tobytes()).hexdigest(),
            "flank_cols": [int(c) for c in flank_cols],
            "keep_cols": [int(c) for c in keep_cols],
            "sel": [int(c) for c in sel], "cutoff": float(cutoff),
            "K": None if K is None else int(K),
            "labels": None if labels is None else [int(l) for l in labels],
            "bics": None if bics is None else [float(b) for b in bics]}


def jax_figure_inputs() -> dict:
    """The JAX viz's figure inputs for FIG_RECORD of the synth pair, as
    svscope_tpu/viz/scopeviz.draw_pipe and draw_window compute them."""
    _paths()
    import numpy as np
    from svscope_tpu.engine.datamaker import data_maker
    from svscope_tpu.engine.decision import call_margin, find_non_same_site
    from svscope_tpu.engine.localgraph import open_bam
    from svscope_tpu.io.fasta import FastaFile
    from svscope_tpu.models.mixture import em_cluster_batch
    from svscope_tpu.native.poa import poa_native
    from svscope_tpu.utils import seq as sq
    from synth import make_test_pair
    with tempfile.TemporaryDirectory() as d:
        ref, tumor, normal, _recs, _ = make_test_pair(d, seed=0)
        win = data_maker(FIG_RECORD, FastaFile(ref),
                         [open_bam(tumor), open_bam(normal)],
                         ["S_tumor", "S_normal"], offset=50, mapq=5)
    _cons, msa = poa_native(win.sequences)
    enc = np.stack([sq.encode(r) for r in msa])
    flank_cols = call_margin(msa[0], win.flank_5, win.flank_3)
    keep_cols = np.setdiff1d(np.arange(enc.shape[1]), flank_cols)
    td_raw = enc[1:, keep_cols]
    cutoff = max(3, enc.shape[0] * 0.05)
    sel = find_non_same_site(td_raw, cutoff)
    feat = td_raw[:, sel]
    K = labels = bics = other = None
    if feat.shape[0] >= 3 and feat.shape[1] >= 10:
        K, _, labels, _t, _g, _p, bics = em_cluster_batch([feat])[0]
        other = em_cluster_batch([feat], seed=2024)[0][6]
    out = figure_summary(enc, flank_cols, keep_cols, sel, cutoff, K, labels,
                         bics)
    out["reinit_runs"] = reinit_runs(bics, other)
    return out


def reinit_runs(bics, other) -> list[bool] | None:
    """Per K-run: did a Dirichlet re-init fire (its BIC moves with the
    EM's seed, which only the re-init's random draws depend on)?"""
    if bics is None:
        return None
    return [bool(a != b) for a, b in zip(bics, other)]


def em_windows(seed: int = EM_SEED, count: int = EM_WINDOWS):
    """Seeded (reads, features) int8 windows of 1-3 clusters with symbol
    noise (4-40 reads, 10-70 columns)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    feats = []
    for _ in range(count):
        n = int(rng.integers(4, 40))
        nf = int(rng.integers(10, 70))
        k_true = int(rng.integers(1, 4))
        protos = rng.integers(0, 4, (k_true, nf))
        x = protos[rng.integers(0, k_true, n)]
        flip = rng.random(x.shape) < 0.05
        feats.append(np.where(flip, rng.integers(0, 5, x.shape), x)
                     .astype(np.int8))
    return feats


def encode_window(x) -> list[str]:
    """A window's rows as digit strings (its codes are 0-4)."""
    return ["".join(str(int(c)) for c in row) for row in x]


def decode_window(rows: list[str]):
    import numpy as np
    return np.array([[int(c) for c in r] for r in rows], np.int8)


def jax_em_cluster(x, dtype_name: str, seed: int = 2023):
    """JAX em_cluster on one window: float64 as the x64 tests run it,
    float32 with x64 off (in x64 mode the JAX per-K path draws its
    Dirichlet re-init in float64 and runs on in float64)."""
    import jax
    import jax.numpy as jnp
    from svscope_tpu.models.mixture import em_cluster
    if dtype_name == "float64":
        return em_cluster(x, dtype=jnp.float64, seed=seed)
    with jax.enable_x64(False):
        return em_cluster(x, dtype=jnp.float32, seed=seed)


def jax_em_entries() -> list[dict]:
    out = []
    for x in em_windows():
        K, _, labels, _t, _g, _p, bics = jax_em_cluster(x, "float32")
        other = jax_em_cluster(x, "float32", seed=2024)[6]
        out.append({"x": encode_window(x), "K": int(K),
                    "labels": [int(l) for l in labels],
                    "bics": [float(b) for b in bics],
                    "reinit_runs": reinit_runs(bics, other)})
    return out


def jax_chrom(mb: float, n_sv: int) -> dict:
    """Output hashes and recall of the JAX chromosome run
    (tools/chrom_bench.py) at mb Mb with n_sv planted SVs."""
    _paths()
    import runpy
    from svscope_tpu_torch.tools.chrom_bench import output_hashes
    with tempfile.TemporaryDirectory() as d, _jax_run():
        argv = sys.argv
        sys.argv = ["chrom_bench.py", "--mb", str(mb), "--n-sv", str(n_sv),
                    "--savedir", d]
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                runpy.run_path(os.path.join(REPO, "tools", "chrom_bench.py"),
                               run_name="__main__")
        finally:
            sys.argv = argv
        recall = [l for l in buf.getvalue().splitlines()
                  if l.startswith("[recall]")][0]
        hit, n = recall.split()[1].split("/")
        return {"mb": mb, "n_sv": n_sv, "recall": [int(hit), int(n)],
                "hashes": output_hashes(d)}


def bics_match(want, got, k_sel: int, rtol: float) -> int:
    """BICs within rtol, but for K-runs that restarted on one side only (a
    float32 ulp at the M-step's `pi*N < 1` threshold, or another random
    stream for the re-init): such a run may differ only where it is below
    the selected K's BIC on both sides, so it cannot change the selection.
    Returns the count of such runs; raises AssertionError otherwise."""
    import numpy as np
    wb, gb = np.asarray(want, np.float64), np.asarray(got, np.float64)
    if wb.shape != gb.shape:
        raise AssertionError(f"BIC count {gb.shape} != {wb.shape}")
    close = np.isclose(gb, wb, rtol=rtol, atol=0, equal_nan=True)
    sel = k_sel - 1
    if close.all():
        return 0
    if not close[sel] or not ((wb[~close] < wb[sel]).all()
                              and (gb[~close] < gb[sel]).all()):
        raise AssertionError(f"BICs differ beyond rtol {rtol}: {gb} vs {wb}")
    return int((~close).sum())


# -------------------------------------------------------------- port side --

def port_dataprepare(device: str, extra=()) -> dict:
    """Normalised outputs of the port's `DataPrepare --selectwindows
    --FullProcess --device <device>` (plus `extra`) and `adjustVCF` on the
    synth pair."""
    _paths()
    from svscope_tpu_torch import cli
    from torch_workloads import make_test_pair
    with tempfile.TemporaryDirectory() as d:
        _write_pair(d, make_test_pair)
        out = os.path.join(d, "out")
        cli.main(dp_args(d, out, "--FullProcess", "--device", device,
                         *extra))
        cli.main(["adjustVCF", "-s", out])
        return read_outputs(out, d)


def port_npz_replay(device: str) -> str:
    """Raw.bed text of the port's `DataPrepare --saveData` then
    `localGraph_npz --device <device>` on the synth pair."""
    _paths()
    from svscope_tpu_torch import cli
    from torch_workloads import make_test_pair
    with tempfile.TemporaryDirectory() as d:
        _write_pair(d, make_test_pair)
        npz = os.path.join(d, "npz")
        cli.main(dp_args(d, npz, "--saveData", "--device", device))
        cli.main(["localGraph_npz", "-t", "S", "-n", "S", "-s", npz,
                  "--device", device])
        with open(os.path.join(npz, RAW_BED)) as f:
            return f.read()


def port_figure_inputs(device: str) -> dict:
    """The port's viz.scopeviz.figure_inputs for FIG_RECORD on `device`."""
    _paths()
    from svscope_tpu_torch.engine.datamaker import data_maker
    from svscope_tpu_torch.engine.localgraph import open_bam
    from svscope_tpu_torch.io.fasta import FastaFile
    from svscope_tpu_torch.viz.scopeviz import figure_inputs
    from torch_workloads import make_test_pair
    with tempfile.TemporaryDirectory() as d:
        ref, tumor, normal, _recs, _ = make_test_pair(d, seed=0)
        win = data_maker(FIG_RECORD, FastaFile(ref),
                         [open_bam(tumor), open_bam(normal)],
                         ["S_tumor", "S_normal"], offset=50, mapq=5)
    fi = figure_inputs(win, device=device)
    return figure_summary(fi["enc"], fi["flank_cols"], fi["keep_cols"],
                          fi["sel"], fi["cutoff"], fi["K"], fi["labels"],
                          fi["bics"])


def make_golden(chrom: dict = CHROM_FULL) -> dict:
    outputs, npz_raw = jax_dataprepare()
    return {"synth_pair": {"seed": 0, "repeats_bed": "", "outputs": outputs},
            "npz_replay": {"raw_bed": npz_raw},
            "viz": {"record": FIG_RECORD, **jax_figure_inputs()},
            "em_cluster": {"seed": EM_SEED, "dtype": "float32",
                           "windows": jax_em_entries()},
            "chrom": jax_chrom(**chrom)}


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
