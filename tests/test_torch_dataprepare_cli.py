"""The port's `DataPrepare` and `localGraph_npz` subcommands with --device
cpu against tests/data/jax_dataprepare_golden.json (the JAX CLI's outputs
on the synth pair, normalised as tests/alnfeature_golden.py does), and the
golden against a fresh JAX run; the npz payloads against JAX's; the
chromosome bench at 0.5 Mb against the JAX harness's.  Text outputs must
be equal."""
import os

import numpy as np
import pytest
import torch

import dataprepare_golden as dg
import svscope_tpu.engine.npz as jnpz
import svscope_tpu_torch.engine.localgraph as tlg
import svscope_tpu_torch.engine.npz as tnpz
from svscope_tpu import cli as jcli
from svscope_tpu.engine.localgraph import open_bam as jopen_bam
from svscope_tpu.parallel.dataparallel import set_data_mesh
from svscope_tpu_torch import cli
from svscope_tpu_torch.engine.localgraph import open_bam as topen_bam
from svscope_tpu_torch.tools import chrom_bench

from synth import make_test_pair

torch.set_num_threads(1)

# four somatic windows (INS and DEL) and a germline one: enough rows for a
# half-written Raw.bed
REPLAY_WINDOWS = [
    dict(start=1000, end=1100, svtype="INS", svlen=60, som_reads=5, depth=12),
    dict(start=4000, end=4100, svtype="DEL", svlen=80, som_reads=5, depth=12),
    dict(start=7000, end=7100, svtype="INS", svlen=90, som_reads=6, depth=12),
    dict(start=10000, end=10100, svtype=None, svlen=0, som_reads=0,
         depth=10),
    dict(start=13000, end=13100, svtype="DEL", svlen=70, som_reads=5,
         depth=12)]


@pytest.fixture(scope="module")
def golden():
    return dg.load_golden()


def test_golden_is_fresh(golden):
    outputs, npz_raw = dg.jax_dataprepare()
    assert outputs == golden["synth_pair"]["outputs"]
    assert npz_raw == golden["npz_replay"]["raw_bed"]
    assert npz_raw == outputs[dg.RAW_BED]
    assert golden["chrom"]["recall"] == [80, 80]
    assert golden["chrom"]["mb"] == dg.CHROM_FULL["mb"]


@pytest.mark.parametrize("device_poa", [None, "fused"])
def test_dataprepare_full_process_matches_golden(golden, device_poa):
    """`DataPrepare --selectwindows --FullProcess --device cpu`, then
    `adjustVCF`: the CandidateSpan beds, InterALNSVs.vcf, the Raw.bed, the
    AlnFeature outputs and the adjusted VCF equal JAX's (host POA, and
    the fused engine's plain versions)."""
    extra = ("--device-poa", device_poa) if device_poa else ()
    out = dg.port_dataprepare("cpu", extra)
    assert out == golden["synth_pair"]["outputs"]
    assert "EMOutput" in out[dg.RAW_BED]


def test_npz_replay_matches_golden(golden):
    raw = dg.port_npz_replay("cpu")
    assert raw == golden["npz_replay"]["raw_bed"]
    assert raw == golden["synth_pair"]["outputs"][dg.RAW_BED]


def _payloads(wins):
    return [(list(w.sequences), [str(r) for r in w.read_ids], w.flank_5,
             w.flank_3, w.record, w.flag) for w in wins]


@pytest.fixture(scope="module")
def replay_pair(tmp_path_factory):
    """A five-window pair, its window records and both packages' npz
    exports of them."""
    d = str(tmp_path_factory.mktemp("replay"))
    ref, tumor, normal, recs, _ = make_test_pair(
        d, seed=3, ref_len=16_000, windows=REPLAY_WINDOWS)
    for name, save, open_bam in (("jax", jnpz.save_window_data, jopen_bam),
                                 ("port", tnpz.save_window_data,
                                  topen_bam)):
        save(recs, ref, [tumor], [normal], ["S"], ["S"],
             os.path.join(d, name), offset=50)
    return d, ref, tumor, normal, recs


def test_npz_payloads_equal_jax(replay_pair):
    """Both exports, loaded by both loaders, give the same payloads (the
    files hold pickled object arrays, so payloads are compared, not
    bytes)."""
    d = replay_pair[0]
    loads = {(w, r): _payloads(mod.load_window_data(os.path.join(d, w)))
             for w in ("jax", "port")
             for r, mod in (("jax", jnpz), ("port", tnpz))}
    want = loads[("jax", "jax")]
    assert len(want) == len(REPLAY_WINDOWS)
    assert all(v == want for v in loads.values())


def _replay(savedir, *extra):
    return cli.main(["localGraph_npz", "-t", "S", "-n", "S", "-s", savedir,
                     "--device", "cpu", *extra])


def test_npz_replay_continue(replay_pair, tmp_path, monkeypatch):
    """`localGraph_npz -C` on a half-written Raw.bed replays only the
    windows it lacks and writes the file the full replay writes, which is
    JAX's."""
    import shutil
    d = replay_pair[0]
    full_dir, cont_dir = str(tmp_path / "full"), str(tmp_path / "cont")
    shutil.copytree(os.path.join(d, "port"), full_dir)
    shutil.copytree(os.path.join(d, "port"), cont_dir)
    with open(_replay(full_dir)) as f:
        full = f.read()
    rows = full.splitlines(keepends=True)
    assert len(rows) == len(REPLAY_WINDOWS)
    with open(os.path.join(cont_dir, dg.RAW_BED), "w") as f:
        f.write("".join(rows[:2]))
    seen = []
    real = tlg.process_window_batch

    def counting(wins, **kw):
        seen.extend(w.record for w in wins)
        return real(wins, **kw)

    monkeypatch.setattr(tlg, "process_window_batch", counting)
    with open(_replay(cont_dir, "-C")) as f:
        assert f.read() == full
    assert len(seen) == len(REPLAY_WINDOWS) - 2
    jdir = str(tmp_path / "jax")
    shutil.copytree(os.path.join(d, "jax"), jdir)
    try:
        jcli.main(["localGraph_npz", "-t", "S", "-n", "S", "-s", jdir])
    finally:
        set_data_mesh(None)
    with open(os.path.join(jdir, dg.RAW_BED)) as f:
        assert f.read() == full


def test_cleanup_dat_removes_only_intermediates(golden, tmp_path):
    d = str(tmp_path)
    make_test_pair(d, seed=0)
    open(os.path.join(d, "repeats.bed"), "w").close()
    out = os.path.join(d, "out")
    cli.main(dg.dp_args(d, out, "--FullProcess", "--device", "cpu", "-c"))
    want = {k: v for k, v in golden["synth_pair"]["outputs"].items()
            if not (k.startswith("Candidate") and k.endswith(".bed")
                    and not k.endswith(".somatic.bed"))
            and "adjusted" not in k}
    assert len(want) < len(golden["synth_pair"]["outputs"]) - 5
    assert dg.read_outputs(out, d) == want


def test_dataprepare_without_selectwindows_does_nothing(tmp_path):
    d = str(tmp_path)
    make_test_pair(d, seed=0)
    open(os.path.join(d, "repeats.bed"), "w").close()
    args = [a for a in dg.dp_args(d, os.path.join(d, "port"), "--device",
                                  "cpu", "--FullProcess")
            if a != "--selectwindows"]
    cli.main(args)
    jargs = [a for a in dg.dp_args(d, os.path.join(d, "jax"),
                                   "--FullProcess") if a != "--selectwindows"]
    try:
        jcli.main(jargs)
    finally:
        set_data_mesh(None)
    assert os.listdir(os.path.join(d, "port")) == \
        os.listdir(os.path.join(d, "jax")) == []


def test_dataprepare_missing_repeat_bed(tmp_path, capsys):
    d = str(tmp_path)
    make_test_pair(d, seed=0)
    with pytest.raises(SystemExit):
        cli.main(dg.dp_args(d, os.path.join(d, "o"), "--device", "cpu"))
    assert "RepeatMasker bed not found" in capsys.readouterr().err


def test_chrom_bench_small_matches_jax(tmp_path):
    """The chromosome bench at 0.5 Mb and 16 SVs: every file it leaves
    equals the JAX harness's (tools/chrom_bench.py), recall 16/16."""
    want = dg.jax_chrom(**dg.CHROM_SMALL)
    got = chrom_bench.run(**dg.CHROM_SMALL, device="cpu",
                          savedir=str(tmp_path), log=lambda *_: None)
    assert got["hashes"] == want["hashes"]
    assert got["recall"] == want["recall"] == [16, 16]
    assert got["large_del"] == [2, 2]
    assert set(got["stages"]) == {"synth", "scan", "select", "localGraph",
                                  "AlnFeature", "adjustVCF"}
    np.testing.assert_array_less(0, list(got["stages"].values()))


def test_native_breakpoint_scan_failure_raises(monkeypatch):
    """DataPrepare's native scan with breakpoints has no Python fallback:
    its failure reaches the caller."""
    import argparse

    import svscope_tpu_torch.native.bam as nbam

    def failing(path, *_a, **_k):
        raise OSError(f"{path}: libbamscan.so not loadable")

    monkeypatch.setattr(nbam, "scan_with_breakpoints", failing)
    args = argparse.Namespace(Tumorbam="t.bam", Normalbam="n.bam")
    with pytest.raises(OSError, match="libbamscan"):
        cli._load_tables_with_bp(args)
