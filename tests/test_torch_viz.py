"""The port's viz (viz/scopeviz) against the JAX package's: the figure's
inputs for the synth pair's somatic window (MSA encoding, flank, kept and
selected columns, cutoff, K, labels; BICs within float32's 1e-5, see
dataprepare_golden.bics_match) equal JAX's and the golden's; the `viz`
subcommand writes a PNG on the CPU and raises on a window without reads
as JAX does."""
import os

import pytest
import torch

import dataprepare_golden as dg
from svscope_tpu import cli as jcli
from svscope_tpu.parallel.dataparallel import set_data_mesh
from svscope_tpu_torch import cli

from synth import make_test_pair

torch.set_num_threads(1)


def _assert_same_figure(got, want):
    assert {k: v for k, v in got.items() if k != "bics"} == \
        {k: v for k, v in want.items() if k != "bics"}
    dg.bics_match(want["bics"], got["bics"], want["K"], 1e-5)


def test_figure_inputs_match_jax_and_golden():
    want = dg.jax_figure_inputs()
    golden = dg.load_golden()["viz"]
    assert golden["record"] == dg.FIG_RECORD
    assert {k: v for k, v in golden.items() if k != "record"} == want
    got = dg.port_figure_inputs("cpu")
    assert got["K"] == 2 and len(got["sel"]) >= 10
    _assert_same_figure(got, {k: v for k, v in want.items()
                              if k != "reinit_runs"})


def _viz_args(d, window):
    return ["viz", "-w", window, "-T", os.path.join(d, "tumor.bam"), "-N",
            os.path.join(d, "normal.bam"), "-t", "S", "-n", "S", "-r",
            os.path.join(d, "ref.fa"), "-s", os.path.join(d, "viz")]


@pytest.fixture
def pair2(tmp_path):
    d = str(tmp_path)
    make_test_pair(d, seed=2)
    return d


def test_viz_cli_writes_png(pair2):
    out = cli.main(_viz_args(pair2, "chr1:1000-1100") + ["--device", "cpu"])
    assert out.endswith("chr1_1000-1100.window.png")
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(out) > 20_000      # a real rendered figure


def test_viz_window_bed_skips_empty_windows(pair2):
    bed = os.path.join(pair2, "w.bed")
    with open(bed, "w") as f:
        f.write("chrom\tstart\tend\nchr1\t1000\t1100\nchr1\t58000\t58100\n")
    outs = cli.main(_viz_args(pair2, bed) + ["--device", "cpu",
                                             "--no-graph"])
    assert [os.path.basename(o) for o in outs] == \
        ["chr1_1000-1100.window.png"]


def test_viz_window_without_reads_raises_as_jax(pair2):
    errors = []
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        try:
            with pytest.raises(Exception) as info:
                main(_viz_args(pair2, "chr1:58000-58100") + extra)
        finally:
            set_data_mesh(None)
        errors.append((type(info.value), str(info.value)))
    assert errors[1] == errors[0]
    assert errors[0][0] is ValueError


def test_viz_window_bed_lets_device_errors_raise(pair2, monkeypatch):
    """Only a window without spanning reads (ValueError) is skipped; an
    error from the EM's device reaches the caller."""
    import svscope_tpu_torch.viz.scopeviz as sv

    def failing(*_a, **_k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(sv, "draw_pipe", failing)
    bed = os.path.join(pair2, "w.bed")
    with open(bed, "w") as f:
        f.write("chr1\t1000\t1100\n")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        cli.main(_viz_args(pair2, bed) + ["--device", "cpu"])
