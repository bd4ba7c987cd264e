"""The port's out/ensemble (the minda wrapper) against the JAX package's:
parse_minda_out on a written minda VCF gives the same two files, and
run_minda_ensemble without minda raises as JAX does."""
import os

import pytest

import svscope_tpu.out.ensemble as jens
import svscope_tpu_torch.out.ensemble as tens

MINDA_VCF = """##fileformat=VCFv4.2
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO
chr1\t1000\tm1\tN\t<INS>\t.\tPASS\tSVTYPE=INS;SVLEN=60;SUPPORT=2
chr1\t5400\tm2\tN\t<DEL>\t.\tPASS\tSVTYPE=DEL;SVLEN=-20000
chr2\t300\tm3\tN\t<DUP>\t.\tPASS\tSVTYPE=DUP;SVLEN=9999;FLAG
chr3\t77\tm4\tN\t<BND>\t.\tPASS\tSVTYPE=BND
"""


@pytest.mark.parametrize("len_cutoff", [10_000, 100])
def test_parse_minda_out(tmp_path, len_cutoff):
    outs = []
    for mod, name in ((jens, "jax"), (tens, "port")):
        d = tmp_path / name
        d.mkdir()
        (d / "None_minda_ensemble.vcf").write_text(MINDA_VCF)
        paths = mod.parse_minda_out("S1", str(d), len_cutoff)
        outs.append([(os.path.basename(p), open(p).read()) for p in paths])
    assert outs[1] == outs[0]
    assert outs[0][0][1].count("\n") == 4


def test_run_minda_ensemble_without_minda(tmp_path, monkeypatch):
    monkeypatch.delenv("MINDA", raising=False)
    for mod in (jens, tens):
        with pytest.raises(FileNotFoundError):
            mod.run_minda_ensemble(["a.vcf"], str(tmp_path), "S1",
                                   minda=str(tmp_path / "no-minda"))
