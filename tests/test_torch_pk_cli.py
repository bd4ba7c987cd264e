"""The port's `localGraph` CLI with `--device-poa fused` on the CPU (plain
versions of K3 and K4): Raw.bed byte-identical to the JAX golden."""
import os
import subprocess
import sys

import localgraph_golden as lgg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_fused_raw_bed_matches_golden(tmp_path):
    ref, tumor, normal, recs = lgg.make_synth_pair(str(tmp_path))
    bed = tmp_path / "windows.bed"
    bed.write_text("".join(r + "\n" for r in recs))
    out = tmp_path / "out"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    res = subprocess.run(
        [sys.executable, "-m", "svscope_tpu_torch.cli", "localGraph",
         "--device", "cpu", "--device-poa", "fused", "-w", str(bed),
         "-T", tumor, "-N", normal, "-t", "S", "-n", "S", "-r", ref,
         "-s", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    raw = (out / "S.vs.S.TandemRepeat.Raw.bed").read_bytes()
    assert lgg.sha256(raw.decode()) == \
        lgg.load_golden()["synth_pair"]["raw_bed_sha256"]
