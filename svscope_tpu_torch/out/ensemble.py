"""Benchmark/ensemble wrapper (GenerateWindow equivalent).

Re-implements reference src/GenerateWindow.py: merge multiple callers'
VCFs with the external `minda ensemble` tool and emit
<ID>.minda.Somatic.txt plus a >=10 kb-filtered variant.  minda is an
external benchmark-only dependency (the reference hard-codes a NAS path,
src/GenerateWindow.py:10); here its location comes from --minda or $MINDA.
"""
from __future__ import annotations

import os
import re
import subprocess


def run_minda_ensemble(vcfs: list[str], out_dir: str, sample_id: str,
                       minda: str | None = None, len_cutoff: int = 10_000,
                       min_support: int = 1):
    minda = minda or os.environ.get("MINDA")
    if not minda or not os.path.exists(minda):
        raise FileNotFoundError(
            "minda not found: pass --minda or set $MINDA (external "
            "benchmarking tool; engine output does not depend on it)")
    os.makedirs(out_dir, exist_ok=True)
    subprocess.run([minda, "ensemble", "--vcfs", *vcfs, "--out_dir", out_dir,
                    "--min_support", str(min_support), "--multimatch"],
                   check=True)
    return parse_minda_out(sample_id, out_dir, len_cutoff)


def parse_minda_out(sample_id: str, out_dir: str, len_cutoff: int = 10_000):
    """Parse minda's ensemble VCF into <ID>.minda.Somatic.txt (all calls)
    and <ID>.minda.Somatic.len{cutoff}.txt (|SVLEN| < cutoff)."""
    vcf_path = os.path.join(out_dir, "None_minda_ensemble.vcf")
    rows = []
    with open(vcf_path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            info = dict(kv.split("=", 1) for kv in cols[7].split(";")
                        if "=" in kv)
            svlen = int(info.get("SVLEN", "0") or 0)
            rows.append((cols[0], cols[1], cols[2],
                         info.get("SVTYPE", "."), svlen))
    all_path = os.path.join(out_dir, f"{sample_id}.minda.Somatic.txt")
    flt_path = os.path.join(out_dir,
                            f"{sample_id}.minda.Somatic.len{len_cutoff}.txt")
    with open(all_path, "w") as fa, open(flt_path, "w") as ff:
        for chrom, pos, uid, svtype, svlen in rows:
            rec = f"{chrom}\t{pos}\t{uid}\t{svtype}\t{svlen}\n"
            fa.write(rec)
            if abs(svlen) < len_cutoff:
                ff.write(rec)
    return all_path, flt_path
