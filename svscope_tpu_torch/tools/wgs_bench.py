"""WGS-scale background-stats run (counterpart of tools/wgs_bench.py).

The reference's AlnFeature stage sweeps windowInfo over the ~308k x 10 kb
hg38 window grid with a 100-worker process pool. This tool synthesizes an
hg38-scale in-memory AlignmentTable (24 chromosomes x 128 Mb, ~30x
long-read coverage, 10 % supplementary rows: ~10.1 M alignment rows) and
times the port's vectorized sweep (`engine.features.background_stats`),
reporting its wall and the process's peak RSS. Host work only: the card
runs nothing here, and `--device` only checks that the run is made on the
machine it names.

    python -m svscope_tpu_torch.tools.wgs_bench [--coverage 30]
        [--chrom-mb 128] [--n-chrom 24] [--window-kb 10] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import hashlib
import resource
import time

import numpy as np


def synth_table(n_chrom: int, chrom_len: int, coverage: float, seed: int = 0):
    """The JAX tool's AlignmentTable, drawn by the same rng calls: ONT-like
    reads (8-12 kb), 10 % of reads with a supplementary row on a random
    chromosome, mapQ skewed high with a low-mapQ tail."""
    from ..io.bam import AlignmentTable
    rng = np.random.default_rng(seed)
    chroms, starts, ends, names, mapqs, strands, cigars = \
        [], [], [], [], [], [], []
    read_no = 0
    for c in range(n_chrom):
        cname = f"chr{c + 1}"
        mean_len = 10_000
        n_reads = int(chrom_len * coverage / mean_len)
        s = rng.integers(0, chrom_len - 2000, n_reads)
        ln = rng.integers(8000, 12001, n_reads)
        e = np.minimum(s + ln, chrom_len)
        q = np.where(rng.random(n_reads) < 0.07,
                     rng.integers(0, 5, n_reads),
                     rng.integers(20, 61, n_reads))
        chroms.append(np.full(n_reads, cname, object))
        starts.append(s)
        ends.append(e)
        names.append(np.array([f"r{read_no + i}" for i in range(n_reads)],
                              object))
        mapqs.append(q.astype(np.int32))
        strands.append(rng.random(n_reads) < 0.5)
        cigars.append(np.full(n_reads, f"{mean_len}M", object))
        read_no += n_reads
    all_names = np.concatenate(names)
    n_supp = len(all_names) // 10
    pick = np.random.default_rng(seed + 1).choice(len(all_names), n_supp,
                                                  replace=False)
    sc = np.random.default_rng(seed + 2)
    supp_chrom = np.array([f"chr{i + 1}" for i in
                           sc.integers(0, n_chrom, n_supp)], object)
    supp_start = sc.integers(0, chrom_len - 4000, n_supp)
    supp_len = sc.integers(1000, 4001, n_supp)
    chroms.append(supp_chrom)
    starts.append(supp_start)
    ends.append(supp_start + supp_len)
    names.append(all_names[pick])
    mapqs.append(sc.integers(0, 61, n_supp).astype(np.int32))
    strands.append(sc.random(n_supp) < 0.5)
    cigars.append(np.full(n_supp, "2000M", object))
    return AlignmentTable(np.concatenate(chroms), np.concatenate(starts),
                          np.concatenate(ends), np.concatenate(names),
                          np.concatenate(mapqs), np.concatenate(strands),
                          np.concatenate(cigars))


def genome_grid(n_chrom: int, chrom_len: int, window_kb: int) -> list:
    step = window_kb * 1000
    return [(f"chr{c + 1}", s, min(s + step, chrom_len))
            for c in range(n_chrom) for s in range(0, chrom_len, step)]


def frame_sha256(df) -> str:
    """sha256 of a background_stats frame: its window keys, then COV and
    mapQRate as float64 bytes."""
    h = hashlib.sha256("\n".join(df.index.astype(str)).encode())
    for col in ("COV", "mapQRate"):
        h.update(np.ascontiguousarray(df[col].to_numpy(np.float64)).tobytes())
    return h.hexdigest()


def run(coverage: float = 30.0, chrom_mb: float = 128.0, n_chrom: int = 24,
        window_kb: int = 10, device="cuda", log=print) -> dict:
    """Synthesize the table, sweep the grid; returns the row and window
    counts, the build and sweep walls (s), windows/s, the peak RSS (GB),
    the sanity medians, the frame's sha256 and the frame itself (`df`).
    Raises if under 95 % of the windows are covered or the median COV is
    off the planted coverage by 25 % or more."""
    from ..engine.features import background_stats
    from ..utils.device import resolve_device
    resolve_device(device)
    chrom_len = int(chrom_mb * 1e6)
    t0 = time.perf_counter()
    table = synth_table(n_chrom, chrom_len, coverage)
    t_build = time.perf_counter() - t0
    windows = genome_grid(n_chrom, chrom_len, window_kb)
    log(f"table: {len(table):,} alignment rows ({n_chrom} x {chrom_mb:g} Mb "
        f"@ {coverage:g}x, built in {t_build:.3f}s); grid: "
        f"{len(windows):,} windows of {window_kb} kb")
    t0 = time.perf_counter()
    df = background_stats(table, windows)
    dt = time.perf_counter() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    cov = df["COV"].to_numpy(float)
    ok = np.isfinite(cov)
    med_cov = float(np.median(cov[ok]))
    med_mqr = float(np.median(df["mapQRate"].to_numpy(float)[ok]))
    log(f"background_stats: {dt:.3f}s for {len(windows):,} windows "
        f"({len(windows) / dt:,.0f} windows/s, one host process), peak RSS "
        f"{rss_gb:.2f} GB")
    log(f"sanity: {int(ok.sum()):,} covered windows, median COV "
        f"{med_cov:.1f} (expect ~{coverage:g}), median mapQRate "
        f"{med_mqr:.3f}")
    if ok.sum() <= 0.95 * len(windows):
        raise RuntimeError(f"only {int(ok.sum())} of {len(windows)} "
                           "windows covered")
    if abs(med_cov - coverage) / coverage >= 0.25:
        raise RuntimeError(f"median COV {med_cov} is off {coverage}")
    return {"rows": len(table), "windows": len(windows),
            "build_s": t_build, "seconds": dt,
            "windows_per_s": len(windows) / dt, "peak_rss_gb": rss_gb,
            "covered": int(ok.sum()), "median_cov": med_cov,
            "median_mapq_rate": med_mqr, "sha256": frame_sha256(df),
            "df": df}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--chrom-mb", type=float, default=128.0)
    ap.add_argument("--n-chrom", type=int, default=24)
    ap.add_argument("--window-kb", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    res = run(args.coverage, args.chrom_mb, args.n_chrom, args.window_kb,
              args.device)
    return {k: v for k, v in res.items() if k != "df"}


if __name__ == "__main__":
    main()
