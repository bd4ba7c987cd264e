"""Run one cell of BENCHMARK.json once, on the card this machine holds:

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON object; the checks
that decide `correct` are the last lines of standard error.  Exits
nonzero, printing no result, without CUDA or enough cards, when the
program cannot be imported, or when the process has loaded JAX or the
JAX package."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every kernel and build cache at a fixed path inside the checkout
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(cache, "nv"))
    if args.trace:
        # the profiler's own warnings (lost records, a failed CUPTI
        # start) on standard error: torch silences them otherwise
        os.environ.setdefault("KINETO_LOG_LEVEL", "2")
    sys.path.insert(0, ROOT)
    from benchmark import harness, manifest
    man = manifest.load_manifest(ROOT)
    try:
        cell, _cfg = manifest.cell_config(man, args.workload)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import svscope_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"the program cannot be imported: {exc!r}", file=sys.stderr)
        return 3
    log = lambda s: print(s, file=sys.stderr, flush=True)
    try:
        result, lines = harness.run(args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda", T_START,
                                    man, log=log)
    except harness.ForbiddenImport as exc:
        print(str(exc), file=sys.stderr)
        return 4
    found = harness.forbidden_modules()
    if found:
        print("loaded in the run's process: " + ", ".join(found),
              file=sys.stderr)
        return 4
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
