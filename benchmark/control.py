"""Readings that set a cell's correctness limits, run on the card:

  python3 benchmark/control.py --workload <cell> --seeds S1 S2 ... \\
      --seconds <s> [--control-seeds N]

For each seed, one short window of the cell at its own load, then the
judge's numbers and verdict for the program (the lower readings) and, on
the first N seeds, for the control: the reference itself with its EM in
float32 with TF32 products, put in the program's place (the upper
readings), judged by the same limits.  One JSON line per seed, then a
summary; exits 1 where the program came out not correct or the control
correct on any seed.  The benchmark's own runs never run this."""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark import harness
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    prog, ctl = [], []
    for i, seed in enumerate(args.seeds):
        modes = ("ref", "tf32") if i < args.control_seeds else ("ref",)
        res, lines = harness.run(
            args.workload, seed, args.seconds, False, "cuda", modes=modes,
            log=lambda s: print(s, file=sys.stderr, flush=True))
        prog.append(res["correct"])
        ctl += [c["correct"] for c in res.get("controls", {}).values()]
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "checks": res["checks"],
                          "controls": res.get("controls", {}),
                          "note": lines[0]}), flush=True)
    print(json.dumps({"workload": args.workload,
                      "program_correct": f"{sum(prog)}/{len(prog)}",
                      "control_correct": f"{sum(ctl)}/{len(ctl)}"}),
          flush=True)
    return 0 if all(prog) and not any(ctl) else 1


if __name__ == "__main__":
    sys.exit(main())
