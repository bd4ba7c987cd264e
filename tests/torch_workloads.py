"""Inputs of the port's tests and of chip_smoke.py, free of the JAX package.

The same generators as `bench.make_window_payloads` and
`tests/synth.make_test_pair` (both kept in the package,
svscope_tpu_torch/tools/workloads.py, for the kernel measurement tools and
the chromosome bench), built on the port's own WindowData, BAM writer and
FASTA writer, so the card's machine (which has no JAX) draws the identical
inputs: the same rng calls in the same order give the same payloads and
the same BAM bytes (tests/test_torch_imports.py holds them equal); and
the seeded NW pair sets (misscore4096 lives in the package too, for
tools/roofline.py).
"""
from __future__ import annotations

from svscope_tpu_torch.tools.workloads import (  # noqa: F401
    make_read, make_test_pair, make_window_payloads, misscore4096_pairs,
    mutate, nw_pairs, rand_seq)


def bucket_pairs(rng, bucket: int, n: int) -> list[tuple[str, str]]:
    """Pairs whose longer side falls in (bucket / 2, bucket], with the edge
    cases first: both sides exactly `bucket` long, then an empty side."""
    lo = bucket // 2 + 1
    edge = rand_seq(rng, bucket)
    pairs = [(edge, mutate(rng, edge, 0.05, 0, (1, 1))), ("", edge[:lo]),
             (edge[:lo], "")]
    pairs += nw_pairs(rng, max(n - len(pairs), 0), lo, bucket,
                      indel_len=(1, max(2, bucket // 32)))
    return pairs[:n]
