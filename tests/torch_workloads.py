"""Inputs of the port's tests and of chip_smoke.py, free of the JAX package.

The same generators as `bench.make_window_payloads` and
`tests/synth.make_test_pair` (both kept in the package,
svscope_tpu_torch/tools/workloads.py, for the kernel measurement tools and
the chromosome bench), built on the port's own WindowData, BAM writer and
FASTA writer, so the card's machine (which has no JAX) draws the identical
inputs: the same rng calls in the same order give the same payloads and
the same BAM bytes (tests/test_torch_imports.py holds them equal); and
the seeded NW pair sets.
"""
from __future__ import annotations

import numpy as np

from svscope_tpu_torch.tools.workloads import (  # noqa: F401
    make_read, make_test_pair, make_window_payloads, rand_seq)


ACGT = np.frombuffer(b"ACGT", np.uint8)


def mutate(rng, seq: str, sub_rate: float, n_indels: int,
           indel_len: tuple[int, int]) -> str:
    """`seq` with substitutions at `sub_rate`, then `n_indels` insertions
    or deletions of indel_len[0]..indel_len[1] bp at random positions."""
    b = np.frombuffer(seq.encode(), np.uint8).copy()
    hit = rng.random(len(b)) < sub_rate
    b[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
    s = b.tobytes().decode()
    for _ in range(n_indels):
        n = int(rng.integers(indel_len[0], indel_len[1] + 1))
        p = int(rng.integers(0, len(s) + 1))
        s = (s[:p] + rand_seq(rng, n) + s[p:] if rng.random() < 0.5
             else s[:p] + s[p + n:])
    return s


def nw_pairs(rng, n: int, len_lo: int, len_hi: int,
             sub_rate=(0.02, 0.10), n_indels=(0, 4),
             indel_len=(1, 20)) -> list[tuple[str, str]]:
    """`n` (a, b) pairs: a uniform in [len_lo, len_hi] bp, b = a mutated
    (a per-pair substitution rate drawn from `sub_rate`, up to n_indels[1]
    indels), cut to len_hi."""
    out = []
    for _ in range(n):
        a = rand_seq(rng, int(rng.integers(len_lo, len_hi + 1)))
        b = mutate(rng, a, float(rng.uniform(*sub_rate)),
                   int(rng.integers(n_indels[0], n_indels[1] + 1)),
                   indel_len)
        out.append((a, b[:len_hi]))
    return out


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


def misscore4096_pairs(seed: int = 11, n: int = 4096):
    """The size of a sample's somatic consensus pairs over tandem-repeat
    windows: `n` pairs of 100-4,000 bp, 2-10 % substitutions, indels of
    1-200 bp (every side cut to 4,096 bp, so all pairs fit K2's buckets)."""
    return nw_pairs(np.random.default_rng(seed), n, 100, 4000,
                    n_indels=(1, 6), indel_len=(1, 200))
