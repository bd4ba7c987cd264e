"""Sequence alphabet utilities.

The engine works on the 5-letter alphabet {A:0, T:1, C:2, G:3, '-':4}
(reference: src/DataScanner.py:125).  Decoding drops gaps
(src/DataScanner.py:131-137).
"""
from __future__ import annotations

import numpy as np

GAP = 4
ALPHABET = "ATCG-"

# byte -> code lookup table (uppercase + lowercase); unknown bytes map to -1
_ENC = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate(ALPHABET):
    _ENC[ord(_c)] = _i
    _ENC[ord(_c.lower())] = _i

_DEC = np.frombuffer(ALPHABET.encode(), dtype=np.uint8)

_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("a", "t"), ("c", "g")):
    _COMP[ord(_a)] = ord(_b)
    _COMP[ord(_b)] = ord(_a)


def encode(s: str) -> np.ndarray:
    """Encode an ATCG- string to int8 codes."""
    b = np.frombuffer(s.encode(), dtype=np.uint8)
    out = _ENC[b]
    if (out < 0).any():
        bad = chr(b[np.where(out < 0)[0][0]])
        raise ValueError(f"non-ATCG- character {bad!r} in sequence")
    return out


def encode_rows(rows: list[str]) -> np.ndarray:
    """Encode equal-length rows (an MSA) to an (n, L) int8 matrix in one
    lookup — the per-row encode() loop showed up in the stage-A profile."""
    n = len(rows)
    b = np.frombuffer("".join(rows).encode(), dtype=np.uint8)
    out = _ENC[b]
    if (out < 0).any():
        bad = chr(b[np.where(out < 0)[0][0]])
        raise ValueError(f"non-ATCG- character {bad!r} in sequence")
    return out.reshape(n, len(b) // max(n, 1))


def decode_rows(codes: np.ndarray) -> list[str]:
    """Degap-decode every row of an (n, L) code matrix in one vector pass
    (the per-row decode() loop showed up in the consensus-emit profile)."""
    codes = np.asarray(codes)
    mask = codes != GAP
    flat = _DEC[codes[mask].astype(np.intp)].tobytes().decode()
    offs = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
    return [flat[offs[i]:offs[i + 1]] for i in range(codes.shape[0])]


def decode(codes: np.ndarray, keep_gaps: bool = False) -> str:
    """Decode int codes to a string; gaps (4) dropped unless keep_gaps."""
    codes = np.asarray(codes)
    if not keep_gaps:
        codes = codes[codes != GAP]
    return _DEC[codes.astype(np.intp)].tobytes().decode()


def reverse_complement(s: str) -> str:
    b = np.frombuffer(s.encode(), dtype=np.uint8)
    return _COMP[b][::-1].tobytes().decode()
