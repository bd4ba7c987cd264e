"""FASTA + .fai random access (replaces pysam.FastaFile).

Reference usage: `refFasta.fetch(chrom, start, end)` for window, flank and
example sequences (src/DataScanner.py:230-246).  The .fai column layout is
(name, length, offset, linebases, linewidth).
"""
from __future__ import annotations

import os



class FastaFile:
    def __init__(self, path: str):
        self.path = path
        fai = path + ".fai"
        if not os.path.exists(fai):
            build_fai(path)
        self.index: dict[str, tuple[int, int, int, int]] = {}
        self.order: list[str] = []
        with open(fai) as f:
            for line in f:
                name, length, offset, linebases, linewidth = line.split("\t")[:5]
                self.index[name] = (int(length), int(offset), int(linebases), int(linewidth))
                self.order.append(name)
        self._fh = open(path, "rb")

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @property
    def references(self):
        return list(self.order)

    def get_reference_length(self, chrom: str) -> int:
        return self.index[chrom][0]

    def lengths_dict(self) -> dict[str, int]:
        return {c: self.index[c][0] for c in self.order}

    def fetch(self, chrom: str, start: int | None = None, end: int | None = None) -> str:
        length, offset, linebases, linewidth = self.index[chrom]
        if start is None:
            start = 0
        if end is None:
            end = length
        start = max(0, int(start))
        end = min(length, int(end))
        if end <= start:
            return ""
        fstart = offset + (start // linebases) * linewidth + start % linebases
        fend = offset + ((end - 1) // linebases) * linewidth + (end - 1) % linebases + 1
        self._fh.seek(fstart)
        raw = self._fh.read(fend - fstart)
        return raw.translate(None, b"\r\n").decode()


def build_fai(path: str) -> str:
    """Create a .fai index for a FASTA file."""
    rows = []
    with open(path, "rb") as f:
        name = None
        length = 0
        offset = 0
        linebases = linewidth = 0
        pos = 0
        first_line = True
        for line in f:
            llen = len(line)
            stripped = line.rstrip(b"\r\n")
            if stripped.startswith(b">"):
                if name is not None:
                    rows.append((name, length, offset, linebases, linewidth))
                name = stripped[1:].split()[0].decode()
                length = 0
                offset = pos + llen
                first_line = True
            elif stripped:
                if first_line:
                    linebases = len(stripped)
                    linewidth = llen
                    first_line = False
                length += len(stripped)
            pos += llen
        if name is not None:
            rows.append((name, length, offset, linebases, linewidth))
    with open(path + ".fai", "w") as out:
        for r in rows:
            out.write("\t".join(str(x) for x in r) + "\n")
    return path + ".fai"


def write_fasta(path: str, seqs: dict[str, str], width: int = 60) -> None:
    with open(path, "w") as f:
        for name, seq in seqs.items():
            f.write(f">{name}\n")
            for off in range(0, len(seq), width):
                f.write(seq[off:off + width] + "\n")
    build_fai(path)
