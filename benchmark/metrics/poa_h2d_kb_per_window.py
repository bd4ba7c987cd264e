"""Kilobytes a window's POA copies to the card: the program's counters
`h2d_bytes` of ops.poa_batch (the per-round chunks' copies) and
ops.poa_fused (the fused builds' uploads), taken over the traced window,
over the windows completed there; nothing where the program has no such
counter."""
UNIT, LAYER, BETTER, SOURCE, MOVES = (
    "KB/window", "ops.poa_batch", "lower", "program_counter",
    "windows_per_s")
SPANS = []


def read(run):
    if not run.windows:
        return None
    counts = [run.counts.get(g, {}).get("h2d_bytes")
              for g in ("poa_batch", "poa_fused")]
    if None in counts:
        return None
    return sum(counts) / 1e3 / run.windows
