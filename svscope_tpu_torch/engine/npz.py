"""Per-window input serialization (npz export + replay).

Re-implements reference src/SomTDDetector_AimDatFetch.py (the --saveData
path) and src/SVscope.py:185-239 (localGraph_npz): window payloads
(sequences, read IDs, flanks, record) are batched into .npz files of 8192
windows and can be replayed through the Decision stage without touching
the BAMs — the reference's intermediate-data checkpoint format.
"""
from __future__ import annotations

import logging
import os
import re
import time

import numpy as np

from ..io.bam import BamReader  # noqa: F401
from .localgraph import open_bam
from ..io.fasta import FastaFile
from .datamaker import WindowData, data_maker

log = logging.getLogger("svscope_tpu_torch.npz")

BATCH = 8192               # windows per npz (reference :160-162)
WATCHDOG_S = 10 * 3600     # abandon unfinished work after 10 h (:178)


def save_window_data(window_records, reference, tumor_bams, normal_bams,
                     t_ids, n_ids, savedir, offset=50, mapq=5,
                     batch=BATCH, watchdog_s=WATCHDOG_S) -> list[str]:
    """Export DataMaker payloads for all windows into npz batches."""
    os.makedirs(savedir, exist_ok=True)
    ref = FastaFile(reference)
    readers = [open_bam(p) for p in tumor_bams + normal_bams]
    labels = [f"{t}_tumor" for t in t_ids] + [f"{n}_normal" for n in n_ids]
    paths = []
    bufffer: list = []
    t0 = time.time()
    n_file = 0
    for rec in window_records:
        if time.time() - t0 > watchdog_s:
            log.warning("npz export watchdog hit after %d windows",
                        len(bufffer) + n_file * batch)
            break
        win = data_maker(rec, ref, readers, labels, offset=offset, mapq=mapq)
        bufffer.append(np.array(
            [np.array(win.sequences, dtype=object), win.read_ids,
             win.flank_5, win.flank_3, win.record], dtype=object))
        if len(bufffer) >= batch:
            paths.append(_flush(bufffer, savedir, n_file))
            n_file += 1
            bufffer = []
    if bufffer:
        paths.append(_flush(bufffer, savedir, n_file))
    return paths


def _flush(buf, savedir, n_file) -> str:
    path = os.path.join(savedir, f"WindowDat.{n_file}.npz")
    np.savez_compressed(path, DatSet=np.array(buf, dtype=object))
    log.info("npz export: %s (%d windows)", path, len(buf))
    return path


def load_window_data(savedir: str):
    """Yield WindowData from every npz in savedir (replay path,
    src/SVscope.py:209-212).  Flag defaults to NormalOutput like
    TDscope_npz -> Decision (src/SomTDDetector.py:63-73)."""
    for name in sorted(os.listdir(savedir)):
        if not re.search("npz", name):
            continue
        dat = np.load(os.path.join(savedir, name), allow_pickle=True)["DatSet"]
        for row in dat:
            sequences, read_ids, flank_5, flank_3, record = row
            yield WindowData(list(sequences), np.asarray(read_ids, dtype=object),
                             str(flank_5), str(flank_3), str(record),
                             "NormalOutput")
