"""localGraph driver (counterpart of svscope_tpu/engine/localgraph.py): run
the per-window somatic decision over a stream of candidate windows,
batched for the GPU.

Three phases per chunk of windows:

  A (host + device)  gates, batched POA MSA (device rounds through the
                     CUDA aligner with C++ graph fusion, or with
                     device_poa="fused" the whole build on the device),
                     feature selection
  B (device)         batched 45-slot folded EM with BIC selection
  C (host + device)  cluster labeling, batched consensus POA, records

Resume (--Continue) re-reads finished window keys (chrom:start-end) from an
existing Raw.bed and skips them.

Output: '<T>.vs.<N>.TandemRepeat.Raw.bed', 10 columns, sorted by
(chrom, start).

Backend policy for device_poa=None: the CUDA kernel on a CUDA device, the
host C++ engine on the CPU.  There is no latency watchdog and no fallback
from the device to the host: a device that fails raises.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from ..io.fasta import FastaFile
from ..models.mixture import em_cluster_batch_dispatch
from ..ops.poa_batch import poa_msa_batch
from ..utils import seq as sq
from ..utils.device import resolve_device
from .datamaker import WindowData, data_maker, data_maker2
from .decision import call_margin, decision, dup_rescue, find_non_same_site

log = logging.getLogger("svscope_tpu_torch.localgraph")

PIPELINE_CHUNK = 128     # sub-chunk size: one EM batch-bucket exactly


def resolve_device_poa(device_poa, device: torch.device):
    """device_poa=None -> "pallas" (the per-round device aligner: the CUDA
    kernel) on a CUDA device, False (host C++) on the CPU."""
    if device_poa is None:
        return "pallas" if device.type == "cuda" else False
    return device_poa


def open_bam(path: str):
    """Lazy native-backed BAM reader (columns in C++, sequences decoded per
    fetch).  A failing native reader raises: the pure-Python BamReader
    (the parity oracle of the tests) would fetch the same reads and so
    hide it."""
    from ..native.bam import LazyBamReader
    return LazyBamReader(path)


def raw_bed_name(t_ids: list[str], n_ids: list[str]) -> str:
    return "%s.vs.%s.TandemRepeat.Raw.bed" % ("-".join(t_ids), "-".join(n_ids))


def record_line(record: list) -> str:
    """One Raw.bed line (without newline) of a 10-column record."""
    return "\t".join(str(x) for x in record)


def _read_tags(read_ids) -> np.ndarray:
    """Sample tag per read ("tumor"/"normal")."""
    return np.array([x.split("|")[0].split("_")[-1] for x in read_ids])


def _passes_gates(win: WindowData, tags: np.ndarray,
                  t_label: str = "tumor") -> bool:
    """Decision's entry gates (src/DecisionMaker.py:126-134)."""
    if tags.size == 0:
        return False
    uniq, cnt = np.unique(tags, return_counts=True)
    return (len(win.sequences) > 3 and uniq.shape[0] >= 2 and cnt.min() >= 3)


def _emit_chunk(ready, em_results, t_label, readcutoff, device_poa,
                threads=None, device="cpu"):
    """Phase C: label clusters, batch all consensus POAs in one round set,
    emit 10-column records."""
    jobs = []        # consensus sequence lists across all windows
    job_ref = []     # (window index, 'som'|'germ', position)
    parsed = []
    for wi, ((win, enc, read_ids, feat, tags), em) in enumerate(
            zip(ready, em_results)):
        K, _, labels, theta, gamma, pi, bics = em
        som_idx, germ_idx = [], []
        for L in np.unique(labels):
            members = np.flatnonzero(labels == L)
            mtags = np.unique(tags[members])
            if (mtags.shape[0] == 1 and mtags[0] == t_label
                    and members.size >= readcutoff):
                som_idx.append(members)
            elif members.size >= readcutoff:
                germ_idx.append(members)
        dec = sq.decode_rows(enc[1:]) if (som_idx or germ_idx) else []
        som_rows = [[dec[i] for i in idx] for idx in som_idx]
        germ_rows = [[dec[i] for i in idx] for idx in germ_idx]
        for pos, rws in enumerate(som_rows):
            if max(map(len, rws)) > 0:
                job_ref.append((wi, "som", pos))
                jobs.append(rws)
        for pos, rws in enumerate(germ_rows):
            if max(map(len, rws)) > 0:
                job_ref.append((wi, "germ", pos))
                jobs.append(rws)
        parsed.append((win, read_ids, som_idx, germ_idx,
                       ["-"] * len(som_idx), ["-"] * len(germ_idx)))
    cons_out = poa_msa_batch(jobs, use_device=device_poa, threads=threads,
                             device=device) if jobs else []
    for (wi, kind, pos), (cons, _msa) in zip(job_ref, cons_out):
        if kind == "som":
            parsed[wi][4][pos] = cons
        else:
            parsed[wi][5][pos] = cons
    out = []
    for win, read_ids, som_idx, germ_idx, som_seqs, germ_seqs in parsed:
        parts = win.record.strip().split("\t")
        record = [parts[0], parts[1], parts[2], "-", "-", 0, "-", "-", 0,
                  win.flag]
        if som_idx and germ_idx and som_seqs:
            record = [parts[0], parts[1], parts[2],
                      ";".join(som_seqs),
                      ";".join(",".join(read_ids[i] for i in idx)
                               for idx in som_idx),
                      len(som_seqs),
                      ";".join(germ_seqs),
                      ";".join(",".join(read_ids[i] for i in idx)
                               for idx in germ_idx),
                      len(germ_seqs),
                      win.flag + "|EMOutput"]
        out.append(record)
    return out


def _stage_a(wins: list[WindowData], t_label: str, hcutoff: int,
             scutoff: float, device_poa, threads: int | None,
             device="cpu"):
    """Phase A: gates -> batched POA MSA -> feature selection.

    Returns (entries, ready) where entries[i] = [win, ready_index | None]."""
    entries = []     # [win, state]; state None=base | ready-index
    msa_jobs = []
    pending = []
    tags_of = {}
    for win in wins:
        tags = _read_tags(win.read_ids)
        if _passes_gates(win, tags, t_label):
            tags_of[len(entries)] = tags
            pending.append(len(entries))
            msa_jobs.append(win.sequences)
        entries.append([win, None])
    msa_out = poa_msa_batch(msa_jobs, use_device=device_poa, threads=threads,
                            device=device) if msa_jobs else []
    ready = []
    for ei, (_cons, msa) in zip(pending, msa_out):
        win, _ = entries[ei]
        enc = sq.encode_rows(msa)
        flank_cols = call_margin(msa[0], win.flank_5, win.flank_3)
        keep_cols = np.setdiff1d(np.arange(enc.shape[1]), flank_cols)
        td_raw = enc[1:, keep_cols]
        cutoff = max(hcutoff, enc.shape[0] * scutoff)
        feat = td_raw[:, find_non_same_site(td_raw, cutoff)]
        if feat.shape[0] != 0 and feat.shape[1] >= 10:
            entries[ei][1] = len(ready)
            ready.append((win, enc, win.read_ids, feat, tags_of[ei]))
    return entries, ready


def _dispatch_em(ready, em_dtype, device="cpu", uniforms=None):
    """Phase B dispatch: host prep + device EM for one chunk.  Returns a
    fetch() closure."""
    feats = [feat for (_, _, _, feat, _) in ready]
    if not feats:
        return lambda: []
    return em_cluster_batch_dispatch(feats, labels_only=True, dtype=em_dtype,
                                     device=device, uniforms=uniforms)


def _complete_chunk(entries, ready, em_fetch, t_label, readcutoff,
                    device_poa, threads, device="cpu"):
    """Phase B fetch + phase C emission for one dispatched chunk."""
    em_results = em_fetch()
    emitted = _emit_chunk(ready, em_results, t_label, readcutoff, device_poa,
                          threads, device)
    records = []
    for win, state in entries:
        if state is None:
            parts = win.record.strip().split("\t")
            records.append([parts[0], parts[1], parts[2],
                            "-", "-", 0, "-", "-", 0, win.flag])
        else:
            records.append(emitted[state])
    return records


def process_window_batch(wins: list[WindowData], t_label: str = "tumor",
                         readcutoff: int = 3, hcutoff: int = 3,
                         scutoff: float = 0.05, em_dtype=None,
                         device_poa=None, threads: int | None = None,
                         device="cuda", uniforms=None) -> list[list]:
    """Batched Decision over prepared window payloads: gates -> batched POA
    MSA -> feature selection -> batched EM -> labeling + batched consensus.

    device: where the POA kernel and the EM run ("cuda" raises when CUDA
    is absent).  device_poa: None = policy (kernel on CUDA, host C++ on
    CPU), False/"host" = host C++, True/"pallas" = device aligner,
    "fused" = the whole MSA build on the device (stage A and the
    per-cluster consensus alike).
    uniforms: the EM's random draws (see models/mixture.py).

    Large batches run as a two-stage pipeline: a worker thread computes
    phase A of sub-chunk k+1 while the main thread runs EM + consensus
    emission of sub-chunk k."""
    dev = resolve_device(device)
    device_poa = resolve_device_poa(device_poa, dev)
    if len(wins) <= PIPELINE_CHUNK:
        entries, ready = _stage_a(wins, t_label, hcutoff, scutoff,
                                  device_poa, threads, dev)
        fetch = _dispatch_em(ready, em_dtype, dev, uniforms)
        return _complete_chunk(entries, ready, fetch, t_label, readcutoff,
                               device_poa, threads, dev)
    from concurrent.futures import ThreadPoolExecutor
    chunks = [wins[off:off + PIPELINE_CHUNK]
              for off in range(0, len(wins), PIPELINE_CHUNK)]
    records: list[list] = []

    def stage_a(c):
        # the worker thread launches kernels too: pin it to the same card
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return _stage_a(c, t_label, hcutoff, scutoff, device_poa, threads,
                        dev)

    with ThreadPoolExecutor(1) as prefetch:
        pending = [prefetch.submit(stage_a, c) for c in chunks[:2]]
        inflight = None   # (entries, ready, em_fetch) of chunk k
        for ci in range(len(chunks)):
            entries, ready = pending.pop(0).result()
            if ci + 2 < len(chunks):
                pending.append(prefetch.submit(stage_a, chunks[ci + 2]))
            fetch = _dispatch_em(ready, em_dtype, dev, uniforms)
            if inflight is not None:
                records.extend(_complete_chunk(*inflight, t_label, readcutoff,
                                               device_poa, threads, dev))
            inflight = (entries, ready, fetch)
        records.extend(_complete_chunk(*inflight, t_label, readcutoff,
                                       device_poa, threads, dev))
    return records


def run_local_graph(window_records: list[str], reference: str,
                    tumor_bams: list[str], normal_bams: list[str],
                    t_ids: list[str], n_ids: list[str], savedir: str,
                    offset: int = 50, mapq: int = 5, batch_size: int = 256,
                    continue_run: bool = False, em_dtype=None,
                    t_label: str = "tumor", readcutoff: int = 3,
                    hcutoff: int = 3, scutoff: float = 0.05,
                    device_poa=None, threads: int | None = None,
                    device="cuda", uniforms=None,
                    data_parallel=None) -> str:
    """Batched localGraph (src/SVscope.py:118-183 equivalent), with resume
    and the DUP corner rescue.  Returns the Raw.bed path.

    data_parallel: split the engine's batched device dispatches (EM, POA
    rounds, fused builds) over a device tuple (parallel/dataparallel), the
    replacement for the reference's 6-process window pool: True = every
    local CUDA device, a sequence = those devices, None or False = off.
    Off by default, even with several GPUs: no multi-GPU run has shown a
    gain yet, the read-parallel EM issues a window's launches one by one
    from the host, and the fused build's host syncs keep its parts from
    running at once.  The mesh is cleared when the run ends, so no later
    call inherits it."""
    from ..parallel.dataparallel import data_mesh_installed, make_dp_mesh
    dev = resolve_device(device)
    device_poa = resolve_device_poa(device_poa, dev)
    mesh = None
    if data_parallel is True:
        mesh = make_dp_mesh()
    elif data_parallel:
        mesh = make_dp_mesh(devices=data_parallel)
    with data_mesh_installed(mesh):
        return _run_local_graph(
            window_records, reference, tumor_bams, normal_bams, t_ids, n_ids,
            savedir, offset=offset, mapq=mapq, batch_size=batch_size,
            continue_run=continue_run, em_dtype=em_dtype, t_label=t_label,
            readcutoff=readcutoff, hcutoff=hcutoff, scutoff=scutoff,
            device_poa=device_poa, threads=threads, dev=dev,
            uniforms=uniforms)


def _run_local_graph(window_records, reference, tumor_bams, normal_bams,
                     t_ids, n_ids, savedir, *, offset, mapq, batch_size,
                     continue_run, em_dtype, t_label, readcutoff, hcutoff,
                     scutoff, device_poa, threads, dev, uniforms) -> str:
    os.makedirs(savedir, exist_ok=True)
    out_path = os.path.join(savedir, raw_bed_name(t_ids, n_ids))
    done: set[str] = set()
    existing: list[str] = []
    if continue_run and os.path.exists(out_path):
        with open(out_path) as f:
            for line in f:
                if line.strip():
                    existing.append(line.rstrip("\n"))
                    done.add(":".join(line.split("\t")[0:3]))
    todo = [r for r in window_records
            if ":".join(r.strip().split("\t")[0:3]) not in done]
    log.info("localGraph: %d windows (%d resumed) on %s, POA engine %r",
             len(todo), len(done), dev, device_poa)

    ref = FastaFile(reference)
    readers = [open_bam(p) for p in tumor_bams + normal_bams]
    labels = [f"{t}_tumor" for t in t_ids] + [f"{n}_normal" for n in n_ids]
    rows: list[list] = []
    t0 = time.time()
    make_data2 = lambda r: data_maker2(r, ref, readers, labels,
                                       offset=offset, mapq=mapq)
    decide_seq = lambda w: decision(
        w, t_label, readcutoff, hcutoff, scutoff, em_dtype=em_dtype,
        em_kwargs={"uniforms": uniforms}, device=dev)
    from concurrent.futures import ThreadPoolExecutor
    loader = ThreadPoolExecutor(1)
    make_batch = lambda recs: [data_maker(rec, ref, readers, labels,
                                          offset=offset, mapq=mapq)
                               for rec in recs]
    batches = [todo[off:off + batch_size]
               for off in range(0, len(todo), batch_size)]
    next_fut = loader.submit(make_batch, batches[0]) if batches else None
    try:
        for bi, chunk in enumerate(batches):
            wins = next_fut.result()
            off = bi * batch_size
            if bi + 1 < len(batches):
                next_fut = loader.submit(make_batch, batches[bi + 1])
            records = process_window_batch(
                wins, t_label=t_label, readcutoff=readcutoff,
                hcutoff=hcutoff, scutoff=scutoff, em_dtype=em_dtype,
                device_poa=device_poa, threads=threads, device=dev,
                uniforms=uniforms)
            for rec, win, record in zip(chunk, wins, records):
                # DUP corner rescue on any non-EMOutput result
                # (src/SomTDDetector.py:41-58; trigger column replicated)
                parts = rec.strip().split("\t")
                svtype = parts[3].split(",")[0] if len(parts) > 3 else ""
                if record[-1].split("|")[-1] != "EMOutput" and svtype == "DUP":
                    record = dup_rescue(record, win, rec, make_data2,
                                        decide_seq)
                rows.append(record)
            log.info("localGraph: %d/%d windows, %.1fs", off + len(chunk),
                     len(todo), time.time() - t0)
    finally:
        loader.shutdown(wait=False, cancel_futures=True)
    out_rows = existing + [record_line(r) for r in rows]
    out_rows.sort(key=lambda l: (l.split("\t")[0], int(l.split("\t")[1])))
    with open(out_path, "w") as f:
        for line in out_rows:
            f.write(line + "\n")
    log.info("localGraph: finished %d windows in %.1f s", len(todo),
             time.time() - t0)
    return out_path
