"""Per-window diagnostic figures (ScopeVIZ equivalent).

Re-designs reference src/ScopeVIZ.py's six-panel window figure
(DrawPipe, :530-562): raw spanning reads, the POA MSA, the selected
feature columns, the EM clustering with tumor/normal identity, per-cluster
composition bars, and an optional graph-genome rendering of the phased
consensuses (ShowConsensus, :465-525: per-cluster consensus -> POA of
consensuses -> common/variant blocks -> DiGraph layout).

All panels are derived from the same engine entry points the caller uses
(data_maker -> msa_feature_selection -> em_cluster), so the figure shows
exactly what the somatic decision saw.  `figure_inputs` computes what the
panels show without matplotlib (the MSA encoding, the flank and selected
columns, the cutoff, and K, labels and BICs when the EM runs, on
`device`); `draw_window` draws from it.
"""
from __future__ import annotations

import os

import numpy as np

from ..engine.datamaker import WindowData, data_maker
from ..engine.decision import call_margin, find_non_same_site
from ..models.mixture import em_cluster_batch
from ..native.poa import poa_native
from ..utils import seq as sq
from ..utils.device import resolve_device

BASE_COLORS = {0: "#4daf4a", 1: "#e41a1c", 2: "#377eb8", 3: "#ff7f00",
               4: "#f0f0f0"}


def _msa_image(enc: np.ndarray) -> np.ndarray:
    img = np.zeros(enc.shape + (3,))
    for code, hexc in BASE_COLORS.items():
        rgb = tuple(int(hexc[i:i + 2], 16) / 255 for i in (1, 3, 5))
        img[enc == code] = rgb
    return img


def figure_inputs(win: WindowData, hcutoff: int = 3, scutoff: float = 0.05,
                  em_dtype=None, device="cuda") -> dict:
    """What the figure's panels show, without matplotlib: `enc` (the POA
    MSA encoded, ref row first), `flank_cols`, `keep_cols`, `sel` (selected
    columns among keep_cols), `cutoff`, `feat`, `tags`, and `K`, `labels`
    and `bics` of the EM on `device` (None when too few variant columns
    leave the EM out, as the figure's 'EM skipped' panel)."""
    device = resolve_device(device)
    if len(win.sequences) < 2:
        raise ValueError(f"window {win.record!r} has no spanning reads "
                         f"(flag {win.flag})")
    _cons, msa = poa_native(win.sequences)
    enc = np.stack([sq.encode(r) for r in msa])
    flank_cols = call_margin(msa[0], win.flank_5, win.flank_3)
    keep_cols = np.setdiff1d(np.arange(enc.shape[1]), flank_cols)
    td_raw = enc[1:, keep_cols]
    cutoff = max(hcutoff, enc.shape[0] * scutoff)
    sel = find_non_same_site(td_raw, cutoff)
    feat = td_raw[:, sel]
    tags = np.array([x.split("|")[0].split("_")[-1] for x in win.read_ids])
    out = dict(enc=enc, flank_cols=flank_cols, keep_cols=keep_cols, sel=sel,
               cutoff=cutoff, feat=feat, tags=tags, K=None, labels=None,
               bics=None)
    if feat.shape[0] >= 3 and feat.shape[1] >= 10:
        kwargs = {} if em_dtype is None else {"dtype": em_dtype}
        K, _, labels, _theta, _gamma, _pi, bics = em_cluster_batch(
            [feat], device=device, **kwargs)[0]
        out.update(K=K, labels=labels, bics=bics)
    return out


def draw_window(win: WindowData, out_path: str, hcutoff: int = 3,
                scutoff: float = 0.05, t_label: str = "tumor",
                graph: bool = True, em_dtype=None, device="cuda"):
    """Render the six-panel figure for one window; returns out_path.  The
    EM runs on `device` (default cuda; raises when CUDA is absent)."""
    fi = figure_inputs(win, hcutoff, scutoff, em_dtype, device)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    enc, keep_cols, sel, cutoff = (fi["enc"], fi["keep_cols"], fi["sel"],
                                   fi["cutoff"])
    feat, tags = fi["feat"], fi["tags"]

    fig, axes = plt.subplots(3, 2, figsize=(16, 12))
    ax = axes[0, 0]
    lens = [len(s) for s in win.sequences[1:]]
    colors = ["#c0392b" if t == t_label else "#2c3e50" for t in tags]
    ax.barh(np.arange(len(lens)), lens, color=colors)
    ax.set_title(f"spanning reads ({win.record.split(chr(9))[0]}:"
                 f"{win.record.split(chr(9))[1]}-{win.record.split(chr(9))[2]})")
    ax.set_xlabel("read length (bp)")

    ax = axes[0, 1]
    ax.imshow(_msa_image(enc), aspect="auto", interpolation="nearest")
    ax.set_title(f"POA MSA ({enc.shape[0]} rows x {enc.shape[1]} cols)")
    ax.set_ylabel("ref + reads")

    ax = axes[1, 0]
    track = np.zeros(enc.shape[1])
    track[keep_cols[sel]] = 1
    ax.plot(track, lw=0.8)
    ax.fill_between(np.arange(enc.shape[1]), track, alpha=0.4)
    ax.set_title(f"selected feature columns (n={len(sel)}, cutoff={cutoff:.1f})")
    ax.set_ylim(-0.1, 1.2)

    labels = fi["labels"]
    if labels is not None:
        K = fi["K"]
        order = np.argsort(labels, kind="stable")
        ax = axes[1, 1]
        ax.imshow(_msa_image(feat[order]), aspect="auto",
                  interpolation="nearest")
        for b in np.flatnonzero(np.diff(labels[order])) + 1:
            ax.axhline(b - 0.5, color="k", lw=1)
        ax.set_title(f"EM clustering K={K} (rows sorted by cluster)")

        ax = axes[2, 0]
        uniq = np.unique(labels)
        t_counts = [(tags[labels == L] == t_label).sum() for L in uniq]
        n_counts = [(tags[labels == L] != t_label).sum() for L in uniq]
        ax.bar(uniq, t_counts, color="#c0392b", label="tumor")
        ax.bar(uniq, n_counts, bottom=t_counts, color="#2c3e50",
               label="normal")
        ax.set_xlabel("cluster")
        ax.set_title("cluster composition")
        ax.legend()
    else:
        axes[1, 1].set_title("EM skipped (too few variant columns)")
        axes[2, 0].set_visible(False)

    ax = axes[2, 1]
    if graph and labels is not None:
        _draw_graph_genome(ax, enc, labels)
    else:
        ax.set_visible(False)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def _draw_graph_genome(ax, enc, labels):
    """Graph-genome panel: POA of per-cluster consensuses, segmented into
    shared/variant blocks rendered as a DiGraph (ShowConsensus
    equivalent)."""
    import networkx as nx

    cons = []
    for L in np.unique(labels):
        rows = [sq.decode(enc[i + 1]) for i in np.flatnonzero(labels == L)]
        rows = [r for r in rows if r]
        if rows:
            cons.append(poa_native(rows)[0])
    if len(cons) == 0:
        ax.set_visible(False)
        return
    _c, cmsa = poa_native(cons)
    mat = np.stack([sq.encode(r) for r in cmsa])
    same = (mat == mat[0]).all(axis=0)
    # segment columns into runs of identical same/diff state
    blocks = []
    start = 0
    for j in range(1, mat.shape[1] + 1):
        if j == mat.shape[1] or same[j] != same[start]:
            blocks.append((start, j, bool(same[start])))
            start = j
    G = nx.DiGraph()
    prev_nodes = []
    for bi, (s, e, is_common) in enumerate(blocks):
        if is_common:
            name = f"B{bi}\n{e - s}bp"
            G.add_node(name, common=True)
            for p in prev_nodes:
                G.add_edge(p, name)
            prev_nodes = [name]
        else:
            variants = {}
            for ci in range(mat.shape[0]):
                v = sq.decode(mat[ci, s:e]) or "-"
                variants.setdefault(v, []).append(ci)
            names = []
            for vi, (v, members) in enumerate(sorted(variants.items())):
                name = f"B{bi}.{vi}\n{len(v) if v != '-' else 0}bp"
                G.add_node(name, common=False)
                for p in prev_nodes:
                    G.add_edge(p, name)
                names.append(name)
            prev_nodes = names
    pos = nx.kamada_kawai_layout(G)
    colors = ["#7fbf7f" if G.nodes[n].get("common") else "#fdae61"
              for n in G.nodes]
    nx.draw_networkx(G, pos=pos, ax=ax, node_color=colors, node_size=900,
                     font_size=6, arrows=True)
    ax.set_title("graph genome (shared / variant blocks)")
    ax.axis("off")


def draw_pipe(record: str, reference: str, tumor_bams, normal_bams, t_ids,
              n_ids, savedir: str, offset: int = 50, mapq: int = 5,
              graph: bool = True, device="cuda"):
    """DrawPipe equivalent (src/ScopeVIZ.py:530-562): extract + render,
    the EM on `device`."""
    from ..engine.localgraph import open_bam
    from ..io.fasta import FastaFile
    os.makedirs(savedir, exist_ok=True)
    ref = FastaFile(reference)
    readers = [open_bam(p) for p in tumor_bams + normal_bams]
    lbls = [f"{t}_tumor" for t in t_ids] + [f"{n}_normal" for n in n_ids]
    win = data_maker(record, ref, readers, lbls, offset=offset, mapq=mapq)
    chrom, start, end = record.strip().split("\t")[:3]
    out = os.path.join(savedir, f"{chrom}_{start}-{end}.window.png")
    return draw_window(win, out, graph=graph, device=device)
