"""The kernels of the fused `pk` MSA build, and the plain torch versions
of K3 and K4/K5 (counterpart of svscope_tpu/ops/poa_fused_kernel.py).

  * K3 `align_tb` (csrc/poa_pk_align.cu): K1's DP over the rank-space graph
    that ops/poa_fused.pk_round_prep builds each round, plus the traceback
    — K1's row pass (csrc/poa_row.cuh) on the pk layout, one launch a
    round.  Plain version: `align_tb_reference`.
  * K4/K5 `fusion` (csrc/poa_pk_fusion.cu): fuse each window's alignment
    into its graph state, in place — K4 one block per window, the round in
    a fixed number of parallel phases, a window its phases cannot fuse
    exactly (detected before any write) taking the serial walk; K5 the
    serial walk itself, one warp per window.  `fusion_engine()` reads
    SVSCOPE_PK_FUSION ("lockstep", the default, or "seq") at every call.
    Plain version of both: `fusion_reference(order=...)`.
  * K6 `round_prep_cuda` / `toposort_cuda` (csrc/poa_pk_prep.cu): a round's
    group-Kahn order and K3's and the fusion's operands, one block per
    window, the whole Kahn loop on the card; in its order mode the build's
    final order.  Plain versions: ops/poa_fused.pk_round_prep_reference and
    toposort_reference, which ops/poa_fused dispatches to on CPU tensors.
  * K7 `consensus_cuda` (csrc/poa_pk_consensus.cu): the heaviest-bundle
    consensus walk, one block per window.  Plain version:
    ops/poa_fused.consensus_walk_reference.
K6 and K7 replace loops that the JAX package keeps on the device as XLA
(`_toposort`'s while loop, `_consensus_walk`'s scan and walks), not Pallas
kernels.

CUDA tensors go to the kernels, CPU tensors to the plain versions; any other
device raises, and so does a kernel that fails to build or launch.
`LAUNCHES` counts kernel launches by name ("K3" ... "K7"); the plain
versions never touch it.

Graph state (`GraphState`): struct-of-arrays int32 tensors per window, row
`ncap-1` the trash row — a node that would be created there sets the
overflow flag, and the window goes to the host engine.  The JAX package
keeps the same fields in one lane-structured (B, ncap, 128) array `gs`;
`graph_state_from_jax` / `graph_state_to_jax` map between the two as numpy
arrays, so tests can feed JAX round states to the port and back.
"""
from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..utils.cuda_build import load_cuda_lib
from .poa_align import check_tensor, launch_threads
from .poa_device import MAX_PREDS, align_batch_reference

ALPHA5 = 5                 # base codes ACGTN -> 0..4
ALIGN_SOURCE = "poa_pk_align.cu"
FUSION_SOURCE = "poa_pk_fusion.cu"
PREP_SOURCE = "poa_pk_prep.cu"
CONSENSUS_SOURCE = "poa_pk_consensus.cu"
SOURCES = (ALIGN_SOURCE, FUSION_SOURCE, PREP_SOURCE, CONSENSUS_SOURCE)
FUSION_ENGINES = ("lockstep", "seq")
SEQ_GROUP = 8              # JAX's seq kernel: windows per grid step
# gs lane fields of the JAX layout (svscope_tpu/ops/poa_fused_kernel.py)
GS_LANES = 128
L_PN, L_PW, L_PT, L_GC, L_CH, L_GM = 0, 8, 16, 24, 32, 33

LAUNCHES = {"K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}
_count_lock = threading.Lock()
_fns: dict[str, object] = {}


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def fusion_engine() -> str:
    """SVSCOPE_PK_FUSION, read now: "lockstep" (K4) or "seq" (K5)."""
    eng = os.environ.get("SVSCOPE_PK_FUSION", "lockstep")
    if eng not in FUSION_ENGINES:
        raise ValueError(f"SVSCOPE_PK_FUSION={eng!r}: one of "
                         f"{FUSION_ENGINES}")
    return eng


@dataclass
class GraphState:
    """Per-window POA graph state on one device (all int32).

    pn/pw/pt (B, ncap, 8): in-edge tails in insertion order (-1 empty),
    their weights and creation stamps; gc (B, ncap, 5): per column id, the
    member carrying each base (-1 none); ch (B, ncap): base code; gm
    (B, ncap): column id (smallest member id); nn, tctr, ovf (B,): node
    count, next edge stamp, overflow flag."""
    pn: torch.Tensor
    pw: torch.Tensor
    pt: torch.Tensor
    gc: torch.Tensor
    ch: torch.Tensor
    gm: torch.Tensor
    nn: torch.Tensor
    tctr: torch.Tensor
    ovf: torch.Tensor

    @classmethod
    def empty(cls, batch: int, ncap: int, device) -> "GraphState":
        i32 = dict(dtype=torch.int32, device=device)
        return cls(
            pn=torch.full((batch, ncap, MAX_PREDS), -1, **i32),
            pw=torch.zeros((batch, ncap, MAX_PREDS), **i32),
            pt=torch.zeros((batch, ncap, MAX_PREDS), **i32),
            gc=torch.full((batch, ncap, ALPHA5), -1, **i32),
            ch=torch.zeros((batch, ncap), **i32),
            gm=torch.arange(ncap, **i32).repeat(batch, 1),
            nn=torch.zeros(batch, **i32), tctr=torch.zeros(batch, **i32),
            ovf=torch.zeros(batch, **i32))

    def tensors(self) -> list[torch.Tensor]:
        return [getattr(self, f.name) for f in fields(self)]

    def clone(self) -> "GraphState":
        return GraphState(*[t.clone() for t in self.tensors()])

    def numpy(self) -> dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in fields(self)}


def graph_state_from_jax(gs, nn, tctr, ovf, device="cpu") -> GraphState:
    """JAX pk state — gs (B, ncap, 128) lanes and (B, 1) counters, numpy —
    to a GraphState on `device`.  The tensors are copies: fusion updates
    them in place."""
    gs = np.asarray(gs)

    def t(a):
        return torch.from_numpy(np.array(a, np.int32, order="C")).to(device)
    return GraphState(
        pn=t(gs[..., L_PN:L_PN + MAX_PREDS]),
        pw=t(gs[..., L_PW:L_PW + MAX_PREDS]),
        pt=t(gs[..., L_PT:L_PT + MAX_PREDS]),
        gc=t(gs[..., L_GC:L_GC + ALPHA5]), ch=t(gs[..., L_CH]),
        gm=t(gs[..., L_GM]), nn=t(np.asarray(nn).reshape(-1)),
        tctr=t(np.asarray(tctr).reshape(-1)),
        ovf=t(np.asarray(ovf).reshape(-1)))


def graph_state_to_jax(st: GraphState):
    """GraphState -> (gs, nn, tctr, ovf) numpy in the JAX pk layout: the
    unused gchar lanes hold -1, every other unused lane (and the
    out-degree lane, which the pk kernels never write) 0."""
    s = st.numpy()
    B, ncap = s["ch"].shape
    gs = np.zeros((B, ncap, GS_LANES), np.int32)
    gs[..., L_PN:L_PN + MAX_PREDS] = s["pn"]
    gs[..., L_PW:L_PW + MAX_PREDS] = s["pw"]
    gs[..., L_PT:L_PT + MAX_PREDS] = s["pt"]
    gs[..., L_GC:L_GC + 8] = -1
    gs[..., L_GC:L_GC + ALPHA5] = s["gc"]
    gs[..., L_CH] = s["ch"]
    gs[..., L_GM] = s["gm"]
    return (gs, s["nn"].reshape(-1, 1), s["tctr"].reshape(-1, 1),
            s["ovf"].reshape(-1, 1))


# ---------------------------------------------------------------- K3 ----

def align_tb_reference(charsr, sinksr, predsp, seqv, lb, nn_eff):
    """Plain torch K3.  charsr/sinksr (B, N) int32; predsp (B, N, 8) int32
    rank-space preds, empty slots holding slot 0; seqv (B, l_max+1) int32
    with column 0 = 255 and codes 0-4 after it; lb, nn_eff (B,).

    Returns (an, asx, ke): (B, N-1+l_max) int32 right-aligned rank / seq
    position pairs (-1 gap, -2 pad) and (B,) int32 last unwritten index.
    It is K1's plain version with K1's narrower-by-one buffer: a path has
    at most nn_eff + lb <= N-1+l_max entries, so K1's first column is
    always pad.  JAX's align_tb_call also takes chain-row flags, which
    only its TPU kernel reads; the port has none."""
    B, N = charsr.shape
    l_max = seqv.shape[1] - 1
    slot = torch.arange(MAX_PREDS, device=predsp.device)
    # back to K1's table: -1 in the slots that copy slot 0
    preds = torch.where((slot > 0) & (predsp == predsp[..., :1]), -1, predsp)
    an, asx, ke, _score = align_batch_reference(
        charsr.to(torch.uint8), preds, sinksr > 0, nn_eff.reshape(B),
        seqv[:, 1:].to(torch.uint8), lb.reshape(B), l_max)
    return an[:, 1:].contiguous(), asx[:, 1:].contiguous(), ke - 1


def _align_fn():
    if "align" not in _fns:
        fn = load_cuda_lib(ALIGN_SOURCE).pk_align_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 11 + [ci] * 4 + [vp]
        fn.restype = ci
        _fns["align"] = fn
    return _fns["align"]


def align_tb_cuda(charsr, sinksr, predsp, seqv, lb, nn_eff):
    """Launch K3 on CUDA tensors (see align_tb_reference), with K1's launch
    configuration (poa_align.launch_threads).  Every tensor must be
    contiguous; predsp also 16-byte aligned (the kernel reads a rank's 8
    slots as two 16-byte words)."""
    dev = charsr.device
    if dev.type != "cuda":
        raise ValueError(f"align_tb_cuda needs CUDA tensors, got {dev}")
    B, N = charsr.shape
    l1 = seqv.shape[1]
    l_max = l1 - 1
    i32 = torch.int32
    for name, t, shape in (("charsr", charsr, (B, N)),
                           ("sinksr", sinksr, (B, N)),
                           ("predsp", predsp, (B, N, MAX_PREDS)),
                           ("seqv", seqv, (B, l1)), ("lb", lb, (B,)),
                           ("nn_eff", nn_eff, (B,))):
        check_tensor(name, t, i32, shape, dev)
    if predsp.data_ptr() % 16:
        raise ValueError("predsp must be 16-byte aligned")
    threads = launch_threads(l_max)
    out_len = N - 1 + l_max        # at most N-1 nodes plus l_max bases
    H = torch.empty((B, N + 1, l1), dtype=i32, device=dev)
    D = torch.empty((B, N, l1), dtype=torch.int8, device=dev)
    an = torch.empty((B, out_len), dtype=i32, device=dev)
    asx = torch.empty((B, out_len), dtype=i32, device=dev)
    ke = torch.empty((B,), dtype=i32, device=dev)
    fn = _align_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(charsr.data_ptr(), sinksr.data_ptr(), predsp.data_ptr(),
                seqv.data_ptr(), lb.data_ptr(), nn_eff.data_ptr(),
                H.data_ptr(), D.data_ptr(), an.data_ptr(), asx.data_ptr(),
                ke.data_ptr(), B, N, l_max, threads, stream)
    if rc != 0:
        raise RuntimeError(f"pk_align_launch failed: CUDA error {rc} "
                           f"(B={B}, N={N}, l_max={l_max})")
    _count("K3")
    return an, asx, ke


def align_tb(charsr, sinksr, predsp, seqv, lb, nn_eff):
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if charsr.device.type == "cuda":
        return align_tb_cuda(charsr, sinksr, predsp, seqv, lb, nn_eff)
    if charsr.device.type == "cpu":
        return align_tb_reference(charsr, sinksr, predsp, seqv, lb, nn_eff)
    raise ValueError(f"unsupported device {charsr.device}")


# ------------------------------------------------------------- K4/K5 ----

def _fuse_windows(w, an, asx, ke, gminr, seqs5, g, path, trash: int):
    """Fuse the alignments of windows `w` (a long tensor) into the padded
    state `g`, one entry per window per step (K4's schedule).  `g` holds
    one extra dump row per window (index ncap) and `path` one extra dump
    column (index l_max): masked writes go there, so no step needs a
    host-side mask."""
    out_len = an.shape[1]
    n_max = gminr.shape[1]
    l_max = seqs5.shape[1]
    dump = trash + 1
    dev = an.device
    i32, i64 = torch.int32, torch.long
    slots8 = torch.arange(MAX_PREDS, device=dev)
    slots5 = torch.arange(ALPHA5, device=dev)
    ke_w = ke[w].to(i64)
    ne = out_len - 1 - ke_w
    nn = g["nn"][w].to(i64)
    tc = g["tctr"][w].to(i64)
    ovf = g["ovf"][w] > 0
    prev = torch.full_like(nn, -1)
    pn, pw, pt, gc = g["pn"], g["pw"], g["pt"], g["gc"]
    steps = int(ne.max()) if len(w) else 0
    for it in range(steps):
        k = (ke_w + 1 + it).clamp(max=out_len - 1)
        anv = an[w, k].to(i64)
        aspv = asx[w, k].to(i64)
        valid = (it < ne) & (aspv >= 0)
        sposc = aspv.clamp(0, l_max - 1)
        c5 = seqs5[w, sposc].to(i64)
        has_node = valid & (anv >= 0)
        gid_old = gminr[w, anv.clamp(0, n_max - 1)].to(i64)
        rowsel = torch.where(has_node, gid_old, 0).clamp(0, trash)
        pre = torch.where(has_node, gc[w, rowsel, c5].to(i64), -1)
        creator = valid & (pre < 0)
        ovf = ovf | (creator & (nn >= trash))
        newid = nn.clamp(max=trash)
        cur = torch.where(creator, newid, pre)
        gid = torch.where(has_node, gid_old, newid)
        # a creator writes its whole new row
        crow = torch.where(creator, newid, dump)
        pn[w, crow] = -1
        pw[w, crow] = 0
        pt[w, crow] = 0
        own = (slots5 == c5[:, None]) & (gid == newid)[:, None]
        gc[w, crow] = torch.where(own, newid[:, None], -1).to(i32)
        g["ch"][w, crow] = c5.to(i32)
        g["gm"][w, crow] = gid.to(i32)
        jrow = torch.where(creator & has_node, gid.clamp(0, trash), dump)
        gc[w, jrow, c5] = newid.to(i32)
        nn = (nn + creator.to(i64)).clamp(max=trash)
        # edge prev -> cur, read after the creator's writes
        add_e = valid & (prev >= 0)
        curc = cur.clamp(0, trash)
        prow = pn[w, curc].to(i64)
        ehit = prow == prev[:, None]
        has_e = add_e & ehit.any(1)
        eslot = torch.where(ehit, slots8, MAX_PREDS).amin(1).clamp(
            max=MAX_PREDS - 1)
        nvalid = (prow >= 0).sum(1)
        ovf_e = add_e & ~has_e & (nvalid >= MAX_PREDS)
        newe = add_e & ~has_e & ~ovf_e
        slot = torch.where(has_e, eslot, nvalid.clamp(max=MAX_PREDS - 1))
        w_old = pw[w, curc, slot].to(i64)
        erow = torch.where(has_e | newe, curc, dump)
        pn[w, erow, slot] = prev.to(i32)
        pw[w, erow, slot] = torch.where(has_e, w_old + 1, 1).to(i32)
        pt[w, torch.where(newe, curc, dump), slot] = tc.to(i32)
        tc = tc + newe.to(i64)
        ovf = ovf | ovf_e
        path[w, torch.where(valid, sposc, l_max)] = cur.to(i32)
        prev = torch.where(valid, cur, prev)
    g["nn"][w] = nn.to(i32)
    g["tctr"][w] = tc.to(i32)
    g["ovf"][w] = ovf.to(i32)


def fusion_reference(an, asx, ke, gminr, seqs5, st: GraphState,
                     order: str = "lockstep"):
    """Plain torch K4 and K5: the serial fusion of each window, windows
    being independent (order="lockstep": every window at once, one entry
    per window per step; order="seq": window g of every group of 8 at
    once, for g = 0..7 in turn, as JAX's seq kernel walks a grid step).

    an/asx (B, out_len), ke (B,): K3's output; gminr (B, n_max) pre-round
    column ids by rank; seqs5 (B, l_max) the reads' base codes.  Updates
    `st` in place (the trash row included, exactly as the kernels do) and
    returns the round's path (B, l_max) int32: the node of each read base,
    -1 where the read is shorter."""
    if order not in FUSION_ENGINES:
        raise ValueError(f"order {order!r}: one of {FUSION_ENGINES}")
    B, ncap = st.ch.shape
    l_max = seqs5.shape[1]
    dev = an.device

    def pad_rows(t):
        extra = torch.zeros((B, 1) + tuple(t.shape[2:]), dtype=t.dtype,
                            device=dev)
        return torch.cat([t, extra], dim=1)
    g = {"pn": pad_rows(st.pn), "pw": pad_rows(st.pw), "pt": pad_rows(st.pt),
         "gc": pad_rows(st.gc), "ch": pad_rows(st.ch), "gm": pad_rows(st.gm),
         "nn": st.nn.clone(), "tctr": st.tctr.clone(), "ovf": st.ovf.clone()}
    path = torch.full((B, l_max + 1), -1, dtype=torch.int32, device=dev)
    if order == "lockstep":
        groups = [torch.arange(B, device=dev)]
    else:
        groups = [torch.arange(q, B, SEQ_GROUP, device=dev)
                  for q in range(min(SEQ_GROUP, B))]
    for w in groups:
        _fuse_windows(w, an, asx, ke, gminr, seqs5, g, path, ncap - 1)
    for name in ("pn", "pw", "pt", "gc", "ch", "gm"):
        getattr(st, name).copy_(g[name][:, :ncap])
    for name in ("nn", "tctr", "ovf"):
        getattr(st, name).copy_(g[name])
    return path[:, :l_max].contiguous()


def fusion_smem_bytes(ncap: int, l_max: int, out_len: int) -> int:
    """K4's dynamic shared memory (csrc/poa_pk_fusion.cu fusion_smem, which
    refuses a launch past a block's limit): a window's out_len entries
    staged as four int32 (read position, old column, cur, code), then
    bitmaps over the keys (ncap x 5), the curs (ncap) and the read
    positions (l_max)."""
    words = -(-ncap * ALPHA5 // 32) + -(-ncap // 32) + -(-l_max // 32)
    return 4 * (4 * out_len + words)


def _fusion_fns():
    """K4/K5's C entry points: the launch, the counted launch and K4's
    shared-memory size."""
    if "pk_fusion_launch" not in _fns:
        lib = load_cuda_lib(FUSION_SOURCE)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for name, argtypes in (
                ("pk_fusion_smem_bytes", [ci] * 3),
                ("pk_fusion_launch_counted", [vp] * 15 + [ci] * 6 + [vp] * 2),
                ("pk_fusion_launch", [vp] * 15 + [ci] * 6 + [vp])):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ci
            _fns[name] = fn
    return _fns


def fusion_cuda(an, asx, ke, gminr, seqs5, st: GraphState,
                order: str = "lockstep", fallbacks=None, out=None):
    """Launch K4 (order="lockstep") or K5 (order="seq") on CUDA tensors
    (see fusion_reference); updates `st` in place, returns the path.
    st.pn, st.pw and st.pt must be 16-byte aligned (whole pred rows move as
    two 16-byte words).  `fallbacks`, a (1,) int32 tensor on the same
    device, gets K4's count of windows that took the serial walk added
    (K5 walks every window and adds nothing).  `out`, a contiguous
    (B, l_max) int32 tensor holding -1, takes the path in place of a new
    one (the kernels write only the read's positions)."""
    if order not in FUSION_ENGINES:
        raise ValueError(f"order {order!r}: one of {FUSION_ENGINES}")
    dev = an.device
    if dev.type != "cuda":
        raise ValueError(f"fusion_cuda needs CUDA tensors, got {dev}")
    B, out_len = an.shape
    ncap = st.ch.shape[1]
    n_max = gminr.shape[1]
    l_max = seqs5.shape[1]
    i32 = torch.int32
    for name, t, shape in (("an", an, (B, out_len)),
                           ("asx", asx, (B, out_len)), ("ke", ke, (B,)),
                           ("gminr", gminr, (B, n_max)),
                           ("seqs5", seqs5, (B, l_max)),
                           ("pn", st.pn, (B, ncap, MAX_PREDS)),
                           ("pw", st.pw, (B, ncap, MAX_PREDS)),
                           ("pt", st.pt, (B, ncap, MAX_PREDS)),
                           ("gc", st.gc, (B, ncap, ALPHA5)),
                           ("ch", st.ch, (B, ncap)), ("gm", st.gm, (B, ncap)),
                           ("nn", st.nn, (B,)), ("tctr", st.tctr, (B,)),
                           ("ovf", st.ovf, (B,))):
        check_tensor(name, t, i32, shape, dev)
    if fallbacks is not None:
        check_tensor("fallbacks", fallbacks, i32, (1,), dev)
    if out is not None:
        check_tensor("out", out, i32, (B, l_max), dev)
    if any(t.data_ptr() % 16 for t in (st.pn, st.pw, st.pt)):
        raise ValueError("st.pn, st.pw and st.pt must be 16-byte aligned")
    path = torch.full((B, l_max), -1, dtype=i32, device=dev) \
        if out is None else out
    fns = _fusion_fns()
    ptrs = (an.data_ptr(), asx.data_ptr(), ke.data_ptr(), gminr.data_ptr(),
            seqs5.data_ptr(), st.pn.data_ptr(), st.pw.data_ptr(),
            st.pt.data_ptr(), st.gc.data_ptr(), st.ch.data_ptr(),
            st.gm.data_ptr(), st.nn.data_ptr(), st.tctr.data_ptr(),
            st.ovf.data_ptr(), path.data_ptr(), B, ncap, n_max, l_max,
            out_len, int(order == "seq"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if fallbacks is None:
            rc = fns["pk_fusion_launch"](*ptrs, stream)
        else:
            rc = fns["pk_fusion_launch_counted"](*ptrs, fallbacks.data_ptr(),
                                                 stream)
    if rc != 0:
        raise RuntimeError(f"pk_fusion_launch failed: CUDA error {rc} "
                           f"(B={B}, ncap={ncap}, l_max={l_max})")
    _count("K5" if order == "seq" else "K4")
    return path


def fusion(an, asx, ke, gminr, seqs5, st: GraphState, out=None):
    """K4, or K5 under SVSCOPE_PK_FUSION=seq, on CUDA tensors; the plain
    version in the same order on CPU tensors.  `out` (see fusion_cuda), when
    given, receives the path and is returned."""
    order = fusion_engine()
    if an.device.type == "cuda":
        return fusion_cuda(an, asx, ke, gminr, seqs5, st, order, out=out)
    if an.device.type == "cpu":
        path = fusion_reference(an, asx, ke, gminr, seqs5, st, order)
        return path if out is None else out.copy_(path)
    raise ValueError(f"unsupported device {an.device}")


# ---------------------------------------------------------------- K6 ----

def prep_smem_bytes(ncap: int) -> int:
    """K6's dynamic shared memory (csrc/poa_pk_prep.cu prep_smem, which
    refuses a launch past a block's limit): each column's first four
    blockers and heads (uint16), gm, the blocker and head list offsets,
    the blocker counts and the placement list (int32), the unplaced and
    ready column masks, the blocker and head lists (uint16, 8 a node) and
    the placed flags."""
    words = -(-ncap // 32)
    return (16 * ncap + 4 * (5 * ncap + 2) + 8 * words
            + 4 * MAX_PREDS * ncap + -(-ncap // 16) * 16)


def _prep_fn():
    if "prep" not in _fns:
        fn = load_cuda_lib(PREP_SOURCE).pk_prep_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 17 + [ci] * 3 + [vp]
        fn.restype = ci
        _fns["prep"] = fn
    return _fns["prep"]


def _check_graph(pn, gm, nn):
    """Device, shape and type checks of a (pn, gm, nn) window batch;
    returns (B, ncap)."""
    dev = gm.device
    if dev.type != "cuda":
        raise ValueError(f"K6 needs CUDA tensors, got {dev}")
    B, ncap = gm.shape
    check_tensor("pn", pn, torch.int32, (B, ncap, MAX_PREDS), dev)
    check_tensor("gm", gm, torch.int32, (B, ncap), dev)
    check_tensor("nn", nn, torch.int32, (B,), dev)
    if pn.data_ptr() % 16:
        raise ValueError("pn must be 16-byte aligned")
    return B, ncap


def _launch_prep(pn, gm, nn, cyclic, *, order=None, rank=None,
                 ops=(None,) * 7, ch=None, seq=None, slen=None, ovf=None):
    """One K6 launch: order mode with `order` and `rank`, prep mode with
    `ops` (charsr ... gminr), ch, seq and slen (and ovf |= cyclic when
    `ovf` is given)."""
    B, ncap = gm.shape
    l_max = 0 if seq is None else seq.shape[1]
    ptrs = [0 if t is None else t.data_ptr() for t in (
        pn, gm, nn, ch, seq, slen, ovf, cyclic, order, rank, *ops)]
    with torch.cuda.device(gm.device):
        stream = torch.cuda.current_stream(gm.device).cuda_stream
        rc = _prep_fn()(*ptrs, B, ncap, l_max, stream)
    if rc != 0:
        raise RuntimeError(f"pk_prep_launch failed: CUDA error {rc} "
                           f"(B={B}, ncap={ncap}, l_max={l_max})")
    _count("K6")


def toposort_cuda(pn, gm, nn):
    """K6 in its order mode on CUDA tensors (ops/poa_fused.toposort_reference
    on the card): pn (B, ncap, 8), gm (B, ncap), nn (B,) int32, pn 16-byte
    aligned.  Returns (order, rank) (B, ncap) int64 and cyclic (B,) bool."""
    B, ncap = _check_graph(pn, gm, nn)
    order = torch.empty((B, ncap), dtype=torch.long, device=gm.device)
    rank = torch.empty_like(order)
    cyclic = torch.empty(B, dtype=torch.bool, device=gm.device)
    _launch_prep(pn, gm, nn, cyclic, order=order, rank=rank)
    return order, rank, cyclic


def round_prep_cuda(st: GraphState, seq, slen, update_ovf: bool = False):
    """K6 on CUDA tensors (ops/poa_fused.pk_round_prep_reference on the
    card): the round's operands (charsr, sinksr, predsp, seqv, lb, nn_eff,
    gminr), int32, and cyclic (B,) bool; with update_ovf, st.ovf |= cyclic
    in the same launch.  seq (B, l_max) and slen (B,) int32, contiguous;
    predsp comes out 16-byte aligned, as K3 needs it."""
    B, ncap = _check_graph(st.pn, st.gm, st.nn)
    dev = st.gm.device
    l_max = seq.shape[1] if seq.dim() == 2 else -1
    i32 = torch.int32
    for name, t, shape in (("ch", st.ch, (B, ncap)), ("ovf", st.ovf, (B,)),
                           ("seq", seq, (B, l_max)), ("slen", slen, (B,))):
        check_tensor(name, t, i32, shape, dev)

    def out(*shape):
        return torch.empty(shape, dtype=i32, device=dev)
    ops = (out(B, ncap), out(B, ncap), out(B, ncap, MAX_PREDS),
           out(B, l_max + 1), out(B), out(B), out(B, ncap))
    cyclic = torch.empty(B, dtype=torch.bool, device=dev)
    _launch_prep(st.pn, st.gm, st.nn, cyclic, ops=ops, ch=st.ch, seq=seq,
                 slen=slen, ovf=st.ovf if update_ovf else None)
    return ops, cyclic


# ---------------------------------------------------------------- K7 ----

def consensus_smem_bytes(ncap: int) -> int:
    """K7's dynamic shared memory (csrc/poa_pk_consensus.cu walk_smem):
    scores and best out-keys (int64), the order, best in-edges, stamp
    minima and best out-edges (int32), and two 256-rank tiles of pred and
    weight rows."""
    return 32 * ncap + 2 * 2 * 256 * MAX_PREDS * 4


def _consensus_fn():
    if "consensus" not in _fns:
        fn = load_cuda_lib(CONSENSUS_SOURCE).pk_consensus_launch
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 9 + [ci] * 2 + [vp]
        fn.restype = ci
        _fns["consensus"] = fn
    return _fns["consensus"]


def consensus_cuda(pn, pw, pt, nn, order):
    """K7 on CUDA tensors (ops/poa_fused.consensus_walk_reference on the
    card): pn, pw, pt (B, ncap, 8) int32 (pn and pw 16-byte aligned), nn
    (B,) int32, order (B, ncap) int64.  Returns (back_buf (B, ncap),
    back_start (B,), fwd_buf (B, ncap), fwd_cnt (B,)), int64."""
    dev = pn.device
    if dev.type != "cuda":
        raise ValueError(f"consensus_cuda needs CUDA tensors, got {dev}")
    B, ncap = order.shape
    for name, t, shape, dt in (("pn", pn, (B, ncap, MAX_PREDS), torch.int32),
                               ("pw", pw, (B, ncap, MAX_PREDS), torch.int32),
                               ("pt", pt, (B, ncap, MAX_PREDS), torch.int32),
                               ("nn", nn, (B,), torch.int32),
                               ("order", order, (B, ncap), torch.long)):
        check_tensor(name, t, dt, shape, dev)
    if pn.data_ptr() % 16 or pw.data_ptr() % 16:
        raise ValueError("pn and pw must be 16-byte aligned")
    back_buf = torch.empty((B, ncap), dtype=torch.long, device=dev)
    fwd_buf = torch.empty_like(back_buf)
    back_start = torch.empty(B, dtype=torch.long, device=dev)
    fwd_cnt = torch.empty_like(back_start)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _consensus_fn()(pn.data_ptr(), pw.data_ptr(), pt.data_ptr(),
                             nn.data_ptr(), order.data_ptr(),
                             back_buf.data_ptr(), back_start.data_ptr(),
                             fwd_buf.data_ptr(), fwd_cnt.data_ptr(), B, ncap,
                             stream)
    if rc != 0:
        raise RuntimeError(f"pk_consensus_launch failed: CUDA error {rc} "
                           f"(B={B}, ncap={ncap})")
    _count("K7")
    return back_buf, back_start, fwd_buf, fwd_cnt
