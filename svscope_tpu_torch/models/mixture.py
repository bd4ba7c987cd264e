"""Categorical mixture EM with BIC model selection — the phasing core of the
per-window engine (counterpart of svscope_tpu/models/mixture.py).

The localGraph engine's path: the 45-slot folded EM (all nine K-runs of a
window share one segmented slot axis, so each step is one pair of batched
products over (windows, reads, nf*5) x (nf*5, 45)), its labels-only
variant, the bucketed batch dispatch with the reference's NaN-BIC retry
policy, and the result selection.  The window axis is a leading batch
dimension where the JAX package vmaps.  Beside it, the per-K single-window
path (`em_cluster`, which the figures of viz/scopeviz.py's callers and
the reference's EMCluster API use): the nine K-runs as a leading run axis
of batched products where the JAX package vmaps `em_run` over K.

Random state.  On a degenerate mixing weight the M-step re-initialises a
K-run from Dirichlet(1) draws.  The JAX package draws them per step from
`jax.random.uniform(keys[s], (45, nf_pad, 5), minval=1e-12)` with keys split
from (seed, attempt); here the draws are an explicit input, one
(nsteps + 1, 45, nf_pad, 5) tensor per (bucket chunk, attempt), shared by
every window of the chunk.  By default they come from a torch.Generator
seeded from (seed, attempt); the `uniforms=` callable replaces them (the
tests hand in JAX's own draws, which makes the BICs comparable).
K and labels do not depend on the stream on the engine's workloads.
The per-K path draws Gamma(1) variates (JAX: `jax.random.gamma(key, ones)`
per run and step); here they are an explicit (MAX_K, nsteps + 1, MAX_K,
nf_pad, 5) input per attempt, -log(U) from a torch.Generator seeded from
(seed, attempt) by default, and the `gammas=` callable replaces them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device, resolve_dtype

ALPHA = 5          # alphabet size {A,T,C,G,-}
MAX_K = 9          # reference max cluster count (src/ReadsCluster.py:221)
NSTEP = 20         # fixed EM iterations (src/ReadsCluster.py:190)
PAD_CODE = 5       # feature pad: one-hot(5, num_classes=5) == zeros
EPS = 1e-10
NEG_BIG = -1e30
MAX_BATCH = 256                  # windows per device call
BATCH_LADDER = (32, 128, 256)     # batch-axis shape buckets
SHAPE_LADDER = (16, 64, 256, 1024, 4096)   # feature-axis buckets
READS_LADDER = (16, 64, 512)      # read-axis buckets (selection caps at 500)
UNIFORM_MIN = 1e-12

R_TOTAL = MAX_K * (MAX_K + 1) // 2           # 45
SLOT_RUN = np.concatenate([[r] * (r + 1) for r in range(MAX_K)])  # (45,)
RUN_OFF = np.concatenate([[0], np.cumsum(np.arange(1, MAX_K + 1))])[:MAX_K]
SLOT_K = SLOT_RUN + 1                         # K of the run owning the slot
SEG = np.eye(MAX_K)[SLOT_RUN]                 # (45, 9) slot -> run one-hot

# Reference parity: EMCluster re-runs EM while BIC is NaN, up to 5 total
# attempts per K (src/ReadsCluster.py:247-252).  Each attempt draws a fresh
# random stream; slots that produced a finite BIC keep their first result.
MAX_EM_ATTEMPTS = 5


# ---------------------------------------------------------------------------
# Host prep (numpy)
# ---------------------------------------------------------------------------

def pairwise_identity(seqdatamx: np.ndarray) -> np.ndarray:
    """Per-pair fraction of identical columns, diag=1
    (CallDistance/pariwiseDistance, src/ReadsCluster.py:44-59)."""
    x = np.asarray(seqdatamx)
    n, nf_raw = x.shape
    nf = max(nf_raw, 1)
    if n * n * nf_raw > (1 << 21):
        # one-hot matmul; integer counts <= nf are exact in f32
        oh = (x[..., None] == np.arange(ALPHA, dtype=x.dtype))
        oh_f = oh.reshape(n, nf_raw * ALPHA).astype(np.float32)
        eq = (oh_f @ oh_f.T).astype(np.float64)
        out = eq / nf
    else:
        eq = (x[:, None, :] == x[None, :, :]).sum(axis=2) / nf
        out = eq.astype(np.float64)
    np.fill_diagonal(out, 1.0)
    return out


def zero_param_count(seqdatamx: np.ndarray) -> int:
    """Number of (symbol, column) cells with zero count
    (src/ReadsCluster.py:225-234)."""
    x = np.asarray(seqdatamx)
    counts = np.stack([(x == a).sum(axis=0) for a in range(ALPHA)])
    return int((counts == 0).sum())


def _bucket(x: int, ladder=SHAPE_LADDER):
    for b in ladder:
        if x <= b:
            return b
    return x


def ward_cut_many(sims: list[np.ndarray], kmax: int) -> list[np.ndarray]:
    """Ward-cut init labels through the native C++ kernel
    (csrc/host/hcluster.cpp).  No NumPy fallback: a load failure
    raises with its cause."""
    try:
        from ..native.hcluster import ward_cut_batch
        return ward_cut_batch(sims, kmax)
    except (ImportError, OSError) as exc:
        raise RuntimeError("native Ward kernel (csrc/host/hcluster.cpp) "
                           f"cannot load: {exc!r}") from exc


# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------

def _generator(seed: int, attempt: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) << 8) + int(attempt))
    return gen


def torch_uniforms(seed: int, attempt: int, nf_pad: int, nsteps: int,
                   dtype: torch.dtype, device) -> torch.Tensor:
    """Default draws: (nsteps + 1, 45, nf_pad, 5) uniforms in
    [UNIFORM_MIN, 1) from a torch.Generator on `device` seeded from
    (seed, attempt) — the counterpart of the JAX package's per-step
    `jax.random.uniform(..., minval=1e-12)` under split keys."""
    device = torch.device(device)
    u = torch.rand((nsteps + 1, R_TOTAL, nf_pad, ALPHA),
                   generator=_generator(seed, attempt, device), dtype=dtype,
                   device=device)
    return torch.clamp(u * (1.0 - UNIFORM_MIN) + UNIFORM_MIN,
                       min=UNIFORM_MIN)


def torch_gammas(seed: int, attempt: int, nf_pad: int, nsteps: int,
                 dtype: torch.dtype, device) -> torch.Tensor:
    """Default draws of the per-K path: (MAX_K, nsteps + 1, MAX_K, nf_pad,
    5) Gamma(1) variates, -log(U) of uniforms in [UNIFORM_MIN, 1) from a
    torch.Generator on `device` seeded from (seed, attempt) — the
    counterpart of `jax.random.gamma(keys[s], ones)` under the keys that
    em_run splits per K-run and step."""
    device = torch.device(device)
    u = torch.rand((MAX_K, nsteps + 1, MAX_K, nf_pad, ALPHA),
                   generator=_generator(seed, attempt, device), dtype=dtype,
                   device=device)
    return -torch.log(torch.clamp(u, min=UNIFORM_MIN))


# ---------------------------------------------------------------------------
# Per-K EM (one window, the nine K-runs batched over a leading run axis)
# ---------------------------------------------------------------------------

def _m_step(gamma, x_flat, read_mask, n_true, kmask, draws):
    """pi/theta update with degenerate-pi Dirichlet re-init, per run
    (svscope_tpu/models/mixture.py::_m_step under vmap over K).

    gamma (R, N, K); x_flat (N, nf*5); kmask (R, K) bool; draws (R, K, nf,
    5) Gamma(1) variates.  Returns pi (R, K), theta (R, K, nf*5)."""
    gamma = gamma * read_mask[None, :, None]
    # reads summed in order, as XLA's reduction does (see _em_folded_batch)
    denom = gamma.cumsum(dim=1)[:, -1]                            # (R, K)
    pi = denom / n_true
    counts = torch.matmul(gamma.transpose(1, 2), x_flat)          # (R, K, F)
    theta = counts / torch.where(denom == 0, 1.0, denom)[..., None]
    bad = ((torch.where(kmask, pi, 1.0) * n_true < 1).any(dim=1)
           | torch.isnan(pi).any(dim=1))                          # (R,)
    dirich = (draws / draws.sum(-1, keepdim=True)).reshape(theta.shape)
    k_act = kmask.sum(dim=1).clamp(min=1).to(torch.float64)
    pi = torch.where(bad[:, None], (1.0 / k_act).to(pi.dtype)[:, None], pi)
    theta = torch.where(bad[:, None, None], dirich, theta)
    return pi, theta


def _e_step(pi, theta, x_flat, kmask):
    """(gamma (R, N, K), M (R, N, K)) with the reference's reciprocal-sum
    gamma_I = 1 / sum_j exp(clip(M_j - M_I, -700, 700))."""
    logt = torch.log(torch.clamp(theta, EPS, 1 - EPS))            # (R, K, F)
    M = torch.matmul(x_flat, logt.transpose(1, 2))                # (R, N, K)
    M = M + torch.log(torch.clamp(pi, EPS, 1 - EPS))[:, None, :]
    M = torch.where(kmask[:, None, :], M, NEG_BIG)
    diff = torch.clamp(M[:, :, :, None] - M[:, :, None, :], -700.0, 700.0)
    gamma = 1.0 / torch.exp(diff).sum(dim=2)                      # [r, n, I]
    gamma = torch.where(kmask[:, None, :], gamma, 0.0)
    return gamma, M


def _loglik(pi, theta, gamma, x_flat, read_mask):
    """Expected complete-data log-lik per read, (R, N)
    (src/ReadsCluster.py:104-122)."""
    logt = torch.log(torch.clamp(theta, EPS, 1 - EPS))
    per_k = torch.matmul(x_flat, logt.transpose(1, 2)) \
        + torch.log(torch.clamp(pi, EPS, 1 - EPS))[:, None, :]
    return (per_k * gamma).sum(dim=2) * read_mask[None, :]


def em_run(x_flat, read_mask, gamma0, kmask, n_true, draws,
           nsteps: int = NSTEP):
    """EM runs of one window, one per K-run: init M/E then nsteps x (M, E)
    (svscope_tpu/models/mixture.py::em_run, batched over the run axis).

    x_flat (N, nf*5) one-hot (pad rows/cols zero); gamma0 (R, N, K) Ward
    hard labels; kmask (R, K) active cluster slots; draws (R, nsteps + 1,
    K, nf, 5).  Returns (pi, theta, gamma, lik_per_read) of the last step."""
    pi, theta = _m_step(gamma0, x_flat, read_mask, n_true, kmask,
                        draws[:, 0])
    gamma, _ = _e_step(pi, theta, x_flat, kmask)
    lik = None
    for s in range(1, nsteps + 1):
        pi, theta = _m_step(gamma, x_flat, read_mask, n_true, kmask,
                            draws[:, s])
        gamma, _ = _e_step(pi, theta, x_flat, kmask)
        lik = _loglik(pi, theta, gamma * read_mask[None, :, None], x_flat,
                      read_mask)
    return pi, theta, gamma, lik


def _bic(lik_sum, n_true, nf_true, k, zero_param_num):
    n_theta = (k - 1) + k * nf_true * (ALPHA - 1) - zero_param_num
    return 2.0 * lik_sum - n_theta * torch.log(n_true)


def _em_all_k(x_oh, read_mask, gamma0_all, kmask_all, n_true, nf_true,
              zero_param_num, draws, nsteps: int = NSTEP):
    """Every K-run of one window (svscope_tpu mixture._em_all_k_core).

    x_oh (N, nf, 5); gamma0_all (MAX_K, N, MAX_K); kmask_all (MAX_K, MAX_K)
    bool; draws (MAX_K, nsteps + 1, MAX_K, nf, 5).
    Returns (bics (MAX_K,), gammas (MAX_K, N, MAX_K), pis (MAX_K, MAX_K),
    thetas (MAX_K, MAX_K, nf, 5))."""
    n, nf = x_oh.shape[:2]
    x_flat = x_oh.reshape(n, nf * ALPHA)
    pis, thetas, gammas, liks = em_run(x_flat, read_mask, gamma0_all,
                                       kmask_all, n_true, draws, nsteps)
    ks = kmask_all.sum(dim=1).to(x_oh.dtype)
    bics = _bic(liks.sum(dim=1), n_true, nf_true, ks, zero_param_num)
    return bics, gammas, pis, thetas.reshape(MAX_K, MAX_K, nf, ALPHA)


# ---------------------------------------------------------------------------
# Folded EM (batched over windows)
# ---------------------------------------------------------------------------

def _em_folded_batch(codes, hard, n_k, n_true, nf_true, zpn, uniforms,
                     nsteps: int = NSTEP):
    """45-slot folded EM over a batch of windows
    (svscope_tpu/models/mixture.py::_em_folded_one, window axis leading).

    codes (B, n_pad, nf_pad) int8 (PAD_CODE pads); hard (B, 9, n_pad) Ward
    labels per K-run; n_k, n_true (B,) int; nf_true, zpn (B,) float;
    uniforms (nsteps + 1, 45, nf_pad, 5) shared by the batch.
    Returns bics (B, 9) and per-run gamma (B, 9, n_pad, 9)."""
    dtype = uniforms.dtype
    dev = codes.device
    B, n_pad, nf_pad = codes.shape
    seg = torch.as_tensor(SEG, dtype=dtype, device=dev)           # (R, 9)
    slot_run = torch.as_tensor(SLOT_RUN, device=dev)
    slot_k = torch.as_tensor(SLOT_K, dtype=dtype, device=dev)
    run_off = torch.as_tensor(RUN_OFF, device=dev)

    alphabet = torch.arange(ALPHA, dtype=codes.dtype, device=dev)
    x_flat = (codes[..., None] == alphabet).reshape(
        B, n_pad, nf_pad * ALPHA).to(dtype)
    read_mask = (torch.arange(n_pad, device=dev)[None, :]
                 < n_true[:, None]).to(dtype)                     # (B, n)
    nt = n_true.to(dtype)[:, None]                                # (B, 1)
    slot_active = slot_run[None, :] < n_k[:, None]                # (B, R)

    # init gamma: run r's hard labels land in slots run_off[r] + label
    slots0 = run_off[None, :, None] + hard.long()                 # (B, 9, n)
    run_ok = torch.arange(MAX_K, device=dev)[None, :] < n_k[:, None]
    slots0 = torch.where(run_ok[:, :, None], slots0, -1)
    gamma0 = torch.zeros((B, n_pad, R_TOTAL), dtype=dtype, device=dev)
    for r in range(MAX_K):
        s = slots0[:, r]                                          # (B, n)
        hit = (s[..., None] == torch.arange(R_TOTAL, device=dev))
        gamma0 = gamma0 + hit.to(dtype)
    gamma0 = gamma0 * read_mask[..., None]

    def m_step(gamma, u):
        g = gamma * read_mask[..., None]
        # reads summed in order (as XLA's reduction does): a one-read
        # cluster sits right on the pi*N < 1 restart threshold, where a
        # one-ulp difference of another summation order flips the restart
        denom = g.cumsum(dim=1)[:, -1]                            # (B, R)
        counts = torch.bmm(g.transpose(1, 2), x_flat)             # (B, R, F)
        theta = counts / torch.where(denom == 0, 1.0, denom)[..., None]
        pi = denom / nt
        # per-run degeneracy: any active slot with pi*N < 1 or NaN
        bad_slot = ((pi * nt < 1) | torch.isnan(pi)) & slot_active
        bad_run = (bad_slot.to(dtype) @ seg) > 0                  # (B, 9)
        bad = bad_run[:, slot_run]                                # (B, R)
        # Dirichlet(1) == normalized exponentials
        e = -torch.log(u)
        dirich = (e / e.sum(-1, keepdim=True)).reshape(R_TOTAL, -1)
        pi = torch.where(bad, 1.0 / slot_k, pi)
        theta = torch.where(bad[..., None], dirich[None], theta)
        return pi, theta

    def e_step(pi, theta):
        logt = torch.log(torch.clamp(theta, EPS, 1 - EPS))
        M = torch.bmm(x_flat, logt.transpose(1, 2)) \
            + torch.log(torch.clamp(pi, EPS, 1 - EPS))[:, None, :]
        M = torch.where(slot_active[:, None, :], M, NEG_BIG)
        # segment softmax with exact slice/gather segment max and
        # denominator (never one-hot products: see the e_step note in
        # svscope_tpu/models/mixture.py on the -1e30 sentinel)
        m_run = torch.stack(
            [M[:, :, int(RUN_OFF[r]):int(RUN_OFF[r]) + r + 1].amax(dim=2)
             for r in range(MAX_K)], dim=2)                       # (B, n, 9)
        m_slot = m_run[:, :, slot_run]                            # (B, n, R)
        a = torch.exp(torch.clamp(M - m_slot, -700.0, 700.0))
        seg_sum = a @ seg                                         # (B, n, 9)
        denom = seg_sum[:, :, slot_run]
        gamma = a / denom
        gamma = torch.where(slot_active[:, None, :], gamma, 0.0)
        return gamma, M

    pi, theta = m_step(gamma0, uniforms[0])
    gamma, _ = e_step(pi, theta)
    lik = None
    for s in range(1, nsteps + 1):
        pi, theta = m_step(gamma, uniforms[s])
        gamma, M = e_step(pi, theta)
        lik_run = ((gamma * M) @ seg) * read_mask[..., None]      # (B, n, 9)
        lik = lik_run.sum(dim=1)                                  # (B, 9)
    ks = torch.arange(1, MAX_K + 1, dtype=dtype, device=dev)[None, :]
    n_theta = (ks - 1) + ks * nf_true.to(dtype)[:, None] * (ALPHA - 1) \
        - zpn.to(dtype)[:, None]
    bics = 2.0 * lik - n_theta * torch.log(nt)
    # re-split segments into the (9, n, 9) per-run gamma layout
    gam_runs = torch.zeros((B, MAX_K, n_pad, MAX_K), dtype=dtype, device=dev)
    for r in range(MAX_K):
        o = int(RUN_OFF[r])
        gam_runs[:, r, :, :r + 1] = gamma[:, :, o:o + r + 1]
    return bics, gam_runs


def _em_folded_batch_light(codes, hard, n_k, n_true, nf_true, zpn, uniforms,
                           nsteps: int = NSTEP):
    """Labels-only path: (bics (B, 9), int8 labels (B, 9, n_pad)) — the
    argmax runs on the device so the host fetch stays small (localGraph
    only consumes hard labels, src/DecisionMaker.py:143)."""
    bics, gam_runs = _em_folded_batch(codes, hard, n_k, n_true, nf_true, zpn,
                                      uniforms, nsteps)
    return bics, torch.argmax(gam_runs, dim=3).to(torch.int8)


# ---------------------------------------------------------------------------
# Dispatch + selection
# ---------------------------------------------------------------------------

def _raw_em_dispatch(feats: list[np.ndarray], max_c: int, seed: int,
                     attempt: int, dtype: torch.dtype, nsteps: int,
                     labels_only: bool, device, uniforms):
    """Host prep + device EM over shape buckets.  Returns a fetch() closure
    producing raw per-window tuples (bics (MAX_K,), per-K output — int8
    labels (MAX_K, N) or gamma (MAX_K, N, MAX_K) —, n_k)."""
    results: list = [None] * len(feats)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, x in enumerate(feats):
        key = (_bucket(x.shape[0], READS_LADDER), _bucket(x.shape[1]))
        groups.setdefault(key, []).append(i)
    chunks = []
    for key, idxs in groups.items():
        for off in range(0, len(idxs), MAX_BATCH):
            chunks.append((key, idxs[off:off + MAX_BATCH]))
    pending: list = []
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    for (n_pad, nf_pad), idxs in chunks:
        b_pad = _bucket(len(idxs), ladder=BATCH_LADDER)
        codes = np.full((b_pad, n_pad, nf_pad), PAD_CODE, np.int8)
        hard_b = np.zeros((b_pad, MAX_K, n_pad), np.int8)
        nks = np.ones(b_pad, np.int32)
        ns = np.zeros(b_pad, np.int32)
        nfs = np.zeros(b_pad, np.int32)
        zps = np.zeros(b_pad, np.float64)
        for bi, i in enumerate(idxs):
            x = np.asarray(feats[i])
            ns[bi], nfs[bi] = x.shape
            codes[bi, :x.shape[0], :x.shape[1]] = x
        nb = len(idxs)
        # batched pairwise identity + zero-param counts via a one-hot
        # batched matmul (PAD_CODE is outside 0..4, so pads contribute 0;
        # integer counts are exact in f32)
        sims = zps_b = None
        if nb * n_pad * n_pad * nf_pad * ALPHA <= (1 << 29):
            c = codes[:nb]
            oh = (c[..., None] == np.arange(ALPHA, dtype=c.dtype))
            oh_f = oh.reshape(nb, n_pad, nf_pad * ALPHA).astype(np.float32)
            sims = np.matmul(oh_f, oh_f.transpose(0, 2, 1))
            zps_b = oh.sum(axis=1)
        sim_list = []
        for bi, i in enumerate(idxs):
            x = np.asarray(feats[i])
            n, nf = x.shape
            nks[bi] = max(min(max_c + 1, n) - 1, 1)
            if sims is not None:
                sim = (sims[bi, :n, :n] / max(nf, 1)).astype(np.float64)
                np.fill_diagonal(sim, 1.0)
                zps[bi] = float((zps_b[bi, :nf] == 0).sum())
            else:
                sim = pairwise_identity(x)
                zps[bi] = zero_param_count(x)
            sim_list.append(sim)
        cuts = ward_cut_many(sim_list, MAX_K)
        for bi, i in enumerate(idxs):
            n = sim_list[bi].shape[0]
            kmin = min(int(nks[bi]), MAX_K)
            hard_b[bi, :kmin, :n] = cuts[bi][:kmin]
        if len(idxs) < b_pad:                # batch-axis padding
            codes[len(idxs):] = codes[0]
            hard_b[len(idxs):] = hard_b[0]
            nks[len(idxs):] = nks[0]
            ns[len(idxs):] = ns[0]
            nfs[len(idxs):] = nfs[0]
            zps[len(idxs):] = zps[0]
        u = uniforms(seed, attempt, nf_pad, nsteps, dtype, device)
        if tuple(u.shape) != (nsteps + 1, R_TOTAL, nf_pad, ALPHA):
            raise ValueError(f"uniforms shape {tuple(u.shape)}, expected "
                             f"{(nsteps + 1, R_TOTAL, nf_pad, ALPHA)}")
        u = u.to(device=device, dtype=dtype)
        t = lambda a: torch.from_numpy(a).to(device)
        kernel = _em_folded_batch_light if labels_only else _em_folded_batch
        bics_b, out_b = kernel(t(codes), t(hard_b), t(nks), t(ns),
                               t(nfs.astype(np_dtype)),
                               t(zps.astype(np_dtype)), u, nsteps)
        pending.append((idxs, nks, bics_b, out_b))

    def fetch():
        for idxs, nks, bics_b, out_b in pending:
            bics_h = bics_b.cpu().numpy()
            out_h = out_b.cpu().numpy()
            for bi, i in enumerate(idxs):
                results[i] = (np.array(bics_h[bi], np.float64),
                              np.array(out_h[bi]), int(nks[bi]))
        return results

    return fetch


def em_cluster_batch_dispatch(feats: list[np.ndarray], max_c: int = MAX_K,
                              seed: int = 2023, dtype=None,
                              nsteps: int = NSTEP, labels_only: bool = False,
                              device="cuda", uniforms=None):
    """Async half of em_cluster_batch: host prep + device dispatch for every
    shape bucket, returning a fetch() closure that waits for the results,
    applies the reference's NaN-BIC retry policy (up to MAX_EM_ATTEMPTS
    runs per K with fresh draws, src/ReadsCluster.py:247-252) and finishes
    selection.

    uniforms: callable (seed, attempt, nf_pad, nsteps, dtype, device) ->
    (nsteps + 1, 45, nf_pad, 5) tensor of the M-step's random draws;
    default `torch_uniforms`."""
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    uniforms = uniforms or torch_uniforms
    raw_fetch = _raw_em_dispatch(feats, max_c, seed, 0, dtype, nsteps,
                                 labels_only, device, uniforms)

    def fetch():
        raws = raw_fetch()
        need = [i for i, (b, _o, nk) in enumerate(raws)
                if np.isnan(b[:nk]).any()]
        for attempt in range(1, MAX_EM_ATTEMPTS):
            if not need:
                break
            subs = _raw_em_dispatch([feats[i] for i in need], max_c, seed,
                                    attempt, dtype, nsteps, labels_only,
                                    device, uniforms)()
            still = []
            for i, (b2, o2, nk) in zip(need, subs):
                b, o, _nk = raws[i]
                bad = np.flatnonzero(np.isnan(b[:nk]))
                b[bad] = b2[bad]          # last attempt wins on NaN slots
                o[bad] = o2[bad]
                if np.isnan(b[:nk]).any():
                    still.append(i)
            need = still
        out = []
        for x, (b, o, nk) in zip(feats, raws):
            x = np.asarray(x)
            if labels_only:
                out.append(_select_result_labels(x, b, o, nk))
            else:
                out.append(_select_result(x, b, o, nk))
        return out

    return fetch


def _select_k(x, bics, n_k):
    """BIC argmax + the K=1->2 tie-break (EMCluster, src/ReadsCluster.py:
    264-272).  Returns (sel, k_sel, bics) or None when every K is NaN."""
    n, nf = x.shape
    bics = np.array(bics, np.float64)
    bics[n_k:] = np.nan
    if np.isnan(bics[:n_k]).all():
        return None, None, bics
    sel = int(np.nanargmax(bics))
    k_sel = sel + 1
    if k_sel == 1 and n_k >= 2 and (bics[0] - bics[1] <= nf * np.log(n)):
        sel, k_sel = 1, 2
    return sel, k_sel, bics


def _select_result(x, bics, gammas, n_k, pis=None, thetas=None):
    """Full-gamma selection (svscope_tpu mixture._select_result):
    [K, x, labels, theta, gamma, pi, bics]; theta and pi are None when
    pis/thetas are (the folded path computes neither)."""
    n = x.shape[0]
    sel, k_sel, bics = _select_k(x, bics, n_k)
    if sel is None:
        # every K diverged after MAX_EM_ATTEMPTS runs (the reference
        # crashes at nanargmax here, src/ReadsCluster.py:264); one cluster
        return [1, x, np.zeros(n, np.int64), None,
                np.ones((n, 1), np.float64), None, bics[:n_k]]
    gamma = np.array(gammas[sel], np.float64)[:n, :k_sel]
    theta = (np.array(thetas[sel], np.float64)[:k_sel]
             if thetas is not None else None)
    pi = np.array(pis[sel], np.float64)[:k_sel] if pis is not None else None
    labels = np.argmax(gamma, axis=1)
    return [k_sel, x, labels, theta, gamma, pi, bics[:n_k]]


def _select_result_labels(x, bics, labels_all, n_k):
    """Selection over device-computed hard labels (labels_only path)."""
    n = x.shape[0]
    sel, k_sel, bics = _select_k(x, bics, n_k)
    if sel is None:
        return [1, x, np.zeros(n, np.int64), None,
                np.ones((n, 1), np.float64), None, bics[:n_k]]
    labels = np.asarray(labels_all[sel][:n], np.int64)
    return [k_sel, x, labels, None, None, None, bics[:n_k]]


def em_cluster_batch(feats: list[np.ndarray], max_c: int = MAX_K,
                     seed: int = 2023, dtype=None, nsteps: int = NSTEP,
                     device="cuda", uniforms=None):
    """Batched EMCluster over many windows: [K, x, labels, theta, gamma,
    pi, bics] per window (theta and pi are not computed by the folded
    path and are None)."""
    return em_cluster_batch_dispatch(feats, max_c=max_c, seed=seed,
                                     dtype=dtype, nsteps=nsteps,
                                     device=device, uniforms=uniforms)()


def _prepare_window(x: np.ndarray, max_c: int, n_pad: int, nf_pad: int):
    """Host prep of one window for the per-K EM (svscope_tpu
    mixture._prepare_window): one-hot matrix, Ward-init hard assignments
    for every K, masks and counts."""
    n, nf = x.shape
    kmax_excl = min(max_c + 1, n)
    n_k = max(kmax_excl - 1, 1)
    kmax = min(n_k, MAX_K)
    hard = (np.zeros((kmax, n), np.int32) if n < 2
            else ward_cut_many([pairwise_identity(x)], kmax)[0])
    x_oh = np.zeros((n_pad, nf_pad, ALPHA), dtype=np.float64)
    valid = x < ALPHA
    idx = np.where(valid)
    x_oh[idx[0], idx[1], x[valid]] = 1.0
    gamma0_all = np.zeros((MAX_K, n_pad, MAX_K), np.float64)
    kmask_all = np.zeros((MAX_K, MAX_K), bool)
    for ki in range(n_k):
        kmask_all[ki, :ki + 1] = True
        gamma0_all[ki, np.arange(n), hard[ki]] = 1.0
    read_mask = np.zeros(n_pad, np.float64)
    read_mask[:n] = 1.0
    return x_oh, read_mask, gamma0_all, kmask_all, n_k, zero_param_count(x)


def em_cluster(seqdatamx: np.ndarray, max_c: int = MAX_K, seed: int = 2023,
               dtype=None, nsteps: int = NSTEP, device="cuda", gammas=None):
    """EMCluster equivalent (src/ReadsCluster.py:221-277) for one window:
    [K, seqdatamx, labels, theta, gamma, pi, bic_list], with the
    reference's NaN-BIC retry (up to MAX_EM_ATTEMPTS attempts, fresh draws
    each; finite K-runs keep their first result).

    device: where the EM runs (default cuda; raises when CUDA is absent).
    Reads and features are always padded to the shape buckets (masked
    rows, zero one-hots), so the draws' nf_pad axis matches JAX's.
    gammas: callable (seed, attempt, nf_pad, nsteps, dtype, device) ->
    (MAX_K, nsteps + 1, MAX_K, nf_pad, 5) Gamma(1) draws; default
    `torch_gammas`."""
    dtype = resolve_dtype(dtype)
    device = resolve_device(device)
    gammas = gammas or torch_gammas
    x = np.asarray(seqdatamx)
    n, nf = x.shape
    n_pad = _bucket(n, READS_LADDER)
    nf_pad = _bucket(nf)
    x_oh, read_mask, gamma0_all, kmask_all, n_k, zpn = _prepare_window(
        x, max_c, n_pad, nf_pad)
    cast = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    args = (cast(x_oh), cast(read_mask), cast(gamma0_all),
            torch.as_tensor(kmask_all, device=device), cast(float(n)),
            cast(float(nf)), cast(float(zpn)))
    want = (MAX_K, nsteps + 1, MAX_K, nf_pad, ALPHA)

    def run(attempt):
        g = gammas(seed, attempt, nf_pad, nsteps, dtype, device)
        if tuple(g.shape) != want:
            raise ValueError(f"gammas shape {tuple(g.shape)}, expected "
                             f"{want}")
        out = _em_all_k(*args, g.to(device=device, dtype=dtype), nsteps)
        return [np.array(v.cpu().numpy(), np.float64) for v in out]

    bics, gams, pis, thetas = run(0)
    for attempt in range(1, MAX_EM_ATTEMPTS):
        bad = np.flatnonzero(np.isnan(bics[:n_k]))
        if bad.size == 0:
            break
        b2, g2, p2, t2 = run(attempt)
        bics[bad], gams[bad], pis[bad], thetas[bad] = \
            b2[bad], g2[bad], p2[bad], t2[bad]
    return _select_result(x, bics, gams, n_k, pis, thetas)
