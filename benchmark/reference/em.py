"""The reference's read clustering: Ward-cut initial labels, then for
every K = 1..9 a categorical mixture EM of 20 steps, the BIC of each K,
and the selected K's labels (EMCluster, src/ReadsCluster.py:44-277).

Plain torch, one window and one K at a time.  The EM's random draws are
an input of the engine: on a degenerate mixing weight a K-run restarts
from Dirichlet(1) draws.  The engine's default stream is a
torch.Generator seeded from (2023 << 8) + attempt that fills a
(21, 45, nf_pad, 5) float32 tensor of uniforms in [1e-12, 1) on the EM's
device, shared by every window of a bucket chunk; `draws` derives the
same stream itself, so the timed path keeps the draws users get.
Ward linkage is scipy's, as the reference tool calls it."""
from __future__ import annotations

import numpy as np
import torch

ALPHA = 5
MAX_K = 9
NSTEP = 20
EPS = 1e-10
UNIFORM_MIN = 1e-12
STREAM_SEED = 2023
MAX_ATTEMPTS = 5
SHAPE_LADDER = (16, 64, 256, 1024, 4096)


def nf_pad_of(nf: int) -> int:
    for b in SHAPE_LADDER:
        if nf <= b:
            return b
    return nf


def draws(attempt: int, nf_pad: int, device) -> torch.Tensor:
    """The engine's default uniforms of one attempt, (21, 45, nf_pad, 5)
    float32 on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed((STREAM_SEED << 8) + attempt)
    u = torch.rand((NSTEP + 1, MAX_K * (MAX_K + 1) // 2, nf_pad, ALPHA),
                   generator=gen, dtype=torch.float32, device=device)
    return torch.clamp(u * (1.0 - UNIFORM_MIN) + UNIFORM_MIN, min=UNIFORM_MIN)


def identity(feat: np.ndarray) -> np.ndarray:
    """Per read pair the share of feature columns with the same symbol,
    1 on the diagonal (float64)."""
    n, nf = feat.shape
    eq = (feat[:, None, :] == feat[None, :, :]).sum(axis=2)
    sim = eq / max(nf, 1)
    np.fill_diagonal(sim, 1.0)
    return sim


def ward_cuts(feat: np.ndarray, kmax: int) -> np.ndarray:
    """(kmax, n) labels: row k-1 the K=k cut of the Ward tree built on the
    identity matrix's rows as observations (scipy linkage), i.e. the
    first n - k merges, clusters numbered by their first read."""
    from scipy.cluster.hierarchy import linkage
    n = feat.shape[0]
    out = np.zeros((kmax, n), np.int64)
    if n < 2:
        return out
    Z = linkage(identity(feat), method="ward")
    for k in range(2, min(kmax, n) + 1):
        parent = list(range(2 * n - 1))

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        for m in range(n - k):
            a, b = int(Z[m, 0]), int(Z[m, 1])
            parent[find(a)] = parent[find(b)] = n + m
        first: dict[int, int] = {}
        for i in range(n):
            out[k - 1, i] = first.setdefault(find(i), len(first))
    return out


def _run(x, hard, K, u, nf, dtype):
    """One K-run: (BIC's log-likelihood term, final gamma (n, K))."""
    n = x.shape[0]
    off = K * (K - 1) // 2
    gamma = torch.nn.functional.one_hot(hard, K).to(dtype)
    e = -torch.log(u[:, off:off + K, :nf, :].to(dtype))   # (21, K, nf, 5)
    dirich = (e / e.sum(-1, keepdim=True)).reshape(NSTEP + 1, K, -1)
    for s in range(NSTEP + 1):
        denom = gamma.sum(0)
        pi = denom / n
        theta = (gamma.T @ x) / torch.where(denom == 0, 1.0, denom)[:, None]
        if bool(((pi * n < 1) | torch.isnan(pi)).any()):
            pi = torch.full_like(pi, 1.0 / K)
            theta = dirich[s]
        M = x @ torch.log(torch.clamp(theta, EPS, 1 - EPS)).T \
            + torch.log(torch.clamp(pi, EPS, 1 - EPS))
        a = torch.exp(torch.clamp(M - M.amax(1, keepdim=True), -700.0, 700.0))
        gamma = a / a.sum(1, keepdim=True)
    return float((gamma * M).sum()), gamma


def em_window(feat: np.ndarray, device, dtype=torch.float64,
              tf32: bool = False) -> dict:
    """{"k", "labels", "bics"} of one window's feature matrix (n reads x
    nf columns, codes 0..4).  dtype and tf32 set the arithmetic: the
    reference is float64; float32 with TF32 products is the control."""
    n, nf = feat.shape
    n_k = max(min(MAX_K + 1, n) - 1, 1)
    hard = torch.as_tensor(ward_cuts(feat, MAX_K), device=device)
    x = torch.nn.functional.one_hot(
        torch.as_tensor(feat, dtype=torch.long, device=device),
        ALPHA).reshape(n, nf * ALPHA).to(dtype)
    counts = np.stack([(feat == a).sum(axis=0) for a in range(ALPHA)])
    zero_params = int((counts == 0).sum())
    bics = np.full(MAX_K, np.nan)
    gammas: list = [None] * MAX_K
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for attempt in range(MAX_ATTEMPTS):
            todo = [r for r in range(n_k) if np.isnan(bics[r])]
            if not todo:
                break
            u = draws(attempt, nf_pad_of(nf), device)
            for r in todo:
                K = r + 1
                lik, gamma = _run(x, hard[r], K, u, nf, dtype)
                n_theta = (K - 1) + K * nf * (ALPHA - 1) - zero_params
                bics[r] = 2.0 * lik - n_theta * np.log(n)
                gammas[r] = gamma
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    if np.isnan(bics[:n_k]).all():
        return {"k": 1, "labels": np.zeros(n, np.int64), "bics": bics}
    sel = int(np.nanargmax(bics[:n_k]))
    if sel == 0 and n_k >= 2 and bics[0] - bics[1] <= nf * np.log(n):
        sel = 1
    labels = torch.argmax(gammas[sel], dim=1).cpu().numpy().astype(np.int64)
    return {"k": sel + 1, "labels": labels, "bics": bics}
