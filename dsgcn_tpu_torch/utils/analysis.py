"""Embedding maps for analysis: the port of ``tsne_map`` from
``dsgcn_tpu/utils/analysis.py`` (reference core/evaluation.py:197-201,
TSNEmap through sklearn; an exact O(N^2) t-SNE of its own, as in JAX).

The affinities and the PCA start run in numpy on the host, as JAX computes
them, so the start point's component signs are JAX's; the gradient
iterations run in torch float64 on a device: the CUDA device unless the
caller names another (``device='cpu'``).
"""
from __future__ import annotations

import numpy as np
import torch


def _tsne_p_matrix(x: np.ndarray, perplexity: float) -> np.ndarray:
    """The symmetrized affinities: per point, a binary search on the
    Gaussian's precision for the entropy log(perplexity), 50 steps at most
    (JAX ``analysis.py:_tsne_p_matrix``)."""
    n = x.shape[0]
    d2 = np.sum(x * x, 1)[:, None] + np.sum(x * x, 1)[None] - 2 * x @ x.T
    np.fill_diagonal(d2, 0.0)
    d2 = np.maximum(d2, 0.0)
    target = np.log(perplexity)
    P = np.zeros((n, n))
    for i in range(n):
        lo, hi, beta = 0.0, np.inf, 1.0
        for _ in range(50):
            p = np.exp(-d2[i] * beta)
            p[i] = 0.0
            s = p.sum()
            if s <= 0:
                beta *= 0.5
                continue
            h = np.log(s) + beta * np.sum(d2[i] * p) / s
            if abs(h - target) < 1e-5:
                break
            if h > target:
                lo = beta
                beta = beta * 2 if hi == np.inf else (beta + hi) / 2
            else:
                hi = beta
                beta = (beta + lo) / 2
        P[i] = p / s
    P = (P + P.T) / (2 * n)
    return np.maximum(P, 1e-12)


def tsne_map(scores: np.ndarray, n_components: int = 2,
             perplexity: float = 30.0, n_iter: int = 400, seed: int = 42,
             device=None) -> np.ndarray:
    """The (N, n_components) t-SNE embedding of score or feature vectors,
    float32: PCA start scaled to 1e-4, early exaggeration 12 for 100
    iterations, momentum 0.5 then 0.8, learning rate max(N / 12, 50)
    (JAX ``analysis.py:tsne_map``).  ``device``: where the iterations run
    (default the CUDA device; raises without one)."""
    from ..apis import resolve_device
    dev = resolve_device(device)
    x = np.asarray(scores, np.float64)
    n = x.shape[0]
    perplexity = min(perplexity, max((n - 1) / 3.0, 2.0))
    xc = x - x.mean(0)
    _, _, vt = np.linalg.svd(xc, full_matrices=False)
    y = xc @ vt[:n_components].T
    y = y / (y[:, 0].std() + 1e-12) * 1e-4
    P = torch.from_numpy(_tsne_p_matrix(xc, perplexity)).to(dev)
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(y + rng.standard_normal(y.shape) * 1e-6).to(dev)
    vel = torch.zeros_like(y)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    exaggeration, lr = 12.0, max(n / 12.0, 50.0)
    for it in range(n_iter):
        Pe = P * exaggeration if it < 100 else P
        sq = (y * y).sum(1)
        d2 = sq[:, None] + sq[None] - 2 * y @ y.T
        num = (1.0 / (1.0 + d2)).masked_fill(eye, 0.0)
        Q = torch.clamp(num / num.sum(), min=1e-12)
        W = (Pe - Q) * num
        grad = 4 * ((torch.diag(W.sum(1)) - W) @ y)
        momentum = 0.5 if it < 100 else 0.8
        vel = momentum * vel - lr * grad
        y = y + vel
        y = y - y.mean(0)
    return y.cpu().numpy().astype(np.float32)
