"""Phase-transfer-entropy causality matrix (the port's copy of
``dsgcn_tpu/data/causal_pte.py``; reference datasets/pipelines/causal.py:
1-58): the precompute that feeds ``Causalmetrix`` and STGCN_GC's external
graph.

Gaussian transfer entropy between every ordered joint pair from the
determinants of covariances of lag-embedded series; numpy only (scipy's
linear detrend written out).
"""
from __future__ import annotations

import numpy as np

EPS = np.finfo(float).eps


def _detrend(z: np.ndarray) -> np.ndarray:
    """scipy.signal.detrend(type='linear') along the last axis."""
    n = z.shape[-1]
    t = np.arange(n, dtype=np.float64)
    t = t - t.mean()
    denom = (t * t).sum()
    zm = z.mean(axis=-1, keepdims=True)
    slope = ((z - zm) * t).sum(axis=-1, keepdims=True) / denom
    return z - zm - slope * t


def standardize(a: np.ndarray, axis: int = -1) -> np.ndarray:
    return (a - a.mean(axis=axis, keepdims=True)) / a.std(axis=axis,
                                                          keepdims=True)


def embed_data(x: np.ndarray, order: int, lag: int) -> np.ndarray:
    """(C, N) -> (order C, N - (order - 1) lag) lag embedding
    (causal.py:19-27)."""
    ch, n = x.shape
    hidx = np.arange(order * lag, step=lag)
    nv = n - (order - 1) * lag
    u = np.zeros((order * ch, nv))
    for i in range(order):
        u[i * ch:(i + 1) * ch] = x[:, hidx[i]:hidx[i] + nv]
    return u


def pte(z: np.ndarray, lag: int = 1, model_order: int = 1,
        to_norm: bool = False) -> np.ndarray:
    """Pairwise phase transfer entropy (causal.py:30-58).

    z: (V, C, T) per-joint multichannel series -> (V, V), [i, j] the
    estimated information flow i -> j (0 on the diagonal and where a
    covariance determinant is not positive).  ``to_norm`` detrends and
    standardizes each series first (in float64)."""
    nn = z.shape[0]
    out = np.zeros((nn, nn))
    if to_norm:
        z = standardize(_detrend(np.asarray(z, np.float64)))
    c = z.shape[1]
    for i in range(nn):
        xi = embed_data(z[i], model_order + 1, lag)
        xtau = xi[:-c]
        for j in range(nn):
            if i == j:
                continue
            yj = embed_data(z[j], model_order + 1, lag)
            y, ytau = yj[-c:], yj[:-c]
            h_xtyt = np.linalg.det(np.cov(np.concatenate([xtau, ytau])))
            h_yyt = np.linalg.det(np.cov(np.concatenate([y, ytau])))
            h_yytxt = np.linalg.det(np.cov(
                np.concatenate([y, ytau, xtau])))
            h_ytau = np.linalg.det(np.cov(ytau))
            if min(h_xtyt, h_yyt, h_yytxt, h_ytau) > 0:
                out[i, j] = 0.5 * (np.log(h_xtyt) + np.log(h_yyt)
                                   - np.log(h_yytxt) - np.log(h_ytau))
    return out
