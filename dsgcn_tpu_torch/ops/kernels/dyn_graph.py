"""Fused dynamic-graph build + spatial aggregation, forward (K1).

The port of ``dsgcn_tpu/ops/pallas/dyn_graph.py:fused_dyn_graph_agg``
(forward only; the backward K2 comes with the training port):

    ctr[k,c,v,w] = tanh(x1[k,c,v] - x2[k,c,w])
    ada[k,v,w]   = softmax_v( sum_c x1[k,c,v]*x2[k,c,w] )
    G[k,c,v,w]   = alpha[k]*ctr + beta[k]*ada[k,v,w] + A[k,v,w]
    y[t,w,k,c]   = sum_v pre[t,v,k,c] * G[k,c,v,w]

with the DS-GCN per-edge-class attention on subset ``edge_k`` and the
padded-joint softmax mask ``v_real``.  On a CUDA tensor
:func:`fused_dyn_graph_agg` launches the hand-written kernel
(``csrc/dyn_graph.cu``); on a CPU tensor it runs the plain version
:func:`reference_dyn_graph_agg`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _build


def edge_onehot(edge_type: np.ndarray, edge_num: int = 15) -> np.ndarray:
    """(V, V) int class matrix -> (edge_num, V, V) one-hot mask."""
    V = edge_type.shape[0]
    out = np.zeros((edge_num, V, V), np.float32)
    for e in range(edge_num):
        out[e] = (edge_type == e)
    return out


def _ada(raw: torch.Tensor, v_real: int) -> torch.Tensor:
    """Softmax over the source joint axis (-2), padded sources masked."""
    V = raw.shape[-2]
    if 0 < v_real < V:
        src = torch.arange(V, device=raw.device)[:, None] >= v_real
        raw = raw.masked_fill(src, -1e30)
    return torch.softmax(raw, dim=-2)


def reference_dyn_graph_agg(pre_x, x1, x2, A, alpha, beta, edge_w=None,
                            edge_b=None, edge_sel=None, K=3, Cm=8, edge_k=-1,
                            edge_num=15, v_real=-1):
    """Plain PyTorch version of the K1 forward (JAX ``_fwd_reference`` plus
    the kernel's ``v_real`` mask).  The graph builds in float32 and is cast
    to pre's dtype for the contraction, as the kernel does."""
    N, T, V, KC = pre_x.shape
    x1, x2 = x1.float(), x2.float()
    ctr = torch.tanh(x1[..., :, None] - x2[..., None, :])     # (N,K,Cm,V,V)
    if edge_w is not None:
        d = x1[:, edge_k][..., :, None] - x2[:, edge_k][..., None, :]
        es = torch.einsum("ncvw,ce->nevw", d, edge_w.float()).reshape(
            N, edge_num, Cm, V, V)
        sel = edge_sel.float()
        ea = torch.sum(es * sel[None, :, None], dim=1)        # (N,Cm,V,V)
        if edge_b is not None:
            eb = edge_b.float().reshape(edge_num, Cm)
            ea = ea + torch.einsum("evw,ec->cvw", sel, eb)[None]
        ctr = torch.cat([ctr[:, :edge_k], torch.tanh(ea)[:, None],
                         ctr[:, edge_k + 1:]], dim=1)
    ada = _ada(torch.einsum("nkcv,nkcw->nkvw", x1, x2), v_real)
    G = (ctr * alpha.float()[None, :, None, None, None]
         + (ada * beta.float()[None, :, None, None]
            + A.float()[None])[:, :, None])
    pre_k = pre_x.reshape(N, T, V, K, Cm)
    y = torch.einsum("ntvkc,nkcvw->ntwkc", pre_k, G.to(pre_x.dtype))
    return y.reshape(N, T, V, KC)


def fused_dyn_graph_agg(pre_x: torch.Tensor, x1: torch.Tensor,
                        x2: torch.Tensor, A: torch.Tensor,
                        alpha: torch.Tensor, beta: torch.Tensor,
                        edge_w: Optional[torch.Tensor] = None,
                        edge_b: Optional[torch.Tensor] = None,
                        edge_sel: Optional[torch.Tensor] = None,
                        K: int = 3, Cm: int = 8, edge_k: int = -1,
                        edge_num: int = 15,
                        v_real: int = -1) -> torch.Tensor:
    """y = aggregate(pre_x, G(x1, x2, A, alpha, beta[, edge attention])).

    pre_x: (N, T, V, K*Cm) float32 or bfloat16; x1/x2: (N, K, Cm, V);
    A: (K, V, V); alpha/beta: (K,) effective per-subset gates; edge_w:
    (Cm, edge_num*Cm) or None; edge_b: (edge_num*Cm,) or None; edge_sel:
    (edge_num, V, V) one-hot class mask or None; v_real: the ada softmax
    masks source joints >= v_real (joint-padded input).  Returns y in
    pre_x's layout and dtype.
    """
    if pre_x.device.type == "cpu":
        return reference_dyn_graph_agg(pre_x, x1, x2, A, alpha, beta, edge_w,
                                       edge_b, edge_sel, K=K, Cm=Cm,
                                       edge_k=edge_k, edge_num=edge_num,
                                       v_real=v_real)
    name = "fused_dyn_graph_agg"
    _build.check_activation(pre_x, name)
    _build.refuse_grad(name, pre_x, x1, x2, A, alpha, beta, edge_w, edge_b)
    N, T, V, KC = pre_x.shape
    if KC != K * Cm:
        raise ValueError(f"{name}: pre_x has {KC} channels, K*Cm = {K * Cm}")
    dev, E = pre_x.device, edge_num
    _build.check_limits(name, N, V, E)
    op = lambda t, shape, n: _build.graph_operand(t, shape, n, dev)  # noqa: E731
    x1 = op(x1, (N, K, Cm, V), "x1")
    x2 = op(x2, (N, K, Cm, V), "x2")
    A = op(A, (K, V, V), "A")
    alpha, beta = op(alpha, (K,), "alpha"), op(beta, (K,), "beta")
    if edge_w is not None:
        if not 0 <= edge_k < K:
            raise ValueError(f"{name}: edge_k={edge_k} outside [0, {K})")
        edge_w = op(edge_w, (Cm, E * Cm), "edge_w")
        sel = op(edge_sel, (E, V, V), "edge_sel")
        eb = (torch.zeros(E * Cm, device=dev) if edge_b is None
              else op(edge_b, (E * Cm,), "edge_b"))
        # bias field b[class(v,w), c] as a (Cm, V, V) constant, built
        # outside the kernel as the Pallas wrapper does
        bias_field = torch.einsum("evw,ec->cvw", sel,
                                  eb.reshape(E, Cm)).contiguous()
    else:
        edge_k, sel, bias_field = -1, None, None
    out = torch.empty_like(pre_x)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        _build.launch(
            "dyn_graph", _build.ptr(pre_x), _build.ptr(out),
            int(pre_x.dtype == torch.bfloat16), _build.ptr(x1),
            _build.ptr(x2), _build.ptr(A), _build.ptr(alpha),
            _build.ptr(beta), _build.ptr(edge_w), _build.ptr(bias_field),
            _build.ptr(sel), N, T, V, K, Cm, E, edge_k, v_real,
            _build.stream_of(pre_x))
    fused_dyn_graph_agg.launches += 1
    return out


fused_dyn_graph_agg.launches = 0
