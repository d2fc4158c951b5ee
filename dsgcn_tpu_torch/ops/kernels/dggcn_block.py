"""The whole eval GCN block of DG-STGCN and DS-GCN in one kernel (K6).

The port of ``dsgcn_tpu/ops/pallas/dggcn_block.py:fused_dggcn_block_eval``:

    res = x                       (or x w_down + b_down when channels change)
    pre = relu(x w_pre + b_pre)                              (T, V, K*Cm)
    G   = alpha*tanh(x1 - x2) + beta*softmax_v(x1^T x2) + A  (one subset
          optionally the DS-GCN edge-class attention)
    y   = aggregate(pre, G)
    out = relu(y w_post + b_post + res)

with every BatchNorm already folded into its 1x1 (``ops/gcn.py:
fold_block_params``).  The T-pooled queries x1/x2 are built outside, as in
JAX.  On a CUDA tensor :func:`fused_dggcn_block_eval` launches the
hand-written kernel ``csrc/dggcn_block.cu``; on a CPU tensor it runs the
plain version :func:`reference_dggcn_block_eval`.  Eval only.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .dyn_graph import _ctr, _edge_operands, _graph

# csrc/dggcn_block.cu: the shared memory of a one-frame tile must fit
_SMEM_LIMIT = 232448


def _frame_smem_bytes(V: int, KC: int, Cm: int, E: int) -> int:
    """Shared memory of a block that holds one frame (block_smem_bytes at
    TT = 1, channel groups of at most 16)."""
    XS = V | 1
    cg = max(d for d in range(1, min(16, Cm) + 1) if Cm % d == 0)
    return 4 * (2 * V * KC + 2 * Cm * XS + V * V + 2 * E * cg * XS)


def reference_dggcn_block_eval(x, x1, x2, w_pre, b_pre, A, alpha, beta,
                               w_post, b_post, w_down=None, b_down=None, *,
                               K, Cm, edge_w=None, edge_b=None, edge_sel=None,
                               edge_k=-1, edge_num=15):
    """Plain PyTorch version of K6, the TPU kernel's arithmetic: x lifted to
    float32, pre, G, y and the 1x1 products in float32, the output in x's
    dtype."""
    N, T, V, _ = x.shape
    xf = x.float()
    pre = torch.relu(xf @ w_pre.float() + b_pre.float())
    x1, x2 = x1.float(), x2.float()
    ctr = _ctr(x1, x2, edge_w, edge_b, edge_sel, Cm, edge_k, edge_num)
    G, _ = _graph(x1, x2, A, alpha, beta, ctr)
    y = torch.einsum("ntvkc,nkcvw->ntwkc", pre.reshape(N, T, V, K, Cm), G)
    out = y.reshape(N, T, V, K * Cm) @ w_post.float() + b_post.float()
    res = xf if w_down is None else xf @ w_down.float() + b_down.float()
    return torch.relu(out + res).to(x.dtype)


def fused_dggcn_block_eval(x: torch.Tensor, x1: torch.Tensor,
                           x2: torch.Tensor, w_pre: torch.Tensor,
                           b_pre: torch.Tensor, A: torch.Tensor,
                           alpha: torch.Tensor, beta: torch.Tensor,
                           w_post: torch.Tensor, b_post: torch.Tensor,
                           w_down: Optional[torch.Tensor] = None,
                           b_down: Optional[torch.Tensor] = None, *,
                           K: int, Cm: int,
                           edge_w: Optional[torch.Tensor] = None,
                           edge_b: Optional[torch.Tensor] = None,
                           edge_sel: Optional[torch.Tensor] = None,
                           edge_k: int = -1,
                           edge_num: int = 15) -> torch.Tensor:
    """out = relu(post(aggregate(relu(pre(x)), G)) + res) for one block.

    x: (N, T, V, C) float32 or bfloat16; x1/x2: (N, K, Cm, V) T-pooled
    queries; w_pre (C, K*Cm), b_pre (K*Cm,), w_post (K*Cm, Cout), b_post
    (Cout,), w_down (C, Cout) and b_down (Cout,) or None (then C == Cout and
    the residual is x): BatchNorm-folded 1x1s in the JAX (in, out)
    orientation; A (K, V, V); alpha/beta (K,) effective gates; edge_w
    (Cm, edge_num*Cm), edge_b (edge_num*Cm,) or None, edge_sel
    (edge_num, V, V): the edge-class attention on subset ``edge_k``.
    Returns (N, T, V, Cout) in x's dtype."""
    if edge_w is None:
        edge_k = -1
    if x.device.type == "cpu":
        return reference_dggcn_block_eval(
            x, x1, x2, w_pre, b_pre, A, alpha, beta, w_post, b_post, w_down,
            b_down, K=K, Cm=Cm, edge_w=edge_w, edge_b=edge_b,
            edge_sel=edge_sel, edge_k=edge_k, edge_num=edge_num)
    name = "fused_dggcn_block_eval"
    _build.check_activation(x, name)
    _build.refuse_grad(name, x, x1, x2, w_pre, b_pre, A, alpha, beta, w_post,
                       b_post, w_down, b_down, edge_w, edge_b)
    N, T, V, C = x.shape
    KC, Cout, dev = K * Cm, w_post.shape[-1], x.device
    E = edge_num if edge_k >= 0 else 0
    _build.check_limits(name, N, V, E)
    if (w_down is None) != (b_down is None):
        raise ValueError(f"{name}: give both w_down and b_down, or neither")
    if w_down is None and C != Cout:
        raise ValueError(f"{name}: without a down path C ({C}) must equal "
                         f"Cout ({Cout})")
    if _frame_smem_bytes(V, KC, Cm, E) > _SMEM_LIMIT:
        raise ValueError(f"{name}: one frame's pre and y tiles (K*Cm = {KC}, "
                         f"V = {V}) do not fit a block's shared memory")
    op = lambda t, shape, n: _build.graph_operand(t, shape, n, dev)  # noqa
    ops = dict(x1=op(x1, (N, K, Cm, V), "x1"), x2=op(x2, (N, K, Cm, V), "x2"),
               w_pre=op(w_pre, (C, KC), "w_pre"), b_pre=op(b_pre, (KC,),
                                                           "b_pre"),
               A=op(A, (K, V, V), "A"), alpha=op(alpha, (K,), "alpha"),
               beta=op(beta, (K,), "beta"),
               w_post=op(w_post, (KC, Cout), "w_post"),
               b_post=op(b_post, (Cout,), "b_post"), w_down=None,
               b_down=None, edge_w=None, bias_field=None, sel=None)
    if w_down is not None:
        ops["w_down"] = op(w_down, (C, Cout), "w_down")
        ops["b_down"] = op(b_down, (Cout,), "b_down")
    if edge_k >= 0:
        if not 0 <= edge_k < K:
            raise ValueError(f"{name}: edge_k={edge_k} outside [0, {K})")
        ops["edge_w"], ops["bias_field"], ops["sel"] = _edge_operands(
            edge_w, edge_b, edge_sel, Cm, edge_num, V, dev)
    out = torch.empty((N, T, V, Cout), device=dev, dtype=x.dtype)
    if out.numel() == 0:
        return out
    ptr = _build.ptr
    with torch.cuda.device(dev):
        _build.launch(
            "dggcn_block", ptr(x), ptr(out), int(x.dtype == torch.bfloat16),
            *(ptr(ops[k]) for k in (
                "x1", "x2", "w_pre", "b_pre", "A", "alpha", "beta", "w_post",
                "b_post", "w_down", "b_down", "edge_w", "bias_field", "sel")),
            N, T, V, C, K, Cm, Cout, edge_num, edge_k, _build.stream_of(x))
    fused_dggcn_block_eval.launches += 1
    return out


fused_dggcn_block_eval.launches = 0
