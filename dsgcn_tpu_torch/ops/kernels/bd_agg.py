"""Dynamic-graph aggregation for DS-GCN and DG-STGCN eval (K3, K4).

The ports of ``dsgcn_tpu/ops/pallas/bd_agg.py``:

* :func:`bd_dyn_graph_agg` (K3): the same function as the K1 forward
  (``dyn_graph.py``) from other input packaging.  pre2/y2 are the flat
  ``(N, T, V*K*Cm)`` views of ``(N, T, V, K*Cm)``, x1 arrives transposed
  as ``(N, K, V, Cm)``, and the edge-class attention arrives precomputed:
  per-class projections p1t ``(N, E, V, Cm)`` and p2 ``(N, E, Cm, V)`` and
  a ``(V, Cm, V)`` bias field.
* :func:`bd_dyn_graph_agg_subset` (K4): K3's function without edge
  attention, in the TPU kernel's per-subset / channel-group form (the TPU
  kernel builds its ada graph outside the kernel; here the tiled block
  builds it from each subset's full queries, as K3's does).

The TPU kernels' block-diagonal densification and group-major relayouts are
TPU mechanics and are not ported.  Each wrapper calls its custom op
(``dsgcn::bd_agg``, ``dsgcn::bd_agg_subset``): on a CUDA tensor the
hand-written kernel of ``csrc/bd_agg.cu`` (K4 with no edge subset), on a
CPU tensor its plain version.  K3 and K4 share K1's tiled design
(``csrc/graph_agg_tiled.cuh``) and block planner (``dyn_graph.agg_plan``).
"""
from __future__ import annotations

import torch

from . import _build
from .dyn_graph import _ada, agg_plan, like_first


def reference_bd_dyn_graph_agg(pre2, x1t, x2, A, alpha, beta, p1t=None,
                               p2=None, edge_sel=None, ebias=None, *, K, Cm,
                               edge_k=-1, edge_num=15, v_real=-1):
    """Plain PyTorch version of K3 from its own inputs: the graph builds in
    float32 as (N, K, V, Cm, W) and is cast to pre2's dtype for the
    contraction."""
    x1t, x2 = x1t.float(), x2.float()
    ada = subset_ada(x1t, x2, v_real)
    ctr = torch.tanh(x1t[..., :, :, None] - x2[:, :, None, :, :])
    if edge_k >= 0:
        sel = edge_sel.float()
        ea = (ebias.float()[None]
              + torch.einsum("evw,nevc->nvcw", sel, p1t.float())
              - torch.einsum("evw,necw->nvcw", sel, p2.float()))
        ctr = torch.cat([ctr[:, :edge_k], torch.tanh(ea)[:, None],
                         ctr[:, edge_k + 1:]], dim=1)
    return _contract(pre2, ctr, ada, A, alpha, beta, K, Cm)


def subset_ada(x1t, x2, v_real=-1):
    """The float32 ada graph (N, K, V, W): softmax over the source joint of
    each subset's full query product, padded sources masked."""
    return _ada(torch.einsum("nkvc,nkcw->nkvw", x1t.float(), x2.float()),
                v_real)


def _contract(pre2, ctr, ada, A, alpha, beta, K, Cm):
    """y2 from the float32 graphs ctr (N, K, V, Cm, W) and ada (N, K, V, W);
    G is cast to pre2's dtype for the contraction, as the kernels do."""
    N, T, VKC = pre2.shape
    V = A.shape[-1]
    G = (ctr * alpha.float()[None, :, None, None, None]
         + (ada * beta.float()[None, :, None, None]
            + A.float()[None])[:, :, :, None, :])            # (N,K,V,Cm,W)
    y = torch.einsum("ntvkc,nkvcw->ntwkc", pre2.reshape(N, T, V, K, Cm),
                     G.to(pre2.dtype))
    return y.reshape(N, T, VKC)


def bd_dyn_graph_agg(pre2: torch.Tensor, x1t: torch.Tensor, x2: torch.Tensor,
                     A: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                     p1t=None, p2=None, edge_sel=None, ebias=None, *, K: int,
                     Cm: int, edge_k: int = -1, edge_num: int = 15,
                     v_real: int = -1) -> torch.Tensor:
    """y2 = aggregate(pre2, G(x1, x2, A, alpha, beta[, edge attention])).

    pre2: (N, T, V*K*Cm) float32 or bfloat16; x1t: (N, K, V, Cm); x2:
    (N, K, Cm, V); A: (K, V, V); alpha/beta: (K,) effective gates; with
    ``edge_k >= 0``: p1t (N, E, V, Cm), p2 (N, E, Cm, V), edge_sel
    (E, V, V) one-hot class mask, ebias (V, Cm, V).  Returns (N, T, V*K*Cm)
    with columns (w, k, c), the layout of pre2.  The custom op
    ``dsgcn::bd_agg``.
    """
    if pre2.device.type != "cpu":
        _build.refuse_grad("bd_dyn_graph_agg", pre2, x1t, x2, A, alpha, beta,
                           p1t, p2, ebias)
    return bd_agg_op(pre2, x1t, x2, A, alpha, beta, p1t, p2, edge_sel, ebias,
                     K, Cm, edge_k, edge_num, v_real)


def _k3_plain(pre2, x1t, x2, A, alpha, beta, p1t, p2, edge_sel, ebias, K,
              Cm, edge_k, edge_num, v_real):
    return reference_bd_dyn_graph_agg(
        pre2, x1t, x2, A, alpha, beta, p1t, p2, edge_sel, ebias, K=K, Cm=Cm,
        edge_k=edge_k, edge_num=edge_num, v_real=v_real).contiguous()


def _k3_kernel(pre2, x1t, x2, A, alpha, beta, p1t, p2, edge_sel, ebias, K,
               Cm, edge_k, edge_num, v_real):
    out = _launch("bd_dyn_graph_agg", pre2, x1t, x2, A, alpha, beta, p1t,
                  p2, edge_sel, ebias, K, Cm, edge_k, edge_num, v_real)
    if out.numel():
        bd_dyn_graph_agg.launches += 1
    return out


_AGG_OPERANDS = ("Tensor pre2, Tensor x1t, Tensor x2, Tensor A, "
                 "Tensor alpha, Tensor beta")
bd_agg_op = _build.custom_op(
    "bd_agg", f"({_AGG_OPERANDS}, Tensor? p1t, Tensor? p2, Tensor? edge_sel, "
    "Tensor? ebias, int K, int Cm, int edge_k, int edge_num, int v_real) "
    "-> Tensor", _k3_plain, _k3_kernel, like_first)


def _launch(name, pre2, x1t, x2, A, alpha, beta, p1t, p2, edge_sel, ebias,
            K, Cm, edge_k, E, v_real):
    """Check a K3 or K4 call and launch ``csrc/bd_agg.cu`` on its CUDA
    tensors (K4: no edge subset); returns y2, empty without a launch."""
    _build.check_activation(pre2, name)
    N, T, VKC = pre2.shape
    V, dev = A.shape[-1], pre2.device
    _build.check_limits(name, N, V, E)
    if VKC != V * K * Cm:
        raise ValueError(f"{name}: pre2 width {VKC} != V*K*Cm = {V * K * Cm}")
    op = lambda t, shape, n: _build.graph_operand(t, shape, n, dev)  # noqa: E731
    x1t = op(x1t, (N, K, V, Cm), "x1t")
    x2 = op(x2, (N, K, Cm, V), "x2")
    A = op(A, (K, V, V), "A")
    alpha, beta = op(alpha, (K,), "alpha"), op(beta, (K,), "beta")
    if edge_k >= 0:
        if edge_k >= K:
            raise ValueError(f"{name}: edge_k={edge_k} outside [0, {K})")
        p1t = op(p1t, (N, E, V, Cm), "p1t")
        p2 = op(p2, (N, E, Cm, V), "p2")
        edge_sel = op(edge_sel, (E, V, V), "edge_sel")
        ebias = op(ebias, (V, Cm, V), "ebias")
    else:
        p1t = p2 = edge_sel = ebias = None
    out = torch.empty_like(pre2)
    if out.numel() == 0:
        return out
    CG, rows = agg_plan(N, T, V, K, Cm, pre2.element_size())
    # the edge subset's ctr, built for the whole call ahead of the blocks
    ectr = (torch.empty(N * V * V * Cm, device=dev) if edge_k >= 0
            else None)
    with torch.cuda.device(dev):
        _build.launch(
            "bd_agg", _build.ptr(pre2), _build.ptr(out),
            int(pre2.dtype == torch.bfloat16), _build.ptr(x1t),
            _build.ptr(x2), _build.ptr(A), _build.ptr(alpha),
            _build.ptr(beta), _build.ptr(p1t), _build.ptr(p2),
            _build.ptr(edge_sel), _build.ptr(ebias), _build.ptr(ectr), N, T,
            V, K, Cm, E, edge_k, v_real, CG, rows, _build.stream_of(pre2))
    return out


bd_dyn_graph_agg.launches = 0


def _check_group(name, Cm, g):
    g = g or Cm
    if Cm % g or g % 8:
        raise ValueError(f"{name}: channel group g={g} must divide Cm={Cm} "
                         "and be a multiple of 8")


def reference_bd_dyn_graph_agg_subset(pre2, x1t, x2, A, alpha, beta, *, K,
                                      Cm, g=None, v_real=-1):
    """Plain PyTorch version of K4 from its own inputs: the ada graph from
    each subset's full queries, then K3's function without edge attention
    (the channel groups of g do not change the function)."""
    _check_group("bd_dyn_graph_agg_subset", Cm, g)
    x1t, x2 = x1t.float(), x2.float()
    ctr = torch.tanh(x1t[..., :, :, None] - x2[:, :, None, :, :])
    return _contract(pre2, ctr, subset_ada(x1t, x2, v_real), A, alpha, beta,
                     K, Cm)


def bd_dyn_graph_agg_subset(pre2: torch.Tensor, x1t: torch.Tensor,
                            x2: torch.Tensor, A: torch.Tensor,
                            alpha: torch.Tensor, beta: torch.Tensor, *,
                            K: int, Cm: int, g=None,
                            v_real: int = -1) -> torch.Tensor:
    """y2 = aggregate(pre2, G(x1, x2, A, alpha, beta)) without edge
    attention, K3's contract and layout: pre2 (N, T, V*K*Cm) float32 or
    bfloat16, x1t (N, K, V, Cm), x2 (N, K, Cm, V), A (K, V, V), alpha/beta
    (K,) effective gates.  ``g`` (default Cm) is the TPU kernel's channel
    group; it must divide Cm and be a multiple of 8, and does not change
    the function.  ``v_real`` masks padded sources of the ada softmax,
    which is taken over each subset's full Cm (``bd_agg.py:275-281``).
    The custom op ``dsgcn::bd_agg_subset``."""
    name = "bd_dyn_graph_agg_subset"
    _check_group(name, Cm, g)
    if pre2.device.type != "cpu":
        _build.refuse_grad(name, pre2, x1t, x2, A, alpha, beta)
    return bd_agg_subset_op(pre2, x1t, x2, A, alpha, beta, K, Cm, g or 0,
                            v_real)


def _k4_plain(pre2, x1t, x2, A, alpha, beta, K, Cm, g, v_real):
    return reference_bd_dyn_graph_agg_subset(
        pre2, x1t, x2, A, alpha, beta, K=K, Cm=Cm, g=g or None,
        v_real=v_real).contiguous()


def _k4_kernel(pre2, x1t, x2, A, alpha, beta, K, Cm, g, v_real):
    out = _launch("bd_dyn_graph_agg_subset", pre2, x1t, x2, A, alpha, beta,
                  None, None, None, None, K, Cm, -1, 0, v_real)
    if out.numel():
        bd_dyn_graph_agg_subset.launches += 1
    return out


bd_dyn_graph_agg_subset.launches = 0
bd_agg_subset_op = _build.custom_op(
    "bd_agg_subset", f"({_AGG_OPERANDS}, int K, int Cm, int g, int v_real) "
    "-> Tensor", _k4_plain, _k4_kernel, like_first)
