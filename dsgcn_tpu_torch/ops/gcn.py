"""Spatial graph convolution of DS-GCN (channels-last ``(N, T, V, C)``).

The port of ``dsgcn_tpu/ops/gcn.py:DGPHGCN1``, train and eval, with the
helpers it uses.  Two aggregation paths, chosen as in the JAX module:

* ``use_pallas=True`` (``build_backbone``'s default): the dynamic-graph
  kernels.  Training always runs K1 and its backward K2 as one autograd
  Function (``ops/kernels/dyn_graph.py``), as the JAX module does
  (gcn.py:1142, :1192).  Eval takes ``eval_kernel`` 'bd' (K3,
  ``ops/kernels/bd_agg.py``) or 'fused' (K1), 'auto' picking 'bd' when
  V*K*mid <= 2400 as the JAX package does.  On CUDA tensors these launch
  the hand-written kernels, on CPU tensors their plain versions.
* ``use_pallas=False``: the dense path of the JAX module (gcn.py:1206-1259),
  which materializes the (N, K, mid, V, V) graph and contracts it with an
  einsum; it trains through autograd.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, PointConv
from .kernels.bd_agg import bd_dyn_graph_agg
from .kernels.dyn_graph import edge_onehot, fused_dyn_graph_agg

ACTS = {
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    # softmax over the source-joint (row) axis of the (..., v, w) graph
    "softmax": lambda x: torch.softmax(x, dim=-2),
}


def _type_gather(x: torch.Tensor, node_type: torch.Tensor,
                 type_axis: int) -> torch.Tensor:
    """out[..., v] = x[..., node_type[v], ..., v]: per-joint gather on the
    type axis (the reference's ``torch.diagonal`` trick, gcn.py:729-730).
    ``x`` has a trailing joint axis V; the result drops the type axis."""
    x = torch.movedim(x, type_axis, -2)                     # (..., P, V)
    idx = node_type.expand(x.shape[:-2] + (1, x.shape[-1]))
    return torch.gather(x, -2, idx).squeeze(-2)


def _edge_class_select(x: torch.Tensor,
                       edge_type: torch.Tensor) -> torch.Tensor:
    """out[..., u, w] = x[..., class(u, w), u, w] for per-class maps ``x``
    (..., E, V, V) and the (V, V) class matrix (gcn.py:2281-2287)."""
    idx = edge_type.expand(x.shape[:-3] + edge_type.shape)[..., None, :, :]
    return torch.gather(x, -3, idx).squeeze(-3)


def _gate_vec(gates: torch.Tensor, K: int, sem: int, norm: int,
              subset_wise: bool) -> torch.Tensor:
    """Effective per-subset (K,) gate vector, incl. the repeat_interleave
    grouping for the 3-gate (sub_att=False) case (reference gcn.py:2302-2309)."""
    if not subset_wise:
        return gates[0].expand(K)
    if K == gates.shape[0]:
        return gates
    rep = math.ceil(K / 3)
    return torch.repeat_interleave(gates, rep)[2 * sem - norm:]


def _gate(gates: torch.Tensor, K: int, sem: int, norm: int,
          subset_wise: bool, trailing: int) -> torch.Tensor:
    """The gates broadcast over a (N, K, *trailing dims) graph tensor."""
    if not subset_wise:
        return gates[0]
    return _gate_vec(gates, K, sem, norm, subset_wise).reshape(
        (1, K) + (1,) * trailing)


def _dispatch_contract(pre_x: torch.Tensor, G: torch.Tensor, ctr,
                       ada) -> torch.Tensor:
    """The reference einsum dispatch on graph dims (gcn.py:1560-1580) for
    T-pooled graphs.  pre_x: (N, T, V, K, C); G: (K, V, V) when neither
    dynamic graph is on, else (N, K, Cq, V, V) with Cq in {1, C}.
    Returns (N, T, W, K, C)."""
    if ctr is None and ada is None:
        return torch.einsum("ntvkc,kvw->ntwkc", pre_x, G.to(pre_x.dtype))
    if G.shape[2] == 1:
        return torch.einsum("ntvkc,nkvw->ntwkc", pre_x,
                            G[:, :, 0].to(pre_x.dtype))
    return torch.einsum("ntvkc,nkcvw->ntwkc", pre_x, G.to(pre_x.dtype))


class DGPHGCN1(nn.Module):
    """The DS-GCN dynamic semantic spatial graph conv (reference dgphgcn1,
    gcn.py:2074-2365).

    Subset decomposition into semantic/normal groups, per-node-type queries
    and per-edge-class attention on the diff graph.  Reproduces the
    reference quirks the JAX module keeps: x2 of the semantic subset is the
    ``conv1_se`` query x1 (gcn.py:2253-2254, 2272), and the edge-attention
    diff uses the subset slice [norm-sem : norm] (gcn.py:2279).  Submodule
    names follow the JAX module's flax scopes.  The JAX module's
    ``ada_attention`` and ``target_specific`` options and per-frame graphs
    (``ctr``/``ada`` 'NA') are not ported yet.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 A_init: np.ndarray, edge_type: np.ndarray,
                 node_type: np.ndarray, ratio=0.125, decompose=False,
                 ctr="T", ada="T", node_attention=False, edge_attention=False,
                 sub_att=True, stage=True, num_types=5, edge_num=15,
                 subset_wise=True, ada_act="softmax", ctr_act="tanh",
                 use_pallas=False, eval_kernel="auto"):
        super().__init__()
        if ctr not in (None, "T") or ada not in (None, "T"):
            raise NotImplementedError(
                f"DGPHGCN1 ctr={ctr!r}/ada={ada!r}: only T-pooled graphs "
                "('T' or None) are ported")
        if eval_kernel not in ("auto", "bd", "fused", "mega"):
            raise ValueError(f"unknown eval_kernel {eval_kernel!r}")
        if not stage:   # gcn.py:2122-2127
            node_attention = edge_attention = decompose = False
            subset_wise = False
        K = A_init.shape[0]
        self.in_channels, self.out_channels = in_channels, out_channels
        self.K = K
        self.mid = int((ratio if ratio is not None else 1.0 / K)
                       * out_channels)
        self.P, self.E = num_types, edge_num
        self.sem = math.ceil(K / 3) if decompose else 0
        self.norm = K - self.sem
        self.decompose, self.subset_wise = decompose, subset_wise
        self.node_attention, self.edge_attention = node_attention, \
            edge_attention
        self.ctr, self.ada = ctr, ada
        self.ctr_act, self.ada_act = ctr_act, ada_act
        self.use_pallas, self.eval_kernel = use_pallas, eval_kernel
        mid, sem, norm = self.mid, self.sem, self.norm

        if in_channels != out_channels:
            self.down_conv = PointConv(in_channels, out_channels)
            self.down_bn = BatchNorm(out_channels)
        # a copy: blocks are built from one numpy graph and must not share it
        self.A = nn.Parameter(torch.tensor(np.asarray(A_init),
                                           dtype=torch.float32))
        n_gates = K if sub_att else 3
        self.alpha = nn.Parameter(torch.zeros(n_gates))
        self.beta = nn.Parameter(torch.zeros(n_gates))
        self.pre_conv = PointConv(in_channels, mid * K)
        self.pre_bn = BatchNorm(mid * K)
        if ctr is not None or ada is not None:
            self.conv1 = PointConv(in_channels, norm * mid)
            self.conv2 = PointConv(in_channels, norm * mid)
            if decompose:
                self.conv1_se = PointConv(
                    in_channels, sem * mid * (num_types if node_attention
                                              else 1))
                if ctr is not None and edge_attention:
                    self.edge_linears = PointConv(sem * mid,
                                                  edge_num * sem * mid)
        self.post_conv = PointConv(K * mid, out_channels)
        self.bn = BatchNorm(out_channels)
        # static graph structure: buffers that move with the module but are
        # not weights (not in the state_dict)
        self.register_buffer("node_type", torch.as_tensor(
            np.asarray(node_type), dtype=torch.long), persistent=False)
        self.register_buffer("edge_type", torch.as_tensor(
            np.asarray(edge_type), dtype=torch.long), persistent=False)
        self.register_buffer("edge_sel", torch.as_tensor(
            edge_onehot(np.asarray(edge_type), edge_num)), persistent=False)

    def _queries(self, x: torch.Tensor):
        """T-pooled queries x1, x2: (N, K, mid, V)."""
        n, _, v, _ = x.shape
        mid, sem, norm = self.mid, self.sem, self.norm
        tmp = x.mean(dim=1)                                     # (n, v, c)
        x1 = self.conv1(tmp).reshape(n, v, norm, mid).permute(0, 2, 3, 1)
        x2 = self.conv2(tmp).reshape(n, v, norm, mid).permute(0, 2, 3, 1)
        if not self.decompose:
            return x1, x2
        s = self.conv1_se(tmp)
        if self.node_attention:
            s = s.reshape(n, v, sem, mid, self.P).permute(0, 2, 3, 4, 1)
            s = _type_gather(s, self.node_type, type_axis=3)   # (n,sem,mid,v)
        else:
            s = s.reshape(n, v, sem, mid).permute(0, 2, 3, 1)
        # the reference concatenates x1_sem into x2 too (gcn.py:2272)
        return torch.cat([x1, s], dim=1), torch.cat([x2, s], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        K, mid, sem = self.K, self.mid, self.sem
        n, t, v, _ = x.shape
        res = (self.down_bn(self.down_conv(x))
               if self.in_channels != self.out_channels else x)
        pre_x = F.relu(self.pre_bn(self.pre_conv(x)))          # (n,t,v,K*mid)
        x1 = x2 = None
        if self.ctr is not None or self.ada is not None:
            x1, x2 = self._queries(x)

        active_edge = self.edge_attention and self.decompose
        if (self.use_pallas and self.ctr == "T" and self.ada == "T"
                and self.ctr_act == "tanh" and self.ada_act == "softmax"
                and (not active_edge or sem == 1)):
            y = self._kernel_aggregate(pre_x, x1, x2, active_edge)
        else:
            y = self._dense_aggregate(pre_x.reshape(n, t, v, K, mid), x1, x2)
        y = self.bn(self.post_conv(y.reshape(n, t, v, K * mid)))
        return F.relu(y + res)

    def _kernel_aggregate(self, pre_x, x1, x2, active_edge):
        """The dynamic-graph kernels (JAX gcn.py:1119-1196): K1+K2 in
        training, ``eval_kernel`` in eval."""
        K, mid, sem, norm, E = self.K, self.mid, self.sem, self.norm, self.E
        n, t, v, _ = pre_x.shape
        a_vec = _gate_vec(self.alpha, K, sem, norm, self.subset_wise)
        b_vec = _gate_vec(self.beta, K, sem, norm, self.subset_wise)
        ek = "fused" if self.training else self.eval_kernel
        if ek == "auto":
            ek = "bd" if v * K * mid <= 2400 else "fused"
        if ek == "mega":
            raise NotImplementedError(
                "eval_kernel='mega' needs the whole-block kernel K6 "
                "(dsgcn_tpu/ops/pallas/dggcn_block.py:"
                "fused_dggcn_block_eval), which is not ported yet")
        edge_k = norm - sem if active_edge else -1
        if active_edge:
            ew, eb = self.edge_linears.weight, self.edge_linears.bias
        if ek == "bd":
            kw = {}
            if active_edge:
                # class projections P = W_e^T q of the edge subset's queries
                # and the transposed bias field, outside the kernel
                w = ew.to(x1.dtype)
                p1 = torch.einsum("ncv,fc->nfv", x1[:, edge_k], w).reshape(
                    n, E, mid, v)
                p2 = torch.einsum("ncv,fc->nfv", x2[:, edge_k], w).reshape(
                    n, E, mid, v)
                ebias = torch.einsum("evw,ec->vcw", self.edge_sel,
                                     eb.float().reshape(E, mid))
                kw = dict(p1t=p1.transpose(-1, -2), p2=p2,
                          edge_sel=self.edge_sel, ebias=ebias)
            return bd_dyn_graph_agg(
                pre_x.reshape(n, t, v * K * mid), x1.transpose(-1, -2), x2,
                self.A, a_vec, b_vec, K=K, Cm=mid, edge_k=edge_k,
                edge_num=E, **kw)
        if active_edge:
            return fused_dyn_graph_agg(pre_x, x1, x2, self.A, a_vec, b_vec,
                                       ew.t(), eb, self.edge_sel, K, mid,
                                       edge_k, E)
        return fused_dyn_graph_agg(pre_x, x1, x2, self.A, a_vec, b_vec,
                                   K=K, Cm=mid, edge_num=E)

    def _dense_aggregate(self, pre_x, x1, x2):
        """Materialized graph + einsum (JAX gcn.py:1206-1259)."""
        K, mid, sem, norm, E = self.K, self.mid, self.sem, self.norm, self.E
        n, _, V = pre_x.shape[:3]
        dt = pre_x.dtype
        G = self.A.to(dt)                                       # (K, V, V)
        if self.ctr is not None or self.ada is not None:
            G = G[None, :, None]                                # (1,K,1,V,V)
        if self.ctr is not None:
            def diff(lo, hi):
                return x1[:, lo:hi, :, :, None] - x2[:, lo:hi, :, None, :]
            if self.decompose:
                if self.edge_attention:
                    # slice [norm-sem : norm] per reference gcn.py:2279
                    d2 = diff(norm - sem, norm).reshape(n, sem * mid, V, V)
                    es = self.edge_linears(torch.movedim(d2, 1, -1))
                    es = es.reshape(n, V, V, sem, E, mid).permute(
                        0, 3, 5, 4, 1, 2)                     # (n,sem,mid,E,V,V)
                    g_sem = _edge_class_select(es, self.edge_type)
                else:
                    g_sem = diff(sem, norm)
                g = torch.cat([diff(0, norm - sem), g_sem, diff(norm, K)],
                              dim=1)
            else:
                g = diff(0, K)
            g = ACTS[self.ctr_act](g)                           # (n,K,mid,V,V)
            G = g * _gate(self.alpha, K, sem, norm, self.subset_wise,
                          3).to(dt) + G
        if self.ada is not None:
            g = torch.einsum("nkcv,nkcw->nkvw", x1, x2)[:, :, None]
            g = ACTS[self.ada_act](g)                           # (n,K,1,V,V)
            G = g * _gate(self.beta, K, sem, norm, self.subset_wise,
                          3).to(dt) + G
        return _dispatch_contract(pre_x, G, self.ctr, self.ada)
