"""MS-G3D and SGN backbones (port of ``dsgcn_tpu/models/msg3d_sgn.py``;
reference msg3d.py:11-79, sgn.py:10-102).

Neither reaches a Pallas kernel in JAX, and neither launches a kernel of
the port: their graph contractions are einsums and matmuls, their
temporal units ``CTRMSTCN`` (which K7 does not compute) and cuDNN convs.
Submodule names follow the flax scopes.  Input ``(N, M, T, V, C)``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graph import Graph, GraphConfig
from ..ops.common import (BatchNorm, PointConv, TemporalConv, TorchBN,
                          dropout)
from ..ops.msg3d import MSGCN, MWMSG3DBlock
from ..ops.tcn import CTRMSTCN
from .backbones import DataBN


class _NoActInner(CTRMSTCN):
    """MS-G3D's CTR-MSTCN with the trailing activation removed (msg3d.py:38,
    ``self.sgcn1[-1].act = nn.Identity()``; JAX ``_NoActInner``): kernel
    3, dilations (1, 2, 3, 4), stride 1, the branches named as CTRMSTCN's
    (``branch{i}_pre``/``_bn``/``_tcn``, the max-pool branch's ``_bn2``,
    the 1x1 branch's ``_conv``/``_bn``); the input is added only when the
    widths are equal, with no residual unit, and no ReLU follows."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, kernel_size=3, stride=1,
                         dilations=(1, 2, 3, 4), residual=False)
        self.add_input = in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.branch_outputs(x)
        return out + x if self.add_input else out


class MSG3D(nn.Module):
    """MS-G3D (reference msg3d.py:30-76): three stages, each the sum of a
    windowed G3D pathway (``gcn3d{i}``, windows 3 and 5) and a multi-scale
    GCN pathway (``sgcn{i}_gcn`` -> ``sgcn{i}_tcn1`` (CTRMSTCN at the
    stage's stride) -> ``sgcn{i}_tcn2`` (:class:`_NoActInner`)), a ReLU,
    then a CTRMSTCN ``tcn{i}``; widths base, 2 base, 4 base, strides 1, 2,
    2; ``data_bn`` over M*V*C.  Output (N, M, T/4, V, 4 base)."""

    def __init__(self, graph_cfg: GraphConfig = GraphConfig(
                     layout="nturgb+d", mode="binary_adj"),
                 in_channels: int = 3, base_channels: int = 96,
                 num_gcn_scales: int = 13, num_g3d_scales: int = 6,
                 num_person: int = 2, tcn_dropout: float = 0.0):
        super().__init__()
        graph = Graph.from_config(graph_cfg)
        A_bin = graph.A[0].astype("float32")       # 2D binary adjacency
        self.data_bn = DataBN(num_person * graph.num_node * in_channels,
                              "MVC")
        c1 = base_channels
        c2, c3 = c1 * 2, c1 * 4
        stages = [(in_channels, c1, c1, 1), (c1, c1, c2, 2),
                  (c2, c2, c3, 2)]
        self.num_stages = len(stages)
        for i, (cin, cmid, cout, stride) in enumerate(stages, start=1):
            self.add_module(f"gcn3d{i}", MWMSG3DBlock(
                cin, cout, A_bin, num_g3d_scales, window_stride=stride))
            self.add_module(f"sgcn{i}_gcn", MSGCN(num_gcn_scales, cin, cmid,
                                                  A_bin))
            self.add_module(f"sgcn{i}_tcn1", CTRMSTCN(cmid, cout,
                                                      stride=stride))
            self.add_module(f"sgcn{i}_tcn2", _NoActInner(cout, cout))
            self.add_module(f"tcn{i}", CTRMSTCN(cout, cout,
                                                tcn_dropout=tcn_dropout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m, t, v, c = x.shape
        x = self.data_bn(x).reshape(n * m, t, v, c)
        for i in range(1, self.num_stages + 1):
            g3d = getattr(self, f"gcn3d{i}")(x)
            s = getattr(self, f"sgcn{i}_gcn")(x)
            s = getattr(self, f"sgcn{i}_tcn1")(s)
            s = getattr(self, f"sgcn{i}_tcn2")(s)
            x = getattr(self, f"tcn{i}")(F.relu(s + g3d))
        return x.reshape((n, m) + x.shape[1:])


class SGN(nn.Module):
    """Semantics-Guided Network (reference sgn.py:10-102): joint and motion
    embeddings (each through a BatchNorm1d(C*V), ``joint_bn`` and
    ``motion_bn``, :class:`TorchBN` over the (c, v) features), a joint
    code (one-hot of the joint) and a frame code (one-hot of the frame)
    embedded, a per-frame graph ``softmax(a1 a2^T)`` from two 1x1 embeds,
    three graph units ``gcn{1,2,3}`` (``A @ x`` -> 1x1 without bias, plus a
    1x1 ``_res``, BN, ReLU), the frame embedding added, an adaptive max-pool
    to (20, 1) (:func:`_adaptive_max_pool`), a k = 3 temporal conv + BN +
    ReLU, dropout 0.2 (training only, mask from ``self.generator``), a 1x1
    + BN + ReLU.  The clip length is fixed at ``T`` (30): another is
    refused, as JAX asserts.  ``motion`` is the frame difference with a
    zero frame appended (its last frame is -x[T-1], JAX's ``jnp.diff``
    with ``append``).  Output (N, M, 20, 1, 8 base)."""

    def __init__(self, in_channels: int = 3, base_channels: int = 64,
                 num_joints: int = 25, T: int = 30, bias: bool = True):
        super().__init__()
        self.T = T
        b, c, v = base_channels, in_channels, num_joints
        self.joint_bn = TorchBN(c * v)
        self.motion_bn = TorchBN(c * v)

        def conv(name, cin, cout, use_bias=bias):
            self.add_module(f"{name}_conv", PointConv(cin, cout,
                                                      bias=use_bias))
        for name, cin, mid, out in (("joint_embed", c, b, b),
                                    ("motion_embed", c, b, b),
                                    ("t_embed", T, b, 4 * b),
                                    ("s_embed", v, b, b)):
            conv(f"{name}0", cin, mid)
            conv(f"{name}1", mid, out)
        conv("compute_A1", 2 * b, 4 * b)
        conv("compute_A2", 2 * b, 4 * b)
        for name, cin, cout in (("gcn1", 2 * b, 2 * b),
                                ("gcn2", 2 * b, 4 * b),
                                ("gcn3", 4 * b, 4 * b)):
            conv(name, cin, cout, use_bias=False)
            self.add_module(f"{name}_res", PointConv(cin, cout, bias=bias))
            self.add_module(f"{name}_bn", BatchNorm(cout))
        self.tcn_conv1 = TemporalConv(4 * b, 4 * b, kernel_size=3)
        self.tcn_bn1 = BatchNorm(4 * b)
        self.tcn_conv2 = PointConv(4 * b, 8 * b, bias=bias)
        self.tcn_bn2 = BatchNorm(8 * b)
        self.generator: Optional[torch.Generator] = None

    def _embed(self, x: torch.Tensor, name: str) -> torch.Tensor:
        y = F.relu(getattr(self, f"{name}0_conv")(x))
        return F.relu(getattr(self, f"{name}1_conv")(y))

    @staticmethod
    def _cv_bn(bn: TorchBN, x: torch.Tensor) -> torch.Tensor:
        """BatchNorm1d(C*V) over (NM, C*V, T): the features in (c, v)
        order (sgn.py:79-80)."""
        nm, t, v, c = x.shape
        y = bn(x.transpose(2, 3).reshape(nm, t, c * v))
        return y.reshape(nm, t, c, v).transpose(2, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m, t, v, c = x.shape
        if t != self.T:
            raise ValueError(f"SGN expects T={self.T} input frames, got {t}")
        nm = n * m
        x = x.reshape(nm, t, v, c)
        motion = torch.diff(x, dim=1, append=x.new_zeros(nm, 1, v, c))
        joint = self._embed(self._cv_bn(self.joint_bn, x), "joint_embed")
        motion = self._embed(self._cv_bn(self.motion_bn, motion),
                             "motion_embed")
        # the frame and joint codes are one-hots: their embeddings are
        # computed once and broadcast over the clips (and frames/joints)
        eye_t = torch.eye(t, dtype=x.dtype, device=x.device)
        eye_v = torch.eye(v, dtype=x.dtype, device=x.device)
        t_embed = self._embed(eye_t[None, :, None], "t_embed")  # (1,t,1,4b)
        s_embed = self._embed(eye_v[None, None], "s_embed")     # (1,1,v,b)
        h = torch.cat([joint + motion,
                       s_embed.expand(nm, t, v, s_embed.shape[-1])], dim=-1)
        # the per-frame graph (sgn.py:66-71)
        a1 = F.relu(self.compute_A1_conv(h))
        a2 = F.relu(self.compute_A2_conv(h))
        A = torch.softmax(a1 @ a2.transpose(-1, -2), dim=-1)
        for name in ("gcn1", "gcn2", "gcn3"):
            # unit_sgn (gcn.py:932-944)
            y = getattr(self, f"{name}_conv")(A @ h)
            y = y + getattr(self, f"{name}_res")(h)
            h = F.relu(getattr(self, f"{name}_bn")(y))
        h = _adaptive_max_pool(h + t_embed, out_t=20)
        h = F.relu(self.tcn_bn1(self.tcn_conv1(h)))
        h = dropout(h, 0.2, self.training, self.generator)
        h = F.relu(self.tcn_bn2(self.tcn_conv2(h)))
        return h.reshape((n, m) + h.shape[1:])


def _adaptive_max_pool(x: torch.Tensor, out_t: int) -> torch.Tensor:
    """torch ``AdaptiveMaxPool2d((out_t, 1))`` on channels-last (N, T, V,
    C): bin i spans frames [floor(i T / out_t), ceil((i + 1) T / out_t)),
    the joints are pooled entirely (JAX ``_adaptive_max_pool``, which
    slices the bins one by one; ``F.adaptive_max_pool2d`` takes the same
    bins)."""
    y = F.adaptive_max_pool2d(x.permute(0, 3, 1, 2), (out_t, 1))
    return y.permute(0, 2, 3, 1)
