"""MS-G3D ops: the multi-scale GCN, temporal-window unfolding and the
windowed 3D graph-conv blocks (channels-last ``(N, T, V, C)``).

The port of ``dsgcn_tpu/ops/msg3d.py`` (reference msg3d_utils.py: MLP
:12, MSGCN :31, UnfoldTemporalWindows :152, ST_MSGCN :176, MSG3DBlock
:235, MW_MSG3DBlock :289).  The multi-scale adjacency powers are host
numpy (``graph.k_adjacency`` + ``graph.normalize_digraph``), kept as
non-persistent float32 buffers, as JAX bakes them in as constants; each
unit learns an offset ``PA`` on them.  The k-scale aggregation is one
einsum batched over (N, T), as in JAX; no kernel of the port runs here,
and JAX runs none either.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph import k_adjacency, normalize_digraph
from .common import BatchNorm, PointConv, accum_dtype, cast, dropout


def multi_scale_adjacency(A: np.ndarray, num_scales: int) -> np.ndarray:
    """(num_scales, V, V) stack of the normalized k-hop ring adjacencies
    of ``A``, k = 0 .. num_scales - 1, each with self-loops
    (msg3d_utils.py:42-43), in float32."""
    powers = [k_adjacency(A, k, with_self=True) for k in range(num_scales)]
    return np.stack([normalize_digraph(g) for g in powers]).astype(np.float32)


class _ScaledGraphs(nn.Module):
    """The multi-scale adjacencies ``A_scales`` (a constant) and their
    learned offset ``PA`` (U(-1e-6, 1e-6) at init, JAX's
    ``uniform_eps_init``); ``scales(x)`` contracts them with x's joints,
    (N, T, V, C) -> (N, T, V, K*C), k-major."""

    def __init__(self, A: np.ndarray, num_scales: int):
        super().__init__()
        A_scales = multi_scale_adjacency(A, num_scales)
        self.register_buffer("A_scales", torch.from_numpy(A_scales),
                             persistent=False)
        self.PA = nn.Parameter(torch.empty(A_scales.shape).uniform_(-1e-6,
                                                                    1e-6))

    def scales(self, x: torch.Tensor) -> torch.Tensor:
        n, t, v, c = x.shape
        acc = accum_dtype(x.dtype)
        A = cast(self.A_scales, acc) + cast(self.PA, acc)
        # reference einsum('kvu,nctv->nkctu') (msg3d_utils.py:56)
        y = torch.einsum("kvu,ntvc->ntukc", A, cast(x, acc))
        return cast(y, x.dtype).reshape(n, t, v, -1)


class MLP(nn.Module):
    """1x1 conv -> BN -> ReLU chain (msg3d_utils.py:12-28): ``conv{i}``,
    ``bn{i}``; ``act=False`` drops the ReLUs; dropout (training only, mask
    from ``self.generator``) before each 1x1 when over 1e-3."""

    def __init__(self, in_channels: int, out_channels: Sequence[int],
                 act: bool = True, dropout: float = 0.0):
        super().__init__()
        self.act, self.dropout = act, dropout
        self.depth = len(out_channels)
        for i, c in enumerate(out_channels):
            self.add_module(f"conv{i}", PointConv(in_channels, c))
            self.add_module(f"bn{i}", BatchNorm(c))
            in_channels = c
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            if self.dropout > 1e-3:
                x = dropout(x, self.dropout, self.training, self.generator)
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            if self.act:
                x = F.relu(x)
        return x


class MSGCN(_ScaledGraphs):
    """Multi-scale spatial GCN (msg3d_utils.py:31-60): the ``num_scales``
    adjacency powers of ``A_binary`` with the offset ``PA``, the scales
    concatenated over channels, an ``mlp`` merge."""

    def __init__(self, num_scales: int, in_channels: int, out_channels: int,
                 A_binary: np.ndarray, dropout: float = 0.0):
        super().__init__(A_binary, num_scales)
        self.mlp = MLP(num_scales * in_channels, (out_channels,),
                       dropout=dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.scales(x))


def unfold_temporal_windows(x: torch.Tensor, window_size: int,
                            window_stride: int,
                            window_dilation: int = 1) -> torch.Tensor:
    """(N, T, V, C) -> (N, NW, window_size * V, C): sliding temporal
    windows, zero-padded (msg3d_utils.py:152-173).  The joint axis is
    window-major: joint j of window frame w sits at w * V + j."""
    n, t, v, c = x.shape
    ws, wd = window_size, window_dilation
    pad = (ws + (ws - 1) * (wd - 1) - 1) // 2
    xp = F.pad(x, (0, 0, 0, 0, pad, pad))
    nw = (t + 2 * pad - (wd * (ws - 1) + 1)) // window_stride + 1
    span = 1 + (nw - 1) * window_stride
    xw = torch.stack([xp[:, w * wd:w * wd + span:window_stride]
                      for w in range(ws)], dim=2)      # (N, NW, ws, V, C)
    return xw.reshape(n, nw, ws * v, c)


class STMSGCN(_ScaledGraphs):
    """Spatio-temporal multi-scale GCN over the windowed graph
    (msg3d_utils.py:176-232): the (A + I) graph tiled window x window,
    its ``num_scales`` powers with the offset ``PA``, an ``mlp`` merge, the
    residual (x, or a 1x1 + BN ``residual`` MLP without ReLU where the
    width changes; off by default) and a ReLU."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_binary: np.ndarray, num_scales: int, window_size: int,
                 residual: bool = False, dropout: float = 0.0):
        V = A_binary.shape[0]
        A_large = np.tile(A_binary + np.eye(V, dtype=A_binary.dtype),
                          (window_size, window_size))
        super().__init__(A_large, num_scales)
        self.use_residual = residual
        self.identity = in_channels == out_channels
        if residual and not self.identity:
            self.residual = MLP(in_channels, (out_channels,), act=False)
        self.mlp = MLP(num_scales * in_channels, (out_channels,),
                       dropout=dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = 0.0
        if self.use_residual:
            res = x if self.identity else self.residual(x)
        return F.relu(self.mlp(self.scales(x)) + res)


class MSG3DBlock(nn.Module):
    """Windowed 3D graph-conv block (msg3d_utils.py:235-286): the optional
    ``in1x1`` embedding (``embed_factor`` > 1), the temporal windows,
    ``st_msgcn``, then the window axis collapsed by the Conv3d of kernel
    (1, window, 1) (``out_conv_kernel`` (window, C, O) in JAX's
    orientation, ``out_conv_bias``) and ``out_bn``."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_binary: np.ndarray, num_scales: int, window_size: int,
                 window_stride: int, window_dilation: int = 1,
                 embed_factor: int = 1):
        super().__init__()
        self.window_size, self.window_stride = window_size, window_stride
        self.window_dilation = window_dilation
        self.V = A_binary.shape[0]
        if embed_factor == 1:
            embed_in = embed_out = in_channels
            if in_channels == 3:
                embed_out = out_channels
        else:
            embed_in = embed_out = out_channels // embed_factor
            self.in1x1 = MLP(in_channels, (embed_in,))
        self.st_msgcn = STMSGCN(embed_in, embed_out, A_binary, num_scales,
                                window_size)
        # JAX: variance_scaling(1/3, 'fan_in', 'uniform'), fan_in = w * C
        bound = (window_size * embed_out) ** -0.5
        self.out_conv_kernel = nn.Parameter(torch.empty(
            window_size, embed_out, out_channels).uniform_(-bound, bound))
        self.out_conv_bias = nn.Parameter(torch.zeros(out_channels))
        self.out_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if hasattr(self, "in1x1"):
            x = self.in1x1(x)
        xw = unfold_temporal_windows(x, self.window_size, self.window_stride,
                                     self.window_dilation)
        xw = self.st_msgcn(xw)
        xw = xw.reshape(n, xw.shape[1], self.window_size, self.V, -1)
        # collapse the window axis: Conv3d kernel (1, wsize, 1)
        # (msg3d_utils.py:281)
        y = torch.einsum("ntwvc,wco->ntvo", xw,
                         cast(self.out_conv_kernel, x.dtype))
        return self.out_bn(y + cast(self.out_conv_bias, x.dtype))


class MWMSG3DBlock(nn.Module):
    """The sum of one :class:`MSG3DBlock` per window size ``gcn3d{i}``
    (msg3d_utils.py:289-317)."""

    def __init__(self, in_channels: int, out_channels: int,
                 A_binary: np.ndarray, num_scales: int,
                 window_sizes: Sequence[int] = (3, 5),
                 window_stride: int = 1,
                 window_dilations: Sequence[int] = (1, 1)):
        super().__init__()
        self.num_windows = len(window_sizes)
        for i, (ws, wd) in enumerate(zip(window_sizes, window_dilations)):
            self.add_module(f"gcn3d{i}", MSG3DBlock(
                in_channels, out_channels, A_binary, num_scales, ws,
                window_stride, wd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = 0.0
        for i in range(self.num_windows):
            out = out + getattr(self, f"gcn3d{i}")(x)
        return out
