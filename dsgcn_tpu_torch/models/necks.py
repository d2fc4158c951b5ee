"""Necks: feature readouts between backbone and head (port of
``dsgcn_tpu/models/necks.py``).

Reference: pyskl/models/necks/Simple_neck.py:15-107 (SimpleNeck and its
node_precost body-part loss), greadout.py:15-156 (ReadoutNeck, the
prototype-assignment readout), gread.py:45-158 (the GlobalAttention and
Set2Set segment readouts), pre_train.py:17-259 (PretrainNeck),
Causal_neck.py:16-130 (CausalNeck) and causalnn.py:8-96 (cMLP).

A readout neck turns the backbone's (N, M, T, V, C) feature into (N, C):
each (sample, frame, joint) row, person-meaned, is assigned to its nearest
prototype by cosine distance, and every (sample, prototype) segment is
pooled.  The segment reductions run over a flat segment index with
``index_add_`` (sum) and ``scatter_reduce`` (max); an empty segment's max
is 0, as JAX's ``segment_max`` (-inf) made finite.  On the card the sums
add in no fixed order.  No kernel of the port runs here.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.common import accum_dtype, cast
from ..ops.common import dropout as _dropout
from .heads import joint_type_losses


def segment_sum(x: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: the rows of ``x`` added per segment."""
    out = x.new_zeros((num_segments,) + x.shape[1:])
    return out.index_add(0, seg, x)


def segment_max(x: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` with an empty segment's -inf (and any other
    non-finite max) set to 0, as JAX's necks use it."""
    idx = seg.view((-1,) + (1,) * (x.dim() - 1)).expand_as(x)
    out = x.new_full((num_segments,) + x.shape[1:], -math.inf)
    out = out.scatter_reduce(0, idx, x, "amax", include_self=False)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def segment_softmax(score: torch.Tensor, seg: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of ``score`` within each segment (JAX
    ``necks.py:_segment_softmax``): shifted by the segment's max, the sum
    floored by 1e-16."""
    smax = segment_max(score, seg, num_segments)
    e = torch.exp(score - smax[seg])
    denom = segment_sum(e, seg, num_segments)
    return e / (denom[seg] + 1e-16)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """(N, M, T, V, C) -> (N, C): mean over (T, V), then over persons."""
    return x.mean(dim=(2, 3)).mean(dim=1)


def _rows(x: torch.Tensor):
    """Person-meaned (n, t, v)-ordered rows (N T V, C), each row's sample
    index, and N."""
    n, m, t, v, c = x.shape
    rows = x.mean(dim=1).reshape(n * t * v, c)
    batch = torch.arange(n, device=x.device).repeat_interleave(t * v)
    return rows, batch, n


def _soft_min(d: torch.Tensor, gamma: float) -> torch.Tensor:
    """Each row's min distance (gamma = 0) or its soft-min
    -gamma log(sum exp(-d / gamma) + 1e-12)."""
    if gamma == 0:
        return d.min(dim=1).values
    return -gamma * torch.log(torch.exp(-d / gamma).sum(dim=1) + 1e-12)


def _lstm_init(c: int) -> nn.Parameter:
    return nn.Parameter(torch.empty(c).uniform_(-c ** -0.5, c ** -0.5))


class Set2Set(nn.Module):
    """Set2Set segment readout (reference necks/gread.py:99-158, "Order
    Matters"): ``processing_steps`` rounds of an LSTM query, a per-segment
    softmax attention and its readout; the output ``[q, r]`` has twice the
    input's channels.  The cell is torch ``nn.LSTM(2C, C, 1)``'s: gates
    (i, f, g, o), two biases, U(+-1/sqrt(C)) init; the raw leaves keep
    JAX's names ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh``."""

    def __init__(self, in_channels: int, processing_steps: int = 2):
        super().__init__()
        c = self.in_channels = in_channels
        self.processing_steps = processing_steps
        bound = c ** -0.5
        self.w_ih = nn.Parameter(torch.empty(4 * c, 2 * c).uniform_(-bound,
                                                                   bound))
        self.w_hh = nn.Parameter(torch.empty(4 * c, c).uniform_(-bound, bound))
        self.b_ih = _lstm_init(4 * c)
        self.b_hh = _lstm_init(4 * c)

    def forward(self, x: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
        c, dt = self.in_channels, x.dtype
        w_ih, w_hh = cast(self.w_ih, dt), cast(self.w_hh, dt)
        b = cast(self.b_ih, dt) + cast(self.b_hh, dt)
        h = x.new_zeros(num_segments, c)
        cell = x.new_zeros(num_segments, c)
        q_star = x.new_zeros(num_segments, 2 * c)
        for _ in range(self.processing_steps):
            gates = q_star @ w_ih.T + h @ w_hh.T + b
            gi, gf, gg, go = gates.chunk(4, dim=1)
            cell = torch.sigmoid(gf) * cell \
                + torch.sigmoid(gi) * torch.tanh(gg)
            h = torch.sigmoid(go) * torch.tanh(cell)
            e = (x * h[seg]).sum(dim=1)
            a = segment_softmax(e, seg, num_segments)
            r = segment_sum(a[:, None] * x, seg, num_segments)
            q_star = torch.cat([h, r], dim=1)
        return q_star


READ_OPS = ("sum", "mean", "max", "attention", "set2set")


class _SegmentReadout(nn.Module):
    """The ``read_op`` pooling of a (sample, prototype) segment: sum,
    mean (the count clamped at 1), max (0 where empty), a gated
    ``attention`` (``gate``, a 1-output linear map, softmaxed per
    segment) or ``set2set`` (twice the channels)."""

    def _init_readout(self, in_channels: int, read_op: str) -> None:
        if read_op not in READ_OPS:
            raise ValueError(f"read_op {read_op!r} (one of {READ_OPS})")
        self.read_op = read_op
        if read_op == "attention":
            self.gate = nn.Linear(in_channels, 1)
        elif read_op == "set2set":
            self.set2set = Set2Set(in_channels)

    def _gread(self, x: torch.Tensor, seg: torch.Tensor,
               num_segments: int) -> torch.Tensor:
        if self.read_op == "sum":
            return segment_sum(x, seg, num_segments)
        if self.read_op == "mean":
            s = segment_sum(x, seg, num_segments)
            cnt = segment_sum(torch.ones_like(x[:, 0]), seg, num_segments)
            return s / torch.clamp(cnt, min=1.0)[:, None]
        if self.read_op == "max":
            return segment_max(x, seg, num_segments)
        if self.read_op == "attention":
            score = F.linear(x, cast(self.gate.weight, x.dtype),
                             cast(self.gate.bias, x.dtype))[:, 0]
            w = segment_softmax(score, seg, num_segments)
            return segment_sum(x * w[:, None], seg, num_segments)
        return self.set2set(x, seg, num_segments)


class SimpleNeck(nn.Module):
    """Global average pooling (GCN mode) with dropout (training only, mask
    from ``self.generator``; Simple_neck.py:15-92).

    ``node_precost`` raises as JAX's does: JAX's ``SimpleNeck`` builds its
    ``fc_node`` Dense inside a method that is not ``@compact``, so flax
    refuses it (``AssignSubModuleError``) and no JAX tree holds
    ``fc_node``.  The port has no such layer either, so a JAX SimpleNeck's
    (empty) tree loads strictly."""

    def __init__(self, in_channels: int, dropout: float = 0.5,
                 num_types: int = 5):
        super().__init__()
        self.dropout = dropout
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dropout(_pool(x), self.dropout, self.training,
                        self.generator)

    def node_precost(self, x: torch.Tensor,
                     node_type: Sequence[int]) -> torch.Tensor:
        raise NotImplementedError(
            "SimpleNeck.node_precost: JAX's defines its fc_node Dense "
            "outside @compact, which flax refuses (AssignSubModuleError), "
            "so no SimpleNeck tree holds fc_node")


class SemanticNeck(nn.Module):
    """Person-weighted pooling (Simple_neck.py:110-190): GCN mode pools
    (T, V), then averages the persons weighted by ``index`` (N, M);
    ``index=None`` weighs each person by the sum of its feature (what the
    reference's dead branch at recognizergcn.py:34 would pass).  A 2-D
    input passes through; other modes pool every axis but the first and
    the last.  ``dropout`` is stored and never applied (the reference's,
    and JAX's, forward ignores it)."""

    def __init__(self, in_channels: int, dropout: float = 0.5,
                 mode: str = "GCN"):
        super().__init__()
        self.dropout, self.mode = dropout, mode

    def forward(self, x: torch.Tensor,
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x.dim() == 2:
            return x
        if self.mode == "GCN":
            if index is None:
                index = x.sum(dim=(2, 3, 4))
            pooled = x.mean(dim=(2, 3))
            return (pooled * index[..., None]).sum(dim=1) \
                / index.sum(dim=1, keepdim=True)
        return x.mean(dim=tuple(range(1, x.dim() - 1)))


class ReadoutNeck(_SegmentReadout):
    """Prototype-assignment readout (reference necks/greadout.py:15-156;
    JAX ``necks.py:ReadoutNeck``): each person-meaned (sample, frame,
    joint) row goes to its nearest of ``num_position`` prototypes
    (``protos``, (P, C)) by cosine distance (``argmin`` takes the first
    minimum), each (sample, prototype) segment is pooled with
    ``read_op``, and the positions are averaged per sample.
    ``get_aligncost``: the (soft-)min distance of each row, summed per
    (sample, prototype) and divided by that cell's occupancy (+1e-12),
    averaged over the N x P cells (greadout.py:122-148).  ``dropout`` is
    stored and never applied, as in the reference."""

    def __init__(self, in_channels: int, num_position: int = 25,
                 read_op: str = "mean", gamma: float = 0.1,
                 dropout: float = 0.5):
        super().__init__()
        self.num_position, self.gamma, self.dropout = (num_position, gamma,
                                                       dropout)
        self.protos = nn.Parameter(torch.empty(num_position, in_channels))
        nn.init.xavier_normal_(self.protos)
        self._init_readout(in_channels, read_op)

    def distance(self, rows: torch.Tensor) -> torch.Tensor:
        """1 - cosine similarity of each row to every prototype, each norm
        clamped at 1e-8 (torch.cosine_similarity's rule), in
        ``accum_dtype``."""
        r = cast(rows, accum_dtype(rows.dtype))
        p = cast(self.protos, r.dtype)
        rn = r / torch.clamp(torch.linalg.vector_norm(r, dim=1, keepdim=True),
                             min=1e-8)
        pn = p / torch.clamp(torch.linalg.vector_norm(p, dim=1, keepdim=True),
                             min=1e-8)
        return 1.0 - rn @ pn.T

    def assign(self, x: torch.Tensor) -> torch.Tensor:
        """Each row's prototype (N T V,), rows in (n, t, v) order."""
        return torch.argmin(self.distance(_rows(x)[0]), dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows, batch, n = _rows(x)
        seg = self.num_position * batch \
            + torch.argmin(self.distance(rows), dim=1)
        pooled = self._gread(rows, seg, self.num_position * n)
        return pooled.reshape(n, self.num_position, -1).mean(dim=1)

    def get_aligncost(self, x: torch.Tensor) -> torch.Tensor:
        rows, batch, n = _rows(x)
        d = self.distance(rows)
        onehot = F.one_hot(torch.argmin(d, dim=1),
                           self.num_position).to(d.dtype)
        counts = segment_sum(onehot, batch, n)
        d_loss = segment_sum(_soft_min(d, self.gamma)[:, None] * onehot,
                             batch, n)
        return torch.mean(d_loss / (counts + 1e-12))


class CMLP(nn.Module):
    """Neural-GC cMLP (reference necks/causalnn.py:8-96; JAX
    ``necks.py:CMLP``): one small causal MLP per joint.  The first layer
    of all V is one ``conv1d`` with weight ``l0_w`` (V, h0, V, lag) read
    as (V h0, V, lag), torch's (out, in, k) layout as it stands, and bias
    ``l0_b`` (V, h0); each later layer ``l{i}_w`` (V, out, in) is a
    per-joint product ``bvct,voc->bvot`` plus ``l{i}_b`` (V, out), after a
    ReLU; the last has one output.  The raw leaves keep JAX's names and
    orientation, with its U(+-1/sqrt(fan_in)) draws (``init_``)."""

    def __init__(self, num_series: int = 25, lag: int = 9,
                 hidden: Sequence[int] = (100,)):
        super().__init__()
        v = self.num_series = num_series
        self.lag, self.hidden = lag, tuple(hidden)
        h0 = self.hidden[0]
        self.l0_w = nn.Parameter(torch.empty(v, h0, v, lag))
        self.l0_b = nn.Parameter(torch.empty(v, h0))
        self.num_layers = len(self.hidden) + 1       # the last has 1 output
        prev = h0
        for li, ch in enumerate(self.hidden[1:] + (1,)):
            setattr(self, f"l{li + 1}_w", nn.Parameter(torch.empty(v, ch,
                                                                   prev)))
            setattr(self, f"l{li + 1}_b", nn.Parameter(torch.empty(v, ch)))
            prev = ch
        self.init_(None)

    @torch.no_grad()
    def init_(self, generator: Optional[torch.Generator]) -> None:
        """JAX's ``torch_default_kernel``/``_bias`` draws: a kernel
        U(+-1/sqrt(fan_in)) with fan_in = shape[-2] * prod(shape[:-2])
        (``ops/common.py:_fan_in_out``; V V h0 for ``l0_w``, V out for the
        others), ``l0_b`` U(+-1/sqrt(V lag)), ``l{i}_b`` U(+-1/sqrt(in))."""
        v = self.num_series
        for li in range(self.num_layers):
            w, b = getattr(self, f"l{li}_w"), getattr(self, f"l{li}_b")
            fan = w.shape[-2] * math.prod(w.shape[:-2])
            w.uniform_(-fan ** -0.5, fan ** -0.5, generator=generator)
            bfan = v * self.lag if li == 0 else w.shape[-1]
            b.uniform_(-bfan ** -0.5, bfan ** -0.5, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, V) -> each joint's one-step predictions
        (B, T - lag + 1, V)."""
        b, t, v = x.shape
        h0, dt = self.hidden[0], x.dtype
        w0 = cast(self.l0_w, dt).reshape(v * h0, v, self.lag)
        y = F.conv1d(x.transpose(1, 2), w0,
                     cast(self.l0_b, dt).reshape(v * h0))
        y = y.reshape(b, v, h0, -1)
        for li in range(1, self.num_layers):
            y = torch.einsum("bvct,voc->bvot", torch.relu(y),
                             cast(getattr(self, f"l{li}_w"), dt)) \
                + cast(getattr(self, f"l{li}_b"), dt)[None, :, :, None]
        return y[:, :, 0, :].transpose(1, 2)

    def ridge(self, lam: float) -> torch.Tensor:
        """Ridge on every layer after the first (causalnn.py:96-98), summed
        over the V per-joint networks."""
        return lam * sum((getattr(self, f"l{li}_w") ** 2).sum()
                         for li in range(1, self.num_layers))


class CausalNeck(nn.Module):
    """CausalNeck (reference necks/Causal_neck.py:16-130; JAX
    ``necks.py:CausalNeck``): GCN pooling that also returns the raw
    feature, a per-joint body-part classifier ``fc_cls`` (``node_precost``)
    and the Neural-GC cost of a cMLP bank ``cMLP`` over the person-meaned
    channel series (``gc_cost``).  Not in ``NECKS``: its (pooled, feature)
    output is composed by hand, as in JAX."""

    def __init__(self, in_channels: int, dropout: float = 0.5,
                 mode: str = "GCN", num_series: int = 25, lag: int = 9,
                 lam_ridge: float = 1e-2):
        super().__init__()
        self.dropout, self.mode = dropout, mode
        self.lag, self.lam_ridge = lag, lam_ridge
        self.fc_cls = nn.Linear(in_channels, 5)
        nn.init.normal_(self.fc_cls.weight, std=0.01)
        nn.init.zeros_(self.fc_cls.bias)
        self.cMLP = CMLP(num_series, lag, (100,))

    def forward(self, x: torch.Tensor):
        """x: (N, M, T, V, C) -> (pooled (N, C), the feature x)."""
        return _pool(x), x

    def node_precost(self, x: torch.Tensor,
                     node_type: Sequence[int]) -> torch.Tensor:
        """Per-joint body-part cross entropy, mean (Causal_neck.py:97-111)."""
        return joint_type_losses(x, self.fc_cls, node_type).mean()

    def gc_cost(self, x: torch.Tensor) -> torch.Tensor:
        """Neural-GC smooth loss (Causal_neck.py:112-126): each joint's
        one-step prediction MSE over the person-meaned channel series,
        summed over joints, plus the ridge."""
        h = x.mean(dim=1)
        n, t, v, c = h.shape
        series = h.permute(0, 3, 1, 2).reshape(-1, t, v)
        pred = self.cMLP(series[:, :-1])
        target = series[:, self.lag:]
        loss = torch.mean((pred - target) ** 2, dim=(0, 1)).sum()
        return loss + self.cMLP.ridge(self.lam_ridge)


class PretrainNeck(_SegmentReadout):
    """Hierarchical prototype readout for masked pretraining (reference
    necks/pre_train.py:17-259; JAX ``necks.py:PretrainNeck``).

    Level i assigns the rows to the nearest of its int(P declay^i)
    prototypes ``proto{i}`` by cosine distance (each norm + 1e-8), pools
    each (sample, prototype) segment with ``read_op``, and the pooled rows
    are the next level's; the last level's are averaged per sample.
    ``get_aligncost`` sums each level's per-sample (soft-)min distances,
    averaged over samples; ``node_precost`` is the masked body-part cross
    entropy through ``fc_cls``; ``get_intracost``/``get_intercost`` the
    row- and clip-level NCE between a clip and its masked view.

    JAX's quirks, kept: the batch index rebuilt after a level uses 0.4 in
    place of ``declay`` (pre_train.py:113-118); the prototypes are
    trainable parameters; ``get_intracost``'s similarity is the outer
    product of per-row channel sums (the reference's einsum
    'bnc,bmt->bnm'); ``node_precost`` gates each joint with the t = 0
    slice of the (N, M, T, V, 1) mask.  ``gate`` (attention) is flax's
    default Dense and ``fc_cls`` N(0, 0.01) with a zero bias
    (``models/builder.py:init_weights_``).  ``set2set`` doubles the
    channels, so it works with one level only, as upstream."""

    def __init__(self, in_channels: int, num_position: int,
                 read_op: str = "mean", num_hierarchy: int = 3,
                 declay: float = 0.4, gamma: float = 0.1):
        super().__init__()
        self.num_position, self.num_hierarchy = num_position, num_hierarchy
        self.declay, self.gamma = declay, gamma
        for i in range(num_hierarchy):
            p = nn.Parameter(torch.empty(self.level_size(i), in_channels))
            nn.init.xavier_normal_(p)
            setattr(self, f"proto{i}", p)
        self._init_readout(in_channels, read_op)
        self.fc_cls = nn.Linear(in_channels, 5)
        nn.init.normal_(self.fc_cls.weight, std=0.01)
        nn.init.zeros_(self.fc_cls.bias)

    def level_size(self, i: int) -> int:
        return int(self.num_position * self.declay ** i)

    def _assign(self, x: torch.Tensor, level: int):
        p = cast(getattr(self, f"proto{level}"), x.dtype)
        xn = x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-8)
        pn = p / (torch.linalg.vector_norm(p, dim=1, keepdim=True) + 1e-8)
        d = 1.0 - xn @ pn.T
        return d, torch.argmin(d, dim=1)

    def _next_level(self, rows, batch, idx, i, n):
        p_i = self.level_size(i)
        rows = self._gread(rows, p_i * batch + idx, p_i * n)
        p_re = max(int(self.num_position * 0.4 ** i), 1)      # sic
        batch = torch.clamp(torch.arange(rows.shape[0], device=rows.device)
                            // p_re, max=n - 1)
        return rows, batch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows, batch, n = _rows(x)
        for i in range(self.num_hierarchy):
            _, idx = self._assign(rows, i)
            rows, batch = self._next_level(rows, batch, idx, i, n)
        p_last = int(self.num_position * 0.4 ** (self.num_hierarchy - 1))
        return rows.reshape(n, p_last, -1).mean(dim=1)

    def get_aligncost(self, x: torch.Tensor) -> torch.Tensor:
        rows, batch, n = _rows(x)
        total = x.new_zeros(())
        for i in range(self.num_hierarchy):
            d, idx = self._assign(rows, i)
            total = total + segment_sum(_soft_min(d, self.gamma), batch,
                                        n).mean()
            rows, batch = self._next_level(rows, batch, idx, i, n)
        return total

    def node_precost(self, x: torch.Tensor, node_type: Sequence[int],
                     mask: torch.Tensor) -> torch.Tensor:
        per = joint_type_losses(x, self.fc_cls, node_type)
        mk = cast(mask[:, :, 0].reshape(-1), per.dtype)
        return (per * mk).sum() / (mk.sum() + 1e-12)

    @staticmethod
    def get_intracost(x: torch.Tensor, x_modify: torch.Tensor,
                      tau: float = 0.1) -> torch.Tensor:
        n, m, t, v, c = x.shape
        a = x.reshape(n * m, t * v, c).sum(dim=-1)
        b = x_modify.reshape(n * m, t * v, c).sum(dim=-1)
        sim = a[:, :, None] * b[:, None, :]
        sim = sim / (torch.linalg.vector_norm(sim, dim=1, keepdim=True)
                     + 1e-12)
        sim = torch.exp(sim / tau)
        pos = torch.diagonal(sim, dim1=1, dim2=2) / (sim.sum(dim=1) + 1e-6)
        return -torch.log(pos + 1e-12).mean()

    @staticmethod
    def get_intercost(x: torch.Tensor, x_modify: torch.Tensor,
                      tau: float = 0.1) -> torch.Tensor:
        sim = _pool(x) @ _pool(x_modify).T
        sim = sim / (torch.linalg.vector_norm(sim, dim=1, keepdim=True)
                     + 1e-12)
        sim = torch.exp(sim / tau)
        eye = torch.eye(sim.shape[0], dtype=sim.dtype, device=sim.device)
        pos = (sim * eye).sum(dim=0)
        neg = (sim * (1 - eye)).sum(dim=0)
        return -torch.log(pos / (pos + neg + 1e-6) + 1e-12).mean()


# config-buildable necks (JAX's NECKS; CausalNeck returns a (pooled,
# feature) pair for the GC flow and is composed by hand)
NECKS = {"SimpleNeck": SimpleNeck, "SemanticNeck": SemanticNeck,
         "ReadoutNeck": ReadoutNeck, "PretrainNeck": PretrainNeck}


def build_neck(cfg) -> nn.Module:
    cfg = dict(cfg)
    typ = cfg.pop("type")
    if typ not in NECKS:
        raise KeyError(f"neck {typ!r} (the port has {sorted(NECKS)})")
    return NECKS[typ](**cfg)
