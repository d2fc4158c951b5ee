"""Fused dynamic-graph build + spatial aggregation: forward (K1) and
backward (K2), one ``torch.autograd.Function``.

The port of ``dsgcn_tpu/ops/pallas/dyn_graph.py:fused_dyn_graph_agg`` and
its custom VJP:

    ctr[k,c,v,w] = tanh(x1[k,c,v] - x2[k,c,w])
    ada[k,v,w]   = softmax_v( sum_c x1[k,c,v]*x2[k,c,w] )
    G[k,c,v,w]   = alpha[k]*ctr + beta[k]*ada[k,v,w] + A[k,v,w]
    y[t,w,k,c]   = sum_v pre[t,v,k,c] * G[k,c,v,w]

with the DS-GCN per-edge-class attention on subset ``edge_k`` and the
padded-joint softmax mask ``v_real`` (eval only).  :class:`FusedDynGraphAgg`
saves only its inputs, never the graph, as the JAX VJP does.  On CUDA
tensors its forward launches the hand-written kernel ``csrc/dyn_graph.cu``
and its backward ``csrc/dyn_graph_bwd.cu``; on CPU tensors they run the
plain versions :func:`reference_dyn_graph_agg` and
:func:`reference_dyn_graph_agg_bwd`.

:func:`fused_dyn_graph_agg_eval` (K5, eval only) is the same forward with
the BatchNorm-folded pre 1x1 inside the kernel (``csrc/dyn_graph_eval.cu``;
plain version :func:`reference_dyn_graph_agg_eval`).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

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


def _ctr(x1, x2, edge_w, edge_b, edge_sel, Cm, edge_k, edge_num):
    """The float32 ctr graph (N, K, Cm, V, V), with the edge-class attention
    on subset ``edge_k`` when ``edge_w`` is given."""
    N, _, _, V = x1.shape
    ctr = torch.tanh(x1[..., :, None] - x2[..., None, :])
    if edge_w is None:
        return ctr
    d = x1[:, edge_k][..., :, None] - x2[:, edge_k][..., None, :]
    es = torch.einsum("ncvw,ce->nevw", d, edge_w.float()).reshape(
        N, edge_num, Cm, V, V)
    sel = edge_sel.float()
    ea = torch.sum(es * sel[None, :, None], dim=1)        # (N,Cm,V,V)
    if edge_b is not None:
        eb = edge_b.float().reshape(edge_num, Cm)
        ea = ea + torch.einsum("evw,ec->cvw", sel, eb)[None]
    return torch.cat([ctr[:, :edge_k], torch.tanh(ea)[:, None],
                      ctr[:, edge_k + 1:]], dim=1)


def _graph(x1, x2, A, alpha, beta, ctr, v_real=-1):
    """(G, ada) in float32: G (N, K, Cm, V, V), ada (N, K, V, V)."""
    ada = _ada(torch.einsum("nkcv,nkcw->nkvw", x1, x2), v_real)
    G = (ctr * alpha.float()[None, :, None, None, None]
         + (ada * beta.float()[None, :, None, None]
            + A.float()[None])[:, :, None])
    return G, ada


def reference_dyn_graph_agg(pre_x, x1, x2, A, alpha, beta, edge_w=None,
                            edge_b=None, edge_sel=None, K=3, Cm=8, edge_k=-1,
                            edge_num=15, v_real=-1):
    """Plain PyTorch version of the K1 forward (JAX ``_fwd_reference`` plus
    the kernel's ``v_real`` mask).  The graph builds in float32 and is cast
    to pre's dtype for the contraction, as the kernel does."""
    N, T, V, KC = pre_x.shape
    x1, x2 = x1.float(), x2.float()
    ctr = _ctr(x1, x2, edge_w, edge_b, edge_sel, Cm, edge_k, edge_num)
    G, _ = _graph(x1, x2, A, alpha, beta, ctr, v_real)
    pre_k = pre_x.reshape(N, T, V, K, Cm)
    y = torch.einsum("ntvkc,nkcvw->ntwkc", pre_k, G.to(pre_x.dtype))
    return y.reshape(N, T, V, KC)


def reference_dyn_graph_agg_bwd(pre_x, x1, x2, A, alpha, beta, edge_w,
                                edge_b, edge_sel, dy, K=3, Cm=8, edge_k=-1,
                                edge_num=15):
    """Plain PyTorch version of K2: the math of the Pallas ``_bwd_kernel``
    (``dsgcn_tpu/ops/pallas/dyn_graph.py:336-343`` and its edge branch
    ``:450-480``).  pre and dy are lifted to float32 and G is not rounded,
    as the TPU kernel does; dpre comes back in pre's dtype, every other
    gradient in float32.  Returns (dpre, dx1, dx2, dA, dalpha, dbeta,
    dedge_w, dedge_b); the edge gradients are None without edge attention,
    dedge_b also without ``edge_b``."""
    N, T, V, KC = pre_x.shape
    E = edge_num
    x1, x2 = x1.float(), x2.float()
    alpha, beta = alpha.float(), beta.float()
    ctr = _ctr(x1, x2, edge_w, edge_b, edge_sel, Cm, edge_k, E)
    G, ada = _graph(x1, x2, A, alpha, beta, ctr)
    pre_k = pre_x.float().reshape(N, T, V, K, Cm)
    dy_k = dy.float().reshape(N, T, V, K, Cm)
    # dpre[t,v,c] = sum_w dy[t,w,c] G[c,v,w]; dG = sum_t pre[t,v,c] dy[t,w,c]
    dpre = torch.einsum("ntwkc,nkcvw->ntvkc", dy_k, G)
    dG = torch.einsum("ntvkc,ntwkc->nkcvw", pre_k, dy_k)
    sC = dG.sum(dim=2)                                          # (N,K,V,W)
    dA = sC.sum(dim=0)
    dalpha = (dG * ctr).sum(dim=(0, 2, 3, 4))
    dbeta = (sC * ada).sum(dim=(0, 2, 3))
    # ctr path: dz = dG alpha (1 - ctr^2)
    dz = dG * alpha[None, :, None, None, None] * (1.0 - ctr * ctr)
    dx1 = dz.sum(dim=-1)
    dx2 = -dz.sum(dim=-2)
    dew = deb = None
    if edge_w is not None:
        # through ea = sum_e sel (P1 - P2) + bias, P = edge_w^T q
        sel = edge_sel.float()
        dze = dz[:, edge_k]                                     # (N,Cm,V,W)
        dP1 = torch.einsum("evw,ncvw->necv", sel, dze).reshape(N, E * Cm, V)
        dP2 = -torch.einsum("evw,ncvw->necw", sel, dze).reshape(N, E * Cm, V)
        ew = edge_w.float()
        dx1[:, edge_k] = torch.einsum("cf,nfv->ncv", ew, dP1)
        dx2[:, edge_k] = torch.einsum("cf,nfw->ncw", ew, dP2)
        dew = (torch.einsum("ncv,nfv->cf", x1[:, edge_k], dP1)
               + torch.einsum("ncw,nfw->cf", x2[:, edge_k], dP2))
        if edge_b is not None:
            deb = dP1.sum(dim=(0, 2))
    # ada path: softmax VJP over the source axis v
    ds = beta[None, :, None, None] * sC
    inner = (ds * ada).sum(dim=-2, keepdim=True)
    draw = ada * (ds - inner)
    dx1 = dx1 + torch.einsum("nkcw,nkvw->nkcv", x2, draw)
    dx2 = dx2 + torch.einsum("nkcv,nkvw->nkcw", x1, draw)
    return (dpre.reshape(N, T, V, KC).to(pre_x.dtype), dx1, dx2, dA, dalpha,
            dbeta, dew, deb)


def _edge_operands(edge_w, edge_b, edge_sel, Cm, E, V, dev):
    """edge_w (Cm, E*Cm), the (Cm, V, V) bias field and sel (E, V, V) as the
    kernels read them; the bias field b[class(v,w), c] is built outside the
    kernels, as the Pallas wrapper does (``_edge_specs_args``)."""
    op = lambda t, shape, n: _build.graph_operand(t, shape, n, dev)  # noqa
    edge_w = op(edge_w, (Cm, E * Cm), "edge_w")
    sel = op(edge_sel, (E, V, V), "edge_sel")
    eb = (torch.zeros(E * Cm, device=dev) if edge_b is None
          else op(edge_b, (E * Cm,), "edge_b"))
    bias_field = torch.einsum("evw,ec->cvw", sel,
                              eb.reshape(E, Cm)).contiguous()
    return edge_w, bias_field, sel


def _graph_operands(name, pre_x, x1, x2, A, alpha, beta, edge_w, edge_b,
                    edge_sel, K, Cm, edge_k, E):
    """Check a kernel call and bring its graph operands to the contiguous
    float32 tensors the kernels read."""
    _build.check_activation(pre_x, name)
    N, T, V, KC = pre_x.shape
    if KC != K * Cm:
        raise ValueError(f"{name}: pre_x has {KC} channels, K*Cm = {K * Cm}")
    dev = pre_x.device
    _build.check_limits(name, N, V, E)
    op = lambda t, shape, n: _build.graph_operand(t, shape, n, dev)  # noqa
    ops = dict(x1=op(x1, (N, K, Cm, V), "x1"), x2=op(x2, (N, K, Cm, V), "x2"),
               A=op(A, (K, V, V), "A"), alpha=op(alpha, (K,), "alpha"),
               beta=op(beta, (K,), "beta"), edge_w=None, bias_field=None,
               sel=None, edge_k=-1)
    if edge_w is not None:
        if not 0 <= edge_k < K:
            raise ValueError(f"{name}: edge_k={edge_k} outside [0, {K})")
        ops["edge_w"], ops["bias_field"], ops["sel"] = _edge_operands(
            edge_w, edge_b, edge_sel, Cm, E, V, dev)
        ops["edge_k"] = edge_k
    return ops


# the H100 the plan of K1 and K3's block is made for (its SMs and shared
# memory: _build.SMS, SM_SMEM, BLOCK_SMEM)
_SM_THREADS, _SM_BLOCKS, _SM_REGS, _THREAD_REGS = 2048, 32, 65536, 128
# the planner's cost model, in one warp's row steps: a thread's graph build
# and a block's fixed setup (query tables, ada), and the resident warps an
# SM needs to keep issuing through the loads' latency (fitted to plan
# sweeps on the H100: ``python3 chip_smoke.py --sweep``)
_BUILD_ROWS, _SETUP_ROWS, _HIDE_WARPS = 13, 400, 12


def agg_joint_bound(V: int):
    """(VB, WN): the compile-time joint bound the kernel takes for V joints
    and the destination joints a thread holds there
    (``_build.AGG_JOINTS_PER_THREAD``)."""
    VB = min(b for b in _build.AGG_JOINTS_PER_THREAD if b >= V)
    return VB, _build.AGG_JOINTS_PER_THREAD[VB]


def agg_block(V: int, Cm: int, CG: int, esize: int):
    """(threads, shared-memory bytes) of a K1/K3 block of CG channels for
    pre/y elements of ``esize`` bytes: CG x ceil(V / WN) threads rounded to
    warps; the ring of pre tiles, the query tables and beta*ada + A.  The
    kernels' own count (``csrc/dyn_graph.cu`` ``dsgcn_agg_block``) is held
    to it on the card."""
    VB, WN = agg_joint_bound(V)
    threads = -(-CG * -(-V // WN) // 32) * 32
    XS = V | 1
    ring = -(-_build.AGG_STAGES * _build.AGG_ROWS * VB * CG * esize
             // 16) * 16
    return threads, ring + 4 * (2 * Cm * XS + V * V)


@functools.lru_cache(maxsize=None)
def agg_plan(N: int, T: int, V: int, K: int, Cm: int, esize: int):
    """(CG, rows): the channels and rows of pre a K1/K3 block takes.

    A block builds the graph columns of its CG channels once and streams
    its rows through them, so splitting T repeats the build and the setup,
    and narrower channel groups repeat the setup, while a grid of too few
    warps leaves the SMs waiting on loads.  The cost is the blocks the
    busiest SM runs times a block's work (its warps' build and rows, plus
    the fixed setup), divided by the share of _HIDE_WARPS resident warps
    the SM keeps (by threads, registers and shared memory); copies that
    are not 16-byte aligned cost half as much again.  The cheapest plan
    wins, ties to fewer blocks."""
    VB, WN = agg_joint_bound(V)
    row = VB * (WN + 2) + 2 * WN          # a warp's instructions a row
    best = None
    for CG in range(min(Cm, 32), 0, -1):
        if Cm % CG:
            continue
        threads, smem = agg_block(V, Cm, CG, esize)
        if threads > _build.AGG_MAX_THREADS or smem > _build.BLOCK_SMEM:
            continue
        warps = threads // 32
        per_sm = min(_SM_BLOCKS, _SM_THREADS // threads,
                     _SM_REGS // (threads * _THREAD_REGS),
                     _build.SM_SMEM // (smem + 1024))
        slow = 1.0 if (CG * esize) % 16 == 0 and (Cm * esize) % 16 == 0 \
            else 1.5
        for S in range(1, T + 1):
            rows = -(-T // S)
            if S > 1 and -(-T // (S - 1)) == rows:
                continue
            blocks = N * K * (Cm // CG) * -(-T // rows)
            load = -(-blocks // _build.SMS)
            resident = min(per_sm, load) * warps
            work = warps * (_BUILD_ROWS + rows) + _SETUP_ROWS
            cost = slow * row * load * work / min(1.0,
                                                  resident / _HIDE_WARPS)
            key = (cost, blocks)
            if best is None or key < best[0]:
                best = (key, CG, rows)
    if best is None:
        raise ValueError(f"no block plan for V={V}, Cm={Cm}: the block's "
                         "shared memory or threads exceed the card's")
    return best[1], best[2]


def _forward_kernel(pre_x, x1, x2, A, alpha, beta, edge_w, edge_b, edge_sel,
                    K, Cm, edge_k, E, v_real):
    """Launch K1 (``csrc/dyn_graph.cu``) on CUDA tensors."""
    o = _graph_operands("fused_dyn_graph_agg", pre_x, x1, x2, A, alpha, beta,
                        edge_w, edge_b, edge_sel, K, Cm, edge_k, E)
    N, T, V, _ = pre_x.shape
    out = torch.empty_like(pre_x)
    if out.numel() == 0:
        return out
    CG, rows = agg_plan(N, T, V, K, Cm, pre_x.element_size())
    # the edge subset's projections and ctr, built for the whole call ahead
    # of the blocks
    p1s = p2s = ectr = None
    if o["edge_k"] >= 0:
        p1s, p2s = torch.empty(2, N * E * V * Cm, device=pre_x.device)
        ectr = torch.empty(N * V * V * Cm, device=pre_x.device)
    ptr = _build.ptr
    with torch.cuda.device(pre_x.device):
        _build.launch(
            "dyn_graph", ptr(pre_x), ptr(out),
            int(pre_x.dtype == torch.bfloat16), ptr(o["x1"]), ptr(o["x2"]),
            ptr(o["A"]), ptr(o["alpha"]), ptr(o["beta"]), ptr(o["edge_w"]),
            ptr(o["bias_field"]), ptr(o["sel"]), ptr(p1s), ptr(p2s),
            ptr(ectr), N, T, V, K, Cm, E, o["edge_k"], v_real, CG, rows,
            _build.stream_of(pre_x))
    fused_dyn_graph_agg.launches += 1
    return out


def bwd_joint_bound(V: int):
    """(VB, WN): K2's compile-time joint bound for V joints and the source
    joints a contraction thread holds there
    (``_build.BWD_JOINTS_PER_THREAD``)."""
    VB = min(b for b in _build.BWD_JOINTS_PER_THREAD if b >= V)
    return VB, _build.BWD_JOINTS_PER_THREAD[VB]


def _align16(b: int) -> int:
    return -(-b // 16) * 16


def bwd_block(V: int, CG: int, esize: int, E: int):
    """(threads, shared-memory bytes) of a K2 contraction block of CG
    channels for pre/dy elements of ``esize`` bytes, with E edge classes
    (0 without an edge subset): CG x ceil(V / WN) threads rounded to warps;
    the larger of the rings of pre and dy and the post-row planes (dG / dz,
    and dP1/dP2 on the edge subset), the block's queries and their
    exponential tables, base, 32 floats for block sums, and each (v, w)'s
    class mask and value at its first class.  The kernel's own count
    (``csrc/dyn_graph_bwd.cu`` ``dsgcn_bwd_block``) is held to it on the
    card."""
    VB, WN = bwd_joint_bound(V)
    threads = -(-CG * -(-V // WN) // 32) * 32
    XS = V | 1
    # pre's slots (rows, joints, channels); dy's (rows, channels, joints
    # padded to 4), channels paired in bfloat16
    dy_channels = -(-CG // 2) * 2 if esize == 2 else CG
    ring = _build.BWD_STAGES * (
        _align16(_build.BWD_ROWS * VB * CG * esize)
        + _align16(_build.BWD_ROWS * dy_channels * -(-VB // 4) * 4 * esize))
    post = 4 * (CG * (V * V | 1) + 2 * E * CG * XS)
    smem = (_align16(max(ring, post)) + 4 * (4 * CG * XS + V * V + 32)
            + (6 * V * V if E else 0))
    return threads, smem


def bwd_finish_smem(V: int, Cm: int) -> int:
    """Shared-memory bytes of K2's finish block (``finish_smem_bytes``)."""
    return 4 * (2 * Cm * (V | 1) + 2 * V * V + V * (V | 1) + 32)


# K2's cost model, in one warp's row steps: a warp's graph rows and chain
# after the rows, and a block's fixed work (tables, barriers, the partial
# sums it writes)
_BWD_BUILD_ROWS, _BWD_SETUP_ROWS = 8, 70


@functools.lru_cache(maxsize=None)
def bwd_plan(N: int, T: int, V: int, K: int, Cm: int, esize: int, E: int):
    """(CG, rows): the channels and rows of pre/dy a K2 contraction block
    takes (E: the edge classes, 0 without an edge subset).

    A block builds its graph rows once and chains its partial dG after its
    rows, so splitting T or narrowing the channel group repeats that work
    and adds partial sums for the finish kernel to add, while a grid of too
    few warps leaves the SMs waiting on loads.  The cost is agg_plan's:
    the blocks the busiest SM runs times a block's work, over the share of
    _HIDE_WARPS resident warps the SM keeps; the cheapest plan wins, ties
    to fewer blocks."""
    VB, WN = bwd_joint_bound(V)
    row = VB * (2 * WN + 1) + 2 * WN      # a warp's instructions a row
    regs = _SM_REGS // (_build.BWD_MIN_BLOCKS * _build.BWD_MAX_THREADS)
    best = None
    for CG in range(min(Cm, 32), 0, -1):
        if Cm % CG:
            continue
        threads, smem = bwd_block(V, CG, esize, E)
        if threads > _build.BWD_MAX_THREADS or smem > _build.BLOCK_SMEM:
            continue
        warps = threads // 32
        per_sm = min(_SM_BLOCKS, _SM_THREADS // threads,
                     _SM_REGS // (threads * regs),
                     _build.SM_SMEM // (smem + 1024))
        if per_sm < 1:
            continue
        slow = 1.0 if (CG * esize) % 16 == 0 and (Cm * esize) % 16 == 0 \
            else 1.5
        for S in range(1, max(T, 1) + 1):
            rows = -(-max(T, 1) // S)
            if S > 1 and -(-T // (S - 1)) == rows:
                continue
            blocks = N * K * (Cm // CG) * -(-max(T, 1) // rows)
            load = -(-blocks // _build.SMS)
            resident = min(per_sm, load) * warps
            work = warps * (_BWD_BUILD_ROWS + rows) + _BWD_SETUP_ROWS
            cost = slow * row * load * work / min(1.0,
                                                  resident / _HIDE_WARPS)
            key = (cost, blocks)
            if best is None or key < best[0]:
                best = (key, CG, rows)
    if best is None:
        raise ValueError(f"no K2 block plan for V={V}, Cm={Cm}: the block's "
                         "shared memory or threads exceed the card's")
    return best[1], best[2]


def _edge_slices(N: int, F: int) -> int:
    """Sample slices of K2's dedge_w product: enough blocks for four
    waves of the card (``edge_dw_kernel``'s grid is ceil(F / 64) x
    slices)."""
    return max(1, min(N, -(-4 * _build.SMS // -(-F // 64))))


def fused_dyn_graph_agg_bwd(pre_x: torch.Tensor, x1: torch.Tensor,
                            x2: torch.Tensor, A: torch.Tensor,
                            alpha: torch.Tensor, beta: torch.Tensor,
                            edge_w: Optional[torch.Tensor],
                            edge_b: Optional[torch.Tensor],
                            edge_sel: Optional[torch.Tensor],
                            dy: torch.Tensor, K: int = 3, Cm: int = 8,
                            edge_k: int = -1, edge_num: int = 15):
    """The backward of :func:`fused_dyn_graph_agg` (K2) for the upstream
    gradient ``dy`` (pre_x's shape and dtype).  Returns (dpre, dx1, dx2,
    dA, dalpha, dbeta, dedge_w, dedge_b) as
    :func:`reference_dyn_graph_agg_bwd` does.  On a CUDA tensor it launches
    ``csrc/dyn_graph_bwd.cu``; on a CPU tensor it runs the plain version."""
    if pre_x.device.type == "cpu":
        return reference_dyn_graph_agg_bwd(pre_x, x1, x2, A, alpha, beta,
                                           edge_w, edge_b, edge_sel, dy, K=K,
                                           Cm=Cm, edge_k=edge_k,
                                           edge_num=edge_num)
    name = "fused_dyn_graph_agg_bwd"
    E = edge_num
    o = _graph_operands(name, pre_x, x1, x2, A, alpha, beta, edge_w, edge_b,
                        edge_sel, K, Cm, edge_k, E)
    if dy.shape != pre_x.shape or dy.dtype != pre_x.dtype \
            or dy.device != pre_x.device or not dy.is_contiguous():
        raise ValueError(f"{name}: dy must be a contiguous tensor of pre_x's "
                         "shape, dtype and device")
    N, T, V, _ = pre_x.shape
    has_edge = o["edge_k"] >= 0
    if has_edge and Cm > _build.MAX_BWD_EDGE_CHANNELS:
        raise ValueError(f"{name}: edge attention with Cm = {Cm} over "
                         f"{_build.MAX_BWD_EDGE_CHANNELS} (the edge "
                         "products take the subset's channels and the bias "
                         "in one block)")
    if bwd_finish_smem(V, Cm) > _build.BLOCK_SMEM:
        raise ValueError(f"{name}: Cm = {Cm} channels overflow the finish "
                         "block's shared memory")
    Ee = E if has_edge else 0
    CG, rows = bwd_plan(N, T, V, K, Cm, pre_x.element_size(), Ee)
    nrr = max(1, -(-T // rows))
    S = nrr * (Cm // CG)
    dev, f32 = pre_x.device, torch.float32
    VV, F = V * V, E * Cm
    W0 = K * VV + 2 * K
    dpre = torch.empty_like(pre_x)
    dx1 = torch.empty((N, K, Cm, V), device=dev, dtype=f32)
    dx2 = torch.empty_like(dx1)
    sums = torch.empty(W0 + ((Cm + 1) * F if has_edge else 0), device=dev,
                       dtype=f32)
    if N == 0:
        sums.zero_()
    else:
        # per-block slices and per-sample sums, added in order by the
        # kernels (csrc/dyn_graph_bwd.cu, the C interface's note), carved
        # from one workspace
        shapes = dict(parts=(N, W0), ada=(N, K, VV), sc_part=(N, K, S, VV),
                      da_part=(N, K, S), dx_part=(N, K, nrr, 2, Cm, V))
        ns = 0
        if has_edge:
            ns = _edge_slices(N, F)
            shapes.update(p1s=(N * E * V * Cm,), p2s=(N * E * V * Cm,),
                          ectr=(N * VV * Cm,), dp_part=(N, nrr, 2, F, V),
                          dxe_part=(N, _build.BWD_DX_PARTS, 2, Cm, V),
                          dw_part=(ns, Cm + 1, F))
        # each piece on a 256-byte boundary
        sizes = {k: -(-int(np.prod(v)) // 64) * 64 for k, v in shapes.items()}
        work = torch.empty(sum(sizes.values()), device=dev, dtype=f32)
        w = dict(zip(sizes, torch.split(work, list(sizes.values()))))
        ptr = _build.ptr
        with torch.cuda.device(dev):
            _build.launch(
                "dyn_graph_bwd", ptr(pre_x), ptr(dy), ptr(dpre),
                int(pre_x.dtype == torch.bfloat16), ptr(dx1), ptr(dx2),
                ptr(w["parts"]), ptr(sums), ptr(o["x1"]), ptr(o["x2"]),
                ptr(o["A"]), ptr(o["alpha"]), ptr(o["beta"]),
                ptr(o["edge_w"]), ptr(o["bias_field"]), ptr(o["sel"]),
                ptr(w.get("p1s")), ptr(w.get("p2s")), ptr(w.get("ectr")),
                ptr(w["ada"]), ptr(w["sc_part"]), ptr(w["da_part"]),
                ptr(w["dx_part"]), ptr(w.get("dp_part")),
                ptr(w.get("dxe_part")), ptr(w.get("dw_part")), N, T, V, K,
                Cm, E, o["edge_k"], CG, rows, nrr, ns,
                _build.stream_of(pre_x))
        fused_dyn_graph_agg_bwd.launches += 1
    dA = sums[:K * VV].view(K, V, V)
    dgates = sums[K * VV:W0].view(2, K)
    dew = deb = None
    if has_edge:
        dew = sums[W0:W0 + Cm * F].view(Cm, F)
        deb = sums[W0 + Cm * F:] if edge_b is not None else None
    return dpre, dx1, dx2, dA, dgates[0], dgates[1], dew, deb


fused_dyn_graph_agg_bwd.launches = 0


def _cast(g, like):
    return None if g is None or like is None else g.to(like.dtype)


class FusedDynGraphAgg(torch.autograd.Function):
    """K1 forward and K2 backward; saves the inputs only (JAX ``_vjp_fwd``).
    Grad-of-grad is not supported (``once_differentiable`` raises)."""

    @staticmethod
    def forward(ctx, pre_x, x1, x2, A, alpha, beta, edge_w, edge_b, edge_sel,
                K, Cm, edge_k, edge_num, v_real):
        ctx.save_for_backward(pre_x, x1, x2, A, alpha, beta, edge_w, edge_b,
                              edge_sel)
        ctx.static = (K, Cm, edge_k, edge_num, v_real)
        if pre_x.device.type == "cpu":
            return reference_dyn_graph_agg(pre_x, x1, x2, A, alpha, beta,
                                           edge_w, edge_b, edge_sel, K=K,
                                           Cm=Cm, edge_k=edge_k,
                                           edge_num=edge_num, v_real=v_real)
        return _forward_kernel(pre_x, x1, x2, A, alpha, beta, edge_w, edge_b,
                               edge_sel, K, Cm, edge_k, edge_num, v_real)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        K, Cm, edge_k, edge_num, v_real = ctx.static
        if v_real > 0:
            raise NotImplementedError(
                "joint-padded mode (v_real) is eval-only: it has no backward")
        pre_x, x1, x2, A, alpha, beta, edge_w, edge_b, edge_sel = \
            ctx.saved_tensors
        dpre, dx1, dx2, dA, da, db, dew, deb = fused_dyn_graph_agg_bwd(
            pre_x, x1, x2, A, alpha, beta, edge_w, edge_b, edge_sel,
            dy.to(pre_x.dtype).contiguous(), K, Cm, edge_k, edge_num)
        return (dpre, _cast(dx1, x1), _cast(dx2, x2), _cast(dA, A),
                _cast(da, alpha), _cast(db, beta), _cast(dew, edge_w),
                _cast(deb, edge_b), None, None, None, None, None, None)


def fused_dyn_graph_agg(pre_x: torch.Tensor, x1: torch.Tensor,
                        x2: torch.Tensor, A: torch.Tensor,
                        alpha: torch.Tensor, beta: torch.Tensor,
                        edge_w: Optional[torch.Tensor] = None,
                        edge_b: Optional[torch.Tensor] = None,
                        edge_sel: Optional[torch.Tensor] = None,
                        K: int = 3, Cm: int = 8, edge_k: int = -1,
                        edge_num: int = 15,
                        v_real: int = -1) -> torch.Tensor:
    """y = aggregate(pre_x, G(x1, x2, A, alpha, beta[, edge attention])),
    differentiable in every tensor but ``edge_sel``.

    pre_x: (N, T, V, K*Cm) float32 or bfloat16; x1/x2: (N, K, Cm, V);
    A: (K, V, V); alpha/beta: (K,) effective per-subset gates; edge_w:
    (Cm, edge_num*Cm) or None; edge_b: (edge_num*Cm,) or None; edge_sel:
    (edge_num, V, V) one-hot class mask or None; v_real: the ada softmax
    masks source joints >= v_real (joint-padded eval input; it has no
    backward).  Returns y in pre_x's layout and dtype.
    """
    if v_real > 0 and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (pre_x, x1, x2, A, alpha, beta, edge_w, edge_b)):
        raise NotImplementedError(
            "fused_dyn_graph_agg: joint-padded mode (v_real) is eval-only; "
            "call it under torch.no_grad()")
    if edge_w is None:
        edge_k = -1
    return FusedDynGraphAgg.apply(pre_x, x1, x2, A, alpha, beta, edge_w,
                                  edge_b, edge_sel, K, Cm, edge_k, edge_num,
                                  v_real)


fused_dyn_graph_agg.launches = 0


# K5's and K6's blocks (csrc/pointwise_mma.cuh): a tile of whole frames of
# one sample, R rows (a multiple of the warps' 32-row tiles, the warps a
# WR x WC grid), the 1x1 products on tensor cores; the planners' cost
# model is _build's (MMA_FLOP_CLK, ...).
PW_ROWS = tuple(_build.PW_WARP_ROWS * 2 ** i for i in range(5))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pitch_a(nbytes: int) -> int:
    """An A tile's row pitch: the smallest >= nbytes that is 16 mod 128."""
    return (nbytes + 111) // 128 * 128 + 16


def pitch_b(nbytes: int) -> int:
    """A weight panel's row pitch: the smallest >= nbytes, 32 mod 128."""
    return (nbytes + 95) // 128 * 128 + 32


def pw_tiles(R: int, ncols: int) -> int:
    """n8 accumulator tiles a warp holds of an ncols-wide product over R
    rows (``tiles_per_warp``)."""
    WC = (_build.PW_THREADS // 32) // (R // _build.PW_WARP_ROWS)
    return -(-(-(-ncols // 8)) // WC)


def pw_slot(widest: int, esize: int) -> int:
    """Bytes of a ring slot (``slot_bytes``): PW_KP rows of the widest
    product's columns, PW_PANEL_WIDTH at least."""
    return _build.PW_KP * pitch_b(
        _round_up(max(widest, _build.PW_PANEL_WIDTH), 8) * esize)


def pw_panels(depth: int, ncols: int, slot: int, esize: int) -> int:
    """Panels of a product through a ring of ``slot``-byte slots: each as
    many k8 steps deep as a slot holds (``Weights``)."""
    kp = min(slot // pitch_b(_round_up(ncols, 8) * esize) // 8 * 8,
             _round_up(depth, 8))
    return -(-depth // kp)


def pw_chunks(K: int, Cm: int):
    """The channel chunks a K5/K6 block may take: divisors of K*Cm that lie
    inside one subset or cover whole subsets."""
    KC = K * Cm
    return [c for c in range(1, KC + 1)
            if KC % c == 0 and (Cm % c == 0 or c % Cm == 0)]


def pw_pre(R: int, CH: int) -> int:
    """Bytes of a staged pre chunk: a channel a row of R + 37 floats
    (``pre_pitch``: the aggregation reads up to 31 past the tile's rows)."""
    return _round_up(CH * (R + 37) * 4, 16)


def pw_tables(V: int, Cm: int, CH: int) -> int:
    """Bytes of a chunk's subset tables: the queries and base of each."""
    S = CH // Cm if CH > Cm else 1
    return 4 * (2 * S * Cm * (V | 1) + S * V * V)


def _aggregate_clk(V: int, TT: int, CH: int, WN: int):
    """(all, build): clocks of one chunk's aggregation over TT frames and
    of its graph build, one thread an item, 16 warps issuing four a
    clock."""
    rounds = -(-CH * -(-V // WN) // _build.PW_THREADS)
    build = V * WN * _build.ENTRY_INSTR
    warp_clk = _build.PW_THREADS // 32 // 4
    return (rounds * (build + TT * V * (1 + WN)) * warp_clk,
            rounds * build * warp_clk)


def _product_clk(R: int, depth: int, ncols: int, split_a: bool,
                 split_b: bool) -> float:
    """Clocks of an R-row product on tensor cores, the warps' padding
    included: the larger of the MMAs at _build.MMA_FLOP_CLK and the warps'
    instructions issued four a clock (a k8 step's fragment loads, their
    hi/lo splits where an operand is float32, and the MMAs)."""
    warps = _build.PW_THREADS // 32
    MT = _build.PW_WARP_ROWS // 16
    WC = warps // (R // _build.PW_WARP_ROWS)
    nt = pw_tiles(R, ncols)
    terms = 1 + int(split_a) + int(split_b)
    ksteps = -(-depth // 8)
    mma = 2.0 * R * ksteps * 8 * nt * WC * 8 * terms / _build.MMA_FLOP_CLK
    per_step = (4 * MT * (1 + 3 * split_a) + 2 * nt * (1 + 3 * split_b)
                + nt * MT * terms)
    return max(mma, ksteps * warps * per_step / 4)


def _row_tiles(T: int, V: int):
    """(R, TT) candidates: each row count with the frames it holds, the
    smallest R for each TT."""
    out = []
    for R in PW_ROWS:
        TT = min(T, R // V)
        if TT >= 1 and not (out and out[-1][1] == TT):
            out.append((R, TT))
    return out


def graph_tables(N: int, K: int, Cm: int, V: int, dev):
    """Scratch of K5's and K6's ``graph_prep_kernel``: each (sample,
    subset)'s query tables t1, t2 (N, K, Cm, V), base (N, K, V, V) and
    whether its tables are exponential (N, K) int32."""
    work = torch.empty(N * K * (2 * Cm * V + V * V), device=dev)
    t1, t2, tb = torch.split(work, [N * K * Cm * V] * 2 + [N * K * V * V])
    return t1, t2, tb, torch.empty(N * K, device=dev, dtype=torch.int32)


def eval_block(V: int, C: int, K: int, Cm: int, esize: int, R: int,
               CH: int) -> int:
    """Shared-memory bytes of a K5 block (``eval_layout``): the x tile, the
    pre chunk (``pw_pre``), the ring of w_pre panels and the tables; 0 where
    the kernel refuses the plan (its accumulator tiles).  The kernel's own
    count (``csrc/dyn_graph_eval.cu`` ``dsgcn_eval_block_geometry``) is held
    to it on the card."""
    if pw_tiles(R, CH) > _build.K5_PRE_TILES:
        return 0
    KP = _build.PW_KP
    slot = pw_slot(CH, esize)
    return (R * pitch_a(_round_up(C, KP) * esize) + pw_pre(R, CH)
            + _build.PW_STAGES * slot + pw_tables(V, Cm, CH))


@functools.lru_cache(maxsize=None)
def eval_plan(N: int, T: int, V: int, C: int, K: int, Cm: int, esize: int):
    """(TT, R, CH): the frames, rows and channels of a K5 block.

    A block reads its x tile once for CH channels, so narrow chunks read x
    again and again, while wide chunks and long tiles leave too few blocks
    for the card; each block also builds its chunk's graph entries.  The
    cost is the blocks the busiest SM runs (one at a time) times a block's
    clocks: the tensor-core product, the aggregation, a barrier a weight
    panel, a fixed share, and x and y's bytes.  The cheapest plan
    wins, ties to fewer blocks.  Raises, naming the limit, where no plan
    fits."""
    KC = K * Cm
    best, least = None, None
    for R, TT in _row_tiles(T, V):
        for CH in pw_chunks(K, Cm):
            smem = eval_block(V, C, K, Cm, esize, R, CH)
            if smem == 0 or smem > _build.BLOCK_SMEM:
                if smem:
                    least = smem if least is None else min(least, smem)
                continue
            blocks = N * -(-T // TT) * (KC // CH)
            if -(-T // TT) > 65535:
                continue
            agg, _ = _aggregate_clk(V, TT, CH, _build.K5_JOINTS_PER_THREAD)
            panels = pw_panels(C, CH, pw_slot(CH, esize), esize)
            clk = (_product_clk(R, C, CH, esize == 4, esize == 4) + agg
                   + panels * _build.PANEL_CLK + _build.CHUNK_CLK
                   + (R * C + TT * V * CH) * esize / _build.BYTES_CLK)
            key = (-(-blocks // _build.SMS) * clk, blocks)
            if best is None or key < best[0]:
                best = (key, TT, R, CH)
    if best is None:
        raise ValueError(
            f"fused_dyn_graph_agg_eval: no block plan for {C} input "
            f"channels, K*Cm = {KC}, V = {V}: the smallest block needs "
            f"{least} bytes of shared memory, over the {_build.BLOCK_SMEM} a "
            "block has")
    return best[1:]


def reference_dyn_graph_agg_eval(x, w_pre, b_pre, x1, x2, A, alpha, beta, *,
                                 K, Cm, v_real=-1):
    """Plain PyTorch version of K5: pre = relu(x w_pre + b_pre), summed in
    float32 and rounded to x's dtype as the TPU kernel does, then the K1
    forward without edge attention."""
    pre = torch.relu(x.float() @ w_pre.float() + b_pre.float()).to(x.dtype)
    return reference_dyn_graph_agg(pre, x1, x2, A, alpha, beta, K=K, Cm=Cm,
                                   v_real=v_real)


def fused_dyn_graph_agg_eval(x: torch.Tensor, w_pre: torch.Tensor,
                             b_pre: torch.Tensor, x1: torch.Tensor,
                             x2: torch.Tensor, A: torch.Tensor,
                             alpha: torch.Tensor, beta: torch.Tensor, *,
                             K: int, Cm: int,
                             v_real: int = -1) -> torch.Tensor:
    """Eval only: y = aggregate(relu(x w_pre + b_pre), G(x1, x2, A, alpha,
    beta)) with the pre 1x1 inside the kernel, so pre never reaches device
    memory (``dsgcn_tpu/ops/pallas/dyn_graph.py:fused_dyn_graph_agg_eval``).

    x: (N, T, V, C) float32 or bfloat16; w_pre: (C, K*Cm) in x's dtype and
    b_pre: (K*Cm,) float32, the BatchNorm-folded pre-conv; x1/x2:
    (N, K, Cm, V); A: (K, V, V); alpha/beta: (K,).  No edge attention.
    Returns (N, T, V, K*Cm) in x's dtype."""
    if x.device.type == "cpu":
        return reference_dyn_graph_agg_eval(x, w_pre, b_pre, x1, x2, A,
                                            alpha, beta, K=K, Cm=Cm,
                                            v_real=v_real)
    name = "fused_dyn_graph_agg_eval"
    _build.check_activation(x, name)
    _build.refuse_grad(name, x, w_pre, b_pre, x1, x2, A, alpha, beta)
    N, T, V, C = x.shape
    KC = K * Cm
    if w_pre.shape != (C, KC) or w_pre.dtype != x.dtype \
            or w_pre.device != x.device:
        raise ValueError(f"{name}: w_pre must be ({C}, {KC}) in x's dtype "
                         f"and device, got {tuple(w_pre.shape)} "
                         f"{w_pre.dtype} on {w_pre.device}")
    if b_pre.shape != (KC,) or b_pre.dtype != torch.float32 \
            or b_pre.device != x.device:
        raise ValueError(f"{name}: b_pre must be float32 ({KC},) on "
                         f"x's device")
    _build.check_limits(name, N, V, 0)
    # the block plan refuses what the kernel cannot take (input channels
    # over the shared memory), before the operands are looked at
    plan = (eval_plan(N, T, V, C, K, Cm, x.element_size())
            if N * T * KC else None)
    op = lambda t, shape, n: _build.graph_operand(t, shape, n, x.device)  # noqa
    x1, x2 = op(x1, (N, K, Cm, V), "x1"), op(x2, (N, K, Cm, V), "x2")
    A = op(A, (K, V, V), "A")
    alpha, beta = op(alpha, (K,), "alpha"), op(beta, (K,), "beta")
    w_pre, b_pre = w_pre.contiguous(), b_pre.contiguous()
    out = torch.empty((N, T, V, KC), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    TT, R, CH = plan
    tables = graph_tables(N, K, Cm, V, x.device)
    ptr = _build.ptr
    with torch.cuda.device(x.device):
        _build.launch(
            "dyn_graph_eval", ptr(x), ptr(w_pre), ptr(b_pre), ptr(out),
            int(x.dtype == torch.bfloat16),
            ptr(x1), ptr(x2), ptr(A), ptr(alpha), ptr(beta), N, T, V, C, K,
            Cm, v_real, TT, R, CH, *(ptr(t) for t in tables),
            _build.stream_of(x))
    fused_dyn_graph_agg_eval.launches += 1
    return out


fused_dyn_graph_agg_eval.launches = 0
