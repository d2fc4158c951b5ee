"""The port's CUDA kernels K1 (fused_dyn_graph_agg forward), K2 (its
backward), K3 (bd_dyn_graph_agg), K4 (bd_dyn_graph_agg_subset), K5
(fused_dyn_graph_agg_eval), K6 (fused_dggcn_block_eval) and K7
(fused_dgmstcn_eval) against their plain PyTorch versions on the card, the
K1+K2 autograd Function, a narrow DG-STGCN's eval options on the card
against the CPU, MSTCN through K7, one DS-GCN train step on the card
against the same step on the CPU, narrow AAGCN and CTR-GCN forwards and
train steps on the card against the CPU, the seven kernels' custom ops
under ``torch.library.opcheck``, a DS-GCN served from its exported
artifact, and K1, K3 and K4 through the joint-padded modules (which run
at the real joints).

Marked ``cuda``: they skip without a GPU.  The file imports no JAX, so it
runs on a GPU machine without it; there, run it without the JAX-side
``tests/conftest.py``:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""
import copy
import ctypes

import numpy as np
import pytest
import torch

from dsgcn_tpu_torch.core.train import make_optimizer, train_step
from dsgcn_tpu_torch.models.builder import (build_model, init_weights_,
                                           model_cfg)
from dsgcn_tpu_torch.ops.kernels import _build
from dsgcn_tpu_torch.ops.kernels.bd_agg import (
    bd_dyn_graph_agg, bd_dyn_graph_agg_subset, reference_bd_dyn_graph_agg,
    reference_bd_dyn_graph_agg_subset)
from dsgcn_tpu_torch.ops.kernels import dggcn_block
from dsgcn_tpu_torch.ops.kernels.dggcn_block import (
    fused_dggcn_block_eval, reference_dggcn_block_eval)
from dsgcn_tpu_torch.ops.kernels import dyn_graph
from dsgcn_tpu_torch.ops.kernels.dyn_graph import (
    agg_block, bwd_block, fused_dyn_graph_agg, fused_dyn_graph_agg_bwd,
    fused_dyn_graph_agg_eval, reference_dyn_graph_agg,
    reference_dyn_graph_agg_bwd, reference_dyn_graph_agg_eval)
from dsgcn_tpu_torch.ops.kernels import ms_tcn
from dsgcn_tpu_torch.ops.kernels.ms_tcn import (fused_dgmstcn_eval,
                                                reference_fused_dgmstcn_eval)
from dsgcn_tpu_torch.ops.tcn import MSTCN
from dsgcn_tpu_torch.apis import to_padded_inference
from dsgcn_tpu_torch.serving import export_recognizer, load_exported
from torch_port_cases import (CASES, E, block_inputs, k3_packaging,
                              opcheck_cases, to_torch)
from chip_smoke import DG_BLOCKS, DG_K, DS_BLOCKS, TCN_SHAPES

K2_OUTS = ("dpre", "dx1", "dx2", "dA", "dalpha", "dbeta", "dedge_w",
           "dedge_b")


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (kernel, K, Cm): DS-GCN's widths (K = 3) for both, DG-STGCN's (K = 8) for
# K1, whose widest stage is Cm = 64; and Cm = 6, whose channel runs are not
# 16-byte aligned (element-wise staging; K1's projections a channel a
# thread)
KERNEL_WIDTHS = [("k1", 3, 8), ("k1", 3, 16), ("k1", 3, 32), ("k1", 8, 16),
                 ("k1", 8, 32), ("k1", 8, 64), ("k3", 3, 8), ("k3", 3, 16),
                 ("k3", 3, 32), ("k1", 3, 6), ("k3", 3, 6)]
# CASES, a graph of 18 joints (the joint bound 25 with 7 joints short) and
# COCO's 17 joints with its edge classes and without
AGG_CASES = CASES + [(False, 18, -1), (True, 17, -1), (False, 17, -1)]


def _k1_k3_call(kernel, d, K, Cm, edge_k, v_real, dtype, dev):
    """(kernel call, plain call, launch counter) of K1 or K3 on ``d``."""
    g = {k: to_torch(v).to(dev) for k, v in d.items()}
    g["pre"] = g["pre"].to(dtype)
    if kernel == "k1":
        args = (g["pre"], g["x1"], g["x2"], g["A"], g["alpha"], g["beta"],
                g.get("ew"), g.get("eb"), g.get("sel"), K, Cm, edge_k, E,
                v_real)
        return (lambda: fused_dyn_graph_agg(*args),
                lambda: reference_dyn_graph_agg(*args), fused_dyn_graph_agg)
    p = {k: to_torch(v).to(dev) for k, v in
         k3_packaging(d, K, Cm, edge_k).items()}
    p["pre2"] = p["pre2"].to(dtype)
    args = (p["pre2"], p["x1t"], g["x2"], g["A"], g["alpha"], g["beta"],
            p.get("p1t"), p.get("p2"), g.get("sel"), p.get("ebias"))
    kw = dict(K=K, Cm=Cm, edge_k=edge_k, edge_num=E, v_real=v_real)
    return (lambda: bd_dyn_graph_agg(*args, **kw),
            lambda: reference_bd_dyn_graph_agg(*args, **kw), bd_dyn_graph_agg)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge,V,v_real", AGG_CASES)
@pytest.mark.parametrize("T", [1, 13, 15, 25, 100])
@pytest.mark.parametrize("kernel,K,Cm", KERNEL_WIDTHS)
def test_cuda_kernel_matches_plain(cuda, kernel, K, Cm, T, edge, V, v_real,
                                   dtype):
    """K1 and K3 under every block plan the widths and lengths give (T = 1,
    below and across the 8-row ring stage, T = 100; N = 1 at T = 15 and
    100): f32 within 1e-4 (summation order), bf16 within 2e-2 against the
    plain version in bf16."""
    edge_k = 1 if edge else -1
    N = 1 if T in (15, 100) else 3
    d = block_inputs(seed=5 + T + Cm, N=N, T=T, V=V, K=K, Cm=Cm, edge=edge)
    kern, plain, wrapper = _k1_k3_call(kernel, d, K, Cm, edge_k, v_real,
                                       dtype, cuda)
    n = wrapper.launches
    got = kern()
    assert wrapper.launches == n + 1
    want = plain()
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_agg_block_matches_planner(cuda):
    """The planner's model of a K1/K3 block (threads, shared memory) is the
    block the kernels launch."""
    lib = ctypes.CDLL(str(_build.compile_kernel("dyn_graph")))
    threads, smem = ctypes.c_int(), ctypes.c_int()
    for V in (1, 18, 25, 26, 32):
        for Cm in (1, 6, 8, 12, 16, 32, 64):
            for CG in [g for g in range(1, min(Cm, 32) + 1) if Cm % g == 0]:
                for esize in (2, 4):
                    lib.dsgcn_agg_block(V, Cm, CG, esize,
                                        ctypes.byref(threads),
                                        ctypes.byref(smem))
                    assert (threads.value, smem.value) == agg_block(
                        V, Cm, CG, esize), (V, Cm, CG, esize)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_cuda_kernel_same_bits_every_call(cuda, kernel, dtype):
    """No atomics: two calls on the same inputs give identical bits."""
    d = block_inputs(seed=3, N=8, T=50, Cm=16, edge=True)
    kern, _, _ = _k1_k3_call(kernel, d, 3, 16, 1, -1, dtype, cuda)
    a, b = kern(), kern()
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32))


@pytest.mark.cuda
def test_cuda_kernels_refuse_grad(cuda):
    """K3 is eval-only: inputs that need a gradient are refused (training
    goes through K1 and K2)."""
    d = block_inputs(seed=6)
    g = {k: to_torch(v).to(cuda) for k, v in d.items()}
    p = {k: to_torch(v).to(cuda) for k, v in
         k3_packaging(d, 3, 8, 1).items()}
    g["x2"].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="eval-only"):
        bd_dyn_graph_agg(p["pre2"], p["x1t"], g["x2"], g["A"], g["alpha"],
                         g["beta"], K=3, Cm=8)


@pytest.mark.cuda
def test_cuda_kernels_refuse_unsupported_sizes(cuda):
    """More joints than the kernels hold raise before any launch."""
    d = {k: to_torch(v).to(cuda) for k, v in
         block_inputs(seed=7, V=33, edge=False).items()}
    n = fused_dyn_graph_agg.launches
    with pytest.raises(ValueError, match="joints"):
        fused_dyn_graph_agg(d["pre"], d["x1"], d["x2"], d["A"], d["alpha"],
                            d["beta"], K=3, Cm=8)
    assert fused_dyn_graph_agg.launches == n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("Cm,T", [(8, 60), (16, 60), (16, 30), (32, 30),
                                  (32, 15)])
def test_cuda_k2_matches_plain(cuda, Cm, T, edge, dtype):
    """K2 at the DS-GCN training block widths (N=8 here; chip_smoke.py
    runs N=256): every gradient within 1e-4 of its largest entry (float32
    sums in another order), a bfloat16 dpre within 8e-3 (one rounding of
    the same float32 sum)."""
    K, edge_k = 3, (1 if edge else -1)
    d = block_inputs(seed=Cm + T, N=8, T=T, Cm=Cm, edge=edge)
    g = {k: to_torch(v).to(cuda) for k, v in d.items()}
    dy = torch.randn(g["pre"].shape, generator=torch.Generator().manual_seed(
        T)).to(cuda)
    g["pre"], dy = g["pre"].to(dtype), dy.to(dtype)
    args = (g["pre"], g["x1"], g["x2"], g["A"], g["alpha"], g["beta"],
            g.get("ew"), g.get("eb"), g.get("sel"), dy, K, Cm, edge_k, E)
    n = fused_dyn_graph_agg_bwd.launches
    got = fused_dyn_graph_agg_bwd(*args)
    assert fused_dyn_graph_agg_bwd.launches == n + 1
    want = reference_dyn_graph_agg_bwd(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype
    for name, a, b in zip(K2_OUTS, got, want):
        if b is None:
            assert a is None, name
            continue
        tol = 8e-3 if name == "dpre" and dtype == torch.bfloat16 else 1e-4
        assert _rel(a, b) <= tol, (name, _rel(a, b))


def _k2_call(cuda, d, K, Cm, edge_k, dtype, seed):
    """K2's arguments on the card from K1-packaged inputs ``d``."""
    g = {k: to_torch(v).to(cuda) for k, v in d.items()}
    dy = torch.randn(g["pre"].shape,
                     generator=torch.Generator().manual_seed(seed)).to(cuda)
    return (g["pre"].to(dtype), g["x1"], g["x2"], g["A"], g["alpha"],
            g["beta"], g.get("ew"), g.get("eb"), g.get("sel"), dy.to(dtype),
            K, Cm, edge_k, E)


def _k2_check(args, dtype):
    """K2 against its plain version: every gradient within 1e-4 of its
    largest entry, a bfloat16 dpre within 8e-3."""
    n = fused_dyn_graph_agg_bwd.launches
    got = fused_dyn_graph_agg_bwd(*args)
    assert fused_dyn_graph_agg_bwd.launches == n + 1
    want = reference_dyn_graph_agg_bwd(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype
    for name, a, b in zip(K2_OUTS, got, want):
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape, name
        tol = 8e-3 if name == "dpre" and dtype == torch.bfloat16 else 1e-4
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,Cm,T,CG,rows,edge", [
    (3, 32, 30, 16, 7, e) for e in (False, True)] + [   # rows, channels split
    (3, 16, 30, 16, 1, e) for e in (False, True)] + [   # a row a block
    (3, 32, 15, 4, 15, e) for e in (False, True)] + [   # narrow groups
    (3, 8, 60, 8, 60, e) for e in (False, True)] + [    # a subset a block
    (8, 64, 15, 8, 4, False)])      # DG-STGCN's widest stage, both split
def test_cuda_k2_plans_match_plain(cuda, monkeypatch, K, Cm, T, CG, rows,
                                   edge, dtype):
    """K2 under plans that split T and channels (the planner's choice
    replaced): the partial sums of every block add up to the gradients."""
    monkeypatch.setattr(dyn_graph, "bwd_plan", lambda *a: (CG, rows))
    d = block_inputs(seed=CG + rows, N=3, T=T, K=K, Cm=Cm, edge=edge)
    _k2_check(_k2_call(cuda, d, K, Cm, 1 if edge else -1, dtype, rows),
              dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,Cm,edge", [(25, 6, True), (25, 6, False),
                                       (18, 16, True), (18, 8, False),
                                       (32, 16, True), (25, 48, True)])
def test_cuda_k2_odd_shapes(cuda, V, Cm, edge, dtype):
    """K2 at widths whose channel runs are not 16-byte aligned (Cm = 6), a
    graph of 18 joints (the joint bound 25 with 7 short), joints padded to
    32, and edge attention at Cm*V = 1200 (one block once held all the
    edge subset's Cm*V channels and joints; no longer)."""
    d = block_inputs(seed=V + Cm, N=4, T=21, V=max(V, 25), Cm=Cm, edge=edge)
    if V < 25:
        d = {k: (v[..., :V, :] if k == "pre" else v[..., :V]
                 if k in ("x1", "x2") else v[..., :V, :V]
                 if k in ("A", "sel") else v) for k, v in d.items()}
    _k2_check(_k2_call(cuda, d, 3, Cm, 1 if edge else -1, dtype, V), dtype)


# the COCO DS-GCN blocks (V = 17): (Cm, T at the GCN) of its three stages
COCO_BLOCKS = [(8, 100), (16, 50), (32, 25)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [True, False])
@pytest.mark.parametrize("N", [4, 10])
@pytest.mark.parametrize("Cm,T", COCO_BLOCKS)
def test_cuda_coco_blocks_match_plain(cuda, Cm, T, N, edge, dtype):
    """K1, K3 and K2 on the COCO graph (17 joints inside the compile-time
    bound 25, no v_real) at the hrnet DS-GCN block widths, with 2 bodies a
    clip (N = 4) and fight detection's 5 (N = 10), edge attention on
    subset 1 (COCO's 15 classes) and off: K1 and K3 within 1e-4 (f32) and
    2e-2 (bf16), K2 as in ``_k2_check``."""
    K, edge_k = 3, (1 if edge else -1)
    d = block_inputs(seed=N + Cm, N=N, T=T, V=17, K=K, Cm=Cm, edge=edge)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for kernel in ("k1", "k3"):
        kern, plain, wrapper = _k1_k3_call(kernel, d, K, Cm, edge_k, -1,
                                           dtype, cuda)
        n = wrapper.launches
        got = kern()
        assert wrapper.launches == n + 1
        torch.testing.assert_close(got.float(), plain().float(), rtol=tol,
                                   atol=tol)
    _k2_check(_k2_call(cuda, d, K, Cm, edge_k, dtype, N), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k2_wide_queries(cuda, dtype):
    """Queries that spread over 40 within a channel underflow the
    exponential tables of ctr: those blocks take tanhf, and K2 still
    matches its plain version."""
    d = block_inputs(seed=12, N=4, T=20, Cm=16, edge=True)
    d["x1"] = d["x1"] * 30
    d["x2"][:, :, 3] = d["x2"][:, :, 3] * 30
    _k2_check(_k2_call(cuda, d, 3, 16, 1, dtype, 12), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge", [False, True])
def test_cuda_k2_same_bits_every_call(cuda, monkeypatch, edge, dtype):
    """No atomics: two calls on the same inputs give identical bits, also
    under a plan whose blocks leave partial sums (T and channels split)."""
    monkeypatch.setattr(dyn_graph, "bwd_plan", lambda *a: (8, 9))
    d = block_inputs(seed=4, N=16, T=30, Cm=16, edge=edge)
    args = _k2_call(cuda, d, 3, 16, 1 if edge else -1, dtype, 4)
    a, b = fused_dyn_graph_agg_bwd(*args), fused_dyn_graph_agg_bwd(*args)
    torch.cuda.synchronize()
    for name, x, y in zip(K2_OUTS, a, b):
        if x is None:
            assert y is None
            continue
        bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(x.view(bits), y.view(bits)), name


@pytest.mark.cuda
def test_cuda_bwd_block_matches_planner(cuda):
    """The planner's model of a K2 contraction block (threads, shared
    memory) is the block the kernel launches."""
    lib = ctypes.CDLL(str(_build.compile_kernel("dyn_graph_bwd")))
    threads, smem = ctypes.c_int(), ctypes.c_int()
    for V in (1, 18, 25, 26, 32):
        for Cm in (1, 6, 8, 16, 32, 64):
            for CG in [g for g in range(1, min(Cm, 32) + 1) if Cm % g == 0]:
                for esize in (2, 4):
                    for E_ in (0, E):
                        lib.dsgcn_bwd_block(V, CG, esize, E_,
                                            ctypes.byref(threads),
                                            ctypes.byref(smem))
                        assert (threads.value, smem.value) == bwd_block(
                            V, CG, esize, E_), (V, Cm, CG, esize, E_)


@pytest.mark.cuda
def test_cuda_function_backward(cuda):
    """fused_dyn_graph_agg under autograd on the card launches K1 forward
    and K2 backward, and its gradients equal the CPU Function's (the plain
    versions) within 1e-4 relative."""
    d = block_inputs(seed=11, N=2, T=12, Cm=8)
    names = ("pre", "x1", "x2", "A", "alpha", "beta", "ew", "eb")
    cpu = [to_torch(d[k]).requires_grad_() for k in names]
    gpu = [t.detach().to(cuda).requires_grad_() for t in cpu]
    sel = to_torch(d["sel"])
    dy = torch.randn(cpu[0].shape, generator=torch.Generator().manual_seed(1))
    n1, n2 = fused_dyn_graph_agg.launches, fused_dyn_graph_agg_bwd.launches
    y = fused_dyn_graph_agg(*gpu, sel.to(cuda), 3, 8, 1, E)
    y.backward(dy.to(cuda))
    assert fused_dyn_graph_agg.launches == n1 + 1
    assert fused_dyn_graph_agg_bwd.launches == n2 + 1
    fused_dyn_graph_agg(*cpu, sel, 3, 8, 1, E).backward(dy)
    for name, a, b in zip(names, gpu, cpu):
        assert _rel(a.grad.cpu(), b.grad) <= 1e-4, name


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda):
    """One train step of a narrow DS-GCN on the card (K1+K2) and on the CPU
    (plain versions) from the same weights and batch: the loss within 1e-4,
    each parameter's update with cosine > 0.995 and norm within 5% (float32
    rounding is amplified by the untrained BatchNorm stacks, as
    tests/test_training_dynamics_parity.py explains)."""
    cfg = model_cfg("dsgcn", num_classes=11)
    cfg["backbone"].update(num_stages=4, base_channels=32,
                           inflate_stages=(3,), down_stages=(3,),
                           gcn_ratio=0.25)
    cfg["cls_head"]["in_channels"] = 64
    gen = torch.Generator().manual_seed(0)
    cpu = init_weights_(build_model(cfg), gen)
    with torch.no_grad():
        for m in cpu.modules():
            if hasattr(m, "alpha"):
                m.alpha.uniform_(-0.3, 0.3, generator=gen)
                m.beta.uniform_(-0.3, 0.3, generator=gen)
    gpu = copy.deepcopy(cpu).to(cuda)
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    rng = np.random.default_rng(0)
    batch = dict(keypoint=rng.standard_normal((4, 2, 16, 25, 3)).astype(
        np.float32), label=rng.integers(0, 11, 4))
    losses = []
    for model in (gpu, cpu):
        opt, sched = make_optimizer(model, total_steps=10)
        losses.append(train_step(model, opt, sched, batch)["loss"].item())
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    got = gpu.state_dict()
    for name, p in cpu.named_parameters():
        du_want = (p.detach() - init[name]).ravel()
        du_got = (got[name].cpu() - init[name]).ravel()
        cos = (du_got @ du_want / (du_got.norm() * du_want.norm())).item()
        assert cos > 0.995, (name, cos)
        assert abs(du_got.norm() / du_want.norm() - 1) < 5e-2, name


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["aagcn", "ctrgcn"])
def test_cuda_family_matches_cpu(cuda, family):
    """A narrow AAGCN or CTR-GCN (three blocks: 3 -> 16, 16 -> 16, 16 -> 32
    at stride 2) on the card against the CPU from the same weights: eval
    logits within 1e-4 of the largest, no kernel of the port launched (the
    families have none), and one train step as in
    test_cuda_train_step_matches_cpu.  The gates, the attention's
    zero-initialised convs and the units' closing BN scales (1e-6) are
    moved off their initial values first: at them, the gradients of the
    units' inner parameters are rounding noise (a float32 step on the CPU
    is as far from a float64 one there as from the card's)."""
    from dsgcn_tpu_torch.ops.kernels import launch_counts
    cfg = model_cfg(family, num_classes=11)
    cfg["backbone"].update(num_stages=3, base_channels=16,
                           inflate_stages=(3,), down_stages=(3,))
    cfg["cls_head"]["in_channels"] = 32
    gen = torch.Generator().manual_seed(1)
    cpu = init_weights_(build_model(cfg), gen)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith("alpha"):
                p.uniform_(-0.3, 0.3, generator=gen)
            elif name.endswith(("conv_ta.weight", "fc2c.weight")):
                p.uniform_(-0.1, 0.1, generator=gen)
            elif name.endswith("gcn.bn.weight"):
                p.uniform_(0.2, 0.4, generator=gen)
    gpu = copy.deepcopy(cpu).to(cuda)
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    rng = np.random.default_rng(1)
    batch = dict(keypoint=rng.standard_normal((4, 2, 16, 25, 3)).astype(
        np.float32), label=rng.integers(0, 11, 4))
    x = torch.from_numpy(batch["keypoint"])
    before = launch_counts()
    with torch.no_grad():
        got = gpu.eval()(x.to(cuda)).cpu()
        want = cpu.eval()(x)
    assert _rel(got, want) <= 1e-4
    losses = []
    for model in (gpu, cpu):
        opt, sched = make_optimizer(model.train(), total_steps=10)
        losses.append(train_step(model, opt, sched, batch)["loss"].item())
    assert launch_counts() == before
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    got = gpu.state_dict()
    for name, p in cpu.named_parameters():
        du_want = (p.detach() - init[name]).ravel()
        du_got = (got[name].cpu() - init[name]).ravel()
        cos = (du_got @ du_want / (du_got.norm() * du_want.norm())).item()
        assert cos > 0.995, (name, cos)
        assert abs(du_got.norm() / du_want.norm() - 1) < 5e-2, name


# ---------------------------------------------------------------------------
# DG-STGCN: K4, K5, K6 and K2 at Cm = 64
# ---------------------------------------------------------------------------

def _tol(dtype):
    """f32: 1e-4 of the largest output (summation order); bf16: 2e-2 (one
    bf16 rounding of the output, or of pre and the graph, either way)."""
    return 1e-4 if dtype == torch.float32 else 2e-2


def _on(cuda, d, *names):
    return [to_torch(d[k]).to(cuda) for k in names]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,v_real,g", [(25, -1, None), (25, -1, 32),
                                        (32, 25, 32)])
def test_cuda_k4_matches_plain(cuda, V, v_real, g, dtype):
    """K4 at DG-STGCN's widest width (K = 8, Cm = 64), g = Cm and g = 32,
    and with padded joints masked out of the softmax."""
    K, Cm = 8, 64
    d = block_inputs(seed=40 + V, N=4, T=25, V=V, K=K, Cm=Cm, edge=False)
    if v_real > 0:
        d["pre"][:, :, v_real:] = 0
    p = k3_packaging(d, K, Cm, -1)
    pre2, x1t = _on(cuda, p, "pre2", "x1t")
    args = [pre2.to(dtype), x1t] + _on(cuda, d, "x2", "A", "alpha", "beta")
    kw = dict(K=K, Cm=Cm, g=g, v_real=v_real)
    n = bd_dyn_graph_agg_subset.launches
    got = bd_dyn_graph_agg_subset(*args, **kw)
    assert bd_dyn_graph_agg_subset.launches == n + 1
    want = reference_bd_dyn_graph_agg_subset(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel(got, want) <= _tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cm", [(64, 16), (128, 32), (256, 64)])
def test_cuda_k5_matches_plain(cuda, C, Cm, dtype):
    """K5 at DG-STGCN's block widths (K = 8): w_pre in x's dtype, b_pre
    float32."""
    K = 8
    d = block_inputs(seed=C, N=4, T=20, K=K, Cm=Cm, edge=False)
    gen = torch.Generator().manual_seed(C)
    x = torch.randn(4, 20, 25, C, generator=gen).to(cuda, dtype)
    w_pre = (torch.randn(C, K * Cm, generator=gen) / C ** 0.5).to(cuda,
                                                                   dtype)
    b_pre = (0.1 * torch.randn(K * Cm, generator=gen)).to(cuda)
    args = [x, w_pre, b_pre] + _on(cuda, d, "x1", "x2", "A", "alpha", "beta")
    n = fused_dyn_graph_agg_eval.launches
    got = fused_dyn_graph_agg_eval(*args, K=K, Cm=Cm)
    assert fused_dyn_graph_agg_eval.launches == n + 1
    want = reference_dyn_graph_agg_eval(*args, K=K, Cm=Cm)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel(got, want) <= _tol(dtype)


def _k6_args(cuda, dtype, C, Cout, K, Cm, down, edge, seed, N=4, T=12):
    d = block_inputs(seed=seed, N=N, T=T, K=K, Cm=Cm, edge=edge)
    gen = torch.Generator().manual_seed(seed)
    w = lambda *s: (torch.randn(*s, generator=gen) / s[0] ** 0.5).to(  # noqa
        cuda)
    x = torch.randn(N, T, 25, C, generator=gen).to(cuda, dtype)
    args = [x] + _on(cuda, d, "x1", "x2") + [w(C, K * Cm), w(K * Cm)] + \
        _on(cuda, d, "A", "alpha", "beta") + [w(K * Cm, Cout), w(Cout)] + \
        ([w(C, Cout), w(Cout)] if down else [None, None])
    kw = dict(K=K, Cm=Cm)
    if edge:
        ew, eb, sel = _on(cuda, d, "ew", "eb", "sel")
        kw.update(edge_w=ew, edge_b=eb, edge_sel=sel, edge_k=1, edge_num=E)
    return args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cout,K,Cm,down,edge", [
    (3, 64, 8, 16, True, False), (128, 256, 8, 64, True, False),
    (256, 256, 8, 64, False, False), (64, 128, 3, 16, True, True),
    (256, 256, 3, 32, False, True)])
def test_cuda_k6_matches_plain(cuda, C, Cout, K, Cm, down, edge, dtype):
    """K6 at DG-STGCN's block widths (K = 8, with and without the down
    path) and DS-GCN's with edge attention (K = 3)."""
    args, kw = _k6_args(cuda, dtype, C, Cout, K, Cm, down, edge, seed=C + Cm)
    n = fused_dggcn_block_eval.launches
    got = fused_dggcn_block_eval(*args, **kw)
    assert fused_dggcn_block_eval.launches == n + 1
    want = reference_dggcn_block_eval(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert _rel(got, want) <= _tol(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Cm,T", [(32, 30), (64, 15)])
def test_cuda_k2_wide_matches_plain(cuda, Cm, T, dtype):
    """K2 at DG-STGCN's training widths (K = 8, no edge attention): at
    Cm = 64 the planner splits each subset's channels over blocks."""
    K = 8
    d = block_inputs(seed=Cm + T, N=4, T=T, K=K, Cm=Cm, edge=False)
    pre, x1, x2, A, a, b = _on(cuda, d, "pre", "x1", "x2", "A", "alpha",
                               "beta")
    dy = torch.randn(pre.shape, generator=torch.Generator().manual_seed(T))
    args = (pre.to(dtype), x1, x2, A, a, b, None, None, None,
            dy.to(cuda, dtype), K, Cm, -1, E)
    got = fused_dyn_graph_agg_bwd(*args)
    want = reference_dyn_graph_agg_bwd(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(K2_OUTS[:6], got, want):
        tol = 8e-3 if name == "dpre" and dtype == torch.bfloat16 else 1e-4
        assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.mark.cuda
def test_cuda_eval_kernels_refuse_grad(cuda):
    """K4, K5 and K6 are eval-only, as K3 is."""
    args, kw = _k6_args(cuda, torch.float32, 16, 16, 3, 8, False, False, 50)
    args[1].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="eval-only"):
        fused_dggcn_block_eval(*args, **kw)
    x, x1, x2, w_pre, b_pre, A, a, b = args[:8]
    with pytest.raises(NotImplementedError, match="eval-only"):
        fused_dyn_graph_agg_eval(x, w_pre, b_pre, x1, x2, A, a, b, K=3, Cm=8)
    pre2 = torch.zeros(4, 12, 25 * 24, device=cuda)
    with pytest.raises(NotImplementedError, match="eval-only"):
        bd_dyn_graph_agg_subset(pre2, x1.detach().transpose(-1, -2), x1, A,
                                a, b, K=3, Cm=8)


@pytest.mark.cuda
def test_cuda_new_kernels_refuse_unsupported_sizes(cuda):
    """Where the kernels cannot go, the wrappers raise before a launch: K2's
    edge subset beyond the 127 channels its edge products take, a K6 whose
    x tile overflows shared memory at the fewest rows (C = 2048 in float32;
    K*Cm no longer limits K6, which walks it in chunks), K5 beyond its input
    channels, a K4 group that is no multiple of 8."""
    d = block_inputs(seed=51, N=2, T=4, Cm=128, edge=True)
    pre, x1, x2, A, a, b, ew, eb, sel = _on(
        cuda, d, "pre", "x1", "x2", "A", "alpha", "beta", "ew", "eb", "sel")
    n2 = fused_dyn_graph_agg_bwd.launches
    with pytest.raises(ValueError, match="127"):
        fused_dyn_graph_agg_bwd(pre, x1, x2, A, a, b, ew, eb, sel, pre, 3,
                                128, 1, E)
    assert fused_dyn_graph_agg_bwd.launches == n2
    d = block_inputs(seed=51, N=2, T=4, Cm=48, edge=True)
    pre, x1, x2, A, a, b = _on(cuda, d, "pre", "x1", "x2", "A", "alpha",
                               "beta")
    args, kw = _k6_args(cuda, torch.float32, 2048, 64, 3, 8, True, False,
                        52, N=1, T=2)
    n6 = fused_dggcn_block_eval.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_dggcn_block_eval(*args, **kw)
    assert fused_dggcn_block_eval.launches == n6
    x = torch.zeros(1, 2, 25, 4096, device=cuda)
    with pytest.raises(ValueError, match="input channels"):
        fused_dyn_graph_agg_eval(x, torch.zeros(4096, 24, device=cuda),
                                 torch.zeros(24, device=cuda), x1[:1],
                                 x2[:1], A, a, b, K=3, Cm=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        bd_dyn_graph_agg_subset(torch.zeros(2, 4, 25 * 3 * 48, device=cuda),
                                x1.transpose(-1, -2).contiguous(), x2, A, a,
                                b, K=3, Cm=48, g=12)


# K5 and K6 at the serving shapes of chip_smoke.py (every distinct DG-STGCN
# and DS-GCN block: C in, C out, mid, T), N = 2
K5_SHAPES = sorted({(C, Cm, T) for C, _, Cm, T in DG_BLOCKS})
K6_SHAPES = sorted({(C, Cout, DG_K, Cm, T, False)
                    for C, Cout, Cm, T in DG_BLOCKS}
                   | {(C, Cout, 3, Cm, T, True)
                      for C, Cout, Cm, T in DS_BLOCKS})


def _k5_args(cuda, dtype, C, K, Cm, seed, N=2, T=12, V=25):
    d = block_inputs(seed=seed, N=N, T=T, V=V, K=K, Cm=Cm, edge=False)
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(N, T, V, C, generator=gen).to(cuda, dtype)
    w_pre = (torch.randn(C, K * Cm, generator=gen) / C ** 0.5).to(cuda,
                                                                   dtype)
    b_pre = (0.1 * torch.randn(K * Cm, generator=gen)).to(cuda)
    return [x, w_pre, b_pre] + _on(cuda, d, "x1", "x2", "A", "alpha", "beta")


def _check(fn, args, kw, plain, dtype):
    """One launch of ``fn``, held to its plain version (``_tol``)."""
    n = fn.launches
    got = fn(*args, **kw)
    assert fn.launches == n + 1
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert _rel(got, want) <= _tol(dtype), _rel(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cm,T", K5_SHAPES)
def test_cuda_k5_serving_shapes_match_plain(cuda, C, Cm, T, dtype):
    """K5 at every DG-STGCN block shape (K = 8), the stem's C = 3 too,
    under the planner's plan."""
    args = _k5_args(cuda, dtype, C, 8, Cm, seed=C + Cm + T, T=T)
    _check(fused_dyn_graph_agg_eval, args, dict(K=8, Cm=Cm),
           reference_dyn_graph_agg_eval, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cout,K,Cm,T,edge", K6_SHAPES)
def test_cuda_k6_serving_shapes_match_plain(cuda, C, Cout, K, Cm, T, edge,
                                            dtype):
    """K6 at every DG-STGCN block shape (K = 8) and every DS-GCN one (K = 3,
    edge attention on subset 1), the down path where channels change."""
    args, kw = _k6_args(cuda, dtype, C, Cout, K, Cm, C != Cout, edge,
                        seed=C + Cout + Cm + T, N=2, T=T)
    _check(fused_dggcn_block_eval, args, kw, reference_dggcn_block_eval,
           dtype)


# plans forced on K5 and K6 (frames, rows): tiles of 2, 5 and 10 frames
# against T = 7, 12 and 25, the last tile short in all but (5, 25) and
# (12, ...) of 2
FORCED_TILES = [(2, 64), (5, 128), (10, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("TT,R", FORCED_TILES)
@pytest.mark.parametrize("T", [7, 12, 25])
def test_cuda_k5_ragged_tiles(cuda, monkeypatch, T, TT, R, dtype):
    """K5 with frame tiles that do not divide T (and the planner's own
    plan), chunks of one subset's channels (C 64, K 8, Cm 16)."""
    args = _k5_args(cuda, dtype, 64, 8, 16, seed=T + TT, N=3, T=T)
    kw = dict(K=8, Cm=16)
    _check(fused_dyn_graph_agg_eval, args, kw, reference_dyn_graph_agg_eval,
           dtype)
    monkeypatch.setattr(dyn_graph, "eval_plan",
                        lambda *a: (min(TT, T), R, 16))
    _check(fused_dyn_graph_agg_eval, args, kw, reference_dyn_graph_agg_eval,
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("TT,R", FORCED_TILES)
@pytest.mark.parametrize("T", [7, 12, 25])
def test_cuda_k6_ragged_tiles(cuda, monkeypatch, T, TT, R, dtype):
    """K6 with frame tiles that do not divide T (and the planner's own
    plan): C 64 -> 128 with the down path, K 8, Cm 16, chunks of 16."""
    args, kw = _k6_args(cuda, dtype, 64, 128, 8, 16, True, False,
                        seed=T + TT, N=3, T=T)
    _check(fused_dggcn_block_eval, args, kw, reference_dggcn_block_eval,
           dtype)
    monkeypatch.setattr(dggcn_block, "block_plan",
                        lambda *a: (min(TT, T), R, 16, 0.0))
    _check(fused_dggcn_block_eval, args, kw, reference_dggcn_block_eval,
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,Cout,K,Cm,edge", [
    (3, 64, 8, 16, False), (3, 3, 8, 16, False), (3, 64, 3, 8, True),
    (3, 3, 3, 8, True), (5, 24, 3, 6, True), (40, 40, 3, 6, False)])
def test_cuda_k6_stem_and_odd_widths(cuda, C, Cout, K, Cm, edge, dtype):
    """K6 at the C = 3 stem with the down path and without it (C == Cout),
    the edge subset on K = 3, and widths that are no multiple of 8 (depth,
    chunk and output padding), T = 7."""
    args, kw = _k6_args(cuda, dtype, C, Cout, K, Cm, C != Cout, edge,
                        seed=C + Cout, N=2, T=7)
    _check(fused_dggcn_block_eval, args, kw, reference_dggcn_block_eval,
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,K,Cm,V,v_real", [
    (3, 8, 16, 25, -1), (6, 3, 6, 25, -1), (64, 8, 16, 32, 25),
    (64, 3, 8, 18, -1)])
def test_cuda_k5_stem_and_odd_widths(cuda, C, K, Cm, V, v_real, dtype):
    """K5 at the C = 3 stem, widths that are no multiple of 8, joints padded
    25 -> 32 and masked out of the softmax (v_real), and 18 joints."""
    args = _k5_args(cuda, dtype, C, K, Cm, seed=C + V, N=2, T=7, V=V)
    _check(fused_dyn_graph_agg_eval, args, dict(K=K, Cm=Cm, v_real=v_real),
           reference_dyn_graph_agg_eval, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k5_k6_same_bits_every_call(cuda, dtype):
    """No atomics: two calls of K5 and of K6 (with the edge subset) on the
    same inputs give identical bits."""
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    args = _k5_args(cuda, dtype, 128, 8, 32, seed=1, N=4, T=25)
    a = fused_dyn_graph_agg_eval(*args, K=8, Cm=32)
    b = fused_dyn_graph_agg_eval(*args, K=8, Cm=32)
    args, kw = _k6_args(cuda, dtype, 128, 256, 3, 32, True, True, seed=2,
                        N=4, T=25)
    c = fused_dggcn_block_eval(*args, **kw)
    d = fused_dggcn_block_eval(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a.view(view), b.view(view))
    assert torch.equal(c.view(view), d.view(view))


@pytest.mark.cuda
def test_cuda_k5_k6_blocks_match_planner(cuda):
    """The planners' model of a K5 and a K6 block (shared memory, and the
    plans the kernels refuse) is the block the kernels launch."""
    k6 = ctypes.CDLL(str(_build.compile_kernel("dggcn_block")))
    k5 = ctypes.CDLL(str(_build.compile_kernel("dyn_graph_eval")))
    threads, smem = ctypes.c_int(), ctypes.c_int()
    for V in (18, 25, 32):
        for R in dyn_graph.PW_ROWS:
            TT = max(1, R // V)
            for C, Cout, K, Cm in ((3, 64, 8, 16), (64, 128, 8, 32),
                                   (256, 256, 8, 64), (128, 128, 3, 16),
                                   (40, 24, 3, 6), (1024, 64, 3, 8)):
                for CH in dyn_graph.pw_chunks(K, Cm):
                    for xsize in (2, 4):
                        k6.dsgcn_dggcn_block_geometry(
                            V, C, K, Cm, Cout, xsize, TT, R, CH,
                            int(C != Cout), ctypes.byref(threads),
                            ctypes.byref(smem))
                        assert threads.value == _build.PW_THREADS
                        assert smem.value == dggcn_block.block_smem(
                            V, C, K, Cm, Cout, xsize, R, CH), (
                            V, R, C, Cout, K, Cm, CH, xsize)
                        k5.dsgcn_eval_block_geometry(
                            V, C, K, Cm, xsize, TT, R, CH,
                            ctypes.byref(threads), ctypes.byref(smem))
                        assert threads.value == _build.PW_THREADS
                        assert smem.value == dyn_graph.eval_block(
                            V, C, K, Cm, xsize, R, CH), (
                            V, R, C, K, Cm, CH, xsize)


@pytest.mark.cuda
def test_cuda_dgstgcn_eval_options_match_cpu(cuda):
    """A narrow DG-STGCN (K = 8, mid 16/32) on the card: every eval_kernel
    gives the CPU model's logits within 1e-4 relative (float32 sums in
    another order through four blocks) and launches its kernel once per
    block."""
    cfg = model_cfg("dgstgcn", num_classes=11)
    cfg["backbone"].update(num_stages=4, base_channels=64,
                           inflate_stages=(3,), down_stages=(3,))
    cfg["cls_head"]["in_channels"] = 128
    cpu = init_weights_(build_model(cfg), torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in cpu.modules():
            if hasattr(m, "alpha"):
                m.alpha.uniform_(-0.5, 0.5)
                m.beta.uniform_(-0.5, 0.5)
    cpu.eval()
    x = torch.randn(2, 2, 16, 25, 3, generator=torch.Generator().manual_seed(
        1))
    with torch.no_grad():
        want = cpu(x)
    kernels = {"bd": bd_dyn_graph_agg, "bdps": bd_dyn_graph_agg_subset,
               "bdg": bd_dyn_graph_agg_subset, "fused": fused_dyn_graph_agg,
               "fusedpre": fused_dyn_graph_agg_eval,
               "mega": fused_dggcn_block_eval}
    for ek, fn in kernels.items():
        gpu = copy.deepcopy(cpu).to(cuda)
        for m in gpu.modules():
            if hasattr(m, "eval_kernel"):
                m.eval_kernel = ek
        n = fn.launches
        with torch.no_grad():
            got = gpu(x.to(cuda))
        torch.cuda.synchronize()
        # fusedpre: K5 where c >= 64 (three of four blocks), K1 in the stem
        assert fn.launches - n == (3 if ek == "fusedpre" else 4), ek
        assert _rel(got.cpu(), want) <= 1e-4, (ek, _rel(got.cpu(), want))


# ---------------------------------------------------------------------------
# K7: the fused multi-branch temporal conv
# ---------------------------------------------------------------------------

def _k7_args(cuda, dtype, C, T, coeff, seed, N=4, Cin=None, mid=None, V=25):
    """x (N, T, V, Cin) and the folded weights of a Cin -> C region (Cin =
    C, mid C // 6 unless given; rem = C - 5 mid)."""
    gen = torch.Generator().manual_seed(seed)
    Cin = C if Cin is None else Cin
    mid = C // 6 if mid is None else mid
    rem = C - 5 * mid
    P = rem + 4 * mid

    def w(*s):
        return (torch.randn(*s, generator=gen) / s[-2] ** 0.5).to(cuda)

    def b(n):
        return (0.1 * torch.randn(n, generator=gen)).to(cuda)

    def a(n):
        return (0.5 + torch.rand(n, generator=gen)).to(cuda)
    widths = (rem, mid, mid, mid)
    x = torch.randn(N, T, V, Cin, generator=gen).to(cuda, dtype)
    args = [x, w(Cin, P), b(P), [w(3, cb, cb) for cb in widths],
            [b(cb) for cb in widths], w(Cin, mid), b(mid), a(C), b(C),
            w(C, C), b(C), a(C), b(C)]
    c = (torch.rand(V, generator=gen) - 0.5).to(cuda) if coeff else None
    return args + [c]


# of the largest output: float32, the same sums in another order (the
# products 3xTF32); bfloat16, the output is rounded to bf16 once on both
# sides, and a sum in another order may round the other way
K7_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _k7_check(args, stride, dtype):
    n = fused_dgmstcn_eval.launches
    got = fused_dgmstcn_eval(*args, stride=stride)
    assert fused_dgmstcn_eval.launches == n + 1
    want = reference_fused_dgmstcn_eval(*args, stride=stride)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert bool(torch.isfinite(got.float()).all())
    assert _rel(got, want) <= K7_TOL[dtype], _rel(got, want)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,T,stride,coeff", [
    (64, 100, 1, True), (128, 51, 2, False), (256, 25, 2, True)])
def test_cuda_k7_matches_plain(cuda, C, T, stride, coeff, dtype):
    """K7 at STGCN++ / DG-STGCN widths, with and without the pseudo-joint,
    stride 1 and 2 (odd T): f32 within 1e-5 of the largest output, bf16
    within 2e-2 (``K7_TOL``)."""
    _k7_check(_k7_args(cuda, dtype, C, T, coeff, seed=C + T), stride, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("coeff", [False, True])
@pytest.mark.parametrize("C,T,stride", [s[:3] for s in TCN_SHAPES])
def test_cuda_k7_serving_shapes_match_plain(cuda, monkeypatch, C, T, stride,
                                            coeff, dtype):
    """K7 at every temporal unit shape of chip_smoke.py (STGCN++ without
    the pseudo-joint, DG-STGCN / DS-GCN with it) under the plans the
    planner makes for N = 128, on N = 3 samples."""
    plan = ms_tcn.tile_plan
    monkeypatch.setattr(ms_tcn, "tile_plan",
                        lambda N, *a, **k: plan(128, *a, **k))
    _k7_check(_k7_args(cuda, dtype, C, T, coeff, seed=C + T + stride, N=3),
              stride, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("coeff", [False, True])
@pytest.mark.parametrize("V,C,T,stride,N", [
    (21, 64, 10, 1, 64), (21, 128, 10, 2, 64), (21, 128, 5, 1, 64),
    (17, 64, 100, 1, 128), (17, 128, 100, 2, 128), (17, 128, 50, 1, 128),
    (17, 256, 50, 2, 128), (17, 256, 25, 1, 128)])
def test_cuda_k7_hand_and_coco_shapes_match_plain(cuda, monkeypatch, V, C, T,
                                                  stride, N, coeff, dtype):
    """K7 at the joint counts of the gesture config (the MediaPipe hand, V
    = 21: its clip of 10 frames, 5 after the stride-2 block; N = 64
    skeletons a serving batch) and of the hrnet configs (COCO, V = 17;
    STGCN++'s temporal units at b64 x M2 x T100), under the plans the
    planner makes for N skeletons, on N = 3."""
    plan = ms_tcn.tile_plan
    monkeypatch.setattr(ms_tcn, "tile_plan",
                        lambda n, *a, **k: plan(N, *a, **k))
    _k7_check(_k7_args(cuda, dtype, C, T, coeff, seed=V + C + T, N=3, V=V),
              stride, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,stride,TO,JR", [
    (23, 1, 7, 3), (23, 2, 5, 4), (37, 1, 13, 12), (37, 2, 19, 2),
    (9, 1, 1, 1), (12, 2, 6, 7)])
def test_cuda_k7_ragged_tiles(cuda, monkeypatch, T, stride, TO, JR, dtype):
    """K7 with frame tiles that do not divide the output frames and joint
    groups that do not divide 25 (the last tile and group short), halos
    that cross the sequence's ends, and one frame a tile, with and without
    the pseudo-joint (C 64)."""
    monkeypatch.setattr(ms_tcn, "tile_plan",
                        lambda *a, **k: (1, 1) if k.get("mean") else (TO, JR))
    for coeff in (False, True):
        _k7_check(_k7_args(cuda, dtype, 64, T, coeff, seed=T + TO, N=2),
                  stride, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Cin,C,mid,stride", [
    (30, 30, 5, 1), (45, 45, 7, 2), (66, 66, 11, 1), (30, 64, 10, 2),
    (130, 93, 15, 1)])
def test_cuda_k7_odd_widths(cuda, Cin, C, mid, stride, dtype):
    """Branch widths (mid, rem) and C' that are no multiple of 8, input
    channels that are no multiple of 4 (x read element by element) and
    Cin != C', with the pseudo-joint and without."""
    for coeff in (False, True):
        _k7_check(_k7_args(cuda, dtype, C, 17, coeff, seed=Cin + C, N=2,
                           Cin=Cin, mid=mid), stride, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_k7_same_bits_every_call(cuda, dtype):
    """No atomics: two calls on the same inputs give identical bits."""
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for C, T, stride, coeff in ((64, 40, 1, True), (256, 25, 2, False)):
        args = _k7_args(cuda, dtype, C, T, coeff, seed=5, N=4)
        a = fused_dgmstcn_eval(*args, stride=stride)
        b = fused_dgmstcn_eval(*args, stride=stride)
        torch.cuda.synchronize()
        assert torch.equal(a.view(view), b.view(view))


@pytest.mark.cuda
def test_cuda_k7_refuses(cuda):
    """A wrong shape or type, inputs that need a gradient, and a width no
    block fits (the planner's refusal) raise before a launch."""
    args = _k7_args(cuda, torch.float32, 64, 8, True, seed=1)
    n = fused_dgmstcn_eval.launches
    bad = list(args)
    bad[9] = args[9][:, :32]                      # w_tc (C', C'/2)
    with pytest.raises(ValueError, match="w_tc"):
        fused_dgmstcn_eval(*bad)
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError):
        fused_dgmstcn_eval(*bad)
    wide = _k7_args(cuda, torch.float32, 3000, 4, False, seed=2, N=1, Cin=8,
                    mid=300)
    with pytest.raises(ValueError, match="shared memory"):
        fused_dgmstcn_eval(*wide)
    args[1].requires_grad_(True)
    with pytest.raises(NotImplementedError, match="eval-only"):
        fused_dgmstcn_eval(*args)
    assert fused_dgmstcn_eval.launches == n


@pytest.mark.cuda
def test_cuda_k7_block_matches_planner(cuda):
    """The planner's model of a K7 block (shared memory, and the plans the
    kernel refuses) is the block the kernel launches."""
    lib = ctypes.CDLL(str(_build.compile_kernel("ms_tcn")))
    threads, smem = ctypes.c_int(), ctypes.c_int()
    for C, mid, T, stride in ((64, 10, 100, 1), (128, 21, 100, 2),
                              (256, 42, 25, 1), (45, 7, 17, 2)):
        rem = C - 5 * mid
        for TO in (1, 3, 13, 25, 50):
            for JR in (1, 2, 5, 25):
                for xsize in (2, 4):
                    lib.dsgcn_ms_tcn_geometry(
                        T, C, rem, mid, stride, 4, TO, JR, xsize,
                        ctypes.byref(threads), ctypes.byref(smem))
                    assert threads.value == _build.PW_THREADS
                    assert smem.value == ms_tcn.tile_smem(
                        T, C, rem, mid, stride, 4, TO, JR, xsize), (
                        C, T, stride, TO, JR, xsize)


@pytest.mark.cuda
def test_cuda_mstcn_launches_k7_once(cuda):
    """An eval MSTCN with use_pallas=True on the card, given a permuted
    (non-contiguous) input as UnitGCN's einsum may leave it: one K7 launch
    per forward, the CPU module's output within 1e-4 of its largest entry
    (float32 sums in another order, through cuDNN and cuBLAS on the
    module side)."""
    gen = torch.Generator().manual_seed(2)
    cpu = MSTCN(64, 64, stride=2)
    init_weights_(cpu, gen)
    cpu.eval()
    x = torch.randn(2, 20, 64, 25, generator=gen).transpose(-1, -2)
    with torch.no_grad():
        want = cpu(x)
        gpu = copy.deepcopy(cpu).to(cuda)
        gpu.use_pallas = True
        n = fused_dgmstcn_eval.launches
        got = gpu(x.to(cuda))
    torch.cuda.synchronize()
    assert fused_dgmstcn_eval.launches == n + 1
    assert _rel(got.cpu(), want) <= 1e-4


# ---------------------------------------------------------------------------
# the kernels as custom ops: opcheck, serving export, joint padding
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", list(opcheck_cases("cpu")))
def test_cuda_opcheck(cuda, case):
    """Schema, fake implementation (shapes, dtypes, strides) and dispatch
    of each kernel's custom op on CUDA tensors (the kernel)."""
    op, args = opcheck_cases(cuda)[case]
    torch.library.opcheck(op, args)


def _narrow_on_cpu(name, **backbone):
    """A narrow recognizer (four blocks, 64/128 wide) with seeded weights
    and gates off zero, in eval on the CPU."""
    cfg = model_cfg(name, num_classes=11)
    cfg["backbone"].update(num_stages=4, base_channels=64,
                           inflate_stages=(3,), down_stages=(3,), **backbone)
    cfg["cls_head"]["in_channels"] = 128
    cpu = init_weights_(build_model(cfg), torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in cpu.modules():
            if hasattr(m, "alpha") and hasattr(m, "beta"):
                m.alpha.uniform_(-0.5, 0.5, generator=gen)
                m.beta.uniform_(-0.5, 0.5, generator=gen)
    return cpu.eval()


@pytest.mark.cuda
def test_cuda_dsgcn_artifact_launches_k3(cuda, tmp_path):
    """A narrow DS-GCN exported on the card (dynamic batch) and served from
    the artifact: K3 once a block a forward, counted inside the op, and the
    live module's logits within 1e-5 relative."""
    model = _narrow_on_cpu("dsgcn").to(cuda)
    x = torch.randn(3, 2, 16, 25, 3, generator=torch.Generator().manual_seed(
        2))
    with torch.no_grad():
        want = model(x.to(cuda)).cpu()
    man = export_recognizer(model, str(tmp_path), sample_shape=(2, 16, 25, 3))
    assert man["polymorphic_batch"] and man["device"] == "cuda"
    served = load_exported(str(tmp_path))
    n = bd_dyn_graph_agg.launches
    got = torch.from_numpy(served.logits(x.numpy()))
    assert bd_dyn_graph_agg.launches - n == model.backbone.num_blocks
    assert _rel(got, want) <= 1e-5, _rel(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name,ek,fn", [
    ("dsgcn", "auto", bd_dyn_graph_agg), ("dsgcn", "fused",
                                          fused_dyn_graph_agg),
    ("dgstgcn", "auto", fused_dyn_graph_agg),
    ("dgstgcn", "bdg", bd_dyn_graph_agg_subset)])
def test_cuda_padded_modules_match_cpu(cuda, name, ek, fn):
    """The joint-padded model on the card, which runs at the real joints:
    its kernel (K3 with edge attention, K1 with and without it, K4) once
    a block, the CPU's unpadded logits within 1e-4 relative."""
    cpu = _narrow_on_cpu(name, gcn_eval_kernel=ek)
    x = torch.randn(2, 2, 16, 25, 3, generator=torch.Generator().manual_seed(
        3))
    with torch.no_grad():
        want = cpu(x)
    gpu = to_padded_inference(copy.deepcopy(cpu).to(cuda))
    n = fn.launches
    with torch.no_grad():
        got = gpu(x.to(cuda)).cpu()
    assert fn.launches - n == cpu.backbone.num_blocks
    assert _rel(got, want) <= 1e-4, _rel(got, want)


# ---------------------------------------------------------------------------
# the joint partition's collectives at world size 1 (NCCL)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-process NCCL group on the card and its (1, 1) mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from dsgcn_tpu_torch.parallel import mesh as pmesh
    store = tmp_path_factory.mktemp("nccl") / "store"
    pmesh.init_distributed("nccl", "cuda:0", init_method=f"file://{store}",
                           rank=0, world_size=1)
    try:
        yield pmesh.make_mesh(1, 1)
    finally:
        pmesh.release_mesh()
        torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_cuda_ring_permute_backward_is_its_transpose(cuda, nccl_mesh):
    """At G = 1 the ring step is the identity permutation: the autograd
    Function returns the block and its backward the cotangent (the
    permutation's transpose), in float32 and under gradcheck in float64."""
    from dsgcn_tpu_torch.parallel.joint_partition import ring_permute
    group = nccl_mesh.axis("graph").group
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4, 6, 5, 3, 8, device=cuda, generator=gen,
                    requires_grad=True)
    y = ring_permute(x, group).wait()
    g = torch.randn(y.shape, device=cuda, generator=gen)
    (dx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(y.detach(), x.detach()) and torch.equal(dx, g)
    x64 = torch.randn(2, 3, 5, 3, 2, device=cuda, dtype=torch.float64,
                      requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda t: ring_permute(t, group).wait() * 2.0, (x64,))


@pytest.mark.cuda
def test_cuda_synced_batchnorm_matches_unsynced(cuda, nccl_mesh):
    """BatchNorm(axis_name='graph') with DGMSTCN's per-location weight
    (1 for the joints, 1/G = 1 for the appended one) at world size 1
    against the unsynced BatchNorm: output, input and parameter gradients
    and running statistics; and a general weight against the weighted
    statistics written out."""
    from dsgcn_tpu_torch.ops.common import BatchNorm
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(4, 6, 26, 16, device=cuda, generator=gen) * 2 + 0.5
    g = torch.randn(x.shape, device=cuda, generator=gen)
    outs = []
    for bn, w in ((BatchNorm(16), None),
                  (BatchNorm(16, axis_name="graph"), torch.ones(26, 1))):
        bn = bn.to(cuda).train()
        xi = x.clone().requires_grad_(True)
        y = bn(xi, None if w is None else w.to(cuda))
        y.backward(g)
        outs.append((y.detach(), xi.grad, bn.weight.grad, bn.bias.grad,
                     bn.running_mean.clone(), bn.running_var.clone()))
    for got, want in zip(*outs[::-1]):
        assert _rel(got, want) <= 1e-6, _rel(got, want)
    w = torch.rand(26, 1, device=cuda, generator=gen) + 0.5
    bn = BatchNorm(16, axis_name="graph").to(cuda).train()
    y = bn(x, w)
    wx = w.expand(4, 6, 26, 1)
    cnt = wx.sum()
    mean = (x * wx).sum((0, 1, 2)) / cnt
    var = (x * x * wx).sum((0, 1, 2)) / cnt - mean ** 2
    want = (x - mean) * torch.rsqrt(var + 1e-5)
    assert _rel(y.detach(), want) <= 1e-5
    assert _rel(bn.running_var, 0.9 + 0.1 * var * cnt / (cnt - 1)) <= 1e-6
