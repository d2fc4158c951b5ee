"""The port's CUDA kernels K1 (fused_dyn_graph_agg forward), K2 (its
backward) and K3 (bd_dyn_graph_agg) against their plain PyTorch versions
on the card, the K1+K2 autograd Function, and one DS-GCN train step on the
card against the same step on the CPU.

Marked ``cuda``: they skip without a GPU.  The file imports no JAX, so it
runs on a GPU machine without it; there, run it without the JAX-side
``tests/conftest.py``:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""
import copy

import numpy as np
import pytest
import torch

from dsgcn_tpu_torch.core.train import make_optimizer, train_step
from dsgcn_tpu_torch.models.builder import (build_model, init_weights_,
                                           model_cfg)
from dsgcn_tpu_torch.ops.kernels.bd_agg import (bd_dyn_graph_agg,
                                                reference_bd_dyn_graph_agg)
from dsgcn_tpu_torch.ops.kernels.dyn_graph import (
    fused_dyn_graph_agg, fused_dyn_graph_agg_bwd, reference_dyn_graph_agg,
    reference_dyn_graph_agg_bwd)
from torch_port_cases import CASES, E, block_inputs, k3_packaging, to_torch

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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("edge,V,v_real", CASES)
@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_cuda_kernel_matches_plain(cuda, kernel, edge, V, v_real, dtype):
    """f32: 1e-4 (summation order); bf16: 2e-2 against the plain version in
    bf16."""
    K, Cm, edge_k = 3, 16, (1 if edge else -1)
    d = block_inputs(seed=5, N=4, T=40, V=V, Cm=Cm, edge=edge)
    g = {k: to_torch(v).to(cuda) for k, v in d.items()}
    g["pre"] = g["pre"].to(dtype)
    if kernel == "k1":
        args = (g["pre"], g["x1"], g["x2"], g["A"], g["alpha"], g["beta"],
                g.get("ew"), g.get("eb"), g.get("sel"), K, Cm, edge_k, E,
                v_real)
        n = fused_dyn_graph_agg.launches
        got = fused_dyn_graph_agg(*args)
        assert fused_dyn_graph_agg.launches == n + 1
        want = reference_dyn_graph_agg(*args)
    else:
        p = {k: to_torch(v).to(cuda) for k, v in
             k3_packaging(d, K, Cm, edge_k).items()}
        p["pre2"] = p["pre2"].to(dtype)
        args = (p["pre2"], p["x1t"], g["x2"], g["A"], g["alpha"], g["beta"],
                p.get("p1t"), p.get("p2"), g.get("sel"), p.get("ebias"))
        kw = dict(K=K, Cm=Cm, edge_k=edge_k, edge_num=E, v_real=v_real)
        n = bd_dyn_graph_agg.launches
        got = bd_dyn_graph_agg(*args, **kw)
        assert bd_dyn_graph_agg.launches == n + 1
        want = reference_bd_dyn_graph_agg(*args, **kw)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


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
