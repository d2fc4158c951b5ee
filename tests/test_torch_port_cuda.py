"""The port's CUDA kernels K1 (fused_dyn_graph_agg forward) and K3
(bd_dyn_graph_agg) against their plain PyTorch versions on the card.

Marked ``cuda``: they skip without a GPU.  The file imports no JAX, so it
runs on a GPU machine without it; there, run it without the JAX-side
``tests/conftest.py``:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""
import pytest
import torch

from dsgcn_tpu_torch.ops.kernels.bd_agg import (bd_dyn_graph_agg,
                                                reference_bd_dyn_graph_agg)
from dsgcn_tpu_torch.ops.kernels.dyn_graph import (fused_dyn_graph_agg,
                                                   reference_dyn_graph_agg)
from torch_port_cases import CASES, E, block_inputs, k3_packaging, to_torch


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
    d = block_inputs(seed=6)
    g = {k: to_torch(v).to(cuda) for k, v in d.items()}
    g["x1"].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        fused_dyn_graph_agg(g["pre"], g["x1"], g["x2"], g["A"], g["alpha"],
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
