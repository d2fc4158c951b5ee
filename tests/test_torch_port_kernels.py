"""The port's dynamic-graph kernels K1 (fused_dyn_graph_agg forward), K2
(its backward) and K3 (bd_dyn_graph_agg).

On the CPU each wrapper runs its plain PyTorch version, held here against
the JAX Pallas kernels in interpret mode and the JAX plain reference, on the
same numpy inputs (tolerance 1e-5, float32; for K2 relative to each
gradient's largest entry, the same sums in another order).  The CUDA
kernels themselves
are held against the plain versions on the card by
``test_torch_port_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsgcn_tpu.ops.pallas.bd_agg import bd_dyn_graph_agg as j_bd
from dsgcn_tpu.ops.pallas.dyn_graph import (
    edge_onehot as j_edge_onehot, fused_dyn_graph_agg as j_fused,
    reference_dyn_graph_agg as j_reference)
from dsgcn_tpu_torch.graph import Graph
from dsgcn_tpu_torch.ops.kernels.bd_agg import bd_dyn_graph_agg
from dsgcn_tpu_torch.ops.kernels.dyn_graph import (
    edge_onehot, fused_dyn_graph_agg, fused_dyn_graph_agg_bwd,
    reference_dyn_graph_agg)
from torch_port_cases import CASES, E, block_inputs, k3_packaging, to_torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _j(a):
    return None if a is None else jnp.asarray(a)


K1_ARGS = ("pre", "x1", "x2", "A", "alpha", "beta", "ew", "eb", "sel")


def _k1_args(d, conv):
    return [conv(d.get(k)) for k in K1_ARGS]


def _k3_args(d, p, conv):
    return ([conv(p["pre2"]), conv(p["x1t"])]
            + [conv(d[k]) for k in ("x2", "A", "alpha", "beta")]
            + [conv(p.get("p1t")), conv(p.get("p2")), conv(d.get("sel")),
               conv(p.get("ebias"))])


def _port_k1(d, K, Cm, edge_k, v_real):
    return fused_dyn_graph_agg(*_k1_args(d, to_torch), K, Cm, edge_k, E,
                               v_real).numpy()


def _port_k3(d, K, Cm, edge_k, v_real):
    p = k3_packaging(d, K, Cm, edge_k)
    y = bd_dyn_graph_agg(*_k3_args(d, p, to_torch), K=K, Cm=Cm,
                         edge_k=edge_k, edge_num=E, v_real=v_real)
    return y.numpy().reshape(d["pre"].shape)


@pytest.mark.parametrize("edge,V,v_real", CASES)
def test_k1_plain_matches_jax_interpret(edge, V, v_real):
    K, Cm = 3, 8
    edge_k = 1 if edge else -1
    d = block_inputs(V=V, edge=edge)
    before = fused_dyn_graph_agg.launches
    got = _port_k1(d, K, Cm, edge_k, v_real)
    assert fused_dyn_graph_agg.launches == before   # CPU: plain version
    want = j_fused(*_k1_args(d, _j), K, Cm, edge_k, E, True, v_real)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("edge", [False, True])
def test_k1_plain_matches_jax_reference(edge):
    K, Cm = 3, 16
    edge_k = 1 if edge else -1
    d = block_inputs(seed=1, Cm=Cm, edge=edge)
    got = reference_dyn_graph_agg(*_k1_args(d, to_torch), K=K, Cm=Cm,
                                  edge_k=edge_k, edge_num=E).numpy()
    want = j_reference(*_k1_args(d, _j), K=K, Cm=Cm, edge_k=edge_k,
                       edge_num=E)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("edge,V,v_real", CASES)
def test_k3_plain_matches_jax_interpret(edge, V, v_real):
    K, Cm = 3, 8
    edge_k = 1 if edge else -1
    d = block_inputs(seed=2, V=V, edge=edge)
    p = k3_packaging(d, K, Cm, edge_k)
    before = bd_dyn_graph_agg.launches
    got = _port_k3(d, K, Cm, edge_k, v_real)
    assert bd_dyn_graph_agg.launches == before      # CPU: plain version
    want = j_bd(*_k3_args(d, p, _j), K=K, Cm=Cm, edge_k=edge_k, edge_num=E,
                interpret=True, v_real=v_real)
    np.testing.assert_allclose(got, np.asarray(want).reshape(got.shape),
                               **TOL)


def test_k3_and_k1_plain_versions_agree():
    """Same function from the two input packagings, at a DS-GCN width."""
    K, Cm = 3, 32
    d = block_inputs(seed=3, T=4, Cm=Cm)
    np.testing.assert_allclose(_port_k3(d, K, Cm, 1, -1),
                               _port_k1(d, K, Cm, 1, -1), **TOL)


def test_edge_onehot_identity():
    et = Graph(layout="nturgb+d", mode="spatial").edge_type
    np.testing.assert_array_equal(edge_onehot(et), j_edge_onehot(et))


def test_bf16_plain_contracts_in_bf16():
    """bfloat16 pre: the graph is rounded to bf16 for the contraction and
    the output stays bf16 (the kernels' contract); within 2e-2 of f32."""
    K, Cm = 3, 8
    d = block_inputs(seed=4)
    y32 = _port_k1(d, K, Cm, 1, -1)
    args = _k1_args(d, to_torch)
    args[0] = args[0].to(torch.bfloat16)
    y16 = fused_dyn_graph_agg(*args, K, Cm, 1, E)
    assert y16.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.float().numpy(), y32, rtol=2e-2,
                               atol=2e-2 * np.abs(y32).max())


@pytest.mark.parametrize("edge", [False, True])
def test_k2_plain_matches_jax_reference_vjp(edge):
    """K2's plain version against jax.vjp of the JAX plain forward
    (``reference_dyn_graph_agg``, XLA autodiff) at a DS-GCN width."""
    import jax
    K, Cm, edge_k = 3, 16, (1 if edge else -1)
    d = block_inputs(seed=8, N=2, T=5, Cm=Cm, edge=edge)
    dy = np.random.default_rng(9).standard_normal(d["pre"].shape).astype(
        np.float32)
    names = ["pre", "x1", "x2", "A", "alpha", "beta"] + (
        ["ew", "eb"] if edge else [])
    sel = _j(d.get("sel"))

    def f(*a):
        ew, eb = (a[6], a[7]) if edge else (None, None)
        return j_reference(*a[:6], ew, eb, sel, K=K, Cm=Cm, edge_k=edge_k,
                           edge_num=E)
    _, vjp = jax.vjp(f, *[_j(d[k]) for k in names])
    want = vjp(jnp.asarray(dy))
    got = fused_dyn_graph_agg_bwd(*_k1_args(d, to_torch), to_torch(dy),
                                  K, Cm, edge_k, E)
    got = [g for g in got if g is not None]
    assert len(got) == len(want)
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (name, err)
