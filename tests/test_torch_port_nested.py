"""Port parity, the nested copy's sparse units and the multi-backbone
assembly: ``SparseUnitAAGCN``, ``SparseDGGCN`` (ctr and ada 'T', 'NA' and
None, ``subset_wise`` both ways), ``AssembleSparse`` over the four block
families and ``assemble_regularize`` of ``dsgcn_tpu_torch/sparse/nested.py``
against ``dsgcn_tpu/sparse/nested.py`` on the CPU.  (The backbones
``SparseAAGCN`` and ``SparseDGSTGCN`` are cases of
``tests/test_torch_port_sparse.py::test_sparse_backbone_float64_matches_jax``.)

None of these reaches a Pallas kernel in JAX or launches a kernel of the
port.  Weights move by ``convert_jax_variables`` and load strictly.
Tolerance: float64 at 1e-8 relative to the largest entry, for the
forward, the gradients to the input and every parameter (scores through
the straight-through mask included; a parameter's gradient relative to
the largest of all, since the biases before a train-mode BatchNorm get
rounding noise only) and the BatchNorm statistics after one train-mode
forward; Assemble also one SGD step by hand (the loss, every
parameter and statistic).  Each JAX side is one jitted program.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.core.losses import cross_entropy as j_cross_entropy
from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu.graph import GraphConfig as JGraphConfig
from dsgcn_tpu.sparse import nested as jn
from dsgcn_tpu_torch.core.losses import cross_entropy
from dsgcn_tpu_torch.core.train import jax_param_names
from dsgcn_tpu_torch.graph import GraphConfig
from dsgcn_tpu_torch.models.builder import init_weights_
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.sparse import nested as tn
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _random_variables
from test_torch_port_gcn_families import F64, _f64, _x, x64
from test_torch_port_grad import assert_rel

THR = 0.02                  # a unit's mask threshold (scores are 0.1 N(0, 1))


def _unit_parity(jmod, tmod, x, seed):
    """``tmod`` loaded from random variables of ``jmod``: one train-mode
    forward at THR, the gradients of (y * r).sum() to x and every
    parameter, and the BatchNorm statistics after it, in float64."""
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.zeros(x.shape), THR, train=False))
    v = _random_variables(shapes, seed)
    y_shape = jax.eval_shape(lambda: jmod.apply(
        v, jnp.zeros(x.shape), THR, train=False)).shape
    r = _x(seed + 1, *y_shape)

    def both(p, stats, xx):
        def f(q, z):
            y, mut = jmod.apply({"params": q, "batch_stats": stats}, z, THR,
                                train=True, mutable=["batch_stats"])
            return (y * r).sum(), (y, mut)
        (_, (y, mut)), g = jax.value_and_grad(f, argnums=(0, 1),
                                              has_aux=True)(p, xx)
        return y, g, mut
    with x64():
        v64 = _f64(v)
        y_j, (gp, gx), mut = jax.device_get(jax.jit(both)(
            v64["params"], v64["batch_stats"], jnp.asarray(x)))
    tmod.load_state_dict(convert_jax_variables(v), strict=True)
    tmod.double().train()
    xt = torch.from_numpy(x).requires_grad_()
    before = launch_counts()
    y = tmod(xt, THR)
    (y * torch.from_numpy(r)).sum().backward()
    assert launch_counts() == before
    assert_rel(y.detach().numpy(), y_j, F64, "forward")
    assert_rel(xt.grad.numpy(), gx, F64, "d/dx")
    want = convert_jax_variables({"params": gp, "batch_stats":
                                  mut["batch_stats"]})
    named = dict(tmod.named_parameters())
    assert set(named) | {k for k in want if "running" in k} == set(want)
    # a bias before a train-mode BatchNorm has a gradient of rounding
    # noise only: gradients are held to the largest one of the tree
    floor = max(float(np.abs(w.numpy()).max()) for n, w in want.items()
                if n in named)
    for n, w in want.items():
        if n in named:         # an unused gate (beta without ada) has none
            g = named[n].grad
            g = torch.zeros_like(named[n]) if g is None else g
            assert_rel(g.numpy(), w.numpy(), F64, f"d/d{n}", floor)
        else:
            assert_rel(tmod.state_dict()[n].numpy(), w.numpy(), F64, n)
    assert set(jax_param_names(tmod).values()) == {
        ".".join(str(k.key) for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(v["params"])[0]}


def _graph(K=None):
    A = JGraph(layout="nturgb+d", mode="spatial").A.astype(np.float32)
    if K is None:
        return A
    return (0.04 + 0.02 * _x(3, K, 25, 25)).astype(np.float32)


@pytest.mark.parametrize("adaptive", [True, False])
def test_unit_aagcn_float64_matches_jax(adaptive):
    """SparseUnitAAGCN (8 -> 16 channels, so the down path runs; the
    attention chain plain) with its adaptive graph (alpha drawn off 0)
    and without."""
    A = _graph()
    _unit_parity(jn.SparseUnitAAGCN(16, A_init=A, adaptive=adaptive),
                 tn.SparseUnitAAGCN(8, 16, A, adaptive=adaptive),
                 _x(4, 2, 8, 25, 8), 5)


@pytest.mark.parametrize("ctr,ada,subset_wise", [
    ("T", "T", False), ("T", "T", True), ("T", None, True),
    (None, "T", False), (None, None, False), ("NA", "T", True)])
def test_dggcn_float64_matches_jax(ctr, ada, subset_wise):
    """SparseDGGCN on a K = 4 graph (8 -> 16 channels, mid 4), each
    combination of the ctr and ada graphs (T-pooled, per frame, off) and
    of per-subset gates."""
    A = _graph(K=4)
    kw = dict(ratio=0.25, ctr=ctr, ada=ada, subset_wise=subset_wise)
    _unit_parity(jn.SparseDGGCN(16, A_init=A, **kw),
                 tn.SparseDGGCN(8, 16, A, **kw), _x(6, 2, 8, 25, 8), 7)


# ---------------------------------------------------------------------------
# AssembleSparse and assemble_regularize
# ---------------------------------------------------------------------------

FAMILIES = ("ST-GCN", "AA-GCN", "CTR-GCN", "DG-GCN")
RATIOS = (0.5, 0.4, 0.6, 0.5)
ASSEMBLE = dict(base_channels=8, num_stages=3, inflate_stages=(3,),
                down_stages=(3,), warm_up=1, sparse_decay=True)
SHAPE = (2, 2, 8, 25, 3)
EPOCH, MAX_EPOCH = 3, 10          # each branch at 3/5 of its ratio


def _assemble():
    graph = dict(layout="nturgb+d", mode="random", num_filter=8, seed=0)
    return (jn.AssembleSparse(FAMILIES, RATIOS,
                              graph_cfg=JGraphConfig(**graph), **ASSEMBLE),
            tn.AssembleSparse(FAMILIES, RATIOS,
                              graph_cfg=GraphConfig(**graph), **ASSEMBLE))


@pytest.fixture(scope="module")
def assemble_vars():
    jb, _ = _assemble()
    return _random_variables(jax.eval_shape(lambda: jb.init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE), 0, MAX_EPOCH,
        train=False)), 20)


def test_assemble_float64_matches_jax(assemble_vars):
    """AssembleSparse with the four families on a K = 8 random graph (two
    subsets a branch), 3 stages at base 8: the stacked streams of a
    train-mode forward, then one SGD step by hand (lr 0.1) on the cross
    entropy of a linear head over the branches' summed pooled features
    plus ``assemble_regularize`` (GSGL, 1e-3): the loss, every parameter
    and BatchNorm statistic; each (stage, branch) threshold keeps 1 - its
    sparsity of its scores."""
    jb, tb = _assemble()
    v = assemble_vars
    x = _x(21, *SHAPE)
    label = np.random.default_rng(22).integers(0, 5, SHAPE[0])
    head = _x(23, 16, 5)

    def objective(p, stats, xx):
        y, mut = jb.apply({"params": p, "batch_stats": stats}, xx, EPOCH,
                          MAX_EPOCH, train=True, mutable=["batch_stats"])
        logits = y.mean(axis=(2, 3, 4)).sum(axis=0) @ head
        loss = j_cross_entropy(logits, jnp.asarray(label)) \
            + jn.assemble_regularize(p, FAMILIES, RATIOS, 1e-3)
        return loss, (y, mut)

    def both(p, stats, xx):
        (loss, (y, mut)), g = jax.value_and_grad(objective, has_aux=True)(
            p, stats, xx)
        return y, loss, jax.tree.map(lambda a, b: a - 0.1 * b, p, g), mut
    with x64():
        v64 = _f64(v)
        y_j, loss_j, new_p, mut = jax.device_get(jax.jit(both)(
            v64["params"], v64["batch_stats"], jnp.asarray(x)))
    tb.load_state_dict(convert_jax_variables(v), strict=True)
    tb.double()
    before = launch_counts()
    y = tb.train()(torch.from_numpy(x), EPOCH, MAX_EPOCH)
    assert_rel(y.detach().numpy(), y_j, F64, "stacked streams")
    logits = y.mean(dim=(2, 3, 4)).sum(dim=0) @ torch.from_numpy(head)
    loss = cross_entropy(logits, torch.from_numpy(label)) \
        + tn.assemble_regularize(tb, 1e-3)
    loss.backward()
    with torch.no_grad():
        for p in tb.parameters():
            if p.grad is not None:
                p -= 0.1 * p.grad
    assert launch_counts() == before
    np.testing.assert_allclose(loss.item(), loss_j, rtol=F64)
    want = convert_jax_variables({"params": new_p, "batch_stats":
                                  mut["batch_stats"]})
    state = tb.state_dict()
    assert state.keys() == want.keys()
    for n, w in want.items():
        assert_rel(state[n].numpy(), w.numpy(), F64, n)
    from dsgcn_tpu_torch.sparse.models import _all_score_pool
    for i, row in enumerate(tb.thresholds(EPOCH, MAX_EPOCH)):
        for j, thr in enumerate(row):
            sp = tb.branch_sparsity(j, EPOCH, MAX_EPOCH)
            assert sp == pytest.approx(RATIOS[j] * 0.6)
            s = torch.cat([t.detach().reshape(-1)
                           for t in _all_score_pool(tb.block(i, j))])
            assert abs((s < thr).double().mean().item() - sp) < 0.01


def test_assemble_regularize_and_structure_follow_jax(assemble_vars):
    """``assemble_regularize`` as GL and GSGL equals JAX's on the same
    tree (float64, 1e-8), each (stage, branch) block counted once;
    ``AssembleSparse`` keeps JAX's structure: blocks
    ``stage{i}_branch{j}``, every one with a residual (a conv in stage 0),
    one shared 'MVC' data BN; it refuses K % B != 0 and unknown families;
    ``init_weights_`` draws every sparse kernel, the gates stay at zero;
    ``jax_param_names`` names every JAX leaf."""
    v = assemble_vars
    _, tb = _assemble()
    tb.load_state_dict(convert_jax_variables(v), strict=True)
    tb.double()
    with x64():
        p64 = _f64(v["params"])
        for pen in ("GL", "GSGL"):
            want = float(jax.jit(lambda p, pen=pen: jn.assemble_regularize(
                p, FAMILIES, RATIOS, 0.7, pen))(p64))
            assert_rel(tn.assemble_regularize(tb, 0.7, pen).item(), want,
                       F64, pen)
    from dsgcn_tpu_torch.sparse.smoe import _stage_mask
    by_hand = sum(torch.linalg.vector_norm(_stage_mask(
        tb.block(i, j), RATIOS[j])) for i in range(3) for j in range(4))
    assert_rel(tn.assemble_regularize(tb, 1.0).item(), by_hand.item(), F64,
               "each block once")
    assert [n for n, _ in tb.named_children()][:5] == [
        "data_bn", "stage0_branch0", "stage0_branch1", "stage0_branch2",
        "stage0_branch3"]
    assert tb.data_bn.kind == "MVC"
    assert all(tb.block(0, j).res_kind == "conv" for j in range(4))
    assert all(tb.block(1, j).res_kind == "identity" for j in range(4))
    assert set(jax_param_names(tb).values()) == {
        ".".join(str(k.key) for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(v["params"])[0]}
    with pytest.raises(ValueError, match="do not split"):
        tn.AssembleSparse(FAMILIES[:3], RATIOS[:3],
                          graph_cfg=GraphConfig(layout="nturgb+d",
                                                mode="random", num_filter=8,
                                                seed=0), **ASSEMBLE)
    with pytest.raises(ValueError, match="unknown branch"):
        tn.AssembleSparse(("GCN",), (0.5,), **ASSEMBLE)
    _, fresh = _assemble()
    init_weights_(fresh, torch.Generator().manual_seed(0))
    conv = fresh.stage2_branch3.gcn.post_conv
    bound = conv.weight[0].numel() ** -0.5
    assert conv.score.abs().max() <= bound and (conv.bias == 0).all()
    assert (fresh.stage2_branch3.gcn.alpha == 0).all()
    assert (fresh.stage2_branch1.gcn.alpha == 0).all()
