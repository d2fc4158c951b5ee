"""Port parity, sparse training's core: ``supermask`` and its
straight-through gradient, ``SparseDense``/``SparseTemporalConv``, the
percentile thresholds, the group lasso, the score optimizer's gate, the
re-drawing of pruned weights, and the backbones ``SparseSTGCN``,
``SparseCTRGCN`` and ``SparseSTGCNExact`` of ``dsgcn_tpu_torch`` against
``dsgcn_tpu/sparse/`` on the CPU.

None of these reaches a Pallas kernel in JAX or launches a kernel of the
port.  Tolerances: masks, quantiles and percentiles exactly equal (the
same sort and arithmetic in the same dtype); layers, penalties and the
backbones in float64 at 1e-8 relative to the largest entry (forward, one
SGD step by hand: the loss, every parameter and BatchNorm statistic);
two optimizer steps in float32 at 1e-6; the re-drawing by its law (a
Bernoulli fraction within 4 standard deviations) and by the manual
formula at 1e-7, since the bits of a torch generator are not JAX's.  The
backbones run narrow (a stem and a strided block, base 16) at T = 8; each
JAX side is one jitted program.
"""
import importlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.graph import GraphConfig as JGraphConfig
from dsgcn_tpu.sparse import models as jm
from dsgcn_tpu.sparse import nested as jn
from dsgcn_tpu_torch.core.losses import cross_entropy
from dsgcn_tpu_torch.core.train import jax_param_names, paramwise_mults
from dsgcn_tpu_torch.graph import GraphConfig
from dsgcn_tpu_torch.models.builder import init_weights_
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.sparse import models as sm
from dsgcn_tpu_torch.sparse import nested as tn
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from dsgcn_tpu.core.losses import cross_entropy as j_cross_entropy
from dsgcn_tpu.core.train import paramwise_mults as j_paramwise_mults
from test_torch_port_dggcn import _random_variables
from test_torch_port_gcn_families import F64, _f64, _x, x64
from test_torch_port_grad import assert_rel

# the modules (each package exports its function of the same name)
js = importlib.import_module("dsgcn_tpu.sparse.supermask")
ss = importlib.import_module("dsgcn_tpu_torch.sparse.supermask")


def _jvars(jmod, seed, *args, **kw):
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), **kw))
    return _random_variables(shapes, seed)


# ---------------------------------------------------------------------------
# supermask, quantile, percentile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparsity", [0.0, 0.37, 0.5, 0.9, 1.0])
def test_supermask_and_ste_match_jax(sparsity):
    """The mask (scores at or above JAX's linear-interpolated quantile) is
    JAX's bit for bit, the quantile itself too; the gradient reaching the
    score is the upstream gradient, none reaches the sparsity."""
    score = _x(1, 7, 11, 3).astype(np.float32)
    g = _x(2, 7, 11, 3).astype(np.float32)
    q_j = jnp.quantile(jnp.asarray(score).reshape(-1), sparsity)
    mask_j, vjp = jax.vjp(lambda s: js.supermask(s, sparsity),
                          jnp.asarray(score))
    st = torch.from_numpy(score).requires_grad_()
    np.testing.assert_array_equal(ss.quantile(st.detach(), sparsity).numpy(),
                                  np.asarray(q_j))
    sp = torch.tensor(sparsity, requires_grad=True)
    mask = ss.supermask(st, sp)
    np.testing.assert_array_equal(mask.detach().numpy(), np.asarray(mask_j))
    (mask * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(st.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    assert sp.grad is None
    kept = mask.mean().item()
    assert abs(kept - (1 - sparsity)) <= 1 / score.size + 1e-9 \
        or sparsity == 1.0


def test_supermask_at_and_percentiles_match_jax():
    """``supermask_at`` (straight through to the score, nothing to the
    threshold), ``torch_percentile`` (k = 1 + round(0.01 q (n - 1)), half
    to even: n = 6 at q = 50 gives k = 3, as 2.5 rounds to 2) and
    ``pooled_threshold`` over several score tensors equal JAX's."""
    flat = torch.arange(6.0)[torch.randperm(6, generator=torch.Generator()
                                            .manual_seed(0))]
    assert ss.torch_percentile(flat, 50.0).item() == 2.0
    assert float(js.torch_percentile(jnp.asarray(flat.numpy()), 50.0)) == 2.0
    leaves = [_x(3, 4, 5).astype(np.float32), _x(4, 9).astype(np.float32),
              _x(5, 2, 3, 3).astype(np.float32)]
    for q in (0.0, 12.5, 50.0, 73.0, 100.0):
        np.testing.assert_array_equal(
            ss.torch_percentile(torch.from_numpy(leaves[0]), q).numpy(),
            np.asarray(js.torch_percentile(jnp.asarray(leaves[0]), q)))
    for sp in (0.0, 0.3, 0.75):
        thr = ss.pooled_threshold([torch.from_numpy(a) for a in leaves], sp)
        np.testing.assert_array_equal(
            thr.numpy(), np.asarray(js.pooled_threshold(
                [jnp.asarray(a) for a in leaves], sp)))
    st = torch.from_numpy(leaves[0]).requires_grad_()
    thr = torch.tensor(0.1, requires_grad=True)
    m = ss.supermask_at(st, thr)
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(
        js.supermask_at(jnp.asarray(leaves[0]), 0.1)))
    (3.0 * m).sum().backward()
    assert (st.grad == 3.0).all() and thr.grad is None


def test_sparsity_schedules_match_jax():
    for args in ((0.8, 3, 0, 10), (0.5, 7.5, 2, 12)):
        assert ss.get_sparsity(*args) == pytest.approx(js.get_sparsity(*args),
                                                       rel=1e-15)
    for ep in (0, 1, 4, 6, 9):
        for kw in (dict(warm_up=2), dict(sparse_decay=True),
                   dict(warm_up=1, sparse_decay=True)):
            assert ss.sparsity_schedule(0.6, ep, 10, **kw) == pytest.approx(
                js.sparsity_schedule(0.6, ep, 10, **kw), rel=1e-15)


# ---------------------------------------------------------------------------
# the sparse layers
# ---------------------------------------------------------------------------

LAYERS = {
    "dense": (lambda: js.SparseDense(6), lambda: ss.SparseDense(5, 6),
              (3, 4, 7, 5)),
    "dense_at": (lambda: jm.SparseDenseAt(6), lambda: sm.SparseDenseAt(5, 6),
                 (3, 4, 7, 5)),
    "tconv": (lambda: js.SparseTemporalConv(6, kernel_size=5, stride=2,
                                            dilation=2),
              lambda: ss.SparseTemporalConv(5, 6, 5, 2, 2), (3, 11, 7, 5)),
    "tconv_at": (lambda: jm.SparseTemporalConvAt(6, kernel_size=3),
                 lambda: sm.SparseTemporalConvAt(5, 6, 3), (3, 11, 7, 5)),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_sparse_layer_float64_matches_jax(name):
    """Each sparse layer loaded strictly from JAX's variables (its
    ``score`` turned as its kernel): forward at a sparsity (a threshold
    for the ``*At`` layers) and the gradients to the input, kernel, score
    and bias, in float64."""
    jf, tf, shape = LAYERS[name]
    arg = 0.05 if name.endswith("_at") else 0.4
    x = _x(6, *shape)
    v = _f64(_jvars(jf(), 7, x.astype(np.float32), arg))
    r = _x(8, *jax.eval_shape(lambda: jf().apply(
        v, jnp.zeros(shape), arg)).shape)
    with x64():
        (y_j, (gp, gx)) = jax.jit(lambda p, xx: (
            jf().apply({"params": p}, xx, arg),
            jax.grad(lambda q, z: (jf().apply({"params": q}, z, arg)
                                   * r).sum(), argnums=(0, 1))(p, xx)))(
            v["params"], jnp.asarray(x))
    port = tf()
    port.load_state_dict(convert_jax_variables(v), strict=True)
    port.double()
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt, arg)
    (y * torch.from_numpy(r)).sum().backward()
    assert_rel(y.detach().numpy(), y_j, F64, name)
    assert_rel(xt.grad.numpy(), gx, F64, "d/dx")
    want = convert_jax_variables({"params": jax.tree.map(np.asarray, gp)})
    for n, p in port.named_parameters():
        assert_rel(p.grad.numpy(), want[n].numpy(), F64, f"d/d{n}")
    assert jax_param_names(port)["weight"] == "kernel"
    assert jax_param_names(port)["score"] == "score"


# ---------------------------------------------------------------------------
# the backbones
# ---------------------------------------------------------------------------

NARROW = dict(base_channels=16, num_stages=2, inflate_stages=(2,),
              down_stages=(2,))
SHAPE = (2, 2, 8, 25, 3)
BACKBONES = {
    "SparseSTGCN": (jm.SparseSTGCN, sm.SparseSTGCN, {}),
    "SparseCTRGCN": (jm.SparseCTRGCN, sm.SparseCTRGCN, {}),
    "SparseSTGCNExact": (jm.SparseSTGCNExact, sm.SparseSTGCNExact, {}),
    "SparseSTGCNExact_global": (jm.SparseSTGCNExact, sm.SparseSTGCNExact,
                                dict(global_threshold=True)),
    "SparseAAGCN": (jn.SparseAAGCN, tn.SparseAAGCN, {}),
    # the nested DG-STGCN on its default random K = 8 graph
    "SparseDGSTGCN": (jn.SparseDGSTGCN, tn.SparseDGSTGCN,
                      dict(mode="random", num_filter=8, seed=0)),
}
GRAPH_KEYS = ("mode", "num_filter", "seed")


def _backbone_case(name):
    jcls, tcls, kw = BACKBONES[name]
    graph = dict(layout="nturgb+d", mode="spatial")
    graph.update({k: v for k, v in kw.items() if k in GRAPH_KEYS})
    kw = {k: v for k, v in kw.items() if k not in GRAPH_KEYS}
    jb = jcls(graph_cfg=JGraphConfig(**graph), **NARROW, **kw)
    tb = tcls(graph_cfg=GraphConfig(**graph), **NARROW, **kw)
    return jb, tb


@pytest.mark.parametrize("name", list(BACKBONES))
def test_sparse_backbone_float64_matches_jax(name):
    """Each backbone loaded strictly from JAX's variables: the eval
    features at sparsity 0.3, then one SGD step by hand (lr 0.1) on the
    cross entropy of a linear head over the pooled features plus the
    masked group lasso, in train mode at sparsity 0.6: the loss, every
    parameter and BatchNorm statistic, in float64 at 1e-8; the stage
    thresholds equal JAX's and about 0.6 of each pool falls under its
    own."""
    jb, tb = _backbone_case(name)
    x = _x(9, *SHAPE)
    label = np.random.default_rng(10).integers(0, 5, SHAPE[0])
    v = _random_variables(jax.eval_shape(lambda: jb.init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE), 0.0, train=False)), 11)
    width = 32
    head = _x(12, width, 5)

    def objective(p, stats, xx):
        y, mut = jb.apply({"params": p, "batch_stats": stats}, xx, 0.6,
                          train=True, mutable=["batch_stats"])
        logits = y.mean(axis=(1, 2, 3)) @ head
        loss = j_cross_entropy(logits, jnp.asarray(label)) \
            + js.group_lasso_penalty(p, 1e-3, sparsity=0.6)
        return loss, mut

    def both(p, stats, xx):
        feat = jb.apply({"params": p, "batch_stats": stats}, xx, 0.3,
                        train=False)
        (loss, mut), g = jax.value_and_grad(objective, has_aux=True)(
            p, stats, xx)
        return feat, loss, jax.tree.map(lambda a, b: a - 0.1 * b, p, g), mut
    with x64():
        v64 = _f64(v)
        feat_j, loss_j, new_p, mut = jax.device_get(jax.jit(both)(
            v64["params"], v64["batch_stats"], jnp.asarray(x)))
    tb.load_state_dict(convert_jax_variables(v), strict=True)
    tb.double()
    before = launch_counts()
    with torch.no_grad():
        feat = tb.eval()(torch.from_numpy(x), 0.3)
    assert_rel(feat.numpy(), feat_j, F64, f"{name} eval features")
    tb.train()
    y = tb(torch.from_numpy(x), 0.6)
    logits = y.mean(dim=(1, 2, 3)) @ torch.from_numpy(head)
    loss = cross_entropy(logits, torch.from_numpy(label)) \
        + ss.group_lasso_penalty(tb, 1e-3, sparsity=0.6)
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
    if name != "SparseSTGCN":
        pool = sm._block_score_pool if name == "SparseCTRGCN" \
            else sm._all_score_pool
        for blk, thr in zip(tb.blocks(), tb.thresholds(0.6)):
            scores = torch.cat([s.detach().reshape(-1) for s in pool(blk)])
            if "global" not in name:
                assert abs((scores < thr).double().mean().item() - 0.6) < 0.01


def test_score_pools_follow_jax():
    """``_block_score_pool`` leaves out the inner CTRGC ``convs``' scores,
    ``_all_score_pool`` keeps them: the same leaves as JAX's pools
    (compared by their values) in every block."""
    jb, tb = _backbone_case("SparseCTRGCN")
    v = _random_variables(jax.eval_shape(lambda: jb.init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE), 0.0, train=False)), 13)
    tb.load_state_dict(convert_jax_variables(v), strict=True)
    for i, blk in enumerate(tb.blocks()):
        jp = v["params"][f"block{i}"]
        for jpool, tpool in ((jm._block_score_pool, sm._block_score_pool),
                             (jm._all_score_pool, sm._all_score_pool)):
            want = sorted(np.sort(np.asarray(a).ravel()).tolist()
                          for a in jpool(jp))
            got = sorted(np.sort(t.detach().numpy().ravel()).tolist()
                         for t in tpool(blk))
            assert got == want
        assert len(sm._block_score_pool(blk)) < len(sm._all_score_pool(blk))


def test_group_lasso_groups_by_output_feature():
    """``group_lasso_penalty`` norms each output feature's group (JAX's
    last kernel axis, torch's first), with and without the masks, as
    JAX's over the same SparseSTGCN tree (float64, 1e-8); no other leaf
    counts."""
    jb, tb = _backbone_case("SparseSTGCN")
    v = _random_variables(jax.eval_shape(lambda: jb.init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE), 0.0, train=False)), 14)
    tb.load_state_dict(convert_jax_variables(v), strict=True)
    tb.double()
    with x64():
        for sp in (None, 0.5):
            want = js.group_lasso_penalty(_f64(v["params"]), 1e-3, sp)
            got = ss.group_lasso_penalty(tb, 1e-3, sp)
            assert_rel(got.item(), float(want), F64, f"lasso at {sp}")
    n_kernels = sum(1 for _ in ss.sparse_kernels(tb))
    assert n_kernels == 2 * 2 + 1         # gcn and tcn a block, a residual


# ---------------------------------------------------------------------------
# the score optimizer, init, re-drawing
# ---------------------------------------------------------------------------

def test_sparse_optimizer_gates_scores_as_optax():
    """Two steps through ``make_sparse_optimizer`` (warmup 1 epoch, SGD
    groups: main lr 0.1, Nesterov momentum 0.9, decay 5e-4; scores lr
    0.05, momentum 0.9, decay 1e-3) against optax's multi_transform with
    JAX's gate on the same gradients: in epoch 0 the score gradients are
    zero (a score the backward missed gets a zero tensor, not None), so
    the scores only decay, in epoch 1 they train; float32 at 1e-6."""
    layer = ss.SparseDense(4, 3)
    v = _jvars(js.SparseDense(3), 15, np.zeros((2, 4), np.float32), 0.0)
    layer.load_state_dict(convert_jax_variables(v), strict=True)
    opt, gate = ss.make_sparse_optimizer(
        layer, dict(lr=0.1, momentum=0.9, nesterov=True, weight_decay=5e-4),
        dict(lr=0.05, momentum=0.9, weight_decay=1e-3), warmup_epochs=1)
    assert [len(g["params"]) for g in opt.param_groups] == [2, 1]
    assert ss.score_mask_tree(layer) == {"weight": "main", "score": "score",
                                         "bias": "main"}
    tx, jgate = js.make_sparse_optimizer(
        optax.chain(optax.add_decayed_weights(5e-4),
                    optax.sgd(0.1, momentum=0.9, nesterov=True)),
        optax.chain(optax.add_decayed_weights(1e-3),
                    optax.sgd(0.05, momentum=0.9)), v["params"],
        warmup_epochs=1)
    params, state = v["params"], tx.init(v["params"])
    rng = np.random.default_rng(16)
    for epoch in (0, 1):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        if epoch == 0:
            g["score"] = np.zeros_like(g["score"])   # the backward missed it
        gated = jgate(g, epoch)
        upd, state = tx.update(gated, state, params)
        params = optax.apply_updates(params, upd)
        tg = convert_jax_variables({"params": g})
        opt.zero_grad(set_to_none=True)
        for n, p in layer.named_parameters():
            if not (epoch == 0 and n == "score"):
                p.grad = tg[n].clone()
        gate(epoch)
        assert layer.score.grad is not None
        opt.step()
    want = convert_jax_variables({"params": params})
    for n, p in layer.named_parameters():
        assert_rel(p.detach().numpy(), want[n].numpy(), 1e-6, n)


def test_sparse_init_and_param_names_follow_jax():
    """``init_weights_`` draws JAX's laws: kernel and score U(+-1/sqrt(fan
    in)), the ``*At`` biases zero; ``jax_param_names`` gives JAX's leaf
    paths, so ``paramwise_mults`` classifies as JAX's does."""
    _, tb = _backbone_case("SparseCTRGCN")
    jb, _ = _backbone_case("SparseCTRGCN")
    init_weights_(tb, torch.Generator().manual_seed(0))
    conv = tb.block1.tcn1.transform_conv
    bound = conv.weight[0].numel() ** -0.5
    for t in (conv.weight, conv.score):
        assert t.abs().max() <= bound
        assert abs(t.std().item() * 3 ** 0.5 / bound - 1) < 0.1
    assert (conv.bias == 0).all()
    v = _random_variables(jax.eval_shape(lambda: jb.init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE), 0.0, train=False)), 17)
    flat = {".".join(str(k.key) for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(v["params"])[0]}
    names = jax_param_names(tb)
    assert set(names.values()) == flat
    pw = dict(custom_keys={"score": dict(decay_mult=0.0)},
              norm_decay_mult=0.0, bias_lr_mult=2.0)
    lr_tree, decay_tree = j_paramwise_mults(v["params"], pw)
    mults = paramwise_mults(tb, pw)
    for tree, i in ((lr_tree, 0), (decay_tree, 1)):
        jflat = {".".join(str(k.key) for k in path): val for path, val in
                 jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert {n: mults[n][i] for n in names} == {
            n: jflat[p] for n, p in names.items()}


def test_rerandomize_by_law_and_formula():
    """``rerandomize_param``: kept weights unchanged; 'bernoulli' replaces
    a fraction ``la`` of the pruned ones with fresh kaiming-uniform draws
    (within their bound); 'manual' is la old + mu fresh, held to the
    formula on the same fresh draw; ``rerandomize_tree`` touches every
    sparse kernel and nothing else; ``draw_init``'s laws."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 32, 9, 1, generator=g)
    score = torch.randn(64, 32, 9, 1, generator=g)
    mask = ss.supermask(score, 0.5 * 0.8).bool()
    new = ss.rerandomize_param(w, score, 0.5, torch.Generator().manual_seed(1),
                               rerand_rate=0.8, la=0.3)
    assert torch.equal(new[mask], w[mask])
    changed = (new != w) & ~mask
    frac = changed.sum().item() / (~mask).sum().item()
    n = (~mask).sum().item()
    assert abs(frac - 0.3) < 4 * (0.3 * 0.7 / n) ** 0.5
    bound = 2 ** 0.5 * (3.0 / (32 * 9)) ** 0.5
    assert new[changed].abs().max() <= bound
    man = ss.rerandomize_param(w, score, 0.5, torch.Generator().manual_seed(2),
                               mode="manual", la=0.25, mu=0.5)
    fresh = ss.draw_init(w.shape, torch.Generator().manual_seed(2))
    want = torch.where(ss.supermask(score, 0.5).bool(), w,
                       0.25 * w + 0.5 * fresh)
    assert_rel(man.numpy(), want.numpy(), 1e-7, "manual")
    for mode in ("kaiming_normal", "uniform", "signed_constant"):
        d = ss.draw_init((256, 64, 3, 1), torch.Generator().manual_seed(3),
                         init_mode=mode)
        std = 2 ** 0.5 / (64 * 3) ** 0.5
        if mode == "uniform":
            assert d.abs().max() <= 1
            assert abs(d.std().item() - 3 ** -0.5) < 0.01
        elif mode == "signed_constant":
            assert torch.allclose(d.abs(), torch.full_like(d, std))
        else:
            assert abs(d.std().item() / std - 1) < 0.02
    _, tb = _backbone_case("SparseSTGCN")
    kernels = {f"{n}.weight" for n, _ in ss.sparse_kernels(tb)}
    before = {n: p.detach().clone() for n, p in tb.named_parameters()}
    ss.rerandomize_tree(tb, 0.5, torch.Generator().manual_seed(4), la=1.0)
    for n, p in tb.named_parameters():
        assert (not torch.equal(p, before[n])) == (n in kernels), n
