"""Port parity, the sparse mixture of experts: ``cv_squared``,
``NoisyTopKGate``, ``SMoEAssembleSparse`` through a ``ClsHead`` into
``smoe_recognizer_losses`` with ``smoe_regularize``, and expert
parallelism (``dsgcn_tpu_torch/parallel/expert_parallel.py``) against
``dsgcn_tpu/sparse/smoe.py``, ``dsgcn_tpu/core/flows.py`` and
``dsgcn_tpu/parallel/expert_parallel.py`` on the CPU.

None of these reaches a Pallas kernel in JAX or launches a kernel of the
port.  Weights move by ``convert_jax_variables`` and load strictly; the
train-time gate noise is injected into both (JAX's ``noise=``, the port's
``gate_noise``).  Tolerances, float64: the gate's gates, load and
gradients 1e-12; the slice (routed AA-GCN, CTR-GCN and DG-GCN experts and
an ST-GCN base, two stages at base 8, k = 2) at 1e-8 relative to the
largest entry: the eval feature, balance loss and gates, then one SGD
step by hand: the losses, every gradient (``w_gate`` and ``w_noise``
included; a parameter's relative to the largest of all, since biases
before a train-mode BatchNorm get rounding noise only), every updated
parameter and BatchNorm statistic.  Expert parallelism: two gloo ranks
(child processes of ``tests/torch_port_dist_worker.py``, no JAX there)
against JAX's ``make_ep_smoe_eval`` on a 2-device CPU mesh and against
the port's dense forward, at 1e-6.  Each JAX side is one jitted program.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.core import FrozenDict

from dsgcn_tpu.core.flows import smoe_recognizer_losses as j_losses
from dsgcn_tpu.graph import GraphConfig as JGraphConfig
from dsgcn_tpu.models.heads import ClsHead as JClsHead
from dsgcn_tpu.parallel import expert_parallel as jep
from dsgcn_tpu.sparse import smoe as js
from dsgcn_tpu_torch.core.flows import smoe_recognizer_losses
from dsgcn_tpu_torch.core.train import jax_param_names
from dsgcn_tpu_torch.graph import GraphConfig
from dsgcn_tpu_torch.models.builder import init_weights_
from dsgcn_tpu_torch.models.heads import ClsHead
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.parallel import expert_parallel as tep
from dsgcn_tpu_torch.sparse import smoe as ts
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _random_variables
from test_torch_port_gcn_families import F64, _f64, _x, x64
from test_torch_port_grad import assert_rel
from torch_port_dist_worker import collect, launch

GATE = 1e-12


# ---------------------------------------------------------------------------
# cv_squared and the gate
# ---------------------------------------------------------------------------

def test_cv_squared_matches_jax():
    """Bessel-corrected var over mean^2 + 1e-10; 0 for one element."""
    with x64():
        for a in (np.array([0.5]), np.array([3.0, 1.0]), _x(1, 7) ** 2):
            want = float(js.cv_squared(jnp.asarray(a)))
            got = ts.cv_squared(torch.from_numpy(a)).item()
            assert_rel(got, want, GATE, f"cv^2 of {len(a)}")
    assert ts.cv_squared(torch.ones(1)).item() == 0.0


def _gate_case(k, train, seed, zero=False):
    """JAX's and the port's gates, load and the gradients of a random
    projection of both to the weights and the features, in float64."""
    C, E, N = 6, 4, 5
    feat = _x(seed, N, C)
    w = {"w_gate": _x(seed + 1, C, E), "w_noise": 0.3 * _x(seed + 2, C, E)}
    if zero:
        w = {n: np.zeros_like(a) for n, a in w.items()}
    noise = _x(seed + 3, N, E)
    rg, rl = _x(seed + 4, N, E), _x(seed + 5, E)
    jgate = js.NoisyTopKGate(E, k)

    def f(p, xx):
        g, load = jgate.apply({"params": p}, xx, train=train, noise=noise)
        return (g * rg).sum() + (load * rl).sum(), (g, load)
    with x64():
        (_, (g_j, l_j)), (gp, gx) = jax.device_get(jax.jit(
            jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
                {n: jnp.asarray(a) for n, a in w.items()},
                jnp.asarray(feat)))
    gate = ts.NoisyTopKGate(C, E, k).double()
    gate.load_state_dict(convert_jax_variables({"params": w}), strict=True)
    gate.train(train)
    ft = torch.from_numpy(feat).requires_grad_()
    g, load = gate(ft, noise=torch.from_numpy(noise))
    ((g * torch.from_numpy(rg)).sum()
     + (load * torch.from_numpy(rl)).sum()).backward()
    got = dict(gates=g.detach().numpy(), load=load.detach().numpy(),
               d_feat=ft.grad.numpy(),
               **{f"d_{n}": p.grad.numpy() if p.grad is not None
                  else np.zeros(p.shape) for n, p in gate.named_parameters()})
    want = dict(gates=g_j, load=l_j, d_feat=gx,
                **{f"d_{n}": a for n, a in gp.items()})
    return got, want


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_noisy_top_k_gate_matches_jax(k, train):
    """Eval (clean logits) and training with the same injected noise, k of
    4 experts: the gates, the load (training: the in-top-k probability)
    and the gradients to w_gate, w_noise and the features."""
    got, want = _gate_case(k, train, seed=10 * k + train)
    for n in want:
        assert_rel(got[n], want[n], GATE, n)
    assert (got["gates"] > 0).sum(1).tolist() == [k] * 5


@pytest.mark.parametrize("k", [1, 2])
def test_zero_gate_ties_route_as_jax(k):
    """With ``w_gate`` at zero (its init) every eval logit ties: JAX's
    ``lax.top_k`` takes the lower experts first, so each sample goes to
    experts 0..k-1 with equal gates; the port routes the same way."""
    got, want = _gate_case(k, train=False, seed=3, zero=True)
    np.testing.assert_array_equal(got["gates"], want["gates"])
    np.testing.assert_array_equal(got["load"], want["load"])
    expect = np.zeros((5, 4))
    expect[:, :k] = 1.0 / k
    np.testing.assert_array_equal(got["gates"], expect)


def test_gate_noise_needs_a_source():
    """Training with noisy gating draws its noise from the generator given
    (the same draw from the same seed), and refuses to run without a
    generator or the noise, as JAX asserts an rng."""
    gate = ts.NoisyTopKGate(6, 4, 1).train()
    feat = torch.randn(3, 6, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="generator or the noise"):
        gate(feat)
    a = gate(feat, torch.Generator().manual_seed(5))
    b = gate(feat, torch.Generator().manual_seed(5))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert gate.eval()(feat)[1].tolist() == [3.0, 0.0, 0.0, 0.0]
    with pytest.raises(ValueError, match="exceeds"):
        ts.NoisyTopKGate(6, 2, 3)


# ---------------------------------------------------------------------------
# the slice: SMoEAssembleSparse -> ClsHead -> smoe_recognizer_losses
# ---------------------------------------------------------------------------

MODELS = ("AA-GCN", "CTR-GCN", "DG-GCN", "ST-GCN")
RATIOS = (0.5, 0.4, 0.6, 0.5)
NARROW = dict(base_channels=8, num_stages=2, inflate_stages=(2,),
              down_stages=(2,))
SMOE = dict(k_num=2, sparse_decay=True, loss_coef=0.1)
SHAPE = (4, 2, 8, 25, 3)
EPOCH, MAX_EPOCH, WARM_UP = 2, 10, 4   # experts at 2/5 of their ratios
N_CLASSES, WIDTH = 5, 16


def _smoe(models=MODELS, ratios=RATIOS, **kw):
    graph = dict(layout="nturgb+d", mode="spatial")
    kwargs = {f: NARROW for f in set(models)}
    kw = dict(SMOE, **kw)
    return (js.SMoEAssembleSparse(models, ratios,
                                  graph_cfg=JGraphConfig(**graph),
                                  expert_kwargs=FrozenDict(kwargs), **kw),
            ts.SMoEAssembleSparse(models, ratios,
                                  graph_cfg=GraphConfig(**graph),
                                  expert_kwargs=kwargs, **kw))


def _smoe_vars(jm, seed):
    return _random_variables(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE), 0, MAX_EPOCH,
        train=False)), seed)


@pytest.fixture(scope="module")
def slice_runs():
    """JAX's eval forward and one train step of the slice (one jitted
    program) and the port's, from the same variables, inputs and noise."""
    jm, tm = _smoe()
    v = _smoe_vars(jm, 30)
    head = _random_variables(jax.eval_shape(lambda: JClsHead(
        N_CLASSES, WIDTH, dropout=0.0).init(
            jax.random.PRNGKey(0), jnp.zeros((1, WIDTH)), train=False)), 31)
    jhead = JClsHead(N_CLASSES, WIDTH, dropout=0.0)
    x = _x(32, *SHAPE)
    noise = _x(33, SHAPE[0], len(MODELS) - 1)
    label = np.random.default_rng(34).integers(0, N_CLASSES, SHAPE[0])

    def objective(p, stats, xx):
        (feat, aux), mut = jm.apply(
            {"params": p["smoe"], "batch_stats": stats}, xx, EPOCH,
            MAX_EPOCH, train=True, gate_noise=noise,
            mutable=["batch_stats", "intermediates"])
        logits = jhead.apply({"params": p["head"]}, feat, train=False)
        pen = js.smoe_regularize(p["smoe"], MODELS, RATIOS, lam=1.0)
        losses = j_losses(logits, jnp.asarray(label), aux,
                          current_epoch=EPOCH, warm_up=WARM_UP,
                          penalty_value=pen)
        return losses["loss"], (losses, mut)

    def both(p, stats, xx):
        (feat, aux), inter = jm.apply(
            {"params": p["smoe"], "batch_stats": stats}, xx, EPOCH,
            MAX_EPOCH, train=False, mutable=["intermediates"])
        (_, (losses, mut)), g = jax.value_and_grad(objective, has_aux=True)(
            p, stats, xx)
        new = jax.tree.map(lambda a, b: a - 0.1 * b, p, g)
        return dict(feat=feat, aux=aux, gates=inter["intermediates"]["gates"],
                    losses=losses, grads=g, params=new,
                    stats=mut["batch_stats"],
                    train_gates=mut["intermediates"]["gates"])
    with x64():
        p64 = _f64({"smoe": v["params"], "head": head["params"]})
        want = jax.device_get(jax.jit(both)(
            p64, _f64(v["batch_stats"]), jnp.asarray(x)))
    tm.load_state_dict(convert_jax_variables(v), strict=True)
    th = ClsHead(N_CLASSES, WIDTH, dropout=0.0)
    th.load_state_dict(convert_jax_variables(head), strict=True)
    tm.double()
    th.double()
    before = launch_counts()
    got = {}
    with torch.no_grad():
        got["feat"], got["aux"] = tm.eval()(torch.from_numpy(x), EPOCH,
                                            MAX_EPOCH)
    got["gates"] = tm.gates
    tm.train()
    feat, aux = tm(torch.from_numpy(x), EPOCH, MAX_EPOCH,
                   gate_noise=torch.from_numpy(noise))
    got["train_gates"] = tm.gates
    losses = smoe_recognizer_losses(
        th(feat), torch.from_numpy(label), aux, current_epoch=EPOCH,
        warm_up=WARM_UP, penalty_value=ts.smoe_regularize(tm, 1.0))
    losses["loss"].backward()
    got["losses"] = {k: t.item() for k, t in losses.items()}
    got["grads"] = {f"{m}.{n}": p.grad.clone() for m, mod in
                    (("smoe", tm), ("head", th))
                    for n, p in mod.named_parameters()}
    with torch.no_grad():
        for mod in (tm, th):
            for p in mod.parameters():
                p -= 0.1 * p.grad
    assert launch_counts() == before
    return v, want, got, tm, th


def _port_tree(tree):
    """JAX's {'smoe': ..., 'head': ...} tree in the port's names."""
    return {f"{m}.{k}": t for m in ("smoe", "head")
            for k, t in convert_jax_variables({"params": tree[m]}).items()}


def test_smoe_train_step_float64_matches_jax(slice_runs):
    """The slice's train step: the losses (CE, balance, the warm-up
    penalty at lam 2/4), the gates the noise picked, every gradient and
    every updated parameter and BatchNorm statistic."""
    _, want, got, tm, th = slice_runs
    assert set(got["losses"]) == {"loss_cls", "important_loss",
                                  "panelty_loss", "loss"}
    for k, w in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], float(w), rtol=F64,
                                   err_msg=k)
    np.testing.assert_array_equal(got["train_gates"].numpy() > 0,
                                  want["train_gates"][0] > 0)
    assert_rel(got["train_gates"].numpy(), want["train_gates"][0], F64,
               "train gates")
    grads = _port_tree(want["grads"])
    assert grads.keys() == got["grads"].keys()
    floor = max(float(np.abs(w.numpy()).max()) for w in grads.values())
    for n, w in grads.items():
        assert_rel(got["grads"][n].numpy(), w.numpy(), F64, f"d/d{n}", floor)
    for n in ("smoe.gate.w_gate", "smoe.gate.w_noise"):
        assert np.abs(grads[n].numpy()).max() > 1e-3 * floor, n
    params = _port_tree(want["params"])
    state = {f"{m}.{k}": t for m, mod in (("smoe", tm), ("head", th))
             for k, t in mod.state_dict().items()}
    stats = convert_jax_variables({"batch_stats": want["stats"]})
    assert state.keys() == params.keys() | {f"smoe.{k}" for k in stats}
    for n, w in list(params.items()) + [(f"smoe.{k}", t)
                                        for k, t in stats.items()]:
        assert_rel(state[n].numpy(), w.numpy(), F64, n)


def test_smoe_eval_float64_matches_jax(slice_runs):
    """The eval forward: the combined feature, the balance loss and the
    gates (JAX's sown 'intermediates'), k = 2 nonzero a row."""
    _, want, got, _, _ = slice_runs
    assert_rel(got["feat"].numpy(), want["feat"], F64, "feature")
    assert_rel(got["aux"].item(), float(want["aux"]), F64, "aux")
    assert_rel(got["gates"].numpy(), want["gates"][0], F64, "gates")
    assert ((got["gates"] > 0).sum(1) == 2).all()


def test_smoe_regularize_double_append_matches_jax(slice_runs):
    """``smoe_regularize`` (GL and GSGL) equals JAX's on the slice's
    initial tree, and counts each stage of an ST-, AA- or DG-GCN expert
    twice and a CTR-GCN expert's once (the reference's try/else quirk)."""
    v = slice_runs[0]
    _, tm = _smoe()
    tm.load_state_dict(convert_jax_variables(v), strict=True)
    tm.double()
    with x64():
        p64 = _f64(v["params"])
        for pen in ("GL", "GSGL"):
            want = float(jax.jit(lambda p, pen=pen: js.smoe_regularize(
                p, MODELS, RATIOS, 0.3, pen))(p64))
            assert_rel(ts.smoe_regularize(tm, 0.3, pen).item(), want, F64,
                       pen)
    by_hand = sum((1 if f == "CTR-GCN" else 2) * torch.linalg.vector_norm(
        ts._stage_mask(blk, RATIOS[j]))
        for j, f in enumerate(MODELS) for blk in tm.expert(j).blocks())
    assert_rel(ts.smoe_regularize(tm, 1.0).item(), by_hand.item(), F64,
               "double append")


@pytest.mark.parametrize("lam", ["gradual", 0.3])
def test_smoe_losses_warm_up_ramp_matches_jax(lam):
    """``smoe_recognizer_losses`` over the epochs around warm_up 4: the
    penalty at the gradual lam = epoch / 4 (or a fixed lam) up to epoch 4,
    absent after; CE and the balance loss as JAX's."""
    logits, label = _x(40, 6, 5), np.random.default_rng(41).integers(0, 5, 6)
    aux, pen = 0.0123, 2.5
    for epoch in (0, 1, 2, 4, 5, 7):
        with x64():
            want = {k: float(t) for k, t in j_losses(
                jnp.asarray(logits), jnp.asarray(label), jnp.asarray(aux),
                current_epoch=epoch, warm_up=4, lam=lam,
                penalty_value=jnp.asarray(pen)).items()}
        got = {k: float(t) for k, t in smoe_recognizer_losses(
            torch.from_numpy(logits), torch.from_numpy(label),
            torch.tensor(aux, dtype=torch.float64), current_epoch=epoch,
            warm_up=4, lam=lam,
            penalty_value=torch.tensor(pen, dtype=torch.float64)).items()}
        assert got.keys() == want.keys()
        assert ("panelty_loss" in got) == (epoch <= 4)
        for k in want:
            assert_rel(got[k], want[k], F64, f"{k} at epoch {epoch}")
    assert smoe_recognizer_losses(
        torch.from_numpy(logits), torch.from_numpy(label), torch.tensor(0.),
        current_epoch=2, warm_up=4,
        penalty_value=torch.tensor(2.0))["panelty_loss"].item() == 1.0


def test_smoe_structure_init_and_names_follow_jax(slice_runs):
    """The experts keep the nested semantics (ST-GCN one global threshold,
    CTR-GCN every score pooled), the gate takes the base's width, the JAX
    tree names every parameter, and ``init_weights_`` leaves the gate's
    weights at zero and draws the experts' sparse kernels."""
    v = slice_runs[0]
    _, tm = _smoe()
    assert tm.num_experts == 3 and tm.expert(3).global_threshold
    assert tm.expert(1).pool_all_scores
    assert tuple(tm.gate.w_gate.shape) == (WIDTH, 3)
    assert set(jax_param_names(tm).values()) == {
        ".".join(str(k.key) for k in path) for path, _ in
        jax.tree_util.tree_flatten_with_path(v["params"])[0]}
    assert jax_param_names(tm)["gate.w_gate"] == "gate.w_gate"
    init_weights_(tm, torch.Generator().manual_seed(0))
    assert (tm.gate.w_gate == 0).all() and (tm.gate.w_noise == 0).all()
    conv = tm.expert(2).block1.gcn.post_conv
    assert conv.score.abs().max() <= conv.weight[0].numel() ** -0.5
    assert conv.score.abs().max() > 0
    with pytest.raises(ValueError, match="ratios"):
        ts.SMoEAssembleSparse(MODELS, RATIOS[:2])
    with pytest.raises(ValueError, match="unknown expert"):
        ts.make_expert("GCN", 0.5, GraphConfig(), 0, False)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------

EP_MODELS, EP_RATIOS = ("ST-GCN",) * 3, (0.4,) * 3
EP_EPOCH = (5, 10)


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    """The port's two ranks (started first), JAX's make_ep_smoe_eval on a
    2-device mesh and the port's dense forward, float64, distinct experts
    and a random w_gate."""
    tmp = tmp_path_factory.mktemp("ep")
    jm, tm = _smoe(EP_MODELS, EP_RATIOS, k_num=1)
    v = _smoe_vars(jm, 50)
    x = _x(51, *SHAPE)
    # a gate of opposite columns: a sample's sign picks its expert
    w = _x(52, WIDTH, 1)
    v["params"]["gate"]["w_gate"] = np.concatenate([w, -w], 1)
    state = convert_jax_variables(_f64(v))
    case = dict(name="ep", kind="ep", state=state, x=torch.from_numpy(x),
                epochs=list(EP_EPOCH),
                graph=dict(layout="nturgb+d", mode="spatial"),
                smoe=dict(model_list=list(EP_MODELS),
                          sparse_ratio=list(EP_RATIOS),
                          expert_kwargs={"ST-GCN": NARROW}, **dict(
                              SMOE, k_num=1)))
    procs = launch(dict(mesh=(2, 1), cases=[case]), 2, str(tmp))
    with x64():
        v64 = _f64(v)
        feat_j, aux_j = jax.device_get(jep.make_ep_smoe_eval(
            jep.make_expert_mesh(2), jm)(v64, jnp.asarray(x), *EP_EPOCH))
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        dense = tm.eval()(torch.from_numpy(x), *EP_EPOCH)
    return collect(procs, str(tmp)), (feat_j, aux_j), dense, tm


def test_expert_parallel_matches_jax_and_dense(ep_runs):
    """Each rank's feature and balance loss (its expert's share summed by
    one all_reduce over gloo) against JAX's expert-parallel eval and
    against the port's dense SMoE forward, at 1e-6; the samples route to
    both experts."""
    ranks, (feat_j, aux_j), (feat_d, aux_d), tm = ep_runs
    for r in ranks:
        assert_rel(r["ep/feat"], feat_j, 1e-6, "EP feature vs JAX's EP")
        assert_rel(r["ep/feat"], feat_d.numpy(), 1e-6, "EP vs the dense")
        assert_rel(r["ep/aux"], float(aux_j), 1e-6, "aux vs JAX's EP")
        assert_rel(r["ep/aux"], aux_d.item(), 1e-6, "aux vs the dense")
    # a rank holds its expert, the base and the gate, not every expert
    held = sum(p.numel() for m in (tm.expert(0), tm.expert(2), tm.gate)
               for p in m.parameters())
    assert [int(r["ep/params"]) for r in ranks] == [held, held]
    assert held < sum(p.numel() for p in tm.parameters())
    assert set(tm.gates.argmax(1).tolist()) == {0, 1}


def test_expert_parallel_refuses_as_jax():
    """Heterogeneous routed experts (family or ratio) and an expert axis
    of another size than E are refused, as JAX's asserts refuse them."""
    cases = [(("ST-GCN", "CTR-GCN", "ST-GCN"), (0.4,) * 3, 2),
             (EP_MODELS, (0.4, 0.5, 0.4), 2), (EP_MODELS, EP_RATIOS, 3)]
    for models, ratios, size in cases:
        jm, tm = _smoe(models, ratios, k_num=1)
        with pytest.raises(AssertionError):
            jep.make_ep_smoe_eval(jep.make_expert_mesh(size), jm)
        with pytest.raises(ValueError):
            tep.make_ep_smoe_eval(tep.ExpertMesh(None, size, 0), tm)
    stacked = tep.stack_pytrees([tm.expert(0).state_dict(),
                                 tm.expert(1).state_dict()])
    assert stacked["block0.gcn.A"].shape[0] == 2
