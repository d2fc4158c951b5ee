"""Port parity, the other GCN families: MS-G3D's ops
(``multi_scale_adjacency``, ``unfold_temporal_windows``, ``MSGCN``,
``STMSGCN``, ``MSG3DBlock``, ``MWMSG3DBlock``), ``MSG3D``, ``SGN``
(``_adaptive_max_pool``, ``TorchBN``), ``GTGC``/``UnitGTGCN`` and
``GTGCN``, ``UnitGCNEdge``, ``UnitTCNEdge`` and ``STGIN``, ``UnitGCN``'s
external graph and ``STGCN_GC``, of ``dsgcn_tpu_torch`` against
``dsgcn_tpu`` on the CPU; the refusals JAX makes; the init rules of the
new leaves.

None of these reaches a Pallas kernel in JAX or launches a kernel of the
port.  Variables are drawn with ``jax.eval_shape`` + numpy
(``test_torch_port_dggcn._random_variables``), inputs are numpy from a
seed.  Tolerances: the host graph helpers in float32 at 1e-5; in float64
at 1e-8 relative, every unit's eval output, the train pass of MS-G3D's
and STGIN's units (outputs, input and parameter gradients, BatchNorm
statistics), and the eval logits and one step (loss, parameters,
statistics) of SGN, GTGCN and STGIN through both packages' ``train_step``
and of STGCN_GC with a GCNHead by hand; MS-G3D's recognizer, eval and
``train_step``, runs with ``-m slow`` (JAX's programs alone take 30-40 s
to build on a CPU).  Each JAX side is jitted.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu.core.train import TrainState
from dsgcn_tpu.core.train import eval_step as j_eval_step
from dsgcn_tpu.core.train import make_optimizer as j_make_optimizer
from dsgcn_tpu.core.train import train_step as j_train_step
from dsgcn_tpu.models import msg3d_sgn as jms
from dsgcn_tpu.models.builder import build_backbone as j_build_backbone
from dsgcn_tpu.models.builder import build_head as j_build_head
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu.ops import gcn as jgcn
from dsgcn_tpu.ops import msg3d as jmsg3d
from dsgcn_tpu.ops import tcn as jtcn
from dsgcn_tpu_torch.models import msg3d_sgn
from dsgcn_tpu_torch.core.train import make_optimizer, train_step
from dsgcn_tpu_torch.models.builder import (build_backbone, build_head,
                                            build_model, init_weights_,
                                            model_cfg)
from dsgcn_tpu_torch.ops import gcn, msg3d, tcn
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _random_variables
from test_torch_port_grad import assert_rel

NM, T, V = 4, 8, 25          # 2 clips x 2 bodies at the unit level
F64 = 1e-8


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _graph():
    g = JGraph(layout="nturgb+d", mode="spatial")
    return dict(A_init=g.A.astype(np.float32), edge_type=g.edge_type,
                node_type=np.array(g.node_type))


def _a_bin():
    return JGraph(layout="nturgb+d", mode="binary_adj").A[0].astype(
        np.float32)


class x64:
    """JAX in float64 inside the block."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _init_vars(jmod, seed, *args):
    """Random variables of a JAX module called on ``args`` (train=False)."""
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), train=False))
    return _random_variables(shapes, seed)


# ---------------------------------------------------------------------------
# the host graph helpers, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [1, 3])
def test_multi_scale_adjacency_matches_jax(window):
    """The 13 hop scales of NTU's binary graph, and 6 of the graph tiled
    over a window of 3 frames (STMSGCN's)."""
    A = _a_bin()
    if window > 1:
        A = np.tile(A + np.eye(V, dtype=A.dtype), (window, window))
    scales = 13 if window == 1 else 6
    got = msg3d.multi_scale_adjacency(A, scales)
    want = jmsg3d.multi_scale_adjacency(A, scales)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t,ws,stride,dil", [(9, 3, 1, 1), (11, 5, 2, 2),
                                             (11, 3, 2, 1)])
def test_unfold_temporal_windows_matches_jax(t, ws, stride, dil):
    """Window-major on the joint axis, at odd T, stride 2, dilation 2."""
    x = _x(t, 2, t, V, 4).astype(np.float32)
    got = msg3d.unfold_temporal_windows(torch.from_numpy(x), ws, stride,
                                        dil).numpy()
    want = np.asarray(jmsg3d.unfold_temporal_windows(jnp.asarray(x), ws,
                                                     stride, dil))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [30, 7])
def test_adaptive_max_pool_matches_jax(t):
    """SGN's T = 30 pooled to 20 bins of uneven length (floor(i T / 20)
    to ceil((i + 1) T / 20)), and a T shorter than the bins (overlaps)."""
    x = _x(t + 1, 3, t, V, 5).astype(np.float32)
    got = msg3d_sgn._adaptive_max_pool(torch.from_numpy(x), 20).numpy()
    want = np.asarray(jms._adaptive_max_pool(jnp.asarray(x), 20))
    assert got.shape == want.shape == (3, 20, 1, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# units, float64 eval outputs (one JAX program for all of them)
# ---------------------------------------------------------------------------

def _unit_cases():
    """name -> (JAX module, port module, inputs, port's extra call args
    from the inputs)."""
    g, A = _graph(), _a_bin()
    K = g["A_init"].shape[0]
    x8 = _x(1, NM, T, V, 8)
    x16 = _x(2, NM, T, V, 16)
    es = _x(3, NM, T, V, V, 8)
    et = _x(4, NM, T, V, 16)
    et8 = _x(5, NM, T, V, 8)
    a_ext = 0.1 * _x(6, K, V, V)
    gt = dict(num_types=5, reduce=4, edge_type=g["edge_type"],
              node_type=g["node_type"])
    return {
        "msgcn": (jmsg3d.MSGCN(3, 16, A), msg3d.MSGCN(3, 8, 16, A), (x8,)),
        "stmsgcn_res": (jmsg3d.STMSGCN(16, A, 2, 3, residual=True),
                        msg3d.STMSGCN(8, 16, A, 2, 3, residual=True),
                        (msg3d.unfold_temporal_windows(
                            torch.from_numpy(x8), 3, 1).numpy(),)),
        "msg3d_block_embed": (
            jmsg3d.MSG3DBlock(8, 16, A, 2, 5, 2, 2, embed_factor=2),
            msg3d.MSG3DBlock(8, 16, A, 2, 5, 2, 2, embed_factor=2), (x8,)),
        "no_act_inner": (jms._NoActInner(16), msg3d_sgn._NoActInner(16, 16),
                         (x16,)),
        "unit_gtgcn_options": (
            jgcn.UnitGTGCN(16, A_init=g["A_init"], adaptive="offset",
                           edge_attention=True, target_specific=True,
                           global_attention=True, **gt),
            gcn.UnitGTGCN(8, 16, g["A_init"], adaptive="offset",
                          edge_attention=True, target_specific=True,
                          global_attention=True, **gt), (x8,)),
        "unit_gtgcn_importance": (
            jgcn.UnitGTGCN(16, A_init=g["A_init"], adaptive="importance",
                           **gt),
            gcn.UnitGTGCN(16, 16, g["A_init"], adaptive="importance", **gt),
            (x16,)),
        "unit_gcnedge": (
            jgcn.UnitGCNEdge(16, A_init=g["A_init"], with_res=True),
            gcn.UnitGCNEdge(8, 16, g["A_init"], with_res=True,
                            edge_t_channels=8), (x8, es, et8)),
        "unit_tcnedge_stride2": (
            jtcn.UnitTCNEdge(16, stride=2),
            tcn.UnitTCNEdge(16, 16, stride=2),
            (x16, et, _x(7, NM, T, V, V, 16))),
        "mw_msg3d_block_stem": (jmsg3d.MWMSG3DBlock(3, 16, A, 2),
                                msg3d.MWMSG3DBlock(3, 16, A, 2),
                                (x8[..., :3],)),
        "unit_gcn_a_ext": (
            jgcn.UnitGCN(16, A_init=g["A_init"], adaptive="offset"),
            gcn.UnitGCN(8, 16, g["A_init"], adaptive="offset"), (x8, a_ext)),
    }


def _apply(jmod, v, args, train, **kw):
    """JAX's call of a unit on ``args``."""
    if isinstance(jmod, jgcn.UnitGCN):
        return jmod.apply(v, args[0], train=train, A_ext=args[1], **kw)
    return jmod.apply(v, *args, train=train, **kw)


def _jax_init(jmod, seed, args):
    if isinstance(jmod, jgcn.UnitGCN):
        shapes = jax.eval_shape(lambda: jmod.init(
            jax.random.PRNGKey(0), jnp.asarray(args[0]), train=False,
            A_ext=jnp.asarray(args[1])))
        return _random_variables(shapes, seed)
    return _init_vars(jmod, seed, *args)


def _outs(y):
    return y if isinstance(y, tuple) else (y,)


# the units whose train pass is held here: MS-G3D's (its recognizer's
# train_step is the slow test_msg3d_train_step_float64_matches_jax) and
# STGIN's shared-BN units; GTGCN's units and the external graph train in
# their backbones' steps below
TRAIN_UNITS = ("msgcn", "msg3d_block_embed", "no_act_inner",
               "unit_gcnedge", "unit_tcnedge_stride2")


@pytest.fixture(scope="module")
def units():
    """name -> (port module, variables, inputs, JAX's float64 eval
    outputs, JAX's float64 train pass or None), made on first use: the
    train pass is (outputs, cotangents, parameter and input gradients of
    sum(outputs * cotangents), updated statistics).  Each unit's JAX side
    is jitted on its own (one program for many units compiles slower
    than its parts)."""
    cases, done = _unit_cases(), {}

    def get(k):
        if k in done:
            return done[k]
        jmod, port, a = cases[k]
        v = _jax_init(jmod, len(done), a)
        with x64():
            v64, args = _f64(v), tuple(map(jnp.asarray, a))
            outs = jax.device_get(_outs(jax.jit(
                lambda vv, aa: _apply(jmod, vv, aa, False))(v64, args)))
            train = None
            if k in TRAIN_UNITS:
                cot = tuple(np.random.default_rng(i).standard_normal(
                    o.shape) for i, o in enumerate(outs))

                def loss(p, aa):
                    y, mut = _apply(jmod, {**v64, "params": p}, aa,
                                    train=True, mutable=["batch_stats"])
                    y = _outs(y)
                    return sum(jnp.sum(yi * ci)
                               for yi, ci in zip(y, cot)), (y, mut)
                (_, (y, mut)), (gp, ga) = jax.device_get(jax.jit(
                    jax.value_and_grad(loss, argnums=(0, 1),
                                       has_aux=True))(v64["params"], args))
                train = (y, cot, gp, ga, mut)
        done[k] = (port, v, a, outs, train)
        return done[k]
    return get


@pytest.mark.parametrize("name", list(_unit_cases()))
def test_unit_eval_float64_matches_jax(units, name):
    port, v, args, want, _ = units(name)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    port.double().eval()
    with torch.no_grad():
        got = _outs(port(*map(torch.from_numpy, args)))
    assert len(got) == len(want)
    for i, (g_, w_) in enumerate(zip(got, want)):
        assert_rel(g_.numpy(), w_, F64, f"{name} output {i}")


@pytest.mark.parametrize("name", TRAIN_UNITS)
def test_unit_train_float64_matches_jax(units, name):
    """A train-mode pass: the outputs, the gradients of sum(outputs *
    cotangents) with respect to every input and parameter (what one SGD
    step applies), and the BatchNorm statistics it leaves (UnitGCNEdge's
    one BN moved three times, UnitTCNEdge's four)."""
    port, v, args, _, (y_j, cot, gp, ga, mut) = units(name)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    port.double().train()
    xs = [torch.from_numpy(a).requires_grad_() for a in args]
    y = _outs(port(*xs))
    sum((yi * torch.from_numpy(ci)).sum() for yi, ci in zip(y, cot)) \
        .backward()
    for i, (g_, w_) in enumerate(zip(y, y_j)):
        assert_rel(g_.detach().numpy(), w_, F64, f"{name} output {i}")
    for i, (x_, w_) in enumerate(zip(xs, ga)):
        assert_rel(x_.grad.numpy(), w_, F64, f"{name} input grad {i}")
    want = convert_jax_variables({"params": gp})
    floor = 1e-2 * max(np.abs(w.numpy()).max() for w in want.values())
    for k, p in port.named_parameters():
        assert_rel(p.grad.numpy(), want[k].numpy(), F64, f"grad {k}", floor)
    stats = convert_jax_variables({"batch_stats": mut["batch_stats"]})
    state = port.state_dict()
    assert {k for k in state if "running" in k} == stats.keys()
    for k, w in stats.items():
        assert_rel(state[k].numpy(), w.numpy(), F64, k)


# ---------------------------------------------------------------------------
# the backbones: float64 eval logits and one train step each
# ---------------------------------------------------------------------------

# the stem (3 -> 8) and 8 -> 16 at stride 2
NARROW = dict(num_stages=2, base_channels=8, inflate_stages=(2,),
              down_stages=(2,))


def _family_cfgs(family):
    """(JAX config, port config, input (N, M, T, V, C)) of a narrow
    recognizer of the family; per-stage tuples put each option on a
    stage of its own."""
    if family in ("msg3d", "sgn"):
        out = []
        for mc in (j_model_cfg, model_cfg):
            c = mc(family, num_classes=7)
            c["backbone"].update(
                dict(base_channels=8, num_gcn_scales=3, num_g3d_scales=2)
                if family == "msg3d" else dict(base_channels=8))
            c["cls_head"]["in_channels"] = 32 if family == "msg3d" else 64
            out.append(c)
        return out + [(2, 2, 30 if family == "sgn" else 12, V, 3)]
    bb = dict(type=family.upper(), graph_cfg=dict(layout="nturgb+d",
                                                  mode="spatial"), **NARROW)
    if family == "gtgcn":       # 'importance' in test_unit_eval_...
        bb.update(gcn_adaptive=("init", "offset"),
                  gcn_edge_attention=(True, False),
                  gcn_target_specific=(False, True),
                  gcn_global_attention=(True, True), gcn_reduce=4)
    else:                       # stgin; 'importance' in test_unit_eval_...
        bb.update(gcn_adaptive=("init", "offset"),
                  gcn_with_res=(False, True))
    cfg = dict(type="RecognizerGCN", backbone=bb,
               cls_head=dict(type="GCNHead", num_classes=7, in_channels=16))
    return cfg, cfg, (2, 2, T, V, 3)


def _sgn_dropout(shape, seed):
    """The same dropout mask on both sides of SGN's step: JAX's
    ``nn.Dropout`` intercepted, the port's ``dropout`` replaced."""
    keep = np.random.default_rng(seed).random(shape) >= 0.2

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and not mod.deterministic:
            x = args[0]
            return jnp.where(jnp.asarray(keep), x / 0.8, 0)
        return next_fun(*args, **kwargs)

    def port_dropout(x, p, training, generator=None):
        if not training:
            return x
        assert p == 0.2
        return torch.where(torch.from_numpy(keep), x / 0.8,
                           torch.zeros((), dtype=x.dtype))
    return interceptor, port_dropout


def _jax_eval_and_step(jcfg, v, x, batch):
    """JAX's float64 eval logits on ``x`` and one ``train_step`` on
    ``batch`` from the variables ``v``, compiled as one program: (logits,
    loss, the new variables as the port's state dict)."""
    ref = j_build_model(jcfg)
    tx, _ = j_make_optimizer(lr=0.1, total_steps=1)
    v = _f64(v)
    state = TrainState.create(ref.apply, v["params"], v["batch_stats"], tx)

    def both(st, b, xx):
        logits = j_eval_step(ref.apply, st.params, st.batch_stats, xx)
        new, m = j_train_step(st, b, jax.random.PRNGKey(0))
        return logits, m["loss"], {"params": new.params,
                                   "batch_stats": new.batch_stats}
    logits, loss, new = jax.device_get(jax.jit(both)(
        state, dict(keypoint=jnp.asarray(batch["keypoint"]),
                    label=jnp.asarray(batch["label"])), jnp.asarray(x)))
    return (np.asarray(logits), float(loss),
            convert_jax_variables(jax.tree.map(np.array, new)))


def _recognizer_case(family):
    """(JAX config, port model loaded from JAX's variables in float64,
    variables, eval input, train batch, port's eval logits)."""
    jcfg, tcfg, shape = _family_cfgs(family)
    x = _x(30, *shape)
    v = _init_vars(j_build_model(jcfg), 31, x.astype(np.float32))
    rng = np.random.default_rng(32)
    batch = dict(keypoint=rng.standard_normal(shape),
                 label=rng.integers(0, 7, shape[0]))
    port = build_model(tcfg)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    port.double()
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    return jcfg, port, v, x, batch, got


def _step_matches_jax(family, monkeypatch):
    """The recognizer's float64 eval logits and one float64 step through
    both packages' train_step, against JAX at 1e-8; no kernel launched."""
    before = launch_counts()
    jcfg, port, v, x, batch, got = _recognizer_case(family)
    with x64():
        if family == "sgn":
            intercept, port_dropout = _sgn_dropout((4, 20, 1, 32), seed=33)
            monkeypatch.setattr(msg3d_sgn, "dropout", port_dropout)
            with nn.intercept_methods(intercept):
                want, jl, new = _jax_eval_and_step(jcfg, v, x, batch)
        else:
            want, jl, new = _jax_eval_and_step(jcfg, v, x, batch)
    assert_rel(got, want, F64, "eval logits")
    opt, sched = make_optimizer(port, total_steps=1)
    tl = train_step(port, opt, sched, batch)["loss"].item()
    assert launch_counts() == before
    np.testing.assert_allclose(tl, jl, rtol=F64)
    state = port.state_dict()
    assert state.keys() == new.keys()
    for name, w in new.items():
        assert_rel(state[name].numpy(), w.numpy(), F64, name)


@pytest.mark.parametrize("family", ["sgn", "gtgcn", "stgin"])
def test_recognizer_float64_matches_jax(family, monkeypatch):
    """The narrow recognizer's float64 eval logits, then one float64 step
    through both packages' train_step (SGD, Nesterov momentum, weight
    decay): loss, parameters and BatchNorm statistics (STGIN's shared
    BNs included) at 1e-8.  SGN runs at its T = 30 with the same dropout
    mask on both sides."""
    _step_matches_jax(family, monkeypatch)


@pytest.mark.slow
def test_msg3d_train_step_float64_matches_jax(monkeypatch):
    """MS-G3D's recognizer: its float64 eval logits and one step through
    both packages' train_step (tier-1 holds its units' eval outputs and
    train passes): JAX's program alone takes 25-35 s to trace and compile
    on a CPU, so this runs with ``-m slow``."""
    _step_matches_jax("msg3d", monkeypatch)


def test_stgcn_gc_float64_matches_jax():
    """STGCN_GC (per-stage gcn_adaptive None and 'importance'; 'offset'
    in test_unit_eval_float64_matches_jax) fed an external graph, with a
    GCNHead: float64 eval logits, then one SGD
    step by hand on both sides (cross entropy, lr 0.1, no momentum):
    loss, parameters and BatchNorm statistics at 1e-8."""
    bb = dict(type="STGCN_GC", graph_cfg=dict(layout="nturgb+d",
                                              mode="spatial"),
              gcn_adaptive=(None, "importance"), **NARROW)
    hd = dict(type="GCNHead", num_classes=7, in_channels=16)
    jb, jh = j_build_backbone(bb), j_build_head(hd)
    x = _x(40, 2, 2, T, V, 3)
    a_ext = 0.1 * np.abs(_x(41, 3, V, V))
    label = np.random.default_rng(42).integers(0, 7, 2)
    shapes = jax.eval_shape(lambda: jb.init(
        jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
        jnp.asarray(a_ext, jnp.float32), train=False))
    vb = _random_variables(shapes, 43)
    vh = _random_variables(jax.eval_shape(lambda: jh.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 2, 4, V, 16)), train=False)),
        44)
    backbone, head = build_backbone(bb), build_head(hd)
    backbone.load_state_dict(convert_jax_variables(vb), strict=True)
    head.load_state_dict(convert_jax_variables(vh), strict=True)
    backbone.double(), head.double()
    xt, at = torch.from_numpy(x), torch.from_numpy(a_ext)
    with torch.no_grad():
        got = head.eval()(backbone.eval()(xt, at)).numpy()

    def j_loss(params, stats, train):
        feat, mut = jb.apply({"params": params["b"], "batch_stats": stats},
                             x, a_ext, train=train, mutable=["batch_stats"])
        logits = jh.apply({"params": params["h"]}, feat, train=train)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(2), label]), (logits, mut)

    with x64():
        params = _f64({"b": vb["params"], "h": vh["params"]})
        stats = _f64(vb["batch_stats"])
        want = jax.jit(lambda p, s: j_loss(p, s, False)[1][0])(params, stats)
        (jl, (_, mut)), grads = jax.jit(jax.value_and_grad(
            lambda p, s: j_loss(p, s, True), has_aux=True))(params, stats)
        new = jax.device_get(jax.tree.map(lambda p, g: p - 0.1 * g, params,
                                          grads))
        mut = jax.device_get(mut)
    assert_rel(got, np.asarray(want), F64, "eval logits")
    backbone.train(), head.train()
    logits = head(backbone(xt, at))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(label))
    params = list(backbone.parameters()) + list(head.parameters())
    opt = torch.optim.SGD(params, lr=0.1)
    opt.zero_grad()
    loss.backward()
    opt.step()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=F64)
    for mod, tree in ((backbone, {"params": new["b"],
                                  "batch_stats": mut["batch_stats"]}),
                      (head, {"params": new["h"]})):
        want_sd = convert_jax_variables(tree)
        state = mod.state_dict()
        assert state.keys() == want_sd.keys()
        for name, w in want_sd.items():
            assert_rel(state[name].numpy(), w.numpy(), F64, name)


# ---------------------------------------------------------------------------
# refusals, builds and the init rules
# ---------------------------------------------------------------------------

def test_refusals_follow_jax():
    """JAX's refusals: an external graph into adaptive='init', UnitGCNEdge
    with conv_pos='post', SGN at another T than its 30."""
    g = _graph()
    x, a_ext = _x(50, 2, 4, V, 8), _x(51, 3, V, V)
    jmod = jgcn.UnitGCN(8, A_init=g["A_init"])
    with pytest.raises(AssertionError, match="external A"):
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32),
                  train=False, A_ext=jnp.asarray(a_ext))
    with pytest.raises(ValueError, match="external A"):
        gcn.UnitGCN(8, 8, g["A_init"])(torch.from_numpy(x).float(),
                                       torch.from_numpy(a_ext))
    es = jnp.zeros((2, 4, V, V, 8))
    with pytest.raises(AssertionError, match="post"):
        jgcn.UnitGCNEdge(8, A_init=g["A_init"], conv_pos="post").init(
            jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32), es,
            jnp.asarray(x, jnp.float32), train=False)
    with pytest.raises(ValueError, match="post"):
        gcn.UnitGCNEdge(8, 8, g["A_init"], conv_pos="post")
    clip = jnp.zeros((1, 2, 20, V, 3))
    with pytest.raises(AssertionError, match="T=30"):
        jms.SGN().init(jax.random.PRNGKey(0), clip, train=False)
    with pytest.raises(ValueError, match="T=30"):
        msg3d_sgn.SGN()(torch.zeros(1, 2, 20, V, 3))


def test_init_rules_follow_jax():
    """init_weights_ draws JAX's initializers for the new leaves: MS-G3D's
    ``PA`` U(-1e-6, 1e-6) and window kernels U(+-1/sqrt(w C)) with zero
    biases, CTRMSTCN's kaiming 1x1s in ``_NoActInner``, STGIN's 'offset'
    PA U(0, 2e-6) and 'importance' PA ones, GTGC's zero gates."""
    gen = torch.Generator().manual_seed(0)
    m = init_weights_(build_model(model_cfg("msg3d")), gen).backbone
    pa = m.sgcn2_gcn.PA
    assert pa.abs().max() <= 1e-6 and pa.std() > 4e-7
    blk = m.gcn3d2.gcn3d1                      # window 5, 96 -> 192
    w = blk.out_conv_kernel
    assert w.shape == (5, 96, 192) and (blk.out_conv_bias == 0).all()
    bound = (5 * 96) ** -0.5
    assert w.abs().max() <= bound and w.std() > 0.5 * bound
    pre = m.sgcn1_tcn2.branch0_pre.weight     # kaiming_normal_fan_out
    assert abs(pre.std().item() / (2 / pre.shape[0]) ** 0.5 - 1) < 0.15
    spatial = dict(layout="nturgb+d", mode="spatial")
    st = init_weights_(build_backbone(dict(
        type="STGIN", graph_cfg=spatial, num_stages=2,
        gcn_adaptive=("offset", "importance"))), gen)
    assert 0 <= st.block0.gcn.PA.min() and st.block0.gcn.PA.max() <= 2e-6
    assert (st.block1.gcn.PA == 1).all()
    gt = init_weights_(build_backbone(dict(
        type="GTGCN", graph_cfg=spatial, num_stages=2,
        gcn_global_attention=True)), gen)
    assert (gt.block1.gcn1.convs.alpha == 0).all()
    assert (gt.block1.gcn1.convs.beta == 0).all()
