"""Port parity, the GCN necks, heads, flows and causality data: the necks
(``SimpleNeck``, ``SemanticNeck``, ``ReadoutNeck`` with ``Set2Set``,
``PretrainNeck``, ``CMLP``, ``CausalNeck``), ``HGTHead``, ``ClsHead``,
``mask_keypoints``, ``pretrain_losses``, ``gcnr_losses``, ``Causalmetrix``
and ``pte`` of ``dsgcn_tpu_torch`` against ``dsgcn_tpu`` on the CPU.

None of these reaches a Pallas kernel in JAX or launches a kernel of the
port.  Tolerances: in float64 1e-8 relative to the largest entry
(forwards, costs, gradients, steps), with JAX's float32 casts before the
log-softmax of the node-type losses (``necks.py``, ``heads.py``) made
float64 by a monkeypatch (the port takes them in ``accum_dtype``); the
recognizers' float32 logits 1e-5; ``pte`` and ``Causalmetrix`` (the same
numpy arithmetic) 1e-12.  The narrow DS-GCN runs on the dense path
(``gcn_use_pallas=False``) on both sides.  The JAX side of each case is
one jitted program.
"""
import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from dsgcn_tpu.core import flows as jflows
from dsgcn_tpu.data import causal_pte as jpte
from dsgcn_tpu.data import transforms as JT
from dsgcn_tpu.models import heads as jheads
from dsgcn_tpu.models import necks as jnecks
from dsgcn_tpu.models.builder import build_backbone as j_build_backbone
from dsgcn_tpu.models.builder import build_head as j_build_head
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu_torch.core import flows
from dsgcn_tpu_torch.core.train import (jax_param_names, make_optimizer,
                                        paramwise_mults, train_step)
from dsgcn_tpu_torch.data import causal_pte
from dsgcn_tpu_torch.data import transforms as T
from dsgcn_tpu_torch.models import necks
from dsgcn_tpu_torch.models.builder import (build_head, build_model,
                                            init_weights_)
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _random_variables
from test_torch_port_gcn_families import F64, _f64, _x, x64
from test_torch_port_grad import assert_rel
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu_torch.models.builder import model_cfg


class _Float64Numpy:
    """``jax.numpy`` whose ``float32`` is ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_f64(monkeypatch):
    """JAX in float64, its necks' and heads' float32 casts too."""
    monkeypatch.setattr(jnecks, "jnp", _Float64Numpy())
    monkeypatch.setattr(jheads, "jnp", _Float64Numpy())
    with x64():
        yield


def _jvars(jmod, seed, *args, **kw):
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args), **kw))
    return _random_variables(shapes, seed)


def _load(port, v):
    port.load_state_dict(convert_jax_variables(v), strict=True)
    return port.double()


def _grads_as_port(g):
    return convert_jax_variables({"params": jax.tree.map(np.asarray, g)})


def _check_grads(port, gx_port, g_jax, gx_jax, what):
    assert_rel(gx_port, gx_jax, F64, f"{what} d/dx")
    want = _grads_as_port(g_jax)
    got = {n: p.grad for n, p in port.named_parameters()}
    assert got.keys() == want.keys()
    for n, w in want.items():
        g = got[n]
        g = np.zeros(w.shape) if g is None else g.numpy()
        if n.endswith("gate.bias"):
            # the softmax within a segment does not see a shift: both
            # sides' gradients are rounding noise around 0
            assert np.abs(g).max() < 1e-12 and np.abs(w.numpy()).max() \
                < 1e-12, (what, n)
            continue
        assert_rel(g, w.numpy(), F64, f"{what} d/d{n}")


# ---------------------------------------------------------------------------
# ReadoutNeck, every read_op, the soft and hard minimum
# ---------------------------------------------------------------------------

C, P = 16, 5
SHAPE = (3, 2, 4, 6, C)           # N, M, T, V, C


def _readout_input(seed):
    """Rows with a positive first channel and a prototype pointing the
    other way: that prototype's segments are empty in every sample."""
    x = _x(seed, *SHAPE)
    x[..., 0] = np.abs(x[..., 0]) + 2.0
    return x


def _away_proto(v, key="protos"):
    p = np.asarray(v["params"][key]).copy()
    p[-1] = 0.0
    p[-1, 0] = -1.0
    v["params"][key] = p
    return v


@pytest.mark.parametrize("gamma", [0.0, 0.1])
@pytest.mark.parametrize("read_op", necks.READ_OPS)
def test_readout_neck_matches_jax(read_op, gamma, jax_f64):
    """Forward, ``get_aligncost`` and the gradients of
    sum(r * forward) + aligncost to the input and every parameter, in
    float64, with an empty prototype segment in every sample (the mean's
    count clamped at 1, the max's -inf made 0, the attention's and
    set2set's softmax over nothing)."""
    jn = jnecks.ReadoutNeck(C, num_position=P, read_op=read_op, gamma=gamma)
    x = _readout_input(1)
    v = _away_proto(_f64(_jvars(jn, 2, x.astype(np.float32), train=False)))
    width = 2 * C if read_op == "set2set" else C
    r = _x(3, SHAPE[0], width)

    def objective(p, xx):
        out = jn.apply({"params": p}, xx, train=False)
        cost = jn.apply({"params": p}, xx, method=jnecks.ReadoutNeck
                        .get_aligncost)
        return (out * r).sum() + cost, (out, cost)
    (_, (out_j, cost_j)), (gp, gx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(v["params"],
                                                  jnp.asarray(x))
    port = _load(necks.ReadoutNeck(C, num_position=P, read_op=read_op,
                                   gamma=gamma), v)
    xt = torch.from_numpy(x).requires_grad_()
    assign = port.assign(xt).reshape(SHAPE[0], -1)
    assert ((assign == P - 1).sum(dim=1) == 0).all()      # empty segments
    out = port(xt)
    cost = port.get_aligncost(xt)
    ((out * torch.from_numpy(r)).sum() + cost).backward()
    assert_rel(out.detach().numpy(), out_j, F64, "readout")
    assert_rel(cost.item(), cost_j, F64, "aligncost")
    _check_grads(port, xt.grad.numpy(), gp, gx, f"ReadoutNeck {read_op}")


def test_segment_reductions_fill_empty_segments():
    """The port's segment max leaves no -inf (an empty segment is 0, as
    JAX's necks make it), the mean divides an empty segment's 0 by 1, the
    softmax of a lone row is 1."""
    x = torch.tensor([[1.0, -2.0], [3.0, -1.0], [-5.0, 4.0]])
    seg = torch.tensor([0, 0, 2])
    assert necks.segment_max(x, seg, 4).tolist() == [
        [3.0, -1.0], [0.0, 0.0], [-5.0, 4.0], [0.0, 0.0]]
    assert necks.segment_sum(x, seg, 3).tolist() == [
        [4.0, -3.0], [0.0, 0.0], [-5.0, 4.0]]
    sm = necks.segment_softmax(torch.tensor([0.0, np.log(3.0), 7.0]), seg, 3)
    np.testing.assert_allclose(sm.numpy(), [0.25, 0.75, 1.0], rtol=1e-6)


# ---------------------------------------------------------------------------
# PretrainNeck
# ---------------------------------------------------------------------------

PSHAPE = (3, 2, 4, 25, C)


@pytest.mark.parametrize("read_op,levels,declay,gamma", [
    ("sum", 3, 0.4, 0.1), ("mean", 3, 0.4, 0.0), ("max", 3, 0.5, 0.1),
    ("attention", 2, 0.4, 0.1), ("set2set", 1, 0.4, 0.0)])
def test_pretrain_neck_matches_jax(read_op, levels, declay, gamma, jax_f64):
    """Forward, ``get_aligncost``, ``node_precost`` (t = 0 slice of the
    mask), ``get_intracost`` and ``get_intercost`` and the gradients of
    their sum, in float64; declay 0.5 keeps JAX's 0.4 in the batch
    rebuild (segments scrambled alike)."""
    kw = dict(read_op=read_op, num_hierarchy=levels, declay=declay,
              gamma=gamma)
    jn = jnecks.PretrainNeck(C, 25, **kw)
    x, xm = _x(4, *PSHAPE), _x(5, *PSHAPE)
    mask = (np.random.default_rng(6).random(PSHAPE[:4] + (1,)) > 0.5
            ).astype(np.float64)
    node = np.array(jflows.NTU_NODE_TYPE)
    v = _f64(_jvars(jn, 7, x.astype(np.float32), node, mask,
                    method=jnecks.PretrainNeck.init_components))
    r = _x(8, PSHAPE[0], 2 * C if read_op == "set2set" else
           (24 if declay == 0.5 else C))

    def objective(p, a, b):
        ap = lambda *args, method: jn.apply(  # noqa: E731
            {"params": p}, *args, method=method)
        out = jn.apply({"params": p}, a, train=False)
        costs = (ap(a, method=jnecks.PretrainNeck.get_aligncost),
                 ap(b, node, mask, method=jnecks.PretrainNeck.node_precost),
                 ap(a, b, method=jnecks.PretrainNeck.get_intracost),
                 ap(a, b, method=jnecks.PretrainNeck.get_intercost))
        return (out * r).sum() + sum(costs), (out, costs)
    (_, (out_j, costs_j)), (gp, ga, gb) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1, 2), has_aux=True))(
        v["params"], jnp.asarray(x), jnp.asarray(xm))
    port = _load(necks.PretrainNeck(C, 25, **kw), v)
    a = torch.from_numpy(x).requires_grad_()
    b = torch.from_numpy(xm).requires_grad_()
    out = port(a)
    costs = (port.get_aligncost(a),
             port.node_precost(b, flows.NTU_NODE_TYPE, torch.from_numpy(mask)),
             port.get_intracost(a, b), port.get_intercost(a, b))
    ((out * torch.from_numpy(r)).sum() + sum(costs)).backward()
    assert_rel(out.detach().numpy(), out_j, F64, "pretrain readout")
    for name, got, want in zip(("align", "node", "intra", "inter"), costs,
                               costs_j):
        assert_rel(got.item(), want, F64, name)
    assert_rel(b.grad.numpy(), gb, F64, "d/dx_modify")
    _check_grads(port, a.grad.numpy(), gp, ga, f"PretrainNeck {read_op}")


# ---------------------------------------------------------------------------
# SimpleNeck, SemanticNeck, CMLP, CausalNeck
# ---------------------------------------------------------------------------

def test_simple_and_semantic_necks_match_jax(jax_f64):
    """SimpleNeck's pooling (train mode, dropout 0) and its node cost,
    which raises in both packages (JAX's builds its Dense outside
    ``@compact``, which flax refuses); SemanticNeck with derived and given
    person weights, a 2-D input passed through and the 3-D mode's
    pooling."""
    x = _x(9, 2, 2, 3, 25, C)
    sn = necks.SimpleNeck(C, dropout=0.0).double().train()
    want = jnecks.SimpleNeck(C, dropout=0.0).apply({}, jnp.asarray(x),
                                                   train=True)
    assert_rel(sn(torch.from_numpy(x)).detach().numpy(), want, F64,
               "SimpleNeck")
    assert not list(sn.parameters())
    with pytest.raises(flax.errors.AssignSubModuleError):
        jnecks.SimpleNeck(C).apply({}, jnp.asarray(x), flows.NTU_NODE_TYPE,
                                   method=jnecks.SimpleNeck.node_precost)
    with pytest.raises(NotImplementedError, match="fc_node"):
        sn.node_precost(torch.from_numpy(x), flows.NTU_NODE_TYPE)

    jm = jnecks.SemanticNeck(C)
    idx = np.abs(_x(12, 2, 2)) + 0.1
    for args in ((x,), (x, idx), (x[:, 0, 0, 0],), (x[:, 0],)):
        mode = "3D" if args[0].ndim == 4 else "GCN"
        want = jnecks.SemanticNeck(C, mode=mode).apply(
            {}, *map(jnp.asarray, args), train=False)
        got = necks.SemanticNeck(C, mode=mode)(*map(torch.from_numpy, args))
        assert_rel(got.numpy(), want, F64, f"SemanticNeck {mode}")
    del jm


@pytest.mark.parametrize("hidden", [(100,), (8, 6)])
def test_cmlp_matches_jax(hidden, jax_f64):
    """CMLP's per-joint causal MLPs (the conv1d first layer in JAX's
    weight layout as it stands, the per-joint products after it) and the
    ridge over every layer but the first, with their gradients."""
    v_, lag = 7, 3
    jm = jnecks.CMLP(v_, lag, hidden)
    x = _x(13, 3, 12, v_)
    v = _f64(_jvars(jm, 14, x.astype(np.float32)))

    def objective(p, xx):
        y = jm.apply({"params": p}, xx)
        return (y ** 2).sum() + jm.ridge(p, 0.3), y
    (_, y_j), g = jax.jit(jax.value_and_grad(objective, has_aux=True))(
        v["params"], jnp.asarray(x))
    port = necks.CMLP(v_, lag, hidden)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    port.double()
    y = port(torch.from_numpy(x))
    ((y ** 2).sum() + port.ridge(0.3)).backward()
    assert_rel(y.detach().numpy(), y_j, F64, "CMLP")
    for n, p in port.named_parameters():
        assert_rel(p.grad.numpy(), np.asarray(g[n]), F64, f"d/d{n}")


def test_causal_neck_matches_jax(jax_f64):
    """CausalNeck's (pooled, feature), its node cost and its Neural-GC
    cost (prediction MSE + ridge), and the gradients of the two costs."""
    v_, lag = 7, 3
    jn = jnecks.CausalNeck(C, num_series=v_, lag=lag)
    x = _x(15, 2, 2, 12, v_, C)
    node = np.arange(v_) % 5
    v = _f64(_jvars(jn, 16, x.astype(np.float32), node,
                    method=jnecks.CausalNeck.init_components))

    def objective(p, xx):
        ap = lambda *a, method: jn.apply({"params": p}, *a,  # noqa: E731
                                         method=method)
        out = jn.apply({"params": p}, xx, train=False)
        costs = (ap(xx, node, method=jnecks.CausalNeck.node_precost),
                 ap(xx, method=jnecks.CausalNeck.gc_cost))
        return sum(costs), (out, costs)
    (_, (out_j, costs_j)), (gp, gx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    port = _load(necks.CausalNeck(C, num_series=v_, lag=lag), v)
    xt = torch.from_numpy(x).requires_grad_()
    pooled, feat = port(xt)
    assert feat is xt
    assert_rel(pooled.detach().numpy(), out_j[0], F64, "pooled")
    costs = (port.node_precost(xt, node), port.gc_cost(xt))
    sum(costs).backward()
    for name, got, want in zip(("node", "gc"), costs, costs_j):
        assert_rel(got.item(), want, F64, name)
    _check_grads(port, xt.grad.numpy(), gp, gx, "CausalNeck")


# ---------------------------------------------------------------------------
# HGTHead, ClsHead
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pose_type,v_", [("nturgb+d", 25), ("coco", 17)])
def test_hgt_head_matches_jax(pose_type, v_, jax_f64):
    """HGTHead from its config dict: the logits and the node loss (mean
    over (N, V) of each joint's body-part cross entropy) in train mode
    with dropout 0, and their gradients; a clip whose V is not the
    labels' length is refused."""
    cfg = dict(type="HGTHead", num_classes=7, in_channels=C,
               pose_type=pose_type, dropout=0.0)
    jh = j_build_head(cfg)
    x = _x(17, 2, 2, 3, v_, C)
    v = _f64(_jvars(jh, 18, x.astype(np.float32), train=False))
    r = _x(19, 2, 7)

    def objective(p, xx):
        cls, node = jh.apply({"params": p}, xx, train=True)
        return (cls * r).sum() + node, (cls, node)
    (_, (cls_j, node_j)), (gp, gx) = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    port = _load(build_head(cfg), v).train()
    xt = torch.from_numpy(x).requires_grad_()
    cls, node = port(xt)
    ((cls * torch.from_numpy(r)).sum() + node).backward()
    assert_rel(cls.detach().numpy(), cls_j, F64, "HGTHead logits")
    assert_rel(node.item(), node_j, F64, "HGTHead node loss")
    _check_grads(port, xt.grad.numpy(), gp, gx, "HGTHead")
    with pytest.raises(ValueError, match="node labels"):
        port(torch.zeros(1, 1, 2, v_ + 1, C, dtype=torch.float64))


def test_cls_head_matches_jax():
    """ClsHead from its config dict over an (N, C) input, eval (dropout
    off) in float32 at 1e-6; a pooled 5-D input is refused."""
    cfg = dict(type="ClsHead", num_classes=7, in_channels=C)
    jh = j_build_head(cfg)
    x = _x(20, 4, C).astype(np.float32)
    v = _jvars(jh, 21, x, train=False)
    want = jh.apply(v, jnp.asarray(x), train=False)
    port = build_head(cfg)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert_rel(got.numpy(), want, 1e-6, "ClsHead")
    with pytest.raises(ValueError):
        port(torch.zeros(1, 1, 2, 3, C))


# ---------------------------------------------------------------------------
# mask_keypoints, Causalmetrix, pte
# ---------------------------------------------------------------------------

def test_mask_keypoints_at_matches_jax():
    """The fixed-mask form against JAX's draw: the joints JAX dropped,
    read off its mask, give the same masked clip and mask; exact zeros
    anywhere (dropped or not) become 1.0."""
    kp = _x(22, 2, 2, 5, 25, 3).astype(np.float32)
    kp[0, 0, 1, 3] = 0.0                       # a natural zero, kept joint
    masked_j, mask_j = jax.jit(jflows.mask_keypoints)(jax.random.PRNGKey(3),
                                                      jnp.asarray(kp))
    mask_j = np.asarray(mask_j)
    drop = np.stack([np.flatnonzero(row == 0) for row in
                     mask_j[:, :, 0, :, 0].reshape(4, 25)])
    assert drop.shape == (4, 12)
    masked, mask = flows.mask_keypoints_at(torch.from_numpy(kp),
                                           torch.from_numpy(drop))
    np.testing.assert_array_equal(mask.numpy(), mask_j)
    np.testing.assert_array_equal(masked.numpy(), np.asarray(masked_j))
    assert (masked.numpy() != 0).all()


def test_mask_keypoints_draws_int_ratio_joints():
    """The generator form: int(ratio V) distinct joints a (sample, person),
    the same over its frames, repeatable from the seed."""
    kp = torch.from_numpy(_x(23, 3, 2, 4, 25, 3).astype(np.float32))
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    for ratio, k in ((0.5, 12), (0.2, 5)):
        masked, mask = flows.mask_keypoints(kp, ratio, g())
        joints = mask[:, :, :, :, 0]
        assert (joints == joints[:, :, :1]).all()
        assert ((joints[:, :, 0] == 0).sum(dim=-1) == k).all()
        assert torch.equal(masked, torch.where(kp * mask == 0,
                                               torch.ones_like(kp), kp * mask))
        again, _ = flows.mask_keypoints(kp, ratio, g())
        assert torch.equal(masked, again)


def test_causalmetrix_matches_jax():
    """``Causalmetrix`` built from its config dict zeroes the same entries
    as JAX's (and refuses the same unknown argument)."""
    causal = np.abs(_x(24, 25, 25))
    for thr in (75, 30):
        got = T.build_pipeline([dict(type="Causalmetrix", thr=thr)])(
            dict(causal=causal.copy()))["causal"]
        want = JT.Causalmetrix(thr=thr)(dict(causal=causal.copy()))["causal"]
        np.testing.assert_array_equal(got, want)
        assert (got == 0).mean() == pytest.approx(thr / 100, abs=0.01)
    with pytest.raises(TypeError):
        T.build_pipeline([dict(type="Causalmetrix", causal_file="c.npy")])


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("to_norm", [False, True])
def test_pte_matches_jax(order, to_norm):
    """The phase transfer entropy matrix and its helpers (the port's numpy
    copy) equal JAX's."""
    t = np.arange(40)
    z = _x(25, 6, 2, 40) + 0.05 * t
    z[2, :, 1:] += 0.8 * z[1, :, :-1]          # a flow 1 -> 2
    got = causal_pte.pte(z, lag=1, model_order=order, to_norm=to_norm)
    want = jpte.pte(z, lag=1, model_order=order, to_norm=to_norm)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert got[1, 2] > got[2, 1] and np.all(np.diag(got) == 0)
    np.testing.assert_allclose(causal_pte.embed_data(z[0], 3, 2),
                               jpte.embed_data(z[0], 3, 2), rtol=0)


# ---------------------------------------------------------------------------
# DS-GCN with a neck: the recognizer, its train step and the flows
# ---------------------------------------------------------------------------

W = 16                             # the narrow DS-GCN's width
NECK_CFGS = {
    "SimpleNeck": dict(type="SimpleNeck", in_channels=W, dropout=0.0),
    "SemanticNeck": dict(type="SemanticNeck", in_channels=W),
    "ReadoutNeck": dict(type="ReadoutNeck", in_channels=W, num_position=5,
                        read_op="attention"),
    "PretrainNeck": dict(type="PretrainNeck", in_channels=W,
                         num_position=10, num_hierarchy=2),
}
XSHAPE = (2, 2, 8, 25, 3)
NARROW = dict(num_stages=2, base_channels=W, inflate_stages=(),
              down_stages=(2,), gcn_ratio=0.25, gcn_use_pallas=False)


def _cfgs():
    """The narrow DS-GCN (a stem and a strided block, the dense path) as
    JAX's
    the port's configs."""
    out = []
    for cfg in (j_model_cfg("dsgcn", num_classes=11),
                model_cfg("dsgcn", num_classes=11)):
        cfg["backbone"].update(NARROW)
        cfg["cls_head"]["in_channels"] = W
        out.append(cfg)
    return out


def _neck_cfgs(neck):
    jcfg, tcfg = _cfgs()
    for c in (jcfg, tcfg):
        c["neck"] = dict(neck)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def backbone_feats():
    """The narrow DS-GCN's JAX variables (no neck) and its eval features
    of one clip (one jitted program)."""
    jcfg, _ = _cfgs()
    x = _x(26, *XSHAPE).astype(np.float32)
    jb = j_build_backbone(jcfg["backbone"])
    v = _random_variables(jax.eval_shape(lambda: j_build_model(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False)), 27)
    feat = jax.jit(lambda vb, xx: jb.apply(vb, xx, train=False))(
        {k: v[k]["backbone"] for k in v}, jnp.asarray(x))
    return v, x, np.asarray(feat)


@pytest.mark.parametrize("neck", list(NECK_CFGS))
def test_build_model_takes_every_neck(neck, backbone_feats):
    """``build_model`` builds a RecognizerGCN with each neck of JAX's
    NECKS from ``cfg['neck']``, loads JAX's variables strictly (a
    PretrainNeck's ``fc_cls`` from JAX's ``init_components``: its
    ``__call__`` never reaches it) and gives JAX's logits, neck then
    head on JAX's backbone features, in float32 at 1e-5."""
    v0, x, feat = backbone_feats
    assert set(NECK_CFGS) == set(jnecks.NECKS) == set(necks.NECKS)
    jcfg, tcfg = _neck_cfgs(NECK_CFGS[neck])
    jneck = jnecks.build_neck(jcfg["neck"])
    jhead = j_build_head(jcfg["cls_head"])
    init = jneck.init_components if neck == "PretrainNeck" else None
    args = ((feat, np.array(jflows.NTU_NODE_TYPE), np.ones(feat.shape[:4]
                                                           + (1,)))
            if init else (feat,))
    shapes = jax.eval_shape(lambda: jneck.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, args),
        **({"method": jnecks.PretrainNeck.init_components} if init
           else {"train": False})))
    vn = _random_variables(shapes, 28)
    pooled = jneck.apply(vn, jnp.asarray(feat), train=False)
    want = jhead.apply({"params": v0["params"]["head"]}, pooled, train=False)
    v = {"params": dict(v0["params"]), "batch_stats": v0["batch_stats"]}
    if "params" in vn:
        v["params"]["neck"] = vn["params"]
    port = build_model(tcfg)
    assert isinstance(port.neck, necks.NECKS[neck])
    port.load_state_dict(convert_jax_variables(v), strict=True)
    before = launch_counts()
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert launch_counts() == before
    assert_rel(got.numpy(), want, 1e-5, f"{neck} logits")


def test_readout_neck_train_step_float64_matches_jax(backbone_feats):
    """One float64 ``train_step`` of the narrow DS-GCN with a
    ReadoutNeck (mean) on both packages' optimizers (SGD, Nesterov,
    weight decay, the paramwise multipliers of the neck's and head's
    leaves): loss, every parameter and BatchNorm statistic at 1e-8;
    ``paramwise_mults`` classifies the new leaves as JAX's does."""
    from dsgcn_tpu.core.train import TrainState
    from dsgcn_tpu.core.train import make_optimizer as j_make_optimizer
    from dsgcn_tpu.core.train import paramwise_mults as j_paramwise_mults
    from dsgcn_tpu.core.train import train_step as j_train_step
    v0, _, _ = backbone_feats
    jcfg, tcfg = _neck_cfgs(dict(type="ReadoutNeck", in_channels=W,
                                 num_position=5, read_op="mean"))
    v = {"params": dict(v0["params"], neck={"protos": _x(29, 5, W).astype(
        np.float32)}),
         "batch_stats": v0["batch_stats"]}
    rng = np.random.default_rng(30)
    batch = dict(keypoint=rng.standard_normal(XSHAPE),
                 label=rng.integers(0, 11, XSHAPE[0]))
    pw = dict(custom_keys={"protos": dict(lr_mult=0.5, decay_mult=0.0)},
              norm_decay_mult=0.0, bias_lr_mult=2.0)
    with x64():
        jmodel = j_build_model(jcfg)
        tx, _ = j_make_optimizer(lr=0.1, total_steps=1, paramwise_cfg=pw,
                                 params=_f64(v["params"]))
        state = TrainState.create(jmodel.apply, _f64(v["params"]),
                                  _f64(v["batch_stats"]), tx)
        new, m = jax.jit(j_train_step)(
            state, {k: jnp.asarray(a) for k, a in batch.items()},
            jax.random.PRNGKey(0))
        jl = float(m["loss"])
        want = convert_jax_variables(jax.device_get(
            {"params": new.params, "batch_stats": new.batch_stats}))
        lr_tree, decay_tree = j_paramwise_mults(v["params"], pw)
    port = _load(build_model(tcfg), v)
    names = jax_param_names(port)
    assert names["neck.protos"] == "neck.protos"
    mults = paramwise_mults(port, pw)
    for tree, i in ((lr_tree, 0), (decay_tree, 1)):
        flat = {".".join(str(k.key) for k in path): val for path, val in
                jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert {n: mults[n][i] for n in names} == {
            n: flat[p] for n, p in names.items()}
    opt, sched = make_optimizer(port, lr=0.1, total_steps=1,
                                paramwise_cfg=pw)
    before = launch_counts()
    tl = train_step(port, opt, sched, batch)["loss"].item()
    assert launch_counts() == before
    np.testing.assert_allclose(tl, jl, rtol=F64)
    state = port.state_dict()
    assert state.keys() == want.keys()
    for name, w in want.items():
        assert_rel(state[name].numpy(), w.numpy(), F64, name)


def _flow_step(flow, v0, jax_f64_on):
    """JAX's float64 loss terms and one SGD step by hand (lr 0.1) of the
    narrow DS-GCN's backbone with a ReadoutNeck + GCNHead under
    ``gcnr_losses`` or a PretrainNeck under ``pretrain_losses`` (both
    views through the backbone in train mode, its statistics moving
    twice), against the same on the port."""
    jcfg, tcfg = _cfgs()
    jb = j_build_backbone(jcfg["backbone"])
    rng = np.random.default_rng(31)
    x = rng.standard_normal(XSHAPE)
    label = rng.integers(0, 11, XSHAPE[0])
    node = np.array(jflows.NTU_NODE_TYPE)
    if flow == "gcnr":
        ncfg = dict(type="ReadoutNeck", in_channels=W, num_position=5,
                    read_op="sum", gamma=0.1)
        jn, jh = jnecks.build_neck(ncfg), j_build_head(jcfg["cls_head"])
        vn = {"protos": _x(32, 5, W).astype(np.float32)}
    else:
        ncfg = dict(type="PretrainNeck", in_channels=W, num_position=10,
                    num_hierarchy=2)
        jn, jh = jnecks.build_neck(ncfg), None
        vn = _random_variables(jax.eval_shape(lambda: jn.init(
            jax.random.PRNGKey(0), jnp.zeros((2, 2, 4, 25, W)), node,
            jnp.ones((2, 2, 4, 25, 1)),
            method=jnecks.PretrainNeck.init_components)), 33)["params"]
        drop = np.stack([rng.permutation(25)[:12] for _ in range(4)])
        masked, mask = flows.mask_keypoints_at(torch.from_numpy(x),
                                               torch.from_numpy(drop))
        masked, mask = masked.numpy(), mask.numpy()
    params = _f64({"backbone": v0["params"]["backbone"], "neck": vn,
                   "head": v0["params"]["head"]})
    stats = _f64(v0["batch_stats"]["backbone"])

    def objective(p):
        bb = lambda xx, st: jb.apply(  # noqa: E731
            {"params": p["backbone"], "batch_stats": st}, xx, train=True,
            mutable=["batch_stats"])
        feats, mut = bb(jnp.asarray(x), stats)
        if flow == "gcnr":
            logits = jh.apply({"params": p["head"]},
                              jn.apply({"params": p["neck"]}, feats,
                                       train=True), train=True)
            cost = jn.apply({"params": p["neck"]}, feats,
                            method=jnecks.ReadoutNeck.get_aligncost)
            losses = jflows.gcnr_losses(logits, jnp.asarray(label), cost)
            return losses["loss"], (losses, mut)
        fm, mut = bb(jnp.asarray(masked), mut["batch_stats"])
        losses = jflows.pretrain_losses(jn, {"params": p["neck"]}, feats, fm,
                                        jnp.asarray(mask))
        return losses["loss_cls"], (losses, mut)
    (_, (losses_j, mut)), g = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(params)
    new = jax.tree.map(lambda a, b: a - 0.1 * b, params, g)
    want = convert_jax_variables(jax.device_get(
        {"params": new, "batch_stats": {"backbone": mut["batch_stats"]}}))

    port = build_model(dict(tcfg, neck=ncfg))
    if flow == "pretrain":
        port.head = None
        want = {k: w for k, w in want.items() if not k.startswith("head.")}
    sd = convert_jax_variables({"params": params,
                                "batch_stats": {"backbone": stats}})
    port.double().load_state_dict({k: w for k, w in sd.items() if k in
                                   port.state_dict()}, strict=True)
    port.train()
    before = launch_counts()
    feats = port.backbone(torch.from_numpy(x))
    if flow == "gcnr":
        losses = flows.gcnr_losses(port.head(port.neck(feats)),
                                   torch.from_numpy(label),
                                   port.neck.get_aligncost(feats))
        loss = losses["loss"]
    else:
        fm = port.backbone(torch.from_numpy(masked))
        losses = flows.pretrain_losses(port.neck, feats, fm,
                                       torch.from_numpy(mask))
        loss = losses["loss_cls"]
    loss.backward()
    with torch.no_grad():
        for p in port.parameters():
            if p.grad is not None:
                p -= 0.1 * p.grad
    assert launch_counts() == before
    assert losses.keys() == losses_j.keys()
    for k in losses:
        assert_rel(losses[k].item(), losses_j[k], F64, k)
    state = port.state_dict()
    assert state.keys() == want.keys()
    for name, w in want.items():
        assert_rel(state[name].numpy(), w.numpy(), F64, name)


@pytest.mark.parametrize("flow", ["gcnr", "pretrain"])
def test_flow_step_float64_matches_jax(flow, backbone_feats, jax_f64):
    """One float64 SGD step by hand of the narrow DS-GCN through
    ``gcnr_losses`` (ReadoutNeck 'sum' readout, GCNHead, the soft-min
    aligncost) or ``pretrain_losses`` (the clip and its masked view, from
    ``mask_keypoints_at``, through the backbone; PretrainNeck's node cost
    and clip NCE): every loss term, parameter and BatchNorm statistic at
    1e-8."""
    _flow_step(flow, backbone_feats[0], jax_f64)


def test_neck_init_rules_follow_jax():
    """``init_weights_`` draws the necks' and heads' weights by JAX's
    laws: prototypes flax's xavier_normal (truncated, variance 2 / (P +
    C)), Set2Set U(+-1/sqrt(C)), PretrainNeck's and CausalNeck's
    ``fc_cls`` and HGTHead's classifiers N(0, 0.01) with zero biases,
    PretrainNeck's gate flax's default Dense (lecun, zero bias), the cMLP
    U(+-1/sqrt(fan_in)) over JAX's fans."""
    g = torch.Generator().manual_seed(0)
    model = torch.nn.ModuleDict(dict(
        readout=necks.ReadoutNeck(256, 25, read_op="set2set"),
        pretrain=necks.PretrainNeck(256, 25, read_op="attention"),
        causal=necks.CausalNeck(64, num_series=25, lag=9),
        head=build_head(dict(type="HGTHead", num_classes=60,
                             in_channels=256))))
    init_weights_(model, g)
    std = lambda t: t.detach().std().item()  # noqa: E731
    assert abs(std(model["readout"].protos) / (2 / 281) ** 0.5 - 1) < 0.1
    assert abs(std(model["pretrain"].proto0) / (2 / 281) ** 0.5 - 1) < 0.1
    s2s = model["readout"].set2set
    for p in s2s.parameters():
        assert p.abs().max() <= 256 ** -0.5
        assert abs(std(p) * 3 ** 0.5 * 16 - 1) < 0.1
    for fc in (model["pretrain"].fc_cls, model["causal"].fc_cls,
               model["head"].fc_cls, model["head"].node_cls):
        assert abs(std(fc.weight) / 0.01 - 1) < 0.15
        assert (fc.bias == 0).all()
    gate = model["pretrain"].gate
    assert abs(std(gate.weight) * 16 - 1) < 0.15 and (gate.bias == 0).all()
    w = model["causal"].cMLP.l0_w
    bound = (25 * 25 * 100) ** -0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.99 * bound
    b = model["causal"].cMLP.l1_b
    assert b.abs().max() <= 100 ** -0.5
