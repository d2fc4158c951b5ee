"""Port parity, AAGCN and CTR-GCN: ``AttentionChain``, ``UnitAAGCN``,
``UnitAAHGCN``, ``CTRGC``, ``CTRHGC``, ``UnitCTRHGCN``, ``UnitCTRGCN``,
``CTRMSTCN``, ``DataBN('MVC')``, both recognizers (plain and semantic, NTU's
25 joints and COCO's 17), a float64 train step of each family,
``model_cfg('aagcn'|'ctrgcn'|'msg3d'|'sgn')``, the rank-3 kernel
conversion and the init rules of ``dsgcn_tpu_torch`` against
``dsgcn_tpu`` on the CPU; and the options ``DGPHGCN1`` refuses by name.

None of these modules reaches a Pallas kernel in JAX, and none launches a
kernel in the port.  Variables are drawn with ``jax.eval_shape`` + numpy
(``test_torch_port_dggcn._random_variables``); inputs are numpy from a
seed.  Tolerances: eval modules at 1e-5 (``MODULE_TOL``); train modules
(outputs, updated statistics, input and parameter gradients) at
``MODULE_RTOL`` (2e-4, see ``test_torch_port_grad.py``); model logits at
1e-4 (``MODEL_TOL``); the float64 train step at 1e-8.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu.models.backbones import DataBN as JDataBN
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu.ops import gcn as jgcn
from dsgcn_tpu.ops.tcn import CTRMSTCN as JCTRMSTCN
from dsgcn_tpu_torch.models.backbones import DataBN
from dsgcn_tpu_torch.models.builder import build_model, init_weights_, \
    model_cfg
from dsgcn_tpu_torch.ops import gcn
from dsgcn_tpu_torch.ops.gcn import DGPHGCN1
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.ops.tcn import CTRMSTCN
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _random_variables, _variables
from test_torch_port_grad import MODULE_RTOL, _train_parity, assert_rel
from test_torch_port_model import MODEL_TOL, MODULE_TOL, _load, _run
from test_torch_port_train import _run_both

N, T = 4, 12          # N = 2 clips x M = 2 bodies at the module level


def _graph(V):
    g = JGraph(layout="coco" if V == 17 else "nturgb+d", mode="spatial")
    return dict(A_init=g.A.astype(np.float32), edge_type=g.edge_type,
                node_type=np.array(g.node_type))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _eval(jmod, v, x):
    """JAX's eval output, compiled as one program (op by op, JAX on the
    CPU spends seconds compiling each module's many small ops)."""
    return np.asarray(jax.jit(lambda vv, xx: jmod.apply(vv, xx, train=False))(
        v, jnp.asarray(x)))


def _grad_parity(j_fn, v, port, x, seed, extra=()):
    """Output, input and parameter gradients of a module without
    BatchNorm, JAX's ``j_fn(params, x)`` against ``port(x, *extra)``, at
    MODULE_RTOL; the output also at MODULE_TOL (it is the eval output)."""
    port.load_state_dict(convert_jax_variables(v), strict=True)
    y_j = np.asarray(jax.jit(j_fn)(v["params"], jnp.asarray(x)))
    g = _x(seed, *y_j.shape)
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(j_fn(p, xx) * g),
                              argnums=(0, 1)))(v["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt, *extra)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), y_j, **MODULE_TOL)
    assert_rel(xt.grad.numpy(), gx, MODULE_RTOL, "input grad")
    want = convert_jax_variables({"params": jax.device_get(gp)})
    floor = 1e-2 * max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in port.named_parameters():
        assert_rel(p.grad.numpy(), want[name].numpy(), MODULE_RTOL,
                   f"grad {name}", floor)


def _unit_parity(jmod, port, x, seed):
    """A unit with BatchNorms: eval output at MODULE_TOL, then one
    train-mode forward and backward at MODULE_RTOL (_train_parity)."""
    v = _variables(jmod, x, seed)
    want = _eval(jmod, v, x)
    np.testing.assert_allclose(_run(_load(port, v), x), want, **MODULE_TOL)
    _train_parity(jmod, port, v, x, want.shape, seed + 1, jit=True)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def test_attention_chain_matches_jax():
    """The spatial conv's kernel is 25 joints wide at V = 25 (17 at V =
    17: the COCO recognizer below); the (k, C, 1) flax kernels go through
    the rank-3 conversion."""
    V = 25
    x = _x(1, N, T, V, 16)
    jmod = jgcn.AttentionChain(16)
    v = _random_variables(jax.eval_shape(
        lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))), seed=2)
    port = gcn.AttentionChain(16, V)
    assert port.conv_sa.weight.shape == (1, 16, V)
    _grad_parity(lambda p, xx: jmod.apply({"params": p}, xx), v, port, x,
                 seed=3)


@pytest.mark.parametrize("cin,adaptive,attention", [
    (16, True, True), (8, False, False)], ids=["adaptive-att", "static-down"])
def test_unit_aagcn_matches_jax(cin, adaptive, attention):
    A = _graph(25)["A_init"]
    _unit_parity(jgcn.UnitAAGCN(16, A_init=A, adaptive=adaptive,
                                attention=attention),
                 gcn.UnitAAGCN(cin, 16, A, adaptive=adaptive,
                               attention=attention),
                 _x(4, N, T, 25, cin), seed=5)


def test_unit_aahgcn_matches_jax():
    """Node and edge attention on NTU's graph (COCO's in the semantic
    recognizer below)."""
    graph = _graph(25)
    kw = dict(node_att=True, edge_att=True)
    _unit_parity(jgcn.UnitAAHGCN(16, **graph, **kw),
                 gcn.UnitAAHGCN(8, 16, **graph, **kw),
                 _x(6, N, T, 25, 8), seed=7)


def _ctr_case(seed, V=25, cin=24):
    rng = np.random.default_rng(seed)
    A = (0.04 + 0.02 * rng.standard_normal((V, V))).astype(np.float32)
    return _x(seed, N, T, V, cin), A, np.float32(rng.uniform(-1, 1))


def test_ctrgc_matches_jax():
    """R = C_in // 8 = 3 at C_in = 24 (R = 8 at C_in <= 16 is held by the
    recognizers' and the committed models' strict loads)."""
    cin = 24
    x, A, alpha = _ctr_case(8, cin=cin)
    jmod = jgcn.CTRGC(cin, 32)
    v = _random_variables(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(A), alpha)),
        seed=9)
    port = gcn.CTRGC(cin, 32)
    assert port.conv1.out_features == 3
    assert gcn.CTRGC(16, 32).conv1.out_features == 8
    _grad_parity(lambda p, xx: jmod.apply({"params": p}, xx, jnp.asarray(A),
                                          alpha),
                 v, port, x, seed=10,
                 extra=(torch.from_numpy(A), torch.tensor(alpha)))


CTRHGC_OPTIONS = {
    "node-ada-target": dict(node_attention=True, ada=True,
                            target_specific=True),
    "edge-add": dict(node_attention=False, edge_attention=True,
                     add_type=True),
    "edge-full": dict(edge_attention=True, full_channels=True),
    "edge-full-add": dict(edge_attention=True, full_channels=True,
                          add_type=True),
    "off-stage": dict(edge_attention=True, target_specific=True,
                      semantic_index=False),
}


@pytest.mark.parametrize("option", list(CTRHGC_OPTIONS))
def test_ctrhgc_matches_jax(option):
    """Each option of the semantic CTR-GC (on stages in semantic_index; the
    last case is a stage outside it, where they are all off: the plain
    form)."""
    kw = dict(dict(semantic_index=True), **CTRHGC_OPTIONS[option])
    graph = _graph(25)
    types = dict(edge_type=graph["edge_type"], node_type=graph["node_type"])
    x, A, alpha = _ctr_case(11)
    jmod = jgcn.CTRHGC(24, 32, **types, **kw)
    v = _random_variables(jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(A), alpha)),
        seed=12)
    _grad_parity(lambda p, xx: jmod.apply({"params": p}, xx, jnp.asarray(A),
                                          alpha),
                 v, gcn.CTRHGC(24, 32, **types, **kw), x, seed=13,
                 extra=(torch.from_numpy(A), torch.tensor(alpha)))


def test_unit_ctrgcn_matches_jax():
    """16 -> 16 channels (the semantic unit below has the down path)."""
    cin = 16
    A = _graph(25)["A_init"]
    _unit_parity(jgcn.UnitCTRGCN(cin, 16, A_init=A), gcn.UnitCTRGCN(
        cin, 16, A), _x(14, N, T, 25, cin), seed=15)


def test_unit_ctrhgcn_matches_jax():
    """Edge attention in subset 0 only, node attention nowhere, a gate per
    subset; every option of CTRHGC on."""
    kw = dict(semantic_index=True, edge_attention=True, node_attention=True,
              ada=True, full_channels=True, add_type=True,
              target_specific=True)
    graph = _graph(25)
    port = gcn.UnitCTRHGCN(8, 16, **graph, **kw)
    assert port.alpha.shape == (3,)
    assert [port.convs0.edge_att, port.convs1.edge_att] == [True, False]
    assert not any(getattr(port, f"convs{i}").node_att for i in range(3))
    _unit_parity(jgcn.UnitCTRHGCN(8, 16, **graph, **kw), port,
                 _x(16, N, T, 25, 8), seed=17)


def _train_parity_f64(jmod, port, v, x, seed):
    """:func:`_train_parity` in float64 at 1e-8: outputs, updated
    statistics, input and parameter gradients."""
    jax.config.update("jax_enable_x64", True)
    try:
        v = jax.tree.map(lambda a: np.asarray(a, np.float64), v)
        x = x.astype(np.float64)
        g = np.random.default_rng(seed).standard_normal(
            jax.eval_shape(lambda: jmod.apply(v, x, train=False)).shape)

        def loss(params, xx):
            y, mut = jmod.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, xx,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(y * g), (y, mut)
        (_, (y_j, mut)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
        gp, mut = jax.device_get((gp, mut))
    finally:
        jax.config.update("jax_enable_x64", False)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    port.double().train()
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    (y * torch.from_numpy(g)).sum().backward()
    assert_rel(y.detach().numpy(), y_j, 1e-8, "output")
    assert_rel(xt.grad.numpy(), gx, 1e-8, "input grad")
    want = convert_jax_variables({"params": gp})
    floor = 1e-2 * max(np.abs(w.numpy()).max() for w in want.values())
    for name, p in port.named_parameters():
        # a parameter off the path (a gate of a graph that is off) has no
        # gradient in torch and a zero one in JAX
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        assert_rel(got.numpy(), want[name].numpy(), 1e-8, f"grad {name}",
                   floor)
    stats = convert_jax_variables({"batch_stats": mut["batch_stats"]})
    state = port.state_dict()
    buffers = {k: b for k, b in port.named_buffers() if k in state}
    assert buffers.keys() == stats.keys()
    for name, b in buffers.items():
        assert_rel(b.numpy(), stats[name].numpy(), 1e-8, name)


@pytest.mark.parametrize("stride", [1, 2])
def test_ctrmstcn_matches_jax(stride):
    """CTR-GCN's temporal unit as CTRGCNBlock builds it (k = 5, dilations
    (1, 2), no residual of its own), 24 channels in four branches of 6, at
    stride 1; at stride 2 with its residual, 16 -> 22 channels, the
    remainder (7) on the last branch.
    Eval in float32 at MODULE_TOL; the train step in float64 at 1e-8, since
    JAX's float32 gradient through the max-pool branch strays from the
    float64 one further than the port's float32 one does, past
    MODULE_RTOL, which a float32 comparison would charge to the port."""
    kw = dict(kernel_size=5, dilations=(1, 2))
    cin, cout, residual = ((24, 24, False), (16, 22, True))[stride - 1]
    port = CTRMSTCN(cin, cout, stride=stride, residual=residual, **kw)
    assert port.branch3_bn.num_features == cout - 3 * (cout // 4)
    jmod = JCTRMSTCN(cout, stride=stride, residual=residual, **kw)
    x = _x(18, N, T, 25, cin)
    v = _variables(jmod, x, seed=19)
    np.testing.assert_allclose(_run(_load(port, v), x), _eval(jmod, v, x),
                               **MODULE_TOL)
    _train_parity_f64(jmod, port, v, x, seed=20)


def test_ctrmstcn_dropout_in_train_only():
    x = torch.randn(2, 8, 25, 24)
    m = CTRMSTCN(24, 24, kernel_size=5, dilations=(1, 2), tcn_dropout=0.5)
    m.generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        y_eval = m.eval()(x)
        m.train()
        a = m(x)
        m.generator = torch.Generator().manual_seed(0)
        b = m(x)
        m.tcn_dropout = 0.0
        y = m(x)
    assert torch.equal(a, b)                    # one generator, one mask
    live = y != 0                               # past the ReLU
    kept = live & (a != 0)
    assert torch.allclose(a[kept], 2 * y[kept])
    assert 0.4 < 1 - kept.sum().item() / live.sum().item() < 0.6
    with torch.no_grad():
        m.eval()
        y_eval2 = m(x)
        m.tcn_dropout = 0.5
        assert torch.equal(m(x), y_eval2)       # no dropout in eval
    assert (y_eval != 0).float().mean().item() > 0.3


def test_data_bn_mvc_matches_jax():
    """One BatchNorm over the M*V*C features of each frame: the train
    output, the running statistics it leaves and the eval output after."""
    x = (_x(20, 2, 2, 12, 25, 3) * 2 + 0.5)
    ref = JDataBN("MVC")
    v = _variables(ref, x, seed=21)
    y_j, mut = ref.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    port = DataBN(2 * 25 * 3, "MVC")
    port.load_state_dict(convert_jax_variables(v), strict=True)
    y = port.train()(torch.from_numpy(x))
    assert_rel(y.detach().numpy(), y_j, 1e-5, "y")
    new = convert_jax_variables({"params": v["params"],
                                 "batch_stats": mut["batch_stats"]})
    for k in ("running_mean", "running_var"):
        assert_rel(getattr(port, k).numpy(), new[k].numpy(), 1e-5, k)
    y_eval = ref.apply({"params": v["params"],
                        "batch_stats": mut["batch_stats"]},
                       jnp.asarray(x), train=False)
    np.testing.assert_allclose(_run(port.eval(), x), y_eval, **MODULE_TOL)


def test_convert_rank3_kernel_to_conv1d():
    """A flax 1-D conv kernel (k, I, O) becomes the (O, I, k) Conv1d
    weight, and the result computes the same 1-D convolution."""
    k = _x(22, 5, 3, 2)
    sd = convert_jax_variables({"params": {"c": {"kernel": k}}})
    w = sd["c.weight"]
    assert w.shape == (2, 3, 5)
    np.testing.assert_array_equal(w.numpy(), k.transpose(2, 1, 0))
    x = _x(23, 1, 9, 3)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1,), [(2, 2)],
        dimension_numbers=("NWC", "WIO", "NWC"))
    got = torch.nn.functional.conv1d(torch.from_numpy(x).transpose(1, 2), w,
                                     padding=2).transpose(1, 2)
    np.testing.assert_allclose(got.numpy(), want, **MODULE_TOL)


# ---------------------------------------------------------------------------
# the recognizers
# ---------------------------------------------------------------------------

# two blocks: the stem (3 -> 16) and 16 -> 32 at stride 2
NARROW = dict(num_stages=2, base_channels=16, inflate_stages=(2,),
              down_stages=(2,))
SEMANTIC = {
    "aagcn": dict(gcn_type="unit_aahgcn", gcn_node_att=True,
                  gcn_edge_att=True),
    "ctrgcn": dict(gcn_type="unit_ctrhgcn", gcn_edge_attention=True,
                   gcn_ada=True, semantic_stage=(2,)),
}


def _cfgs(family, V=25, semantic=False, narrow=NARROW):
    layout = "coco" if V == 17 else "nturgb+d"
    out = []
    for mc in (j_model_cfg, model_cfg):
        c = mc(family, num_classes=11, layout=layout)
        c["backbone"].update(narrow, **(SEMANTIC[family] if semantic
                                        else {}))
        c["cls_head"]["in_channels"] = narrow["base_channels"] * (
            2 if narrow.get("inflate_stages") else 1)
        out.append(c)
    return out


@pytest.fixture(scope="module")
def recognizers():
    """(port config, JAX variables, input, JAX logits) by case, made on
    first use."""
    cases = {}

    def get(family, V=25, semantic=False):
        key = (family, V, semantic)
        if key not in cases:
            jcfg, tcfg = _cfgs(family, V, semantic)
            x = _x(24, 2, 2, T, V, 3)
            ref = j_build_model(jcfg)
            v = _variables(ref, x, seed=25)
            cases[key] = (tcfg, v, x, _eval(ref, v, x))
        return cases[key]
    return get


@pytest.mark.parametrize("family,V,semantic", [
    ("aagcn", 25, False), ("aagcn", 17, True), ("ctrgcn", 25, True),
    ("ctrgcn", 17, False)])
def test_recognizer_matches_jax(recognizers, family, V, semantic):
    """Eval logits of the narrow recognizer, its DataBN 'MVC'; no kernel
    of the port is launched (nor exists on this path)."""
    tcfg, v, x, want = recognizers(family, V, semantic)
    port = _load(build_model(tcfg), v)
    assert port.backbone.data_bn.kind == "MVC"
    before = launch_counts()
    np.testing.assert_allclose(_run(port, x), want, **MODEL_TOL)
    assert launch_counts() == before


def test_ctrgcn_semantic_stage_counts_the_stem():
    """semantic_stage holds 1-based stage numbers with the stem counted: a
    backbone without the stem (in_channels == base_channels) starts at
    stage 2; the strict load of JAX's variables holds the flags to JAX's."""
    for in_c, want in ((3, [False, True]), (16, [True])):
        jcfg, tcfg = _cfgs("ctrgcn", semantic=True)
        for c in (jcfg, tcfg):
            c["backbone"].update(in_channels=in_c)
        port = build_model(tcfg)
        blocks = [getattr(port.backbone, f"block{i}")
                  for i in range(port.backbone.num_blocks)]
        assert [b.gcn.convs0.edge_att for b in blocks] == want
        x = _x(26, 1, 2, 4, 25, in_c)
        port.load_state_dict(convert_jax_variables(
            _variables(j_build_model(jcfg), x, seed=27)), strict=True)


@pytest.mark.parametrize("family", ["aagcn", "ctrgcn"])
def test_train_float64_matches_jax(family):
    """One float64 step of a one-block recognizer (the stem, 3 -> 16
    channels) through both packages' train_step: loss, parameters and
    BatchNorm statistics to 1e-8 relative."""
    jcfg, tcfg = _cfgs(family, narrow=dict(num_stages=1, base_channels=16))
    v = _variables(j_build_model(jcfg), _x(28, 2, 2, 8, 25, 3), seed=28)
    rng = np.random.default_rng(29)
    batch = dict(keypoint=rng.standard_normal((2, 2, 8, 25, 3)),
                 label=rng.integers(0, 11, 2))
    jax.config.update("jax_enable_x64", True)
    try:
        (jl, want), (tl, port) = _run_both(jcfg, tcfg, v, [batch],
                                           jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(tl, jl, rtol=1e-8)
    state = port.state_dict()
    for name, w in want.items():
        assert_rel(state[name].numpy(), w.numpy(), 1e-8, name)


@pytest.mark.parametrize("use_pallas", [None, True])
@pytest.mark.parametrize("family", ["aagcn", "ctrgcn"])
def test_model_cfg_matches_jax(family, use_pallas):
    for layout in ("nturgb+d", "coco"):
        assert (model_cfg(family, num_classes=120, layout=layout,
                          use_pallas=use_pallas)
                == j_model_cfg(family, num_classes=120, layout=layout,
                               use_pallas=use_pallas))


@pytest.mark.parametrize("name", ["msg3d", "sgn"])
def test_model_cfg_unported_raise(name):
    """MS-G3D and SGN were the last of JAX's model_cfg names the port
    refused; now each reads as JAX's (head width 384, 512), and only a
    name JAX does not know is refused, with a ValueError as JAX's."""
    for layout in ("nturgb+d", "coco"):
        assert (model_cfg(name, num_classes=120, layout=layout)
                == j_model_cfg(name, num_classes=120, layout=layout))
    with pytest.raises(ValueError, match=f"{name}x"):
        model_cfg(f"{name}x")
    with pytest.raises(ValueError):
        j_model_cfg(f"{name}x")


# ---------------------------------------------------------------------------
# the init rules
# ---------------------------------------------------------------------------

def _std_close(t, std, what):
    got = t.detach().double().std().item()
    assert abs(got / std - 1) < 0.1, f"{what}: std {got:.4g}, want {std:.4g}"


@pytest.mark.parametrize("family", ["aagcn", "ctrgcn"])
def test_init_rules_follow_jax(family):
    """init_weights_ draws the JAX initializers' distributions: exact
    1e-6 scales and zeros, and each drawn kernel's std within 10% of the
    JAX formula's (kaiming_normal_fan_out, branch_init, flax's truncated
    xavier_normal and kaiming_normal)."""
    m = init_weights_(build_model(model_cfg(family)),
                      torch.Generator().manual_seed(0))
    b = m.backbone
    gcn4 = b.block4.gcn                        # 64 -> 128, a down path
    for blk in (b.block0, b.block4, b.block9):
        assert (blk.gcn.bn.weight == 1e-6).all()
    if family == "aagcn":
        K = gcn4.K
        assert (gcn4.conv_a0.bias == 0).all()
        _std_close(gcn4.conv_a0.weight, (2 / 32) ** 0.5, "conv_a0")
        _std_close(gcn4.conv_d1.weight, (2 / (128 * 64 * K)) ** 0.5,
                   "conv_d1")
        _std_close(gcn4.down_conv.weight, (2 / 128) ** 0.5, "down_conv")
        att = b.block9.gcn.att
        for t in (att.conv_ta.weight, att.conv_ta.bias, att.fc2c.weight,
                  att.fc2c.bias, att.fc1c.bias, att.conv_sa.bias):
            assert (t == 0).all()
        # flax's truncated normals have exactly the asked variance
        _std_close(att.conv_sa.weight, (2 / (25 * 256 + 25)) ** 0.5,
                   "conv_sa")
        _std_close(att.fc1c.weight, (2 / 256) ** 0.5, "fc1c")
        bound = 2 * (2 / 256) ** 0.5 / .87962566103423978
        assert att.fc1c.weight.abs().max() <= bound
    else:
        c = gcn4.convs0
        for t in (c.conv1, c.conv2, c.conv3, c.conv4):
            assert (t.bias == 0).all()
        _std_close(c.conv3.weight, (2 / 128) ** 0.5, "conv3")
        _std_close(c.conv4.weight, (2 / 128) ** 0.5, "conv4")
        assert gcn4.alpha.shape == (1,) and (gcn4.alpha == 0).all()
        tcn = b.block4.tcn
        _std_close(tcn.branch0_pre.weight, (2 / 32) ** 0.5, "branch0_pre")
        _std_close(tcn.branch3_conv.conv.weight, (2 / 32) ** 0.5,
                   "branch3_conv")
        bound = 1 / 64 ** 0.5                 # torch's default for the rest
        assert gcn4.down_conv.weight.abs().max() <= bound
        _std_close(gcn4.down_conv.weight, bound / 3 ** 0.5, "down_conv")


# ---------------------------------------------------------------------------
# DGPHGCN1's options that are not ported
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option,value", [
    ("ada_attention", True), ("target_specific", True), ("add_type", True),
    ("graph_axis", "joints"), ("v_pad", 32)])
def test_dgphgcn1_unported_options_raise(option, value):
    """Every option of JAX's DGPHGCN1 builds.  ``graph_axis`` (the
    joint-partitioned mode; its parity with JAX is
    ``test_torch_port_jp.py``'s) takes JAX's supported form, and each form
    JAX's assert rejects raises, naming the option; at its default it
    builds.  ``ada_attention``, ``target_specific`` and ``add_type`` are
    ported: set, each builds what it adds (``ada_linears``, the
    per-node-type ``nodeconv_*``) or, for ``add_type``, which DGPHGCN1
    never reads, the default's parameters (their parity with JAX is
    ``test_torch_port_options.py``'s); so is ``v_pad``, which builds the
    default's parameters and refuses training (its parity is
    ``test_torch_port_padded.py``'s)."""
    graph = _graph(25)
    if option == "v_pad":
        mod = DGPHGCN1(16, 16, **graph, **{option: value})
        assert mod.state_dict().keys() == DGPHGCN1(
            16, 16, **graph).state_dict().keys()
        with pytest.raises(NotImplementedError, match="eval-only"):
            mod.train()(torch.zeros(1, 2, 32, 16))
        return
    if option in ("ada_attention", "target_specific", "add_type"):
        shapes = [{k: tuple(t.shape) for k, t in DGPHGCN1(
            16, 16, **graph, decompose=True, **kw).state_dict().items()}
            for kw in ({}, {option: value})]
        added = {k.split(".")[0] for k in set(shapes[1]) - set(shapes[0])}
        assert added == {"ada_attention": {"ada_linears"},
                         "target_specific": {"nodeconv_conv", "nodeconv_bn"},
                         "add_type": set()}[option]
        if option == "add_type":
            assert shapes[1] == shapes[0]
        return
    assert DGPHGCN1(16, 16, **graph, decompose=True, edge_attention=True,
                    **{option: value}).graph_axis == value
    for bad in (dict(ada_attention=True), dict(target_specific=True),
                dict(ada=None), dict(ctr_act="relu"), dict(v_pad=32)):
        with pytest.raises(NotImplementedError,
                           match=f"graph_axis.*{next(iter(bad))}"):
            DGPHGCN1(16, 16, **graph, decompose=True, edge_attention=True,
                     **{option: value}, **bad)
    # decomposed without edge attention: the ring needs sem == norm - sem
    with pytest.raises(NotImplementedError, match="sem == norm - sem"):
        DGPHGCN1(16, 16, **dict(graph, A_init=_graph(25)["A_init"][:2]),
                 decompose=True, **{option: value})
    DGPHGCN1(16, 16, **graph, **{option: None})
