"""Port parity, the main path's options: ``UnitTCN(dropout=)``,
``DGMSTCN(eval_layout=)``, the backbone's ``remat`` (True and 'tcn'),
``DGPHGCN1``'s ``add_type``, ``target_specific`` and ``ada_attention``,
and per-frame graphs (``ctr``/``ada`` 'NA') in ``DGPHGCN1`` and ``DGGCN``,
of ``dsgcn_tpu_torch`` against ``dsgcn_tpu`` on the CPU.

Variables are drawn with ``jax.eval_shape`` + numpy
(``test_torch_port_dggcn._random_variables``); inputs are numpy from a
seed.  JAX runs each module's dense path, jitted; the port runs each of its
paths: on the CPU the kernel wrappers run their plain versions, and the
tests count which wrapper each path called.  Tolerances: eval modules at
1e-5 (``MODULE_TOL``); train modules (outputs, updated statistics, input
and parameter gradients) at ``MODULE_RTOL`` (2e-4, see
``test_torch_port_grad.py``) through the kernels' float32 plain versions,
and in float64 at 1e-8 on the dense path; remat against no remat in
float64 at 1e-12 (the same arithmetic, recomputed).
"""
import numpy as np
import pytest
import torch

from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.ops.gcn import DGGCN as JDGGCN
from dsgcn_tpu.ops.gcn import DGPHGCN1 as JDGPHGCN1
from dsgcn_tpu.ops.tcn import DGMSTCN as JDGMSTCN
from dsgcn_tpu.ops.tcn import UnitTCN as JUnitTCN
from dsgcn_tpu_torch.models.builder import (build_model, init_weights_,
                                           model_cfg, set_dropout_generator)
from dsgcn_tpu_torch.ops import gcn, tcn
from dsgcn_tpu_torch.ops.common import BatchNorm
from dsgcn_tpu_torch.ops.gcn import DGGCN, DGPHGCN1
from dsgcn_tpu_torch.ops.tcn import DGMSTCN, UnitTCN
from test_torch_port_dggcn import _graph8, _variables
from test_torch_port_families import _eval, _train_parity_f64, _x
from test_torch_port_family_configs import one_thread  # noqa: F401
from test_torch_port_grad import _train_parity
from test_torch_port_model import MODULE_TOL, _load, _run

N, T = 2, 8


def _graph3():
    g = JGraph(layout="nturgb+d", mode="random", num_filter=3, seed=0)
    return dict(A_init=g.A.astype(np.float32), edge_type=g.edge_type,
                node_type=np.array(g.node_type))


# ---------------------------------------------------------------------------
# UnitTCN's dropout
# ---------------------------------------------------------------------------

def test_unit_tcn_dropout_matches_jax():
    """Eval: the identity whatever ``dropout``, equal to JAX's module.
    Train: JAX's output without dropout, and with it the same output with
    each entry kept (scaled by 1 / (1 - p)) or zeroed, the mask from the
    module's generator (one generator, one mask)."""
    x = _x(40, N, T, 25, 16)
    jmod = JUnitTCN(24, kernel_size=9, stride=2, dropout=0.5)
    v = _variables(jmod, x, seed=41)
    port = _load(UnitTCN(16, 24, kernel_size=9, stride=2, dropout=0.5), v)
    np.testing.assert_allclose(_run(port, x), _eval(jmod, v, x),
                               **MODULE_TOL)
    plain = JUnitTCN(24, kernel_size=9, stride=2)
    _train_parity(plain, _load(UnitTCN(16, 24, kernel_size=9, stride=2), v),
                  v, x, (N, T // 2, 25, 24), seed=42, jit=True)
    port.train()
    port.generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a = port(torch.from_numpy(x))
        port.generator = torch.Generator().manual_seed(0)
        b = port(torch.from_numpy(x))
        port.dropout = 0.0
        y = port(torch.from_numpy(x))
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], 2 * y[kept])
    assert 0.4 < 1 - kept.float().mean().item() < 0.6


def test_unit_tcn_dropout_through_the_builder():
    """``tcn_dropout`` reaches every unit_tcn but the stem's (JAX pops it
    from stage 1), and ``set_dropout_generator`` reaches them."""
    cfg = model_cfg("stgcn")
    cfg["backbone"].update(tcn_dropout=0.3, num_stages=3, base_channels=16,
                           inflate_stages=(), down_stages=())
    cfg["cls_head"]["in_channels"] = 16
    model = build_model(cfg)
    units = [getattr(model.backbone, f"block{i}").tcn for i in range(3)]
    assert all(isinstance(u, UnitTCN) for u in units)
    assert [u.dropout for u in units] == [0.0, 0.3, 0.3]
    gen = torch.Generator()
    set_dropout_generator(model, gen)
    assert all(u.generator is gen for u in units)


# ---------------------------------------------------------------------------
# DGMSTCN's eval layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("layout", ["split", "concat"])
def test_dgmstcn_eval_layout_matches_jax(layout, stride):
    """The port with each layout against JAX's module with both layouts
    (``tests/test_tcn_eval_layout.py``) at 1e-5: the port runs concat for
    every layout, and JAX's split is the same function."""
    x = _x(43, 4, 12, 25, 24)
    jmod = JDGMSTCN(24, stride=stride, eval_layout=layout)
    v = _variables(jmod, x, seed=44)
    got = _run(_load(DGMSTCN(24, 24, stride=stride, eval_layout=layout), v),
               x)
    np.testing.assert_allclose(got, _eval(jmod, v, x), **MODULE_TOL)
    other = "concat" if layout == "split" else "split"
    np.testing.assert_allclose(got, _eval(JDGMSTCN(
        24, stride=stride, eval_layout=other), v, x), **MODULE_TOL)


def test_dgmstcn_eval_layout_dispatch(monkeypatch):
    """Every layout JAX takes is accepted and runs the same concat path,
    bit for bit, at any batch; K7 (``use_pallas``) comes first whatever
    the layout; any other layout raises JAX's ValueError, and so does an
    unknown ``branch_kind`` (``'mlp'`` builds dgmsmlp).  ``v_pad``
    builds and refuses training (its parity is
    ``test_torch_port_padded.py``'s); ``graph_axis`` builds and refuses
    ``v_pad`` (its parity is ``test_torch_port_jp.py``'s)."""
    assert DGMSTCN(24, 24).eval_layout == "auto"
    with pytest.raises(ValueError, match="eval_layout"):
        DGMSTCN(24, 24, eval_layout="fused")
    assert DGMSTCN(24, 24, branch_kind="mlp").branches.branch_kind == "mlp"
    with pytest.raises(ValueError, match="branch_kind"):
        DGMSTCN(24, 24, branch_kind="conv")
    # graph_axis (joint partition; parity in test_torch_port_jp.py) builds,
    # and refuses joint-padded mode as JAX asserts
    assert DGMSTCN(24, 24, graph_axis="joints").graph_axis == "joints"
    with pytest.raises(ValueError, match="graph_axis"):
        DGMSTCN(24, 24, graph_axis="joints", v_pad=32)
    with pytest.raises(NotImplementedError, match="eval-only"):
        DGMSTCN(24, 24, v_pad=32).train()(torch.zeros(1, 4, 32, 24))
    calls = []
    k7 = tcn.fused_ms_eval
    monkeypatch.setattr(tcn, "fused_ms_eval",
                        lambda *a: calls.append("k7") or k7(*a))
    torch.manual_seed(0)
    ref = DGMSTCN(24, 24).eval()
    for n in (2, 128):
        x = torch.randn(n, 6, 25, 24)
        with torch.no_grad():
            want = ref(x)
            for layout in ("auto", "split", "concat"):
                m = DGMSTCN(24, 24, eval_layout=layout).eval()
                m.load_state_dict(ref.state_dict())
                assert torch.equal(m(x), want)
    assert calls == []
    with torch.no_grad():
        for layout in ("auto", "split", "concat"):
            DGMSTCN(24, 24, eval_layout=layout, use_pallas=True).eval()(x)
    assert calls == ["k7"] * 3


# ---------------------------------------------------------------------------
# DGPHGCN1's options and per-frame graphs
# ---------------------------------------------------------------------------

GCN = dict(ratio=0.25, decompose=True, node_attention=True,
           edge_attention=True, subset_wise=True)
OPTIONS = {
    "target_specific": dict(GCN, target_specific=True),
    "ada_attention": dict(GCN, ada_attention=True),
    "add_type": dict(GCN, add_type=True),
    "ctr_NA": dict(GCN, ctr="NA", edge_attention=False),
    "ada_NA": dict(GCN, ada="NA", edge_attention=False),
    "NA_target_specific": dict(GCN, ctr="NA", edge_attention=False,
                               target_specific=True),
}
# the port's paths: (use_pallas, eval_kernel) -> the wrappers they call
PATHS = {"dense": (False, "auto"), "auto": (True, "auto"),
         "fused": (True, "fused"), "mega": (True, "mega")}
KERNELS = ("bd_dyn_graph_agg", "fused_dyn_graph_agg",
           "fused_dggcn_block_eval")


def _kernel_on_path(option, path):
    """The wrapper JAX's dispatch calls for this option and path (gcn.py:
    1119-1196): none where ada_attention or per-frame graphs rule the
    kernels out; 'mega' takes K1 for target_specific values; 'auto' is
    'bd' at V K mid = 600."""
    if path == "dense" or option in ("ada_attention", "ctr_NA", "ada_NA",
                                     "NA_target_specific"):
        return None
    if path == "mega":
        return ("fused_dyn_graph_agg" if option == "target_specific"
                else "fused_dggcn_block_eval")
    return {"auto": "bd_dyn_graph_agg", "fused": "fused_dyn_graph_agg"}[path]


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of the kernel wrappers DGPHGCN1 uses."""
    calls = []
    for name in KERNELS:
        fn = getattr(gcn, name)
        monkeypatch.setattr(gcn, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    return calls


@pytest.fixture(scope="module")
def option_cases():
    """Per option: JAX's dense module, its variables and eval output."""
    x = _x(45, N, T, 25, 16)
    cases = {}
    for i, (name, kw) in enumerate(OPTIONS.items()):
        jmod = JDGPHGCN1(32, **_graph3(), **kw)
        v = _variables(jmod, x, seed=46 + i)
        cases[name] = (jmod, v, _eval(jmod, v, x))
    return x, cases


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("option", list(OPTIONS))
def test_dgphgcn1_option_eval_matches_jax(option_cases, kernel_calls, option,
                                          path):
    x, cases = option_cases
    jmod, v, want = cases[option]
    use_pallas, ek = PATHS[path]
    port = _load(DGPHGCN1(16, 32, **_graph3(), **OPTIONS[option],
                          use_pallas=use_pallas, eval_kernel=ek), v)
    np.testing.assert_allclose(_run(port, x), want, **MODULE_TOL)
    expect = _kernel_on_path(option, path)
    assert kernel_calls == ([expect] if expect else [])


@pytest.mark.parametrize("option", ["target_specific", "add_type"])
def test_dgphgcn1_option_train_kernel_path_matches_jax(option_cases,
                                                       kernel_calls, option):
    """Train mode through K1+K2 (their plain versions) against JAX's
    dense module."""
    x, cases = option_cases
    jmod, v, _ = cases[option]
    port = DGPHGCN1(16, 32, **_graph3(), **OPTIONS[option], use_pallas=True)
    _train_parity(jmod, port, v, x, (N, T, 25, 32), seed=52, jit=True)
    assert kernel_calls == ["fused_dyn_graph_agg"]


@pytest.mark.parametrize("option", ["target_specific", "ada_attention",
                                    "ctr_NA", "ada_NA",
                                    "NA_target_specific"])
def test_dgphgcn1_option_train_dense_float64_matches_jax(option_cases,
                                                         option):
    """Train mode on the dense path in float64 at 1e-8: outputs, updated
    statistics, input and parameter gradients (``ada_attention`` and 'NA'
    take this path with ``use_pallas`` too, as in JAX)."""
    x, cases = option_cases
    jmod, v, _ = cases[option]
    port = DGPHGCN1(16, 32, **_graph3(), **OPTIONS[option],
                    use_pallas=option in ("ada_attention", "ctr_NA"))
    _train_parity_f64(jmod, port, v, x, seed=53)


def test_dgphgcn1_options_build_what_jax_builds():
    """The parameters each option adds carry JAX's names and shapes: the
    per-node-type values (sem P mid channels) beside a norm-mid pre_conv,
    the K -> E K ada_linears; add_type adds nothing."""
    def names(**kw):
        return {k: tuple(t.shape) for k, t in DGPHGCN1(
            16, 32, **_graph3(), **GCN, **kw).state_dict().items()}
    base = names()
    ts = names(target_specific=True)
    assert ts["nodeconv_conv.weight"] == (1 * 5 * 8, 16)
    assert ts["nodeconv_bn.running_mean"] == (40,)
    assert ts["pre_conv.weight"] == (2 * 8, 16)
    assert names(ada_attention=True)["ada_linears.weight"] == (15 * 3, 3)
    assert names(add_type=True) == base
    # without decompose target_specific changes nothing (gcn.py:1045)
    plain = dict(GCN, decompose=False, edge_attention=False)
    assert (DGPHGCN1(16, 32, **_graph3(), **plain,
                     target_specific=True).state_dict().keys()
            == DGPHGCN1(16, 32, **_graph3(), **plain).state_dict().keys())


@pytest.mark.parametrize("kw,what", [
    (dict(GCN, ctr="NA"), "edge attention"),
    (dict(GCN, ada="NA", edge_attention=False, ada_attention=True),
     "ada attention")])
def test_per_frame_graphs_refuse_attention_as_jax_does(kw, what):
    """Edge and ada attention need T-pooled graphs: JAX asserts it at its
    first call, the port refuses the module when it is built."""
    x = _x(47, N, T, 25, 16)
    with pytest.raises(AssertionError, match=what):
        _variables(JDGPHGCN1(32, **_graph3(), **kw), x, seed=0)
    with pytest.raises(ValueError, match=what):
        DGPHGCN1(16, 32, **_graph3(), **kw)


@pytest.mark.parametrize("kw", [dict(ctr="NA"), dict(ada="NA"),
                                dict(ctr=None, ada="NA"),
                                dict(ctr="NA", ada=None, subset_wise=True)],
                         ids=["ctr", "ada", "ada-only", "ctr-only-subset"])
def test_dggcn_per_frame_graphs_match_jax(kw):
    """DGGCN with per-frame graphs, asked for with use_pallas=True (the
    dense path serves, as in JAX): eval at 1e-5, train in float64 at
    1e-8."""
    x = _x(48, N, T, 25, 16)
    jmod = JDGGCN(16, A_init=_graph8(), **kw)
    v = _variables(jmod, x, seed=49)
    port = DGGCN(16, 16, A_init=_graph8(), **kw, use_pallas=True)
    np.testing.assert_allclose(_run(_load(port, v), x), _eval(jmod, v, x),
                               **MODULE_TOL)
    _train_parity_f64(jmod, port, v, x, seed=50)


@pytest.mark.parametrize("cls", ["DGGCN", "DGPHGCN1"])
def test_unknown_graph_modes_raise(cls):
    kw = (dict(A_init=_graph8()) if cls == "DGGCN" else _graph3())
    with pytest.raises(ValueError, match="ctr"):
        getattr(gcn, cls)(16, 16, ctr="X", **kw)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _narrow(name, **bb):
    cfg = model_cfg(name, num_classes=5)
    cfg["backbone"].update(num_stages=4, base_channels=16,
                           inflate_stages=(3,), down_stages=(3,), **bb)
    cfg["cls_head"]["in_channels"] = 32
    return cfg


def _step(cfg, x, y, seed=54):
    """One float64 train step's loss, parameter gradients and buffers
    (running statistics) from seeded weights, dropout from one generator."""
    model = init_weights_(build_model(cfg),
                          torch.Generator().manual_seed(seed)).double()
    for m in model.modules():           # gates and coefficients off zero
        for name in ("alpha", "beta", "add_coeff"):
            if isinstance(getattr(m, name, None), torch.nn.Parameter):
                with torch.no_grad():
                    getattr(m, name).uniform_(
                        -1, 1, generator=torch.Generator().manual_seed(seed))
    set_dropout_generator(model, torch.Generator().manual_seed(seed + 1))
    model.train()
    loss = torch.nn.functional.cross_entropy(model(x), y)
    loss.backward()
    return (loss.item(), {k: p.grad for k, p in model.named_parameters()},
            {k: b.clone() for k, b in model.named_buffers()},
            model.state_dict().keys())


@pytest.mark.parametrize("remat", [True, "tcn"])
@pytest.mark.parametrize("name", ["dsgcn", "stgcn++"])
def test_remat_is_a_no_op(name, remat, one_thread):  # noqa: F811
    """remat (``tests/test_bf16_training.py``, there up to f32 noise):
    loss, every gradient and every BatchNorm's running statistics after a
    step equal those without remat, with ``tcn_dropout`` 0.5 on, and the
    state dict keeps its names.  DS-GCN takes the dense path in float64
    (the kernels' plain versions compute in float32); STGCN++ has no DG
    block, so 'tcn' changes nothing there, as in JAX."""
    bb = dict(tcn_dropout=0.5)
    if name == "dsgcn":
        bb["gcn_use_pallas"] = False
    x = torch.from_numpy(_x(55, 2, 2, 12, 25, 3).astype(np.float64))
    y = torch.tensor([1, 3])
    l0, g0, b0, k0 = _step(_narrow(name, **bb), x, y)
    l1, g1, b1, k1 = _step(_narrow(name, remat=remat, **bb), x, y)
    assert k0 == k1
    assert l1 == pytest.approx(l0, rel=1e-12)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-12, atol=1e-14,
                                   msg=k)
    moved = [k for k in b0 if k.endswith("running_mean")]
    assert moved and all(b0[k].abs().sum() > 0 for k in moved)
    for k in b0:
        torch.testing.assert_close(b1[k], b0[k], rtol=1e-12, atol=1e-14,
                                   msg=k)


def test_remat_kernel_path_recomputes_k1(monkeypatch,
                                         one_thread):  # noqa: F811
    """On the kernel path whole-block remat runs the K1+K2 Function's
    forward twice a block (the backward's recompute), 'tcn' once, and the
    float32 step equals the one without remat."""
    from dsgcn_tpu_torch.ops.kernels import dyn_graph
    calls = []
    fwd = dyn_graph.FusedDynGraphAgg.forward
    monkeypatch.setattr(dyn_graph.FusedDynGraphAgg, "forward", staticmethod(
        lambda *a: calls.append(1) or fwd(*a)))
    x = torch.from_numpy(_x(56, 2, 2, 12, 25, 3))
    y = torch.tensor([0, 4])
    results = {}
    for remat in (False, "tcn", True):
        calls.clear()
        cfg = _narrow("dsgcn", remat=remat, tcn_dropout=0.5)
        model = init_weights_(build_model(cfg),
                              torch.Generator().manual_seed(57)).train()
        set_dropout_generator(model, torch.Generator().manual_seed(58))
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        blocks = model.backbone.num_blocks
        results[remat] = (len(calls) / blocks, loss.item(), [
            p.grad.clone() for p in model.parameters()], [
            b.clone() for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)])
    assert [results[r][0] for r in (False, "tcn", True)] == [1, 1, 2]
    for r in ("tcn", True):
        assert results[r][1] == results[False][1]
        for a, b in zip(results[r][2] + results[r][3],
                        results[False][2] + results[False][3]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_config_matches_jax_and_refuses_others():
    """``remat`` is a backbone field in both builders (JAX builder.py:67);
    the JAX and port models of a remat config have the same variables."""
    cfg = _narrow("dsgcn", remat="tcn")
    x = np.zeros((1, 2, 4, 25, 3), np.float32)
    v = _variables(j_build_model(cfg), x, seed=59)
    model = build_model(cfg)
    assert model.backbone.remat == "tcn"
    assert all(getattr(model.backbone, f"block{i}").remat_tcn
               for i in range(model.backbone.num_blocks))
    _load(model, v)
    with pytest.raises(ValueError, match="remat"):
        build_model(_narrow("dsgcn", remat="gcn"))
