"""Port parity, DG-STGCN: the kernels K4 (bd_dyn_graph_agg_subset), K5
(fused_dyn_graph_agg_eval) and K6 (fused_dggcn_block_eval), the DGGCN
module in eval and train, DGPHGCN1's 'mega' path, a narrow DG-STGCN
recognizer (also with ``tcn_use_pallas``, the fused TCN kernel K7), a
float64 train step and ``model_cfg('dgstgcn')`` of ``dsgcn_tpu_torch``
against ``dsgcn_tpu`` on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode.  Inputs are numpy from a seed.
Tolerances: kernel functions in float32 within 1e-5 of the largest output
(the same sums in another order), a bfloat16 K5 within 2e-2 of it (pre and
y are each rounded to bfloat16 once, and a sum in another order may round
the other way); K2's plain backward at Cm = 64 within 1e-5 of each
gradient's largest entry; eval modules at 1e-5 (``MODULE_TOL``), train
modules at ``MODULE_RTOL`` (2e-4, see ``test_torch_port_grad.py``), model
logits at 1e-4 (``MODEL_TOL``), the float64 train step at 1e-8.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu.ops.gcn import DGGCN as JDGGCN
from dsgcn_tpu.ops.gcn import DGPHGCN1 as JDGPHGCN1
from dsgcn_tpu.ops.pallas.bd_agg import bd_dyn_graph_agg_subset as j_k4
from dsgcn_tpu.ops.pallas.dggcn_block import fused_dggcn_block_eval as j_k6
from dsgcn_tpu.ops.pallas.dyn_graph import fused_dyn_graph_agg as j_fused
from dsgcn_tpu.ops.pallas.dyn_graph import fused_dyn_graph_agg_eval as j_k5
from dsgcn_tpu_torch.models.builder import (build_model, build_named_model,
                                           model_cfg)
from dsgcn_tpu_torch.ops.common import BatchNorm, fold_bn
from dsgcn_tpu_torch.ops.gcn import DGGCN, DGPHGCN1
from dsgcn_tpu_torch.ops.kernels.bd_agg import (
    bd_dyn_graph_agg_subset, reference_bd_dyn_graph_agg)
from dsgcn_tpu_torch.ops.kernels.dggcn_block import fused_dggcn_block_eval
from dsgcn_tpu_torch.ops.kernels.dyn_graph import (fused_dyn_graph_agg_bwd,
                                                   fused_dyn_graph_agg_eval)
from dsgcn_tpu_torch.ops.kernels.ms_tcn import fused_dgmstcn_eval
from test_torch_port_grad import _jit_eval, _train_parity, assert_rel
from test_torch_port_model import (GCN_KW, MODEL_TOL, MODULE_TOL, _load,
                                   _run)
from test_torch_port_train import _run_both
from torch_port_cases import E, block_inputs, k3_packaging, to_torch

KERNEL_RTOL = 1e-5


def _close(got, want, rtol=KERNEL_RTOL):
    """max |got - want| <= rtol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rtol, f"{err:.3e} of the largest output (tol {rtol})"


def _random_variables(shapes, seed):
    """Variables of the JAX tree ``shapes`` drawn from numpy (cheaper than
    the JAX init on the CPU): 1x1 and temporal kernels N(0, 1/fan_in), BN
    scales 1 + 0.1 N(0, 1), running variances U(0.5, 1.5), gates U(-1, 1),
    graphs around 0.04, everything else 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        name, shape = path[-1].key, a.shape
        n = rng.standard_normal(shape)
        if name == "kernel":
            out = n / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            out = 1 + 0.1 * n
        elif name == "var":
            out = rng.uniform(0.5, 1.5, shape)
        elif name in ("alpha", "beta"):
            out = rng.uniform(-1, 1, shape)
        elif name == "A":
            out = 0.04 + 0.02 * n
        else:
            out = 0.1 * n
        return out.astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, shapes)


def _variables(module, x, seed):
    """Random variables for a JAX module on input x (see
    :func:`_random_variables`)."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    return _random_variables(shapes, seed)


def _graph8():
    return JGraph(layout="nturgb+d", mode="random", num_filter=8, seed=0) \
        .A.astype(np.float32)


# ---------------------------------------------------------------------------
# the kernel functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [None, 8])
@pytest.mark.parametrize("v_real", [-1, 21])
def test_k4_plain_matches_jax_interpret(g, v_real):
    """bd_dyn_graph_agg_subset at Cm = 16: with g = 8 each channel group
    holds half a subset, where an ada graph built per group would be
    wrong."""
    K, Cm = 3, 16
    d = block_inputs(seed=20, T=4, Cm=Cm, edge=False)
    p = k3_packaging(d, K, Cm, -1)
    args = [p["pre2"], p["x1t"]] + [d[k] for k in ("x2", "A", "alpha",
                                                    "beta")]
    before = bd_dyn_graph_agg_subset.launches
    got = bd_dyn_graph_agg_subset(*map(to_torch, args), K=K, Cm=Cm, g=g,
                                  v_real=v_real)
    assert bd_dyn_graph_agg_subset.launches == before   # CPU: plain version
    want = j_k4(*map(jnp.asarray, args), K=K, Cm=Cm, g=g, interpret=True,
                v_real=v_real)
    _close(got.numpy(), want)
    if v_real < 0:   # K3's function without edge attention
        same = reference_bd_dyn_graph_agg(*map(to_torch, args), K=K, Cm=Cm)
        _close(got.numpy(), same.numpy())


def test_k4_checks_the_group():
    d = block_inputs(seed=21, T=2, Cm=12, edge=False)
    p = k3_packaging(d, 3, 12, -1)
    args = [to_torch(a) for a in [p["pre2"], p["x1t"], d["x2"], d["A"],
                                  d["alpha"], d["beta"]]]
    for g in (None, 6):     # 12 is no multiple of 8; 6 neither
        with pytest.raises(ValueError, match="multiple of 8"):
            bd_dyn_graph_agg_subset(*args, K=3, Cm=12, g=g)


def _k5_inputs(seed, C=64, K=3, Cm=8, T=4):
    d = block_inputs(seed=seed, T=T, K=K, Cm=Cm, edge=False)
    rng = np.random.default_rng(seed + 1)
    d.update(x=rng.standard_normal((2, T, 25, C)).astype(np.float32),
             w_pre=(rng.standard_normal((C, K * Cm)) / np.sqrt(C)).astype(
                 np.float32),
             b_pre=(0.1 * rng.standard_normal(K * Cm)).astype(np.float32))
    return d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_plain_matches_jax_interpret(dtype):
    """w_pre in x's dtype, b_pre float32, as DGGCN calls it."""
    K, Cm = 3, 8
    d = _k5_inputs(22)
    graph = [d[k] for k in ("x1", "x2", "A", "alpha", "beta")]
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    before = fused_dyn_graph_agg_eval.launches
    got = fused_dyn_graph_agg_eval(
        to_torch(d["x"]).to(tdt), to_torch(d["w_pre"]).to(tdt),
        to_torch(d["b_pre"]), *map(to_torch, graph), K=K, Cm=Cm)
    assert fused_dyn_graph_agg_eval.launches == before
    assert got.dtype == tdt
    want = j_k5(jnp.asarray(d["x"], jdt), jnp.asarray(d["w_pre"], jdt),
                jnp.asarray(d["b_pre"]), *map(jnp.asarray, graph), K=K,
                Cm=Cm, interpret=True)
    _close(got.float().numpy(), np.asarray(want, np.float32),
           KERNEL_RTOL if dtype == "float32" else 2e-2)


def _k6_inputs(seed, down, edge, C=16, K=3, Cm=8):
    d = block_inputs(seed=seed, T=4, K=K, Cm=Cm, edge=edge)
    rng = np.random.default_rng(seed + 1)
    Cout = 24 if down else C
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[0])).astype(  # noqa
        np.float32)
    d.update(x=rng.standard_normal((2, 4, 25, C)).astype(np.float32),
             w_pre=f(C, K * Cm), b_pre=f(K * Cm), w_post=f(K * Cm, Cout),
             b_post=f(Cout))
    if down:
        d.update(w_down=f(C, Cout), b_down=f(Cout))
    return d


K6_ARGS = ("x", "x1", "x2", "w_pre", "b_pre", "A", "alpha", "beta", "w_post",
           "b_post", "w_down", "b_down")


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("down", [False, True])
def test_k6_plain_matches_jax_interpret(down, edge):
    K, Cm = 3, 8
    d = _k6_inputs(23 + 2 * down + edge, down, edge)
    ekw = dict(edge_k=1, edge_num=E) if edge else {}
    enames = ("ew", "eb", "sel") if edge else ()
    before = fused_dggcn_block_eval.launches
    got = fused_dggcn_block_eval(
        *(to_torch(d.get(k)) for k in K6_ARGS), K=K, Cm=Cm,
        **dict(zip(("edge_w", "edge_b", "edge_sel"),
                   (to_torch(d[k]) for k in enames))), **ekw)
    assert fused_dggcn_block_eval.launches == before
    want = j_k6(*(None if d.get(k) is None else jnp.asarray(d[k])
                  for k in K6_ARGS), K=K, Cm=Cm, interpret=True,
                **dict(zip(("edge_w", "edge_b", "edge_sel"),
                           (jnp.asarray(d[k]) for k in enames))), **ekw)
    _close(got.numpy(), want)


def test_k2_plain_matches_jax_k2_at_cm64():
    """The plain backward (the reference the card's K2 is held to) at
    DG-STGCN's widest stage, K = 8 and Cm = 64, Cm*V = 1600, against JAX's
    K2 in interpret mode."""
    K, Cm = 8, 64
    d = block_inputs(seed=24, N=1, T=4, K=K, Cm=Cm, edge=False)
    dy = np.random.default_rng(25).standard_normal(d["pre"].shape).astype(
        np.float32)
    names = ("pre", "x1", "x2", "A", "alpha", "beta")
    got = fused_dyn_graph_agg_bwd(*(to_torch(d[k]) for k in names), None,
                                  None, None, to_torch(dy), K, Cm, -1, E)
    _, vjp = jax.vjp(lambda *a: j_fused(*a, None, None, None, K, Cm, -1, E,
                                        True),
                     *(jnp.asarray(d[k]) for k in names))
    for name, g, w in zip(names, got, vjp(jnp.asarray(dy))):
        assert_rel(g.numpy(), w, KERNEL_RTOL, name)


def test_fold_bn_matches_the_eval_batchnorm():
    """fold_bn is the eval BatchNorm's affine (perturbed statistics)."""
    rng = np.random.default_rng(26)
    bn = BatchNorm(6).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.from_numpy(rng.standard_normal(6).astype(
                np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(
            0.1, 2, 6).astype(np.float32)))
        x = torch.from_numpy(rng.standard_normal((3, 6)).astype(np.float32))
        a, b = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var)
        torch.testing.assert_close(x * a + b, bn(x), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# DGGCN
# ---------------------------------------------------------------------------

PATHS = ["dense", "auto", "bd", "bdps", "bdg", "fused", "fusedpre", "mega"]
# (in, out, options): A has a down path, c = 64 (K5 applies) and the
# published options; B has no down path, per-subset gates, and c < 64
# (fusedpre falls back to K1, as in JAX)
DGGCN_CASES = {"A": (64, 32, dict()), "B": (32, 32, dict(subset_wise=True))}


@pytest.fixture(scope="module")
def dggcn_cases():
    """Random JAX variables of each case (gates and BN statistics off their
    initial values) and the JAX outputs by path, computed on first use."""
    cases = {}
    for name, (cin, cout, kw) in DGGCN_CASES.items():
        x = np.random.default_rng(30).standard_normal(
            (2, 4, 25, cin)).astype(np.float32)
        v = _variables(JDGGCN(cout, A_init=_graph8(), **kw), x, seed=31)
        cases[name] = dict(x=x, v=v, want={})
    return cases


def _jax_dggcn(case, name, path):
    c = case[name]
    if path not in c["want"]:
        cin, cout, kw = DGGCN_CASES[name]
        opts = (dict(use_pallas=False) if path == "dense" else
                dict(use_pallas=True, pallas_interpret=True,
                     eval_kernel=path))
        m = JDGGCN(cout, A_init=_graph8(), **kw, **opts)
        c["want"][path] = _jit_eval(m, c["v"], c["x"])
    return c["want"][path]


@pytest.mark.parametrize("case,path", [("A", p) for p in PATHS] + [
    ("B", p) for p in ("dense", "auto", "bdps", "fusedpre", "mega")])
def test_dggcn_eval_matches_jax(dggcn_cases, case, path):
    cin, cout, kw = DGGCN_CASES[case]
    port = DGGCN(cin, cout, A_init=_graph8(), **kw,
                 use_pallas=path != "dense",
                 eval_kernel="auto" if path == "dense" else path)
    c = dggcn_cases[case]
    np.testing.assert_allclose(_run(_load(port, c["v"]), c["x"]),
                               _jax_dggcn(dggcn_cases, case, path),
                               **MODULE_TOL)


def test_dggcn_eval_dispatch_follows_jax():
    """'auto' is 'bd' at V*K*mid <= 2400, 'bdg' at mid >= 64, else 'fused'
    (JAX gcn.py:622-634); 'fusedpre' needs c >= 64 (:669-670)."""
    A = _graph8()
    for cout, want in ((32, "bd"), (64, "fused"), (128, "fused"),
                       (256, "bdg")):
        assert DGGCN(cout, cout, A_init=A, use_pallas=True).eval_path(
            cout) == want, cout
    m = DGGCN(64, 64, A_init=A, use_pallas=True, eval_kernel="fusedpre")
    assert m.eval_path(64) == "fusedpre" and m.eval_path(32) == "fused"


@pytest.mark.parametrize("kw", [
    dict(ctr=None), dict(ada=None, ctr_act="sigmoid"),
    dict(ctr=None, ada=None), dict(subset_wise=True, ada_act="relu")],
    ids=["no-ctr", "no-ada-sigmoid", "static", "subset-relu"])
def test_dggcn_dense_options_match_jax(kw):
    """The dense path's other graph forms (the kernels take ctr=ada='T'
    with tanh/softmax only), asked for with use_pallas=True."""
    x = np.random.default_rng(32).standard_normal((2, 4, 25, 16)).astype(
        np.float32)
    ref = JDGGCN(16, A_init=_graph8(), **kw)
    v = _variables(ref, x, seed=33)
    want = _jit_eval(ref, v, x)
    port = _load(DGGCN(16, 16, A_init=_graph8(), **kw, use_pallas=True), v)
    np.testing.assert_allclose(_run(port, x), want, **MODULE_TOL)


@pytest.mark.parametrize("kw,what", [
    (dict(graph_axis="joints"), "graph_axis"), (dict(v_pad=32), "v_pad"),
    (dict(ctr="NA"), "'NA'"), (dict(ada="NA"), "'NA'")])
def test_dggcn_unported_options_raise(kw, what):
    """Every option builds: ``graph_axis`` (the joint-partitioned mode; its
    parity with JAX is ``test_torch_port_jp.py``'s) takes the standard
    form, and a form JAX's assert rejects raises, naming the option;
    per-frame graphs ('NA') build (their parity with JAX is
    ``test_torch_port_options.py``'s), and so does ``v_pad``, which refuses
    training (its parity is ``test_torch_port_padded.py``'s)."""
    if what == "'NA'":
        assert DGGCN(16, 16, A_init=_graph8(), **kw).per_frame
        return
    if what == "v_pad":
        mod = DGGCN(16, 16, A_init=_graph8(), **kw)
        with pytest.raises(NotImplementedError, match="eval-only"):
            mod.train()(torch.zeros(1, 2, 32, 16))
        return
    assert DGGCN(16, 16, A_init=_graph8(), **kw).graph_axis == "joints"
    for bad in (dict(ctr="NA"), dict(ada=None), dict(ada_act="relu"),
                dict(v_pad=32)):
        with pytest.raises(NotImplementedError,
                           match=f"graph_axis.*{next(iter(bad))}"):
            DGGCN(16, 16, A_init=_graph8(), **kw, **bad)


@pytest.mark.parametrize("path", ["kernel", "dense"])
def test_dggcn_train_matches_jax(path):
    """DGGCN (16 -> 32 channels, mid 8) in train mode: the kernel
    path through the K1+K2 Function (JAX: its Pallas kernels in interpret
    mode), the dense path through autograd; outputs, updated statistics,
    input and parameter gradients."""
    x = np.random.default_rng(34).standard_normal((2, 2, 25, 16)).astype(
        np.float32)
    use = path == "kernel"
    # the kernel path at K = 3 (the interpreted Pallas backward compiles in
    # proportion to K); the dense path at DG-STGCN's K = 8
    A = _graph8()[:3] if use else _graph8()
    jmod = JDGGCN(32, A_init=A, use_pallas=use, pallas_interpret=True)
    v = _variables(jmod, x, seed=35)
    port = DGGCN(16, 32, A_init=A, use_pallas=use)
    _train_parity(jmod, port, v, x, (2, 2, 25, 32), seed=36)


# ---------------------------------------------------------------------------
# DGPHGCN1 'mega'
# ---------------------------------------------------------------------------

def test_dgphgcn1_mega_matches_jax():
    """DS-GCN's block (16 -> 32, the down path) in K6 with node and edge
    attention, against JAX's K6 in interpret mode and against the port's
    'bd' path on the same weights."""
    cin = 16
    g = JGraph(layout="nturgb+d", mode="random", num_filter=3, seed=0)
    graph = dict(A_init=g.A.astype(np.float32), edge_type=g.edge_type,
                 node_type=np.array(g.node_type))
    x = np.random.default_rng(37).standard_normal((2, 4, 25, cin)).astype(
        np.float32)
    ref = JDGPHGCN1(32, use_pallas=True, pallas_interpret=True,
                    eval_kernel="mega", **graph, **GCN_KW)
    v = _variables(ref, x, seed=38)
    want = _jit_eval(ref, v, x)
    got = {}
    for ek in ("mega", "bd"):
        port = _load(DGPHGCN1(cin, 32, **graph, **GCN_KW, use_pallas=True,
                              eval_kernel=ek), v)
        before = fused_dggcn_block_eval.launches
        got[ek] = _run(port, x)
        assert fused_dggcn_block_eval.launches == before
    np.testing.assert_allclose(got["mega"], want, **MODULE_TOL)
    np.testing.assert_allclose(got["mega"], got["bd"], **MODULE_TOL)


# ---------------------------------------------------------------------------
# the narrow recognizer, one float64 train step, the config
# ---------------------------------------------------------------------------

# two blocks: the stem (3 -> 16) and a 16 -> 16 block with its residual
NARROW = dict(num_stages=2, base_channels=16)


def _cfgs():
    j = j_model_cfg("dgstgcn", num_classes=11)
    j["backbone"].update(NARROW, gcn_use_pallas=False)
    j["cls_head"]["in_channels"] = 16
    t = model_cfg("dgstgcn", num_classes=11)
    t["backbone"].update(NARROW)
    t["cls_head"]["in_channels"] = 16
    return j, t


@pytest.fixture(scope="module")
def narrow_dgstgcn():
    x = np.random.default_rng(40).standard_normal((2, 2, 8, 25, 3)).astype(
        np.float32)
    jcfg, tcfg = _cfgs()
    ref = j_build_model(jcfg)
    v = _variables(ref, x, seed=41)
    return tcfg, v, x, _jit_eval(ref, v, x)


@pytest.mark.parametrize("port_path", ["auto", "mega", "dense"])
def test_dgstgcn_recognizer_matches_jax(narrow_dgstgcn, port_path):
    """Eval logits of a narrow DG-STGCN (two blocks of width 16, K = 8)
    against the JAX model's dense path."""
    tcfg, v, x, want = narrow_dgstgcn
    tcfg = dict(tcfg, backbone=dict(tcfg["backbone"]))
    if port_path == "dense":
        tcfg["backbone"]["gcn_use_pallas"] = False
    else:
        tcfg["backbone"]["gcn_eval_kernel"] = port_path
    port = _load(build_model(tcfg), v)
    assert type(port.backbone.block0.gcn).__name__ == "DGGCN"
    np.testing.assert_allclose(_run(port, x), want, **MODEL_TOL)


def test_dgstgcn_train_float64_matches_jax(narrow_dgstgcn):
    """One float64 step of the narrow DG-STGCN on the dense path through
    both packages' train_step: loss, parameters and BatchNorm statistics
    to 1e-8 relative."""
    tcfg, v, _, _ = narrow_dgstgcn
    jcfg, _ = _cfgs()
    tcfg = dict(tcfg, backbone=dict(tcfg["backbone"], gcn_use_pallas=False))
    rng = np.random.default_rng(42)
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


@pytest.mark.parametrize("use_pallas", [None, False, True])
def test_model_cfg_dgstgcn_matches_jax(use_pallas):
    assert (model_cfg("dgstgcn", num_classes=120, graph_seed=3,
                      use_pallas=use_pallas)
            == j_model_cfg("dgstgcn", num_classes=120, graph_seed=3,
                           use_pallas=use_pallas))


def test_tcn_use_pallas_raises_naming_k7(narrow_dgstgcn):
    """``tcn_use_pallas=True`` (the fused TCN kernel K7; it raised, naming
    K7, while K7 had no port) builds DG-STGCN at full width with K7 in
    every DGMSTCN, and the narrow model's logits on the CPU (the GCN
    kernels' and K7's plain versions) match JAX's K7 path in interpret
    mode."""
    model = build_named_model("dgstgcn", use_pallas=True)
    assert all(getattr(model.backbone, f"block{i}").tcn.use_pallas
               and getattr(model.backbone, f"block{i}").gcn.use_pallas
               for i in range(10))
    assert not build_named_model("dgstgcn", use_pallas=False) \
        .backbone.block9.tcn.use_pallas
    tcfg, v, x, _ = narrow_dgstgcn
    jcfg, _ = _cfgs()
    jcfg["backbone"].update(tcn_use_pallas=True, tcn_pallas_interpret=True)
    want = _jit_eval(j_build_model(jcfg), v, x)
    tcfg = dict(tcfg, backbone=dict(tcfg["backbone"], gcn_use_pallas=True,
                                    tcn_use_pallas=True))
    before = fused_dgmstcn_eval.launches
    np.testing.assert_allclose(_run(_load(build_model(tcfg), v), x), want,
                               **MODEL_TOL)
    assert fused_dgmstcn_eval.launches == before    # CPU: plain versions
