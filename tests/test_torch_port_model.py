"""Port parity, model side: DGPHGCN1, DGMSTCN and a narrow DS-GCN
RecognizerGCN of ``dsgcn_tpu_torch`` against ``dsgcn_tpu`` on the CPU.

JAX variables are made once per module, nudged off their initial values
(zero gates would hide the ctr/ada graphs, unit statistics the BN affines),
converted with ``convert_jax_variables`` and loaded strictly.  Tolerances:
1e-5 per module, 1e-4 for model logits (the JAX float32 einsum drifts
~3e-4 on some draws, ROADMAP C).  Also: the converter is strict both ways,
the port imports nothing of JAX, and its entry points refuse to fall back
to the CPU.
"""
import ast
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.apis import inference_recognizer as j_inference
from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu.ops.gcn import DGPHGCN1 as JDGPHGCN1
from dsgcn_tpu.ops.tcn import DGMSTCN as JDGMSTCN
from dsgcn_tpu_torch.apis import (inference_recognizer, init_recognizer,
                                  to_bf16_inference)
from dsgcn_tpu_torch.graph import Graph
from dsgcn_tpu_torch.models.builder import build_model, model_cfg
from dsgcn_tpu_torch.ops.gcn import DGPHGCN1
from dsgcn_tpu_torch.ops.tcn import DGMSTCN
from dsgcn_tpu_torch.utils.convert import convert_jax_variables

REPO = pathlib.Path(__file__).resolve().parents[1]
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
NARROW = dict(num_stages=4, base_channels=32, inflate_stages=(3,),
              down_stages=(3,), gcn_ratio=0.25)


def nudge(variables, seed):
    """Move every leaf off its init: gates uniform in [-1, 1], running
    variances scaled by [0.5, 1.5], everything else + 0.1 * N(0, 1)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a, name = np.asarray(a), path[-1].key
        if name == "var":
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if name in ("alpha", "beta"):
            return rng.uniform(-1, 1, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(f, jax.device_get(variables))


def _load(module, variables):
    module.load_state_dict(convert_jax_variables(variables), strict=True)
    return module.eval()


def _run(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

GCN_KW = dict(ratio=0.25, decompose=True, node_attention=True,
              edge_attention=True, subset_wise=True)


@pytest.fixture(scope="module")
def gcn_case():
    """One DGPHGCN1 (16 -> 32 channels: down conv, mid 8) and its JAX
    variables, evaluated on both JAX paths."""
    g = JGraph(layout="nturgb+d", mode="random", num_filter=3, seed=0)
    x = np.random.default_rng(0).standard_normal((2, 12, 25, 16)).astype(
        np.float32)
    graph = dict(A_init=g.A.astype(np.float32), edge_type=g.edge_type,
                 node_type=np.array(g.node_type))
    dense = JDGPHGCN1(32, use_pallas=False, **graph, **GCN_KW)
    v = nudge(dense.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False),
              seed=1)
    want = {"dense": np.asarray(dense.apply(v, jnp.asarray(x), train=False))}
    for ek in ("bd", "fused"):
        m = JDGPHGCN1(32, use_pallas=True, pallas_interpret=True,
                      eval_kernel=ek, **graph, **GCN_KW)
        want[ek] = np.asarray(m.apply(v, jnp.asarray(x), train=False))
    return graph, v, x, want


@pytest.mark.parametrize("path", ["dense", "bd", "fused"])
def test_dgphgcn1_matches_jax(gcn_case, path):
    graph, v, x, want = gcn_case
    port = DGPHGCN1(16, 32, **graph, **GCN_KW, use_pallas=path != "dense",
                    eval_kernel="auto" if path == "dense" else path)
    np.testing.assert_allclose(_run(_load(port, v), x), want[path],
                               **MODULE_TOL)


@pytest.mark.parametrize("kw", [
    dict(ctr=None), dict(ada=None, ctr_act="sigmoid"),
    dict(ctr=None, ada=None), dict(stage=False, ada_act="relu")],
    ids=["no-ctr", "no-ada-sigmoid", "static", "no-stage-relu"])
def test_dgphgcn1_dense_options_match_jax(kw):
    """The dense path's other graph forms (the kernels take ctr=ada='T'
    with tanh/softmax only); 16 -> 16 channels, no down conv."""
    g = JGraph(layout="nturgb+d", mode="random", num_filter=3, seed=0)
    graph = dict(A_init=g.A.astype(np.float32), edge_type=g.edge_type,
                 node_type=np.array(g.node_type))
    x = np.random.default_rng(4).standard_normal((2, 6, 25, 16)).astype(
        np.float32)
    opts = dict(GCN_KW, **kw)
    ref = JDGPHGCN1(16, use_pallas=False, **graph, **opts)
    v = nudge(ref.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False),
              seed=5)
    want = np.asarray(ref.apply(v, jnp.asarray(x), train=False))
    port = _load(DGPHGCN1(16, 16, **graph, **opts, use_pallas=True), v)
    np.testing.assert_allclose(_run(port, x), want, **MODULE_TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_dgmstcn_matches_jax(stride):
    x = np.random.default_rng(stride).standard_normal(
        (2, 12, 25, 24)).astype(np.float32)
    ref = JDGMSTCN(24, stride=stride, eval_layout="concat")
    v = nudge(ref.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False),
              seed=stride)
    want = np.asarray(ref.apply(v, jnp.asarray(x), train=False))
    port = _load(DGMSTCN(24, 24, stride=stride), v)
    np.testing.assert_allclose(_run(port, x), want, **MODULE_TOL)


# ---------------------------------------------------------------------------
# the narrow recognizer
# ---------------------------------------------------------------------------

def _cfgs(use_pallas):
    j = j_model_cfg("dsgcn", num_classes=11)
    j["backbone"].update(NARROW, gcn_use_pallas=use_pallas)
    if use_pallas:
        j["backbone"]["gcn_pallas_interpret"] = True
    j["cls_head"]["in_channels"] = 64
    t = model_cfg("dsgcn", num_classes=11)
    t["backbone"].update(NARROW)
    t["cls_head"]["in_channels"] = 64
    return j, t


@pytest.fixture(scope="module")
def narrow():
    """JAX variables of the narrow DS-GCN (one init; the param tree is the
    same on both JAX paths) and the JAX logits of each path."""
    x = np.random.default_rng(7).standard_normal((2, 2, 16, 25, 3)).astype(
        np.float32)
    jcfg, tcfg = _cfgs(False)
    ref = j_build_model(jcfg)
    v = nudge(ref.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False),
              seed=3)
    want = {False: np.asarray(ref.apply(v, jnp.asarray(x), train=False)),
            True: np.asarray(j_build_model(_cfgs(True)[0]).apply(
                v, jnp.asarray(x), train=False))}
    return tcfg, v, x, want


@pytest.mark.parametrize("jax_pallas", [False, True])
@pytest.mark.parametrize("port_path", ["bd", "fused", "dense"])
def test_recognizer_matches_jax(narrow, jax_pallas, port_path):
    tcfg, v, x, want = narrow
    tcfg = dict(tcfg, backbone=dict(tcfg["backbone"]))
    if port_path == "dense":
        tcfg["backbone"]["gcn_use_pallas"] = False
    else:
        tcfg["backbone"]["gcn_eval_kernel"] = port_path
    port = _load(build_model(tcfg), v)
    np.testing.assert_allclose(_run(port, x), want[jax_pallas], **MODEL_TOL)


def test_init_recognizer_loads_checkpoint(narrow, tmp_path):
    tcfg, v, x, want = narrow
    path = tmp_path / "dsgcn.pt"
    torch.save(convert_jax_variables(v), path)
    port = init_recognizer(dict(model=tcfg), checkpoint=str(path),
                           device="cpu")
    assert not port.training
    np.testing.assert_allclose(_run(port, x), want[False], **MODEL_TOL)


def test_converter_is_strict_both_ways(narrow):
    tcfg, v, _, _ = narrow
    port = build_model(tcfg)
    sd = convert_jax_variables(v)
    port.load_state_dict(sd, strict=True)
    missing = dict(sd)
    missing.pop("backbone.block1.gcn.alpha")
    with pytest.raises(RuntimeError, match="Missing"):
        port.load_state_dict(missing, strict=True)
    extra = {"params": dict(v["params"]),
             "batch_stats": v["batch_stats"]}
    extra["params"]["stray"] = {"kernel": np.zeros((2, 3), np.float32)}
    with pytest.raises(RuntimeError, match="Unexpected"):
        port.load_state_dict(convert_jax_variables(extra), strict=True)
    dup = {"params": {"a": {"bn": {"scale": np.ones(2, np.float32)},
                            "weight": np.ones(2, np.float32)}}}
    with pytest.raises(ValueError, match="two JAX leaves"):
        convert_jax_variables(dup)


def test_inference_recognizer_matches_jax(narrow):
    """The API end to end on the CPU: the same annotation through both
    packages' test pipelines and models gives the same top-5."""
    tcfg, v, _, _ = narrow
    pipe = [dict(type="PreNormalize3D", align_spine=False),
            dict(type="GenSkeFeat", feats=["j"]),
            dict(type="UniformSample", clip_len=16, num_clips=2,
                 test_mode=True),
            dict(type="PoseDecode"), dict(type="FormatGCNInput"),
            dict(type="Collect", keys=["keypoint", "label"])]
    kp = np.random.default_rng(9).standard_normal((2, 40, 25, 3)).astype(
        np.float32)
    anno = dict(frame_dir="S0", label=2, keypoint=kp, total_frames=40)
    port = init_recognizer(dict(model=tcfg), device="cpu")
    port.load_state_dict(convert_jax_variables(v), strict=True)
    got = inference_recognizer(port, anno, test_pipeline=pipe)
    state = types.SimpleNamespace(params=v["params"],
                                  batch_stats=v["batch_stats"])
    want = j_inference(j_build_model(_cfgs(False)[0]), state, anno,
                       test_pipeline=pipe)
    assert [label for label, _ in got] == [label for label, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               **MODEL_TOL)


def test_bf16_inference_keeps_top1(narrow):
    tcfg, v, x, _ = narrow
    port = _load(build_model(tcfg), v)
    bf16 = to_bf16_inference(port)
    assert bf16.backbone.block0.gcn.pre_conv.weight.dtype == torch.bfloat16
    assert bf16.backbone.block0.gcn.bn.running_var.dtype == torch.float32
    assert port.backbone.block0.gcn.pre_conv.weight.dtype == torch.float32
    logits16 = _run(bf16, x)
    assert logits16.dtype == np.float32
    np.testing.assert_array_equal(logits16.argmax(-1),
                                  _run(port, x).argmax(-1))


# ---------------------------------------------------------------------------
# standalone and on the card unless asked otherwise
# ---------------------------------------------------------------------------

def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "dsgcn_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        bad = set(_imported_roots(f)) & {"jax", "jaxlib", "flax",
                                         "dsgcn_tpu"}
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


def test_init_recognizer_needs_cuda_unless_cpu_asked():
    cfg = dict(model=_cfgs(False)[1])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_recognizer(cfg)
    assert next(init_recognizer(cfg, device="cpu").parameters()).device \
        == torch.device("cpu")


def test_train_mode_raises():
    """Training runs (K1+K2 on the kernel path) and raises where the JAX
    package does: the joint-padded mode (v_real) has no backward
    (``dsgcn_tpu/ops/pallas/dyn_graph.py:634``)."""
    from dsgcn_tpu_torch.ops.kernels.dyn_graph import fused_dyn_graph_agg
    model = build_model(_cfgs(False)[1]).train()
    model(torch.zeros(1, 2, 8, 25, 3)).sum().backward()
    assert model.backbone.block0.gcn.alpha.grad is not None
    K, Cm, V = 3, 4, 25
    x1 = torch.zeros(1, K, Cm, V, requires_grad=True)
    with pytest.raises(NotImplementedError, match="eval-only"):
        fused_dyn_graph_agg(torch.zeros(1, 2, V, K * Cm), x1, x1,
                            torch.zeros(K, V, V), torch.zeros(K),
                            torch.zeros(K), K=K, Cm=Cm, v_real=20)


def test_graph_a_is_per_block():
    """Each block owns its adjacency (loading one must not write another)."""
    model = build_model(_cfgs(False)[1])
    a0, a1 = model.backbone.block0.gcn.A, model.backbone.block1.gcn.A
    assert a0.data_ptr() != a1.data_ptr()
    np.testing.assert_array_equal(
        a0.detach().numpy(),
        Graph(layout="nturgb+d", mode="random", num_filter=3, seed=0).A
        .astype(np.float32))
