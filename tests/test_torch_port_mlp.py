"""Port parity, the author's temporal MLPs and DGHGCN: ``UnitMLP``,
``MSTCN(branch_kind='mlp')`` (msmlp), ``GCMLP``,
``DGMSTCN(branch_kind='mlp')`` (dgmsmlp) and ``DGHGCN`` of
``dsgcn_tpu_torch`` against ``dsgcn_tpu`` on the CPU, in eval and train;
float64 train steps of a DGSTGCN (dghgcn + dgmsmlp) and an AAGCN
(unit_aahgcn + unitmlp); a CTRGCN asked for msmlp builds CTR-GCN's MSTCN,
as JAX's does; the pyskl import of every new
unit against JAX's importer; and msmlp/dgmsmlp with ``use_pallas``, which
run the module path as JAX's dispatch says.

None of these units reaches a Pallas kernel in JAX, and none launches a
kernel of the port.  Variables are drawn with ``jax.eval_shape`` + numpy
(``test_torch_port_dggcn._variables``) and load with ``strict=True``;
inputs are numpy from a seed.  Tolerances: eval at 1e-5 (``MODULE_TOL``),
train (outputs, statistics, input and parameter gradients) at 2e-4 of the
largest (``MODULE_RTOL``) or, in float64, at 1e-8; the float64 steps at
1e-8 (loss) and 1e-6 (updated state).  JAX's ``build_backbone`` passes
``gcn_use_pallas`` to every DGSTGCN unit and its DGHGCN has no such field,
so the JAX DGSTGCNs with dghgcn are built as modules (``_j_model``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu.graph import GraphConfig as JGraphConfig
from dsgcn_tpu.models.backbones import DGSTGCN as JDGSTGCN
from dsgcn_tpu.models.builder import _BACKBONE_FIELDS as J_FIELDS
from dsgcn_tpu.models.builder import build_head as j_build_head
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu.models.recognizer import RecognizerGCN as JRecognizerGCN
from dsgcn_tpu.ops import gcn as jgcn
from dsgcn_tpu.ops import tcn as jtcn
from dsgcn_tpu.utils.torch_import import import_state_dict as j_import
from dsgcn_tpu_torch.models.builder import build_model, model_cfg
from dsgcn_tpu_torch.ops import gcn, tcn
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.ops.tcn import CTRMSTCN
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from dsgcn_tpu_torch.utils.torch_import import (import_state_dict,
                                                to_pyskl_state_dict)
from flax.core import FrozenDict
from test_torch_port_dggcn import _variables
from test_torch_port_families import _eval, _train_parity_f64, _x
from test_torch_port_grad import _train_parity, assert_rel
from test_torch_port_model import MODULE_TOL, _load, _run
from test_torch_port_train import _run_both
from torch_port_cases import seeded_state_dict

N, T = 4, 12


def _parity(jmod, port, x, seed, train="f32"):
    """Eval output at MODULE_TOL; with ``train`` one train-mode forward and
    backward, in float32 at MODULE_RTOL or ('f64') in float64 at 1e-8 (JAX
    jitted)."""
    v = dict(_variables(jmod, x, seed))
    v.setdefault("batch_stats", {})
    want = _eval(jmod, v, x)
    before = launch_counts()
    np.testing.assert_allclose(_run(_load(port, v), x), want, **MODULE_TOL)
    assert launch_counts() == before
    if train == "f64":
        _train_parity_f64(jmod, port, v, x, seed + 1)
    elif train:
        _train_parity(jmod, port, v, x, want.shape, seed + 1, jit=True)


# ---------------------------------------------------------------------------
# the temporal MLPs
# ---------------------------------------------------------------------------

UNITMLP = {
    "k9": (16, dict(kernel_size=9)),
    "k5_stride2_dil3_no_bn": (16, dict(kernel_size=5, stride=2, dilation=3,
                                       norm=None)),
    "channel_annention": (32, dict(kernel_size=9, channel_annention=True)),
    "add_tcn": (16, dict(kernel_size=9, add_tcn=True)),
    "add_tcn_merge_after_fixed": (16, dict(kernel_size=5, add_tcn=True,
                                           merge_after=True, adaptive=False,
                                           stride=2)),
}


@pytest.mark.parametrize("case", sorted(UNITMLP))
def test_unitmlp_matches_jax(case):
    """Every option of the unit, train in float64 (the depthwise bias
    feeds a train-mode BatchNorm through a 1x1: its gradient is zero, and
    float32 leaves only rounding noise); the depthwise taps load from JAX's
    (taps, 1, 1, C) ``conv_kernel`` as a (C, 1, taps, 1) grouped conv."""
    c, kw = UNITMLP[case]
    port = tcn.UnitMLP(c, c, **kw)
    assert port.conv.weight.shape == (c, 1, (kw["kernel_size"] + 1) // 2, 1)
    _parity(jtcn.UnitMLP(c, **kw), port, _x(30, N, 24, 25, c), seed=31,
            train="f64")


def test_unitmlp_refusals_follow_jax():
    with pytest.raises(ValueError, match="in == out"):
        tcn.UnitMLP(16, 24)
    m = tcn.UnitMLP(32, 32, channel_annention=True).eval()
    with pytest.raises(ValueError, match="group 8"), torch.no_grad():
        m(torch.zeros(1, 12, 25, 32))


MS = {
    "msmlp_stride2": (lambda: jtcn.MSTCN(24, stride=2, branch_kind="mlp"),
                      lambda: tcn.MSTCN(16, 24, stride=2, branch_kind="mlp"),
                      16),
    "gcmlp_add_tcn": (lambda: jtcn.GCMLP(24, add_tcn=True, dropout=0.0),
                      lambda: tcn.GCMLP(24, 24, add_tcn=True), 24),
    "dgmsmlp": (lambda: jtcn.DGMSTCN(24, branch_kind="mlp"),
                lambda: tcn.DGMSTCN(24, 24, branch_kind="mlp"), 24),
}


@pytest.mark.parametrize("case", sorted(MS))
def test_multi_branch_mlps_match_jax(case):
    """msmlp, gcmlp (the add_tcn passthrough) and dgmsmlp, eval, and train
    in float64 (each branch's conv1 bias feeds a train-mode BatchNorm: a
    zero gradient, rounding noise in float32); dgmsmlp trains with the
    appended mean joint in its branch BNs."""
    jmake, pmake, cin = MS[case]
    port = pmake()
    assert port.branches.branch_kind == "mlp"
    _parity(jmake(), port, _x(32, N, T, 25, cin), seed=33, train="f64")


def test_mlp_branches_take_no_k7(monkeypatch):
    """msmlp and dgmsmlp with ``use_pallas`` run the module path in eval
    (JAX: K7 for branch_kind 'tcn' only), equal to use_pallas=False."""
    def refuse(*a, **k):
        raise AssertionError("K7 called for mlp branches")
    x = torch.from_numpy(_x(34, 2, 8, 25, 24))
    for cls in (tcn.MSTCN, tcn.DGMSTCN):
        ref = cls(24, 24, branch_kind="mlp").eval()
        fused = cls(24, 24, branch_kind="mlp", use_pallas=True).eval()
        fused.load_state_dict(ref.state_dict())
        with torch.no_grad():
            want = ref(x)
            monkeypatch.setattr(tcn, "fused_ms_eval", refuse)
            got = fused(x)
            monkeypatch.undo()
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="branch_kind"):
        tcn.MSTCN(24, 24, branch_kind="conv")


# ---------------------------------------------------------------------------
# DGHGCN
# ---------------------------------------------------------------------------

DGHGCN = {
    "default_down": (16, dict(), False),
    "node_edge_add_type_subset_wise": (
        32, dict(node_attention=True, edge_attention=True, add_type=True,
                 subset_wise=True), True),
    "ada_att_target_specific_acts": (
        32, dict(ada_attention=True, target_specific=True,
                 node_attention=True, ctr_act="relu", ada_act="sigmoid"),
        True),
    "ctr_NA": (32, dict(ctr="NA", node_attention=True), True),
    "ada_NA_no_ctr": (32, dict(ctr=None, ada="NA"), False),
    "ctr_edge_no_ada": (32, dict(ada=None, edge_attention=True), False),
    "static": (32, dict(ctr=None, ada=None), False),
}


def _graph3():
    g = JGraph(layout="nturgb+d", mode="random", num_filter=3, seed=6)
    return dict(A_init=g.A.astype(np.float32), edge_type=g.edge_type,
                node_type=np.array(g.node_type))


@pytest.mark.parametrize("case", sorted(DGHGCN))
def test_dghgcn_matches_jax(case):
    """Each option group 16|32 -> 32 channels (mid 8, K = 3), eval; the
    attention groups and the per-frame graphs also train."""
    cin, kw, train = DGHGCN[case]
    graph = _graph3()
    port = gcn.DGHGCN(cin, 32, **graph, **kw)
    _parity(jgcn.DGHGCN(32, **graph, **kw), port, _x(35, N, T, 25, cin),
            seed=36, train=train)


def test_dghgcn_refusals_follow_jax():
    """Edge and ada attention need T-pooled graphs (JAX asserts Tq = 1); a
    joint-partitioned or joint-padded DGSTGCN refuses dghgcn."""
    graph = _graph3()
    for kw in (dict(ctr="NA", edge_attention=True),
               dict(ada="NA", ada_attention=True)):
        with pytest.raises(ValueError, match="T-pooled"):
            gcn.DGHGCN(16, 32, **graph, **kw)
    cfg = _dg_cfgs()[1]
    cfg["backbone"]["graph_axis"] = "graph"
    with pytest.raises(ValueError, match="dghgcn"):
        build_model(cfg)
    model = build_model(_dg_cfgs()[1])
    with pytest.raises(ValueError, match="joint_pad"):
        model.backbone.set_joint_pad(32)


# ---------------------------------------------------------------------------
# backbones: float64 steps
# ---------------------------------------------------------------------------

DG_BB = dict(num_stages=1, base_channels=16, gcn_type="dghgcn",
             gcn_node_attention=True, gcn_edge_attention=True,
             gcn_subset_wise=True, tcn_type="dgmsmlp")


def _j_model(cfg):
    """JAX's RecognizerGCN over a DGSTGCN built as a module (see the
    docstring)."""
    bb = dict(cfg["backbone"])
    bb.pop("type")
    gc = JGraphConfig(**bb.pop("graph_cfg"))
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in bb.items() if k in J_FIELDS}
    args = FrozenDict({k: v for k, v in bb.items() if k not in J_FIELDS})
    return JRecognizerGCN(backbone=JDGSTGCN(graph_cfg=gc, block_args=args,
                                            **fields),
                          head=j_build_head(cfg["cls_head"]))


def _dg_cfgs():
    j, t = (f("dgstgcn", num_classes=5) for f in (j_model_cfg, model_cfg))
    for c in (j, t):
        c["backbone"].update(DG_BB)
        c["cls_head"]["in_channels"] = 16
    return j, t


def _family_cfgs(family, **bb):
    j, t = (f(family, num_classes=5) for f in (j_model_cfg, model_cfg))
    for c in (j, t):
        c["backbone"].update(num_stages=1, base_channels=16, **bb)
        c["cls_head"]["in_channels"] = 16
    return j, t


STEPS = {
    "dgstgcn_dghgcn_dgmsmlp": lambda: (_j_model(_dg_cfgs()[0]),
                                       _dg_cfgs()[1]),
    "aagcn_aahgcn_unitmlp": lambda: (lambda j, t: (j_build_model(j), t))(
        *_family_cfgs("aagcn", gcn_type="unit_aahgcn", tcn_type="unitmlp",
                      tcn_add_tcn=True, gcn_node_att=True)),
}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_float64_matches_jax(case, monkeypatch):
    """One float64 SGD step of a one-block recognizer through both
    packages' train_step: loss to 1e-8, parameters and BatchNorm
    statistics to 1e-6."""
    jmodel, tcfg = STEPS[case]()
    x = _x(37, 2, 2, 8, 25, 3)
    v = _variables(jmodel, x, seed=38)
    rng = np.random.default_rng(40)
    batch = dict(keypoint=rng.standard_normal((2, 2, 8, 25, 3)),
                 label=rng.integers(0, 5, 2))
    import test_torch_port_train as tt
    monkeypatch.setattr(tt, "j_build_model", lambda cfg: jmodel)
    jax.config.update("jax_enable_x64", True)
    try:
        (jl, want), (tl, port) = _run_both(None, tcfg, v, [batch],
                                           jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(tl, jl, rtol=1e-8)
    state = port.state_dict()
    for name, w in want.items():
        assert_rel(state[name].numpy(), w.numpy(), 1e-6, name)


def test_dghgcn_dgmsmlp_recognizer_matches_jax():
    """The narrow DGSTGCN recognizer's eval logits (dghgcn + dgmsmlp) within
    1e-5; launches no kernel."""
    jcfg, tcfg = _dg_cfgs()
    jmodel = _j_model(jcfg)
    x = _x(41, 2, 2, T, 25, 3)
    v = _variables(jmodel, x, seed=42)
    port = _load(build_model(tcfg), v)
    assert isinstance(port.backbone.block0.gcn, gcn.DGHGCN)
    before = launch_counts()
    np.testing.assert_allclose(_run(port, x), _eval(jmodel, v, x),
                               rtol=1e-5, atol=1e-5)
    assert launch_counts() == before


def test_ctrgcn_takes_no_tcn_type_as_jax():
    """CTRGCN pops tcn_type and builds CTR-GCN's MSTCN in every block, as
    JAX does (the reference's msmlp form of CTRGCN_model.py is not JAX's):
    JAX's variables of the msmlp config load strictly."""
    jcfg, tcfg = _family_cfgs("ctrgcn", gcn_type="unit_ctrhgcn",
                              tcn_type="msmlp", gcn_edge_attention=True)
    port = build_model(tcfg)
    assert isinstance(port.backbone.block0.tcn, CTRMSTCN)
    _load(port, _variables(j_build_model(jcfg), _x(45, 1, 2, 8, 25, 3),
                           seed=46))


# ---------------------------------------------------------------------------
# the pyskl import
# ---------------------------------------------------------------------------

IMPORTS = {
    "dgstgcn_dghgcn_dgmsmlp": lambda: _dg_cfgs()[1],
    "dghgcn_target_ada_msmlp": lambda: (lambda t: (t["backbone"].update(
        gcn_target_specific=True, gcn_ada_attention=True,
        tcn_type="msmlp"), t)[1])(_dg_cfgs()[1]),
    "aagcn_aahgcn_unitmlp": lambda: _family_cfgs(
        "aagcn", gcn_type="unit_aahgcn", tcn_type="unitmlp",
        tcn_add_tcn=True)[1],
    "stgcn_unitmlp_msmlp": lambda: (lambda t: (t["backbone"].update(
        num_stages=3, tcn_type=("unitmlp", "msmlp", "unit_tcn")), t)[1])(
            _family_cfgs("stgcn")[1]),
}


@pytest.mark.parametrize("case", sorted(IMPORTS))
def test_pyskl_import_matches_jax_importer(case):
    """A pyskl-named state dict of each model (``to_pyskl_state_dict`` of a
    seeded one) imports through the port as through JAX's importer
    (converted), array for array, gives back the seeded state dict, and
    loads strictly; a unitmlp's depthwise conv is pyskl's (C, 1, k)
    Conv1d."""
    model = build_model(IMPORTS[case]())
    sd = seeded_state_dict(model, seed=44)
    pyskl = to_pyskl_state_dict(sd)
    got = import_state_dict(pyskl)
    want = convert_jax_variables(j_import(pyskl))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], sd[k]), k
    model.load_state_dict(got, strict=True)
    mlp_convs = [k for k in pyskl if k.endswith(".conv.weight")
                 and pyskl[k].ndim == 3]
    assert mlp_convs and all(pyskl[k].shape[1] == 1 for k in mlp_convs)
