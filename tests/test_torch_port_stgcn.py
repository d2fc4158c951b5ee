"""Port parity, STGCN++: the kernel K7 (fused_dgmstcn_eval), the MSTCN and
DGMSTCN modules with and without it, UnitGCN, a narrow STGCN++
recognizer, a float64 STGCN++ train step, ``model_cfg('stgcn' |
'stgcn++')``, the STGCN++ j config's test pipeline and ``RepeatDataset``
of ``dsgcn_tpu_torch`` against ``dsgcn_tpu`` on the CPU; and the port's CLI
on that config.

On the CPU the K7 wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode, on the same per-branch weights
packed by JAX's ``pack_branches``.  Inputs and variables are numpy from a
seed.  Tolerances: K7 in float32 within 1e-5 of the largest output (the
same sums in another order); eval modules at 1e-5 (``MODULE_TOL``), train
modules at ``MODULE_RTOL`` (2e-4, see ``test_torch_port_grad.py``), model
logits at 1e-4 (``MODEL_TOL``), the float64 train step at 1e-8.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.configs.config import Config as JConfig
from dsgcn_tpu.data import dataset as JD
from dsgcn_tpu.data import transforms as JT
from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu.ops.gcn import UnitGCN as JUnitGCN
from dsgcn_tpu.ops.pallas.ms_tcn import fused_dgmstcn_eval as j_k7
from dsgcn_tpu.ops.pallas.ms_tcn import pack_branches
from dsgcn_tpu.ops.tcn import DGMSTCN as JDGMSTCN
from dsgcn_tpu.ops.tcn import MSTCN as JMSTCN
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.data import dataset as D
from dsgcn_tpu_torch.data import transforms as T
from dsgcn_tpu_torch.models.builder import build_model, model_cfg
from dsgcn_tpu_torch.ops.gcn import UnitGCN
from dsgcn_tpu_torch.ops.kernels.ms_tcn import (fused_dgmstcn_eval,
                                                tile_plan)
from dsgcn_tpu_torch.ops import tcn as tcn_mod
from dsgcn_tpu_torch.ops.tcn import DGMSTCN, MSTCN
from dsgcn_tpu_torch.tools import train as cli
from test_torch_port_dggcn import _close, _variables
from test_torch_port_grad import _train_parity, assert_rel
from test_torch_port_model import MODEL_TOL, MODULE_TOL, _load, _run
from test_torch_port_train import _run_both
from torch_port_cases import one_thread  # noqa: F401

CONFIG = str(pathlib.Path(__file__).resolve().parents[1] / "configs"
             / "stgcnpp" / "ntu60_xsub_3dkp" / "j.py")


def _spatial_graph():
    return JGraph(layout="nturgb+d", mode="spatial").A.astype(np.float32)


# ---------------------------------------------------------------------------
# K7
# ---------------------------------------------------------------------------

def _k7_inputs(seed, C=64, T=6, V=25):
    """Folded K7 weights of a C -> C region (mid = C // 6, rem = C - 5 mid)
    and an input, as numpy."""
    rng = np.random.default_rng(seed)
    mid = C // 6
    rem = C - 5 * mid
    f = lambda *s: (rng.standard_normal(s) / np.sqrt(s[-2] if len(s) > 1  # noqa
                                                     else 10)).astype(
        np.float32)
    d = dict(x=rng.standard_normal((2, T, V, C)).astype(np.float32),
             w_pre=f(C, rem + 4 * mid), b_pre=f(rem + 4 * mid),
             taps_w=[f(3, cb, cb) for cb in (rem, mid, mid, mid)],
             taps_b=[f(cb) for cb in (rem, mid, mid, mid)],
             w11=f(C, mid), b11=f(mid),
             a_tr=rng.uniform(0.5, 1.5, C).astype(np.float32), b_tr=f(C),
             w_tc=f(C, C), b_tc=f(C),
             a_out=rng.uniform(0.5, 1.5, C).astype(np.float32), b_out=f(C),
             coeff=rng.uniform(-0.5, 0.5, V).astype(np.float32))
    return d, rem, mid


K7_NAMES = ("w_pre", "b_pre", "taps_w", "taps_b", "w11", "b11", "a_tr",
            "b_tr", "w_tc", "b_tc", "a_out", "b_out")


@pytest.mark.parametrize("coeff,stride,T", [
    (True, 1, 3), (False, 1, 6), (True, 2, 9), (False, 2, 9)],
    ids=["coeff-s1-T3", "plain-s1-T6", "coeff-s2-T9", "plain-s2-T9"])
def test_k7_plain_matches_jax_interpret(coeff, stride, T):
    """C = 64 (rem 14, mid 10); T = 3 is shorter than the halo (pad 4), T =
    9 with stride 2 leaves a ragged last frame."""
    d, rem, mid = _k7_inputs(50 + T + stride, T=T)
    Cp = rem + 5 * mid
    c = d["coeff"] if coeff else None
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    before = fused_dgmstcn_eval.launches
    got = fused_dgmstcn_eval(
        t(d["x"]), t(d["w_pre"]), t(d["b_pre"]), [t(w) for w in d["taps_w"]],
        [t(b) for b in d["taps_b"]],
        *(t(d[k]) for k in K7_NAMES[4:]), None if c is None else t(c),
        stride=stride)
    assert fused_dgmstcn_eval.launches == before       # CPU: plain version
    assert got.shape == (2, -(-T // stride), 25, Cp)
    slots = (0, rem, rem + mid, rem + 2 * mid)
    shifts, ws, wmax, w11e, bias_all, pad = pack_branches(
        [jnp.asarray(w) for w in d["taps_w"]],
        [jnp.asarray(b) for b in d["taps_b"]], (rem + 3 * mid, mid,
                                                rem + 3 * mid),
        jnp.asarray(d["w11"]), jnp.asarray(d["b11"]), (1, 2, 3, 4), slots,
        slots, rem + 4 * mid, Cp)
    want = j_k7(jnp.asarray(d["x"]), jnp.asarray(d["w_pre"]),
                jnp.asarray(d["b_pre"]), shifts, ws, wmax, w11e, bias_all,
                *(jnp.asarray(d[k]) for k in K7_NAMES[6:]),
                None if c is None else jnp.asarray(c), pad=pad,
                stride=stride, interpret=True)
    _close(got.numpy(), want)


def test_k7_tile_plan_fits_the_block():
    """The wrapper's tiling at STGCN++'s serving shapes (N = 128): each
    block's shared memory under the H100's 227 KB, the joints' blocks in f32 and bf16 and, with coeff, the pseudo-joint's blocks (one
    row a frame)."""
    from dsgcn_tpu_torch.ops.kernels.ms_tcn import tile_smem
    for C, T, s in ((64, 100, 1), (128, 100, 2), (128, 50, 1), (256, 50, 2),
                    (256, 25, 1), (16, 3, 1)):
        mid = C // 6
        rem = C - 5 * mid
        for g in (False, True):
            for xsize in (4, 2):
                TO, JR = tile_plan(128, T, 25, C, rem, mid, s, 4, xsize,
                                   mean=g)
                assert 1 <= TO <= -(-T // s) and 1 <= JR <= (1 if g else 25)
                assert 0 < tile_smem(T, C, rem, mid, s, 4, TO, JR,
                                     4 if g else xsize) <= 232448


# ---------------------------------------------------------------------------
# MSTCN and DGMSTCN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,stride", [("mstcn", 1), ("mstcn", 2),
                                         ("dgmstcn", 1), ("dgmstcn", 2)])
def test_ms_tcn_k7_eval_matches_jax(kind, stride):
    """MSTCN / DGMSTCN (32 -> 32 channels: rem 7, mid 5) in eval with
    use_pallas=True: the port's K7 path against JAX's (interpret mode),
    and the port's module path against both."""
    x = np.random.default_rng(60 + stride).standard_normal(
        (2, 8, 25, 32)).astype(np.float32)
    jcls, pcls = (JMSTCN, MSTCN) if kind == "mstcn" else (JDGMSTCN, DGMSTCN)
    jmod = jcls(32, stride=stride, use_pallas=True, pallas_interpret=True)
    v = _variables(jmod, x, seed=61 + stride)
    want = np.asarray(jmod.apply(v, jnp.asarray(x), train=False))
    port = _load(pcls(32, 32, stride=stride, use_pallas=True), v)
    before = fused_dgmstcn_eval.launches
    np.testing.assert_allclose(_run(port, x), want, **MODULE_TOL)
    assert fused_dgmstcn_eval.launches == before
    module = _load(pcls(32, 32, stride=stride), v)
    np.testing.assert_allclose(_run(module, x), want, **MODULE_TOL)


@pytest.mark.parametrize("kind", ["mstcn", "dgmstcn"])
def test_ms_tcn_train_matches_jax(kind):
    """Training takes the module path with use_pallas=True, as JAX does:
    outputs, statistics and gradients against JAX's train mode."""
    x = np.random.default_rng(62).standard_normal((2, 8, 25, 24)).astype(
        np.float32)
    jcls, pcls = (JMSTCN, MSTCN) if kind == "mstcn" else (JDGMSTCN, DGMSTCN)
    jmod = jcls(24, stride=2, use_pallas=True, pallas_interpret=True)
    v = _variables(jmod, x, seed=63)
    _train_parity(jmod, pcls(24, 24, stride=2, use_pallas=True), v, x,
                  (2, 4, 25, 24), seed=64)


def test_ms_tcn_k7_condition_follows_jax():
    """K7 only in eval, for DEFAULT_MS_CFG at the default widths and conv
    branches; the mlp branches (msmlp) run the module path."""
    x = torch.randn(1, 4, 25, 12)
    before = fused_dgmstcn_eval.launches
    for m in (MSTCN(12, 12, use_pallas=True, mid_channels=0.25),
              MSTCN(12, 12, use_pallas=True, ms_cfg=((3, 1), ("max", 3),
                                                     "1x1"))):
        with torch.no_grad():
            y = m.eval()(x)
        assert y.shape == (1, 4, 25, 12)
    assert fused_dgmstcn_eval.launches == before
    m = MSTCN(12, 12, branch_kind="mlp", use_pallas=True).eval()
    assert not tcn_mod._k7_applies(m)
    with torch.no_grad():
        assert m(x).shape == (1, 4, 25, 12)
    assert fused_dgmstcn_eval.launches == before


def test_ms_tcn_dropout_in_train_only():
    x = torch.randn(2, 8, 25, 24)
    m = MSTCN(24, 24, dropout=0.5, use_pallas=True)
    m.generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        y_eval = m.eval()(x)
        a = m.train()(x)
    zero = (a == 0).float().mean().item()
    assert 0.4 < zero < 0.6
    assert (y_eval != 0).float().mean().item() > 0.99


# ---------------------------------------------------------------------------
# UnitGCN
# ---------------------------------------------------------------------------

# (adaptive, conv_pos, with_res, in channels): 16 -> 24 with res takes the
# down path, 24 -> 24 the identity
GCN_EVAL = [(None, "pre", False, 16), ("init", "pre", True, 16),
            ("offset", "post", True, 16), ("importance", "post", False, 16),
            ("init", "post", True, 24), ("offset", "pre", False, 16),
            ("importance", "pre", True, 24), (None, "post", True, 16)]
GCN_TRAIN = [("init", "pre", True, 16), ("offset", "post", False, 16),
             ("importance", "pre", True, 24), (None, "post", True, 16)]


def _gcn_ids(cases):
    return [f"{a}-{p}-{'res' if r else 'nores'}-{c}" for a, p, r, c in cases]


@pytest.mark.parametrize("adaptive,conv_pos,with_res,cin", GCN_EVAL,
                         ids=_gcn_ids(GCN_EVAL))
def test_unit_gcn_eval_matches_jax(adaptive, conv_pos, with_res, cin):
    x = np.random.default_rng(70).standard_normal((2, 4, 25, cin)).astype(
        np.float32)
    kw = dict(adaptive=adaptive, conv_pos=conv_pos, with_res=with_res)
    ref = JUnitGCN(24, A_init=_spatial_graph(), **kw)
    v = _variables(ref, x, seed=71)
    want = np.asarray(ref.apply(v, jnp.asarray(x), train=False))
    port = _load(UnitGCN(cin, 24, A_init=_spatial_graph(), **kw), v)
    np.testing.assert_allclose(_run(port, x), want, **MODULE_TOL)


@pytest.mark.parametrize("adaptive,conv_pos,with_res,cin", GCN_TRAIN,
                         ids=_gcn_ids(GCN_TRAIN))
def test_unit_gcn_train_matches_jax(adaptive, conv_pos, with_res, cin):
    x = np.random.default_rng(72).standard_normal((2, 4, 25, cin)).astype(
        np.float32)
    kw = dict(adaptive=adaptive, conv_pos=conv_pos, with_res=with_res)
    jmod = JUnitGCN(24, A_init=_spatial_graph(), **kw)
    v = _variables(jmod, x, seed=73)
    _train_parity(jmod, UnitGCN(cin, 24, A_init=_spatial_graph(), **kw), v,
                  x, (2, 4, 25, 24), seed=74)


def test_unit_gcn_graph_is_per_block():
    """'init' copies A into each block; the other forms keep it out of the
    state, as JAX keeps it out of its variables."""
    A = _spatial_graph()
    a, b = UnitGCN(3, 8, A_init=A), UnitGCN(8, 8, A_init=A)
    assert a.A.data_ptr() != b.A.data_ptr()
    assert "A" in a.state_dict()
    assert set(UnitGCN(3, 8, A_init=A, adaptive="offset").state_dict()) \
        >= {"PA"} and "A" not in UnitGCN(3, 8, A_init=A,
                                          adaptive=None).state_dict()


# ---------------------------------------------------------------------------
# the narrow recognizer, one float64 train step, the config
# ---------------------------------------------------------------------------

# four blocks: the stem (3 -> 16), 16 -> 16, 16 -> 32 at stride 2, 32 -> 32
NARROW = dict(num_stages=4, base_channels=16, inflate_stages=(3,),
              down_stages=(3,))


def _cfgs(tcn_use_pallas=False):
    j = j_model_cfg("stgcn++", num_classes=11)
    j["backbone"].update(NARROW)
    if tcn_use_pallas:
        j["backbone"].update(tcn_use_pallas=True, tcn_pallas_interpret=True)
    j["cls_head"]["in_channels"] = 32
    t = model_cfg("stgcn++", num_classes=11)
    t["backbone"].update(NARROW, tcn_use_pallas=tcn_use_pallas)
    t["cls_head"]["in_channels"] = 32
    return j, t


@pytest.fixture(scope="module")
def narrow_stgcnpp():
    x = np.random.default_rng(80).standard_normal((2, 2, 8, 25, 3)).astype(
        np.float32)
    jcfg, _ = _cfgs()
    v = _variables(j_build_model(jcfg), x, seed=81)
    return v, x


@pytest.mark.parametrize("k7", [False, True], ids=["module", "k7"])
def test_stgcnpp_recognizer_matches_jax(narrow_stgcnpp, k7):
    """Eval logits of a narrow STGCN++ (four blocks, widths 16/32): the
    port's K7 path (four K7 calls) against JAX's K7 path in interpret mode,
    the module path against JAX's module path."""
    v, x = narrow_stgcnpp
    jcfg, tcfg = _cfgs(k7)
    want = np.asarray(j_build_model(jcfg).apply(v, jnp.asarray(x),
                                                train=False))
    port = _load(build_model(tcfg), v)
    assert type(port.backbone.block3.tcn).__name__ == "MSTCN"
    assert port.backbone.block3.tcn.use_pallas == k7
    np.testing.assert_allclose(_run(port, x), want, **MODEL_TOL)


def test_stgcnpp_train_float64_matches_jax(narrow_stgcnpp):
    """One float64 step of the narrow STGCN++ through both packages'
    train_step: loss, parameters and BatchNorm statistics to 1e-8
    relative."""
    v, _ = narrow_stgcnpp
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(82)
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


@pytest.mark.parametrize("name", ["stgcn", "stgcn++"])
@pytest.mark.parametrize("use_pallas", [None, True])
def test_model_cfg_stgcn_matches_jax_and_builds(name, use_pallas):
    """The configs equal JAX's (use_pallas touches DGSTGCN only), and the
    full-width model builds without the DGSTGCN-only gcn_use_pallas."""
    cfg = model_cfg(name, num_classes=120, use_pallas=use_pallas)
    assert cfg == j_model_cfg(name, num_classes=120, use_pallas=use_pallas)
    model = build_model(cfg)
    assert model.backbone.num_blocks == 10
    tcn = type(model.backbone.block9.tcn).__name__
    assert tcn == ("MSTCN" if name == "stgcn++" else "UnitTCN")


@pytest.mark.parametrize("tcn_type", ["unit_tcn", "mstcn", "dgmstcn",
                                      "msmlp"])
def test_dgblock_takes_every_ported_tcn_type(tcn_type):
    """DGBlock builds its temporal unit through _make_tcn, as JAX's does;
    msmlp is an MSTCN with mlp branches."""
    cfg = model_cfg("dgstgcn", num_classes=5)
    cfg["backbone"].update(num_stages=2, base_channels=16, tcn_type=tcn_type)
    cfg["cls_head"]["in_channels"] = 16
    model = build_model(cfg).eval()
    want = {"unit_tcn": "UnitTCN", "mstcn": "MSTCN", "dgmstcn": "DGMSTCN",
            "msmlp": "MSTCN"}
    assert type(model.backbone.block1.tcn).__name__ == want[tcn_type]
    if tcn_type == "msmlp":
        assert model.backbone.block1.tcn.branches.branch_kind == "mlp"
    with torch.no_grad():
        assert model(torch.zeros(1, 2, 8, 25, 3)).shape == (1, 5)


def test_stgcnpp_config_and_test_pipeline_match_jax():
    """The STGCN++ j config, and one NTU-shaped annotation through its
    10-clip test pipeline (tolerance 1e-5: the JAX pipeline may
    pre-normalize in its native C++ op)."""
    assert dict(Config.fromfile(CONFIG)) == dict(JConfig.fromfile(CONFIG))
    pipe = Config.fromfile(CONFIG)["data"]["test"]["pipeline"]
    rng = np.random.default_rng(83)
    kp = rng.standard_normal((2, 120, 25, 3)).astype(np.float32)
    kp[1, 70:] = 0
    anno = dict(frame_dir="S0", label=3, keypoint=kp, total_frames=120)
    ours = T.build_pipeline(pipe)(dict(anno))
    ref = JT.build_pipeline(pipe)(dict(anno))
    assert ours["keypoint"].shape == (10, 2, 100, 25, 3)
    np.testing.assert_allclose(ours["keypoint"], ref["keypoint"], rtol=1e-5,
                               atol=1e-5)


def test_repeat_dataset_matches_jax(tmp_path):
    path = str(tmp_path / "synth.pkl")
    D.make_synthetic_pose_dataset(num_samples=8, num_classes=5, t=30, seed=4,
                                  path=path)
    pipe = Config.fromfile(CONFIG)["data"]["train"]["dataset"]["pipeline"]
    ours = D.build_dataset(dict(type="RepeatDataset", times=3, dataset=dict(
        type="PoseDataset", ann_file=path, pipeline=pipe, split="train")))
    ref = JD.RepeatDataset(JD.PoseDataset(path, pipe, split="train"), 3)
    assert isinstance(ours, D.RepeatDataset)
    assert len(ours) == len(ref) == 18
    np.testing.assert_array_equal(ours.labels, ref.labels)
    for idx in (0, 7, 17):
        got = ours.prepare(idx, rng=np.random.RandomState(idx))
        want = ref.prepare(idx, rng=np.random.RandomState(idx))
        np.testing.assert_allclose(got["keypoint"], want["keypoint"],
                                   rtol=1e-5, atol=1e-5)
        assert got["label"] == want["label"]


def test_train_cli_runs_the_stgcnpp_config(tmp_path,
                                           one_thread):  # noqa: F811
    """One epoch of the STGCN++ j config (its RepeatDataset train set) on a
    synthetic pickle, narrowed to two blocks, through the port's CLI."""
    ann = tmp_path / "synth.pkl"
    D.make_synthetic_pose_dataset(num_samples=8, num_classes=5, t=40,
                                  path=str(ann))
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"""
_base_ = [{CONFIG!r}]
model = dict(backbone=dict(num_stages=2, base_channels=16),
             cls_head=dict(num_classes=5, in_channels=16))
data = dict(videos_per_gpu=4, workers_per_gpu=2,
            test_dataloader=dict(videos_per_gpu=4),
            train=dict(times=2, dataset=dict(ann_file={str(ann)!r},
                                             split='train')),
            val=dict(ann_file={str(ann)!r}, split='val'))
""")
    wd = tmp_path / "wd"
    trainer = cli.main([str(cfg), "--work-dir", str(wd), "--validate",
                        "--device", "cpu", "--total-epochs", "1"])
    assert trainer.step == 3                # 2 x 6 clips, batches of 4
    records = [json.loads(line) for f in sorted(wd.glob("*.log.jsonl"))
               for line in f.read_text().splitlines()]
    losses = [r["loss"] for r in records if r.get("mode") == "train"]
    assert losses and all(np.isfinite(losses))
    assert any(r.get("mode") == "val" for r in records)
