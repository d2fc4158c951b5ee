"""Port parity, PoseC3D: the heatmap pipeline (``Resize``,
``RandomResizedCrop``, ``CenterCrop``, ``Flip``, ``GeneratePoseTarget``,
``FormatHeatmapInput``, ``bilinear_resize``), the 3D-CNN backbones
(``ResNet3dSlowOnly``, ``ResNet3d`` with ``Bottleneck3d`` or
``BasicBlock3d``, the ``advanced`` downsample, ``with_pool2``),
``RecognizerPoseC3D``, the builder on ``configs/posec3d/
slowonly_ntu60_xsub.py``, and the port's trainer and test CLI on its
``imgs`` input, against ``dsgcn_tpu`` on the CPU.

Tolerances: the transforms and both of the config's pipelines at 1e-6
(the same numpy arithmetic; random ones draw from one ``RandomState``
each side); float32 eval forwards against JAX's jitted forward at rtol
1e-4 / atol 1e-5; float32 train passes at 2e-5 of the largest logit,
each gradient at cosine > 0.9995 and norm within 2% of JAX's (JAX's and
the port's float32 BatchNorm statistics sum in different orders, and
through the untrained BatchNorm stacks single gradients stray up to 3% of
their largest entry on some draws); float64 train passes and two SGD
steps at 1e-8.  JAX's ``ConvBN3d`` casts its BatchNorm's input to
float32 even under x64 (``dsgcn_tpu/models/cnns.py:52``), which would
hold a float64 comparison to float32's precision (~1e-5 here), so the
float64 checks run JAX's module with that cast made to float64
(:func:`_jax_bn_in_float64`); the port computes its BatchNorm in at
least float32 and keeps float64 as float64 (``ops/common.py:
accum_dtype``).  No kernel of the port is on this path.
"""
import copy
import pathlib
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from dsgcn_tpu.configs.config import Config as JConfig
from dsgcn_tpu.core.train import TrainState
from dsgcn_tpu.core.train import make_optimizer as j_make_optimizer
from dsgcn_tpu.core.train import train_step as j_train_step
from dsgcn_tpu.data import heatmap as JH
from dsgcn_tpu.data import pose_aug as JP
from dsgcn_tpu.data import transforms as JT
from dsgcn_tpu.core.losses import cross_entropy as j_cross_entropy
from dsgcn_tpu.models import cnns as jcnns
from dsgcn_tpu.models.builder import build_backbone as j_build_backbone
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.core.losses import cross_entropy
from dsgcn_tpu_torch.core.train import (jax_param_names, make_optimizer,
                                        train_step)
from dsgcn_tpu_torch.data import heatmap as H
from dsgcn_tpu_torch.data import pose_aug as P
from dsgcn_tpu_torch.data import transforms as T
from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
from dsgcn_tpu_torch.models import cnns
from dsgcn_tpu_torch.models.builder import build_backbone, build_model
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.tools import test as test_cli
from dsgcn_tpu_torch.tools import train as train_cli
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _random_variables
from test_torch_port_grad import assert_rel
from torch_port_cases import one_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "posec3d" / "slowonly_ntu60_xsub.py"
F64 = 1e-8
EVAL_TOL = dict(rtol=1e-4, atol=1e-5)
# a narrow SlowOnly-R50: the committed config's strides and inflation,
# one block a stage, base 8
NARROW = dict(type="ResNet3dSlowOnly", depth=50, in_channels=17,
              base_channels=8, num_stages=3, stage_blocks=[1, 1, 1],
              conv1_stride=[1, 1], pool1_stride=[1, 1], inflate=[0, 1, 1],
              spatial_strides=[2, 2, 2], temporal_strides=[1, 1, 2])
X_SHAPE = (2, 4, 32, 32, 17)


def _x(seed, shape=X_SHAPE):
    return np.random.default_rng(seed).standard_normal(shape)


class x64:
    """JAX in float64 inside the block."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


class _Float64Numpy:
    """``jax.numpy`` whose ``float32`` is ``float64``."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _jax_bn_in_float64(monkeypatch):
    """JAX's ``ConvBN3d`` with its BatchNorm's cast to float32 made to
    float64 (``dsgcn_tpu/models/cnns.py:52`` is the only use of ``jnp`` on
    the ResNet3d path), so that a float64 check holds the math at 1e-8."""
    monkeypatch.setattr(jcnns, "jnp", _Float64Numpy())


def _variables(jmod, seed, x):
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32), train=False))
    return _random_variables(shapes, seed)


def _f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, **tol)


# ---------------------------------------------------------------------------
# (a) the transforms and the config's pipelines, numpy on both sides
# ---------------------------------------------------------------------------

def _same(ours, ref, atol=1e-6):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=atol,
                                       err_msg=k)
        elif isinstance(ref[k], list):
            assert len(ours[k]) == len(ref[k]), k
            for a, b in zip(ours[k], ref[k]):
                np.testing.assert_allclose(a, b, rtol=0, atol=atol,
                                           err_msg=k)
        else:
            assert ours[k] == ref[k], k


def _canvas_anno(seed, m=2, t=5, v=17, size=(48, 64), frames=True):
    """Pixel keypoints (m, t, v, 2) in an (h, w) canvas, some on its edges
    and outside it, some at 0 (missing), scores in [0, 1) with some under
    the 1e-3 floor; with ``frames`` also per-frame images to crop, resize
    and flip."""
    rng = np.random.default_rng(seed)
    h, w = size
    kp = rng.uniform(-3, 1, (m, t, v, 2)) * [w, h] / 1.5 + [w / 2, h / 2]
    kp[0, 0, 0] = 0
    kp[0, 1, 1] = (w - 0.5, h - 0.5)
    kp[1, 2, 3] = (-2.0, 5.0)
    kp[1, 3, 5] = kp[1, 3, 7] + 0.4           # a limb shorter than a pixel
    score = rng.uniform(0, 1, (m, t, v))
    score[0, 4, :4] = 5e-4
    anno = dict(keypoint=kp.astype(np.float32),
                keypoint_score=score.astype(np.float32), img_shape=(h, w),
                label=1, total_frames=t)
    if frames:
        anno["imgs"] = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
                        for _ in range(t)]
    return anno


GPT_CASES = [dict(), dict(with_kp=False, with_limb=True), dict(double=True),
             dict(with_kp=False, with_limb=True, double=True),
             dict(use_score=False), dict(channels_last=False),
             dict(with_kp=False, with_limb=True, channels_last=False),
             dict(sigma=1.3, double=True, channels_last=False)]


@pytest.mark.parametrize("kw", GPT_CASES, ids=str)
def test_generate_pose_target_matches_jax(kw):
    """Keypoint and limb maps, ``double``, ``use_score=False`` and both
    layouts on a canvas with joints on and past its edges, missing joints,
    scores under the floor and a sub-pixel limb."""
    anno = _canvas_anno(0, frames=False)
    ours = H.GeneratePoseTarget(**kw)(copy.deepcopy(anno))
    ref = JH.GeneratePoseTarget(**kw)(copy.deepcopy(anno))
    _same(ours, ref)
    assert ours["imgs"].any()
    assert H.COCO_SKELETONS == JH.COCO_SKELETONS
    assert (H.COCO_LEFT_KP, H.COCO_RIGHT_KP, H.COCO_LEFT_LIMB,
            H.COCO_RIGHT_LIMB) == (JH.COCO_LEFT_KP, JH.COCO_RIGHT_KP,
                                   JH.COCO_LEFT_LIMB, JH.COCO_RIGHT_LIMB)


TRANSFORMS = [
    ("Resize", dict(scale=(-1, 64))), ("Resize", dict(scale=(40, 40),
                                                      keep_ratio=False)),
    ("Resize", dict(scale=0.5)), ("Resize", dict(scale=(100, 30))),
    ("RandomResizedCrop", dict()),
    ("RandomResizedCrop", dict(area_range=(1.5, 2.0))),   # the fallback
    ("CenterCrop", dict(crop_size=32)), ("CenterCrop", dict(crop_size=(40,
                                                                       24))),
    ("Flip", dict(flip_ratio=1.0)), ("Flip", dict(flip_ratio=0.5)),
    ("Flip", dict(flip_ratio=1.0, left_kp=None, right_kp=None)),
]


@pytest.mark.parametrize("name,kw", TRANSFORMS, ids=str)
@pytest.mark.parametrize("frames", [False, True])
def test_transform_matches_jax(name, kw, frames):
    """Each keypoint-space transform with and without frames (crops, the
    bilinear resize and the mirror of ``imgs``), the random ones on a
    ``RandomState`` of the same seed each side, over a few draws."""
    ours_t, ref_t = getattr(P, name)(**kw), getattr(JP, name)(**kw)
    rngs = (np.random.RandomState(3), np.random.RandomState(3))
    for seed in range(3):
        anno = _canvas_anno(seed, frames=frames)
        anno["crop_quadruple"] = (0.1, 0.2, 0.5, 0.6)
        if ours_t.randomized:
            ours = ours_t(copy.deepcopy(anno), rngs[0])
            ref = ref_t(copy.deepcopy(anno), rngs[1])
        else:
            ours, ref = ours_t(copy.deepcopy(anno)), ref_t(copy.deepcopy(
                anno))
        _same(ours, ref)


@pytest.mark.parametrize("size", [(64, 48), (20, 35), (48, 64)])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_bilinear_resize_matches_jax(size, dtype):
    img = np.random.default_rng(4).uniform(0, 255, (48, 64, 3)).astype(
        dtype)
    got, want = P.bilinear_resize(img, size), JP.bilinear_resize(img, size)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got = P.bilinear_resize(img[..., 0], size)
    np.testing.assert_allclose(got, JP.bilinear_resize(img[..., 0], size),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("nc", [1, 3])
def test_format_heatmap_input_matches_jax(nc):
    imgs = np.random.default_rng(5).random((6, 4, 5, 17)).astype(np.float32)
    res = dict(imgs=imgs, num_clips=nc)
    _same(P.FormatHeatmapInput()(dict(res)),
          JP.FormatHeatmapInput()(dict(res)))
    with pytest.raises(ValueError, match="split"):
        P.FormatHeatmapInput()(dict(imgs=imgs, num_clips=4))


def _pipelines(path, clip_len):
    """The config's three pipelines from each package's Config, every
    ``UniformSampleFrames`` at ``clip_len``."""
    out = []
    for C in (Config, JConfig):
        data = C.fromfile(str(path))["data"]
        pipes = {k: copy.deepcopy(data[k]["pipeline"])
                 for k in ("train", "val", "test")}
        for pipe in pipes.values():
            for step in pipe:
                if step["type"] == "UniformSampleFrames":
                    step["clip_len"] = clip_len
        out.append(pipes)
    return out


@pytest.mark.parametrize("split", ["train", "test"])
def test_config_pipelines_match_jax(split):
    """The committed config's train pipeline (PoseCompact, Resize to a
    64-pixel short edge, RandomResizedCrop, Resize to 56 x 56, Flip,
    GeneratePoseTarget, FormatHeatmapInput) and its 10-clip test pipeline
    (Resize and CenterCrop to 64 x 64) at clip_len 8 on synthetic hrnet
    annos, one RandomState each side over the annos in turn: the same
    ``imgs`` (nc, 8, h, w, 17) and labels."""
    ours_cfg, ref_cfg = _pipelines(CONFIG, 8)
    ours_p = T.build_pipeline(ours_cfg[split])
    ref_p = JT.build_pipeline(ref_cfg[split])
    assert ours_cfg["val"] == ref_cfg["val"]
    annos = make_synthetic_pose_dataset(num_samples=3, num_classes=60, t=30,
                                        seed=6, layout="coco")["annotations"]
    rngs = (np.random.RandomState(7), np.random.RandomState(7))
    for anno in annos:
        ours = ours_p(copy.deepcopy(anno), rngs[0])
        ref = ref_p(copy.deepcopy(anno), rngs[1])
        _same(ours, ref)
        nc, hw = (1, 56) if split == "train" else (10, 64)
        assert ours["imgs"].shape == (nc, 8, hw, hw, 17)
        assert ours["imgs"].max() > 0.5


# ---------------------------------------------------------------------------
# (b) the backbones, float32 eval against JAX's jitted forward
# ---------------------------------------------------------------------------

BACKBONES = {
    "slowonly_r50": NARROW,
    "r18_basic": dict(type="ResNet3d", depth=18, in_channels=17,
                      base_channels=8, num_stages=3, stage_blocks=[2, 1, 1],
                      conv1_kernel=[3, 5, 5], inflate=[1, [0, 1], 0],
                      spatial_strides=[1, 2, 2],
                      temporal_strides=[1, 2, 1]),
    "r50_advanced_pool2": dict(NARROW, type="ResNet3d", advanced=True,
                               with_pool2=True, conv1_stride=[1, 2],
                               pool1_stride=[1, 2], stage_blocks=[2, 1],
                               num_stages=2, spatial_strides=[1, 2],
                               temporal_strides=[1, 2]),
    "r50_3x3x3": dict(NARROW, inflate_style="3x3x3", inflate=[1, 0, 1]),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_eval_matches_jax(name):
    """SlowOnly-R50 at base 8 (one block a stage), R18 with
    ``BasicBlock3d`` (per-block inflation, a temporal stride), R50 with
    the ``advanced`` downsample and ``with_pool2``, and the '3x3x3'
    inflate style: the port's eval output (N, T', H', W', C') against
    JAX's jitted forward with the same variables, loaded strictly."""
    cfg = BACKBONES[name]
    x = _x(1).astype(np.float32)
    jmod = j_build_backbone(cfg)
    v = _variables(jmod, 2, x)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        v, jnp.asarray(x))
    port = build_backbone(cfg)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x)).numpy()
    assert port.out_channels == got.shape[-1]
    _close(got, want, EVAL_TOL)


def test_posec3d_slowonly_defaults_match_jax():
    """``posec3d_slowonly`` builds the committed config's backbone."""
    cfg = Config.fromfile(str(CONFIG))["model"]["backbone"]
    port = cnns.posec3d_slowonly()
    ref = build_backbone(cfg)
    assert [(n, p.shape) for n, p in port.named_parameters()] == \
        [(n, p.shape) for n, p in ref.named_parameters()]
    assert jcnns.posec3d_slowonly() == j_build_backbone(cfg)


# ---------------------------------------------------------------------------
# (c) RecognizerPoseC3D, train passes and steps
# ---------------------------------------------------------------------------

def _recognizer_cfg(dropout=0.5):
    return dict(type="RecognizerPoseC3D", backbone=NARROW, num_classes=7,
                dropout=dropout)


def _same_dropout(monkeypatch, seed, shape=(2, 128)):
    """One dropout mask (p = 0.5) on both sides: JAX's ``nn.Dropout``
    intercepted, the port's ``dropout`` replaced."""
    keep = np.random.default_rng(seed).random(shape) >= 0.5

    def interceptor(next_fun, args, kwargs, context):
        mod = context.module
        if isinstance(mod, nn.Dropout) and not mod.deterministic:
            return jnp.where(jnp.asarray(keep), args[0] / 0.5, 0)
        return next_fun(*args, **kwargs)

    def port_dropout(x, p, training, generator=None):
        if not training:
            return x
        assert p == 0.5
        return torch.where(torch.from_numpy(keep), x / 0.5,
                           torch.zeros((), dtype=x.dtype))
    monkeypatch.setattr(cnns, "_dropout", port_dropout)
    return nn.intercept_methods(interceptor)


def _jax_train_pass(jmod, v, x, label):
    """JAX's train-mode logits, loss, gradients and new statistics, as the
    port's state-dict names."""
    def loss(params, stats):
        out, mut = jmod.apply({"params": params, "batch_stats": stats}, x,
                              train=True, mutable=["batch_stats"])
        return j_cross_entropy(out, jnp.asarray(label)), (out, mut)
    (jl, (logits, mut)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"], v["batch_stats"])
    grads = convert_jax_variables({"params": jax.tree.map(np.asarray,
                                                          grads)})
    stats = convert_jax_variables({"batch_stats": jax.tree.map(
        np.asarray, mut["batch_stats"])})
    return float(jl), np.asarray(logits), grads, stats


def _port_train_pass(cfg, v, x, label, dtype):
    port = build_model(cfg)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    port.to(dtype).train()
    logits = port(torch.from_numpy(x))
    loss = cross_entropy(logits, torch.from_numpy(label))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
    return loss.item(), logits.detach().numpy(), grads, port.state_dict()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_recognizer_train_pass_matches_jax(dtype, monkeypatch):
    """A train-mode forward and backward with dropout 0.5 (the same mask
    each side): logits, loss, every parameter's gradient and every
    updated BatchNorm statistic.  float64 at 1e-8 (JAX's BatchNorm cast
    made float64); float32 with JAX's own float32 BatchNorm: loss 1e-5,
    logits 2e-5 and statistics 1e-4 of their largest, each gradient at
    cosine > 0.9995 and norm within 2%."""
    cfg = _recognizer_cfg()
    x, label = _x(3), np.random.default_rng(4).integers(0, 7, 2)
    jmod = j_build_model(cfg)
    v = _variables(jmod, 5, x)
    intercept = _same_dropout(monkeypatch, 6)
    if dtype == "float64":
        _jax_bn_in_float64(monkeypatch)
        with x64(), intercept:
            want = _jax_train_pass(jmod, _f64(v), jnp.asarray(x), label)
        got = _port_train_pass(cfg, v, x, label, torch.float64)
        tol = dict(loss=F64, logits=F64, stats=F64, grads=F64)
    else:
        x = x.astype(np.float32)
        with intercept:
            want = _jax_train_pass(jmod, v, jnp.asarray(x), label)
        got = _port_train_pass(cfg, v, x, label, torch.float32)
        tol = dict(loss=1e-5, logits=2e-5, stats=1e-4, grads=None)
    np.testing.assert_allclose(got[0], want[0], rtol=tol["loss"])
    assert_rel(got[1], want[1], tol["logits"], "logits")
    assert sorted(got[2]) == sorted(want[2])
    for name, g in want[2].items():
        if tol["grads"] is not None:
            assert_rel(got[2][name], g.numpy(), tol["grads"], name)
            continue
        a, b = got[2][name].ravel(), g.numpy().ravel().astype(np.float64)
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        assert a @ b / (na * nb) > 0.9995 and abs(na / nb - 1) < 2e-2, name
    for name, s in want[3].items():
        assert_rel(got[3][name].numpy(), s.numpy(), tol["stats"], name)


def test_recognizer_two_steps_float64_match_jax(monkeypatch):
    """Two steps through both packages' ``train_step`` on ``imgs`` batches
    (the config's SGD: Nesterov momentum 0.9, weight decay 3e-4, cosine
    over two steps), dropout 0.5 with the same mask each side (JAX's step
    is traced once, with the first step's), float64
    with JAX's BatchNorm cast made float64: each step's loss, then every
    parameter and statistic, at 1e-8; no kernel of the port launched."""
    cfg = _recognizer_cfg()
    rng = np.random.default_rng(8)
    batches = [dict(imgs=rng.standard_normal(X_SHAPE),
                    label=rng.integers(0, 7, 2)) for _ in range(2)]
    jmod = j_build_model(cfg)
    v = _variables(jmod, 9, batches[0]["imgs"])
    _jax_bn_in_float64(monkeypatch)
    port = build_model(cfg)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    port.double()
    opt, sched = make_optimizer(port, total_steps=2, lr=0.2,
                                weight_decay=3e-4)
    before = launch_counts()
    with x64():
        tx, _ = j_make_optimizer(lr=0.2, momentum=0.9, weight_decay=3e-4,
                                 nesterov=True, total_steps=2)
        vv = _f64(v)
        state = TrainState.create(jmod.apply, vv["params"],
                                  vv["batch_stats"], tx)
        step = jax.jit(j_train_step)
        with _same_dropout(monkeypatch, 10):
            for b in batches:
                state, m = step(state, dict(imgs=jnp.asarray(b["imgs"]),
                                            label=jnp.asarray(b["label"])),
                                jax.random.PRNGKey(0))
                tl = train_step(port, opt, sched, b)["loss"].item()
                np.testing.assert_allclose(tl, float(m["loss"]), rtol=F64)
        new = convert_jax_variables(jax.tree.map(np.array, {
            "params": state.params, "batch_stats": state.batch_stats}))
    assert launch_counts() == before
    sd = port.state_dict()
    assert sd.keys() == new.keys()
    for name, w in new.items():
        assert_rel(sd[name].numpy(), w.numpy(), F64, name)


def test_recognizer_eval_and_compute_dtype():
    """The eval forward against JAX's at float32's tolerance; a bfloat16
    input runs the convs in bfloat16 with float32 BatchNorm and gives
    bfloat16 logits near float32's; ``to_bf16_inference`` refuses the
    model (it has no ``compute_dtype``, as JAX's)."""
    from dsgcn_tpu_torch.apis import to_bf16_inference
    cfg = _recognizer_cfg()
    x = _x(11).astype(np.float32)
    jmod = j_build_model(cfg)
    v = _variables(jmod, 12, x)
    want = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(
        v, jnp.asarray(x))
    port = build_model(cfg)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
        half = port(torch.from_numpy(x).bfloat16())
    _close(got.numpy(), want, EVAL_TOL)
    assert half.dtype == torch.bfloat16
    assert_rel(half.float().numpy(), got.numpy(), 5e-2, "bf16 logits")
    with pytest.raises(NotImplementedError, match="bfloat16"):
        to_bf16_inference(port)


# ---------------------------------------------------------------------------
# (d) the committed config
# ---------------------------------------------------------------------------

def test_committed_config_builds_and_loads_jax_variables():
    """SlowOnly-R50 at full width (17 in, base 32, blocks (4, 6, 3), 60
    classes): the port's parameters and statistics are JAX's init's, name
    for name and shape for shape, loaded with ``strict=True``; the
    optimizer's JAX paths (``jax_param_names``) are the tree's; the
    initial weights follow JAX's initializers (3-D kernels N(0, 2 /
    fan_out), BatchNorm scales 1, ``fc_cls`` N(0, 0.01) with a zero
    bias)."""
    from dsgcn_tpu_torch.models.builder import init_weights_
    cfg = Config.fromfile(str(CONFIG))["model"]
    assert cfg == JConfig.fromfile(str(CONFIG))["model"]
    shapes = jax.eval_shape(lambda: j_build_model(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 56, 56, 17)), train=False))
    v = _random_variables(shapes, 13)
    sd = convert_jax_variables(v)
    port = build_model(cfg)
    assert isinstance(port, cnns.RecognizerPoseC3D)
    assert {k: tuple(t.shape) for k, t in port.state_dict().items()} == \
        {k: tuple(t.shape) for k, t in sd.items()}
    port.load_state_dict(sd, strict=True)
    flat = {".".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    assert sorted(jax_param_names(port).values()) == sorted(flat)
    assert port.fc_cls.in_features == 512 and port.dropout == 0.5
    assert sum(p.numel() for p in port.parameters()) == sum(
        int(np.prod(a.shape)) for a in flat.values())
    port = init_weights_(build_model(cfg), torch.Generator().manual_seed(0))
    w = port.backbone.layer3_0.conv1.conv.weight        # (128, 512, 3, 1, 1)
    fan_out = w.shape[0] * w[0, 0].numel()
    assert abs(w.std().item() / (2 / fan_out) ** 0.5 - 1) < 0.02
    assert port.fc_cls.bias.abs().max() == 0
    assert abs(port.fc_cls.weight.std().item() / 0.01 - 1) < 0.05
    assert (port.backbone.conv1.weight == 1).all()


def test_data_parallel_step_averages_convbn3d_statistics():
    """The data-parallel step averages every running statistic after a
    step (JAX's ``pmean`` of ``batch_stats``): a ``ConvBN3d``'s are among
    them, two for each of the narrow model's 13 ConvBN3d (the stem, three
    blocks of three and their downsamples)."""
    from dsgcn_tpu_torch.parallel.train import running_stats
    model = build_model(_recognizer_cfg())
    convbns = [m for m in model.modules() if isinstance(m, cnns.ConvBN3d)]
    stats = running_stats(model)
    assert len(convbns) == 13 and len(stats) == 26
    assert {id(t) for t in stats} == {id(t) for m in convbns for t in (
        m.running_mean, m.running_var)}


def test_recognizers_not_ported_are_refused():
    """The 3-D, 2-D and multimodal recognizers build (their parity is in
    ``test_torch_port_video_models.py``); a recognizer type the port does
    not have is refused."""
    head = dict(type="I3DHead", num_classes=5, in_channels=128)
    assert type(build_model(dict(type="Recognizer3D", backbone=NARROW,
                                 cls_head=head))).__name__ == "Recognizer3D"
    assert type(build_model(dict(
        type="Recognizer2D", backbone=dict(type="PoTion", in_channels=17),
        cls_head=dict(type="TSNHead", num_classes=5, in_channels=512)))
    ).__name__ == "Recognizer2D"
    assert type(build_model(dict(
        type="MMRecognizer3D", backbone=dict(type="RGBPoseConv3D"),
        cls_head=dict(type="RGBPoseHead", num_classes=5,
                      in_channels=[2048, 512])))).__name__ == \
        "MMRecognizer3D"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_model(dict(type="RecognizerAudio", backbone=NARROW,
                         cls_head=head))


# ---------------------------------------------------------------------------
# (e) the trainer and the CLIs on imgs
# ---------------------------------------------------------------------------

def _cli_config(tmp_path, ann):
    cfg = tmp_path / "posec3d.py"
    cfg.write_text(
        f"_base_ = ['{CONFIG}']\n"
        "model = dict(backbone=dict(base_channels=8, stage_blocks=[1, 1, 1]),"
        "\n             num_classes=5)\n"
        "train_pipeline = [\n"
        "    dict(type='UniformSampleFrames', clip_len=8),\n"
        "    dict(type='PoseDecode'),\n"
        "    dict(type='PoseCompact', hw_ratio=1.0, allow_imgpad=True),\n"
        "    dict(type='Resize', scale=(-1, 40)),\n"
        "    dict(type='RandomResizedCrop', area_range=(0.56, 1.0)),\n"
        "    dict(type='Resize', scale=(32, 32), keep_ratio=False),\n"
        "    dict(type='Flip', flip_ratio=0.5),\n"
        "    dict(type='GeneratePoseTarget', sigma=0.6, use_score=True),\n"
        "    dict(type='FormatHeatmapInput'),\n"
        "    dict(type='Collect', keys=['imgs', 'label'])]\n"
        "test_pipeline = [\n"
        "    dict(type='UniformSampleFrames', clip_len=8, num_clips=2,\n"
        "         test_mode=True),\n"
        "    dict(type='PoseDecode'),\n"
        "    dict(type='PoseCompact', hw_ratio=1.0, allow_imgpad=True),\n"
        "    dict(type='Resize', scale=(32, 32), keep_ratio=False),\n"
        "    dict(type='CenterCrop', crop_size=32),\n"
        "    dict(type='GeneratePoseTarget', sigma=0.6, use_score=True),\n"
        "    dict(type='FormatHeatmapInput'),\n"
        "    dict(type='Collect', keys=['imgs', 'label'])]\n"
        "data = dict(videos_per_gpu=2, workers_per_gpu=0,\n"
        "            test_dataloader=dict(videos_per_gpu=2),\n"
        f"            train=dict(ann_file='{ann}', split='train',\n"
        "                       pipeline=train_pipeline),\n"
        f"            val=dict(ann_file='{ann}', split='val',\n"
        "                     pipeline=test_pipeline),\n"
        f"            test=dict(ann_file='{ann}', split='val',\n"
        "                      pipeline=test_pipeline))\n")
    return cfg


def test_train_and_test_cli_on_imgs(tmp_path, capsys, one_thread):
    """The committed config narrowed (base 8, a block a stage, 5 classes,
    clip_len 8 at 32 x 32, 2 test clips) on synthetic hrnet annos: the
    train CLI steps on (2, 8, 32, 32, 17) ``imgs`` (the nc = 1 axis
    dropped), validates on the 2-clip val split and checkpoints; the test
    CLI's clip-averaged scores equal the model's own on the test pipeline's
    volumes (1e-6); the feature flags and ``--bf16`` refuse the model."""
    from dsgcn_tpu_torch.core.trainer import squeeze_clip
    from dsgcn_tpu_torch.data.transforms import build_pipeline
    from dsgcn_tpu_torch.models.recognizer import average_clip
    ann = tmp_path / "synth.pkl"
    data = make_synthetic_pose_dataset(num_samples=8, num_classes=5, t=20,
                                       seed=14, layout="coco",
                                       path=str(ann))
    cfg = _cli_config(tmp_path, ann)
    wd = str(tmp_path / "wd")
    trainer = train_cli.main([str(cfg), "--work-dir", wd, "--total-epochs",
                              "1", "--device", "cpu", "--test-last"])
    out = capsys.readouterr().out
    assert trainer.step == 3                # 6 train annos, batch 2
    assert "mode=val" in out and "final: {" in out
    batch = next(iter(trainer.train_loader.epoch(0)))
    assert batch["imgs"].shape == (2, 1, 8, 32, 32, 17)
    assert squeeze_clip(batch)["imgs"].shape == (2, 8, 32, 32, 17)
    pkl = str(tmp_path / "scores.pkl")
    test_cli.main([str(cfg), wd, "--out", pkl, "--device", "cpu"])
    assert "top1_acc: " in capsys.readouterr().out
    with open(pkl, "rb") as f:
        scores = pickle.load(f)["scores"]
    model = trainer.model.eval()
    pipe = build_pipeline(Config.fromfile(str(cfg))["data"]["test"][
        "pipeline"])
    val = [a for a in data["annotations"]
           if a["frame_dir"] in data["split"]["val"]]
    with torch.no_grad():
        want = torch.cat([average_clip(model(torch.from_numpy(pipe(
            copy.deepcopy(a))["imgs"]))[None], "prob") for a in val])
    assert scores.shape == (2, 5)
    np.testing.assert_allclose(scores, want.numpy(), rtol=1e-6, atol=1e-6)
    for flag in ("--feat-ext", "--score-ext"):
        with pytest.raises(NotImplementedError, match="RecognizerGCN"):
            test_cli.main([str(cfg), wd, flag, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="bfloat16"):
        test_cli.main([str(cfg), wd, "--bf16", "--device", "cpu"])
