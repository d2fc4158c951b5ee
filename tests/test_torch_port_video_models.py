"""Port parity, the 3D-CNN, 2D-CNN and multimodal models: ``ConvBN3d``'s
grouped, zero-gamma and BatchNorm-less forms, ``C3D``, ``X3D`` (with and
without SE and swish, the width and depth rounding), ``PoTion``, the
SlowFast pathway pieces (the forward and the transposed lateral, a narrow
pair of ``ResNet3dPathway``s with laterals both ways), ``ResNet3dSlowFast``,
``RGBPoseConv3D`` at its fixed widths, the heads ``SimpleHead3D`` /
``I3DHead`` / ``SlowFastHead``, ``TSNHead`` and ``RGBPoseHead``, the
recognizers ``Recognizer3D``, ``Recognizer2D`` and ``MMRecognizer3D``,
``mm_cross_entropy``, the converter's new kernels and the init rules,
against ``dsgcn_tpu`` on the CPU.

JAX's variables come from ``jax.eval_shape`` and numpy
(``test_torch_port_dggcn._random_variables``), its programs are jitted.
Tolerances: float32 eval forwards at 1e-5 of the largest output
(``RGBPoseConv3D``'s 38M parameters at 1e-4); float64 train passes and SGD
steps at 1e-8, with JAX's float32 BatchNorm cast made float64
(``test_torch_port_posec3d._jax_bn_in_float64``: ``ConvBN3d`` and
``ConvBN2d`` cast there); ``RGBPoseConv3D``'s ``mm_cross_entropy``
gradient in float32 at 1e-4 of each gradient's largest entry.  No kernel
of the port is on this path.
"""
import math
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from dsgcn_tpu.core.losses import mm_cross_entropy as j_mm_cross_entropy
from dsgcn_tpu.core.train import TrainState
from dsgcn_tpu.core.train import make_optimizer as j_make_optimizer
from dsgcn_tpu.core.train import train_step as j_train_step
from dsgcn_tpu.models import cnns as jcnns
from dsgcn_tpu.models.builder import build_backbone as j_build_backbone
from dsgcn_tpu.models.builder import build_head as j_build_head
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu_torch.core.losses import mm_cross_entropy
from dsgcn_tpu_torch.core.train import (jax_param_names, make_optimizer,
                                        train_step)
from dsgcn_tpu_torch.models import cnns
from dsgcn_tpu_torch.models.builder import (build_backbone, build_head,
                                            build_model, init_weights_)
from dsgcn_tpu_torch.models.recognizer import (MMRecognizer3D, Recognizer2D,
                                               Recognizer3D)
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _random_variables
from test_torch_port_grad import assert_rel
from test_torch_port_posec3d import _f64, _jax_bn_in_float64, x64
from torch_port_cases import one_thread  # noqa: F401

EVAL = 1e-5
F64 = 1e-8

# narrow forms of each backbone: (config, input shape)
BACKBONES = {
    "c3d": (dict(type="C3D", in_channels=5, base_channels=4, num_stages=4),
            (2, 8, 16, 16, 5)),
    "c3d_light": (dict(type="C3D", in_channels=5, base_channels=4,
                       num_stages=3, temporal_downsample=False),
                  (2, 4, 16, 16, 5)),
    "x3d_se_swish": (dict(type="X3D", in_channels=5, base_channels=8,
                          gamma_d=1.0, num_stages=2, stage_blocks=[3, 1],
                          spatial_strides=[2, 2]),
                     (2, 6, 16, 16, 5)),
    "x3d_all_se_noswish": (dict(type="X3D", in_channels=5, base_channels=8,
                                gamma_d=1.0, num_stages=2,
                                stage_blocks=[2, 1], se_style="all",
                                use_swish=False, spatial_strides=[1, 2]),
                           (2, 4, 8, 8, 5)),
    "x3d_nose_noswish": (dict(type="X3D", in_channels=5, base_channels=8,
                              gamma_d=1.0, num_stages=2, stage_blocks=[2, 1],
                              se_ratio=None, use_swish=False,
                              spatial_strides=[2, 2]),
                         (2, 4, 16, 16, 5)),
    "potion": (dict(type="PoTion", in_channels=7, channels=[8, 16],
                    num_layers=[2, 1]),
               (4, 16, 16, 7)),
    "slowfast_r18": (dict(type="ResNet3dSlowFast", slow_depth=18,
                          fast_depth=18),
                     (2, 8, 32, 32, 3)),
}
# each backbone in its recognizer: (type, head, head in_channels); the
# input of a Recognizer2D is (N, S, H, W, C)
RECOGNIZERS = {
    "c3d": ("Recognizer3D", "I3DHead", 32),
    "c3d_light": ("Recognizer3D", "I3DHead", 32),
    "x3d_se_swish": ("Recognizer3D", "SimpleHead", 36),
    "x3d_all_se_noswish": ("Recognizer3D", "SimpleHead", 36),
    "x3d_nose_noswish": ("Recognizer3D", "SimpleHead", 36),
    "potion": ("Recognizer2D", "TSNHead", 16),
    "slowfast_r18": ("Recognizer3D", "SlowFastHead", 576),
}
# the second C3D and X3D forms are held in eval only (their steps' JAX
# programs would add ~6 s of tracing and compiling for no new layer)
EVAL_ONLY = ("c3d_light", "x3d_all_se_noswish")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape)


def _jvars(init, seed):
    return _random_variables(jax.eval_shape(init), seed)


def _load(port, v):
    port.load_state_dict(convert_jax_variables(v), strict=True)
    return port


def test_x3d_rounding_matches_jax():
    """``_round_width`` and ``_round_repeats`` over X3D's scales."""
    for w in (1, 8, 24, 54, 100, 432):
        for m in (None, 0, 1 / 16, 0.5, 1.0, 2.0, 2.25):
            assert cnns._round_width(w, m) == jcnns._round_width(w, m)
    for r in (1, 2, 3, 5, 7):
        for m in (None, 1.0, 2.2, 5.0):
            assert cnns._round_repeats(r, m) == jcnns._round_repeats(r, m)


@pytest.mark.parametrize("k,s", [(7, 4), (3, 2), (5, 4), (4, 4), (1, 1)])
def test_transposed_lateral_matches_flax(k, s):
    """The inverse lateral (``conv_transpose3d``, the kernel flipped by the
    converter, the padding and the last frames cut) against flax's
    ``ConvTranspose(padding='SAME')`` at several kernels and strides;
    the forward lateral against ``nn.Conv``."""
    x = _x(3, (2, 5, 3, 2, 6)).astype(np.float32)
    for inv in (True, False):
        jmod = jcnns._LateralConv(s, k, inv=inv, infl=2)
        v = _jvars(lambda: jmod.init(jax.random.PRNGKey(0),
                                     jnp.asarray(x)), 4)
        want = np.asarray(jax.jit(jmod.apply)(v, jnp.asarray(x)))
        port = cnns._LateralConv(6, s, k, inv=inv, infl=2)
        # the converter flips a pose pathway's lateral kernel
        scope = {"params": {"pose_path" if inv else "rgb_path": {
            "layer1_lateral": v["params"]}}}
        sd = convert_jax_variables(scope)
        prefix = ("pose_path" if inv else "rgb_path") + ".layer1_lateral."
        port.load_state_dict({k_[len(prefix):]: t for k_, t in sd.items()},
                             strict=True)
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        got = got.permute(0, 2, 3, 4, 1).numpy()
        assert got.shape == want.shape, (inv, got.shape, want.shape)
        assert_rel(got, want, EVAL, f"inv={inv}")


# ---------------------------------------------------------------------------
# a narrow pair of pathways with laterals both ways (RGBPoseConv3D's form)
# ---------------------------------------------------------------------------

PAIR_RGB = dict(depth=18, base_channels=8, num_stages=3,
                stage_blocks=(1, 1, 1), conv1_kernel=(1, 3, 3),
                inflate=(0, 1, 1), lateral=True,
                lateral_activate=(0, 1, 1), speed_ratio=4, fusion_kernel=7)
PAIR_POSE = dict(depth=18, base_channels=4, num_stages=3,
                 stage_blocks=(1, 1, 1), conv1_kernel=(1, 3, 3),
                 conv1_stride=(1, 1), pool1_stride=(1, 1),
                 inflate=(0, 1, 1), spatial_strides=(2, 2, 2),
                 lateral=True, lateral_inv=True, lateral_infl=2,
                 lateral_activate=(0, 1, 1), speed_ratio=4, fusion_kernel=7)
PAIR_X = ((1, 2, 16, 16, 3), (1, 8, 8, 8, 5))


class _JaxPair(nn.Module):
    """Two JAX pathways exchanging features after stages 0 and 1."""

    def setup(self):
        self.rgb_path = jcnns.ResNet3dPathway(in_channels=3, **PAIR_RGB)
        self.pose_path = jcnns.ResNet3dPathway(in_channels=5, **PAIR_POSE)

    def __call__(self, r, p, *, train):
        r = self.rgb_path.stage(0, self.rgb_path.stem(r, train=train),
                                train=train)
        p = self.pose_path.stage(0, self.pose_path.stem(p, train=train),
                                 train=train)
        for i in (1, 2):
            lp = self.rgb_path.lateral_conv(i, p, train=train)
            lr = self.pose_path.lateral_conv(i, r, train=train)
            r = self.rgb_path.stage(i, jnp.concatenate([r, lp], -1),
                                    train=train)
            p = self.pose_path.stage(i, jnp.concatenate([p, lr], -1),
                                     train=train)
        return r, p


class _PortPair(torch.nn.Module):
    def __init__(self):
        super().__init__()
        rgb_w = [cnns.pathway_width(18, 8, i) for i in range(4)]
        pose_w = [cnns.pathway_width(18, 4, i) for i in range(4)]
        self.rgb_path = cnns.ResNet3dPathway(in_channels=3, lateral_in=[
            0, pose_w[1], pose_w[2]], **PAIR_RGB)
        self.pose_path = cnns.ResNet3dPathway(in_channels=5, lateral_in=[
            0, rgb_w[1], rgb_w[2]], **PAIR_POSE)

    def forward(self, r, p):
        r = self.rgb_path.stage(0, self.rgb_path.stem(cnns._enter(r)))
        p = self.pose_path.stage(0, self.pose_path.stem(cnns._enter(p)))
        for i in (1, 2):
            lp = self.rgb_path.lateral_conv(i, p)
            lr = self.pose_path.lateral_conv(i, r)
            r = self.rgb_path.stage(i, torch.cat([r, lp], 1))
            p = self.pose_path.stage(i, torch.cat([p, lr], 1))
        return cnns._leave(r), cnns._leave(p)


def _pair_loss(outs):
    return sum((o ** 2).mean() for o in outs)


def test_pathway_pair_float64_train_pass_matches_jax(monkeypatch):
    """The narrow pair in train mode, float64: both outputs, the gradient
    of every parameter (the transposed laterals' through the converter's
    flip) and every new BatchNorm statistic at 1e-8; the eval outputs of
    the same float64 JAX program at 1e-5 in float32 and 1e-8 in
    float64."""
    xs = [_x(5 + i, s) for i, s in enumerate(PAIR_X)]
    jmod = _JaxPair()
    v = _jvars(lambda: jmod.init(jax.random.PRNGKey(0),
                                 *[jnp.asarray(x, jnp.float32) for x in xs],
                                 train=False), 7)
    port = _load(_PortPair(), v)
    _jax_bn_in_float64(monkeypatch)
    with x64():
        vv = _f64(v)

        def loss(params, stats, a, b):
            v = {"params": params, "batch_stats": stats}
            outs, mut = jmod.apply(v, a, b, train=True,
                                   mutable=["batch_stats"])
            return _pair_loss(outs), (outs, mut,
                                      jmod.apply(v, a, b, train=False))
        (jl, (jouts, mut, want)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(vv["params"], vv["batch_stats"],
                                 *[jnp.asarray(x) for x in xs])
        grads = convert_jax_variables({"params": jax.tree.map(np.asarray,
                                                              grads)})
        stats = convert_jax_variables({"batch_stats": jax.tree.map(
            np.asarray, mut["batch_stats"])})
    for dtype, tol in ((torch.float32, EVAL), (torch.float64, F64)):
        with torch.no_grad():
            got = port.to(dtype).eval()(*[torch.from_numpy(x).to(dtype)
                                          for x in xs])
        for g, w in zip(got, want):
            assert_rel(g.numpy(), np.asarray(w), tol, f"pair eval {dtype}")
    port.train()
    outs = port(*[torch.from_numpy(x) for x in xs])
    pl = _pair_loss(outs)
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=F64)
    for g, w in zip(outs, jouts):
        assert_rel(g.detach().numpy(), np.asarray(w), F64, "pair train")
    got = dict(port.named_parameters())
    assert sorted(got) == sorted(grads)
    for name, g in grads.items():
        assert_rel(got[name].grad.numpy(), g.numpy(), F64, name)
    sd = port.state_dict()
    for name, s in stats.items():
        assert_rel(sd[name].numpy(), s.numpy(), F64, name)


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

HEADS = {
    "simple": (dict(type="SimpleHead", num_classes=5, in_channels=6),
               [(2, 3, 4, 4, 6)]),
    "slowfast_tuple": (dict(type="SlowFastHead", num_classes=5,
                            in_channels=10),
                       [(2, 2, 3, 3, 6), (2, 8, 3, 3, 4)]),
    "tsn": (dict(type="TSNHead", num_classes=5, in_channels=6),
            [(2, 3, 4, 4, 6)]),
    "rgbpose": (dict(type="RGBPoseHead", num_classes=5,
                     in_channels=[6, 4]),
                [(2, 2, 3, 3, 6), (2, 8, 3, 3, 4)]),
}


class _Masks:
    """JAX's ``nn.Dropout`` calls take the given masks in order; so do the
    port's heads (``heads._dropout``), the same masks each side."""

    def __init__(self, monkeypatch, masks, p=0.5):
        from dsgcn_tpu_torch.models import heads
        self.masks, self.p = masks, p
        it = iter(masks)

        def port_dropout(x, p, training, generator=None):
            if not training:
                return x
            keep = torch.from_numpy(next(it))
            return torch.where(keep, x / (1 - p), torch.zeros((),
                                                              dtype=x.dtype))
        monkeypatch.setattr(heads, "_dropout", port_dropout)

    def intercept(self):
        it = iter(self.masks)

        def interceptor(next_fun, args, kwargs, context):
            mod = context.module
            if isinstance(mod, nn.Dropout) and not mod.deterministic:
                return jnp.where(jnp.asarray(next(it)),
                                 args[0] / (1 - self.p), 0)
            return next_fun(*args, **kwargs)
        return nn.intercept_methods(interceptor)


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_matches_jax(name, monkeypatch):
    """Each head's float32 eval logits at 1e-5, and a float64 train pass
    with dropout 0.5 (the same masks each side, one a stream for
    RGBPoseHead): logits and every gradient at 1e-8."""
    cfg, shapes = HEADS[name]
    xs = [_x(11 + i, s) for i, s in enumerate(shapes)]
    feed = (lambda a: tuple(a)) if len(xs) > 1 else (lambda a: a[0])
    jmod = j_build_head(cfg)
    v = _jvars(lambda: jmod.init(jax.random.PRNGKey(0), feed(
        [jnp.asarray(x, jnp.float32) for x in xs]), train=False), 12)
    port = _load(build_head(cfg), v)
    want = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
        v, feed([jnp.asarray(x, jnp.float32) for x in xs]))
    with torch.no_grad():
        got = port.eval()(feed([torch.from_numpy(x).float() for x in xs]))
    got, want = (got, want) if isinstance(got, dict) \
        else ({"y": got}, {"y": want})
    assert sorted(got) == sorted(want)
    for k in want:
        assert_rel(got[k].numpy(), np.asarray(want[k]), EVAL, k)

    rng = np.random.default_rng(13)
    masks = [rng.random((2, s[-1])) >= 0.5 for s in shapes] \
        if name == "rgbpose" else \
        [rng.random((2, cfg["in_channels"])) >= 0.5]
    same = _Masks(monkeypatch, masks)
    with x64(), same.intercept():
        def loss(params, a):
            out = jmod.apply({"params": params}, a, train=True,
                             rngs={"dropout": jax.random.PRNGKey(0)})
            out = out if isinstance(out, dict) else {"y": out}
            return sum((o ** 2).sum() for o in out.values()), out
        (jl, jout), grads = jax.value_and_grad(loss, has_aux=True)(
            _f64(v)["params"], feed([jnp.asarray(x) for x in xs]))
        grads = convert_jax_variables({"params": jax.tree.map(np.asarray,
                                                              grads)})
    port.double().train()
    out = port(feed([torch.from_numpy(x) for x in xs]))
    out = out if isinstance(out, dict) else {"y": out}
    pl = sum((o ** 2).sum() for o in out.values())
    pl.backward()
    np.testing.assert_allclose(pl.item(), float(jl), rtol=F64)
    for k in out:
        assert_rel(out[k].detach().numpy(), np.asarray(jout[k]), F64, k)
    for n, p in port.named_parameters():
        assert_rel(p.grad.numpy(), grads[n].numpy(), F64, n)


# ---------------------------------------------------------------------------
# recognizers: a float64 SGD step through both packages' train_step
# ---------------------------------------------------------------------------

def _recognizer_cfg(name, classes=5):
    typ, head, width = RECOGNIZERS[name]
    return dict(type=typ, backbone=BACKBONES[name][0],
                cls_head=dict(type=head, num_classes=classes,
                              in_channels=width, dropout=0.0))


def _recognizer_input(name, seed):
    shape = BACKBONES[name][1]
    if RECOGNIZERS[name][0] == "Recognizer2D":   # (N, S, H, W, C)
        shape = (2, shape[0] // 2) + shape[1:]
    return _x(seed, shape)


@pytest.mark.parametrize("name", sorted(RECOGNIZERS))
def test_model_matches_jax(name, monkeypatch):
    """Each narrow backbone in its recognizer (``Recognizer3D`` with an
    ``I3DHead``, ``SimpleHead`` or ``SlowFastHead``; PoTion in a
    ``Recognizer2D`` with a ``TSNHead``), against one jitted JAX program
    in float64 (JAX's BatchNorm cast made float64) that takes the eval
    backbone features (both pathways' for SlowFast; the ``feat_ext``
    feature is their mean over every axis but the first and the last),
    the eval logits and one SGD step (Nesterov momentum 0.9,
    weight decay 1e-3, the cosine over two steps, lr 0.2) of JAX's
    ``train_step`` on an ``imgs`` batch (eval only for ``EVAL_ONLY``).
    The port, loaded strictly: in
    float32 the eval features, logits and ``feat_ext`` at 1e-5 of their
    largest (``out_channels`` is the features' width); in float64 the same
    at 1e-8, then its ``train_step``'s loss and every parameter and
    statistic after it at 1e-8, with the same names decayed on both sides
    (``jax_param_names``) and no kernel launched; ``to_bf16_inference``
    (which the ``compute_dtype`` allows, as JAX's) gives float32 logits
    within 2e-2 of the largest."""
    from dsgcn_tpu_torch.apis import to_bf16_inference
    cfg = _recognizer_cfg(name)
    x = _recognizer_input(name, 21)
    label = np.random.default_rng(22).integers(0, 5, x.shape[0])
    jmod = j_build_model(cfg)
    v = _jvars(lambda: jmod.init(jax.random.PRNGKey(0),
                                 jnp.asarray(x, jnp.float32), train=False),
               23)
    _jax_bn_in_float64(monkeypatch)
    with x64():
        tx, _ = j_make_optimizer(lr=0.2, momentum=0.9, weight_decay=1e-3,
                                 nesterov=True, total_steps=2)

        def program(v, x, label):
            feat = jmod.apply(v, x, train=False,
                              method=lambda m, x, train: m.backbone(
                                  x.reshape((-1,) + x.shape[2:])
                                  if m.backbone.__class__.__name__ ==
                                  "PoTion" else x, train=train))
            logits = jmod.apply(v, x, train=False)
            if name in EVAL_ONLY:
                return feat, logits, None, None
            state = TrainState.create(jmod.apply, v["params"],
                                      v["batch_stats"], tx)
            new, m = j_train_step(state, dict(imgs=x, label=label),
                                  jax.random.PRNGKey(0))
            return feat, logits, new, m
        feat, logits, state, m = jax.jit(program)(
            _f64(v), jnp.asarray(x), jnp.asarray(label))
        if state is not None:
            new = convert_jax_variables(jax.tree.map(np.array, {
                "params": state.params,
                "batch_stats": state.batch_stats}))
    feat = feat if isinstance(feat, tuple) else (feat,)
    # the feat_ext feature: each pathway's mean over every axis but the
    # first and the last (for PoTion, its frames' spatial mean, then the
    # segments' mean)
    pooled = np.concatenate([np.asarray(f).reshape(
        x.shape[0], -1, f.shape[-1]).mean(1) for f in feat], -1)
    port = _load(build_model(cfg), v).eval()
    widths = port.backbone.out_channels
    widths = widths if isinstance(widths, tuple) else (widths,)
    for dtype, tol in ((torch.float32, EVAL), (torch.float64, F64)):
        xt = torch.from_numpy(x).to(dtype)
        port.to(dtype)
        with torch.no_grad():
            fb = port.backbone(xt.reshape((-1,) + xt.shape[2:])
                               if name == "potion" else xt)
            fb = fb if isinstance(fb, tuple) else (fb,)
            for g, w, c in zip(fb, feat, widths):
                assert g.shape[-1] == c
                assert_rel(g.numpy(), np.asarray(w), tol, f"{dtype} feat")
            assert_rel(port(xt).numpy(), np.asarray(logits), tol,
                       f"{dtype} logits")
            pf = port(xt, feat_ext=True)
            assert pf.dtype == torch.float32
            assert_rel(pf.numpy(), pooled, max(tol, 1e-7), "feat_ext")
            if dtype == torch.float32 and "c3d" not in name:
                # (the CPU has no bfloat16 avg_pool3d, which C3D takes)
                bf16 = to_bf16_inference(port)(xt)
                assert bf16.dtype == torch.float32
                assert_rel(bf16.numpy(), np.asarray(logits), 2e-2, "bf16")
    if name in EVAL_ONLY:
        return
    names = jax_param_names(port)
    flat = {".".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(
                v["params"])[0]}
    assert set(names.values()) == flat
    opt, sched = make_optimizer(port, total_steps=2, lr=0.2,
                                weight_decay=1e-3)
    before = launch_counts()
    loss = train_step(port, opt, sched, dict(imgs=x, label=label))["loss"]
    np.testing.assert_allclose(loss.item(), float(m["loss"]), rtol=F64)
    assert launch_counts() == before
    sd = port.state_dict()
    assert sd.keys() == new.keys()
    for n, w in new.items():
        assert_rel(sd[n].numpy(), w.numpy(), F64, n)


def test_recognizer2d_refuses_a_3d_backbone():
    """JAX's ``Recognizer2D`` builds over a ``ResNet3d`` and mixes the
    videos (flax reads the folded batch as one volume); the port's refuses
    every backbone that is not 2-D."""
    for bb in (dict(type="ResNet3d", depth=18, num_stages=2,
                    stage_blocks=[1, 1], base_channels=8),
               BACKBONES["x3d_se_swish"][0], BACKBONES["c3d"][0]):
        with pytest.raises(ValueError, match="2-D backbone"):
            build_model(dict(type="Recognizer2D", backbone=bb,
                             cls_head=dict(type="TSNHead", num_classes=3,
                                           in_channels=8)))
    model = build_model(dict(type="Recognizer2D",
                             backbone=BACKBONES["potion"][0],
                             cls_head=dict(type="TSNHead", num_classes=3,
                                           in_channels=16)))
    assert isinstance(model, Recognizer2D)


# ---------------------------------------------------------------------------
# RGBPoseConv3D at its fixed widths
# ---------------------------------------------------------------------------

MM_CFG = dict(type="MMRecognizer3D", backbone=dict(type="RGBPoseConv3D"),
              cls_head=dict(type="RGBPoseHead", num_classes=7,
                            in_channels=[2048, 512], dropout=0.0))
MM_X = ((1, 8, 32, 32, 3), (1, 32, 8, 8, 17))


def test_rgbpose_eval_and_mm_loss_gradient_match_jax():
    """``MMRecognizer3D(RGBPoseConv3D, RGBPoseHead)`` at the backbone's
    fixed widths (38,359,456 parameters) on a (1, 8, 32, 32, 3) clip and
    (1, 32, 8, 8, 17) heatmaps: the eval logits of both streams at 1e-4 of
    the largest, and ``mm_cross_entropy``'s total and parts and its
    gradient at 1e-4 (relative; the gradient at 1e-4 of each parameter's
    largest entry), in float32, through the eval-mode forward: at one
    sample, train-mode BatchNorms of the last rgb stage normalize 8 values
    a channel, which turns float32 rounding of the two convolution
    libraries into gradients 10% apart (the train-mode path is held in
    float64 by the narrow pair's and the recognizers' tests)."""
    xs = [_x(41 + i, s).astype(np.float32) for i, s in enumerate(MM_X)]
    label = np.array([3])
    jmod = j_build_model(MM_CFG)
    jx = [jnp.asarray(x) for x in xs]
    v = _jvars(lambda: jmod.init(jax.random.PRNGKey(0), *jx, train=False),
               42)
    port = _load(build_model(MM_CFG), v)
    assert isinstance(port, MMRecognizer3D)
    assert sum(p.numel() for p in port.backbone.parameters()) == 38359456

    def loss(params, stats):
        out = jmod.apply({"params": params, "batch_stats": stats}, *jx,
                         train=False)
        total, parts = j_mm_cross_entropy(out, jnp.asarray(label),
                                          {"rgb": 1.0, "pose": 0.5})
        return total, (parts, out)
    (jl, (jparts, want)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"], v["batch_stats"])
    grads = convert_jax_variables({"params": jax.tree.map(np.asarray,
                                                          grads)})
    got = port.eval()(*[torch.from_numpy(x) for x in xs])
    for k in ("rgb", "pose"):
        assert_rel(got[k].detach().numpy(), np.asarray(want[k]), 1e-4, k)
    total, parts = mm_cross_entropy(got, torch.from_numpy(label),
                                    {"rgb": 1.0, "pose": 0.5})
    total.backward()
    np.testing.assert_allclose(total.item(), float(jl), rtol=1e-4)
    assert sorted(parts) == sorted(jparts) == ["pose_loss_cls",
                                               "rgb_loss_cls"]
    for k in parts:
        np.testing.assert_allclose(parts[k].item(), float(jparts[k]),
                                   rtol=1e-4)
    for n, p in port.named_parameters():
        assert_rel(p.grad.numpy(), grads[n].numpy(), 1e-4, n)


def test_rgbpose_drop_path_and_detach():
    """Whole-lateral drop-path draws one uniform a lateral from the
    generator, rgb before pose at each exchange, and keeps the lateral
    where it is >= p, unscaled; ``rgb_detach`` stops the gradient that
    the rgb laterals send into the pose pathway."""
    bb = cnns.RGBPoseConv3D(rgb_drop_path=0.5, pose_drop_path=0.5,
                            rgb_detach=True)
    calls = []
    orig = bb._drop

    def spy(lat, p):
        out = orig(lat, p)
        calls.append((p, bool((out == 0).all()), bool(torch.equal(out,
                                                                  lat))))
        return out
    bb._drop = spy
    bb.generator = torch.Generator().manual_seed(5)
    draws = torch.rand(4, generator=torch.Generator().manual_seed(5))
    xs = [torch.from_numpy(_x(51 + i, s)).float()
          for i, s in enumerate(MM_X)]
    xs[1].requires_grad_(True)
    x_rgb, x_pose = bb.train()(*xs)
    assert [c[0] for c in calls] == [0.5] * 4
    for (p, zero, same), u in zip(calls, draws.tolist()):
        assert (same and not zero) if u >= p else (zero and not same)
    # the rgb output reaches the heatmaps only through the (detached) pose
    # features the rgb laterals receive
    x_rgb.sum().backward()
    assert xs[1].grad is None or not xs[1].grad.abs().any()


# ---------------------------------------------------------------------------
# builder, converter, init
# ---------------------------------------------------------------------------

def test_build_model_takes_every_video_model():
    """``build_model`` builds each backbone under its recognizer and each
    head type (JAX's config keys: lists for tuples, SimpleHead's
    ``mode``), and an unknown recognizer is refused."""
    for name in sorted(RECOGNIZERS):
        m = build_model(_recognizer_cfg(name))
        assert isinstance(m, Recognizer2D if name == "potion"
                          else Recognizer3D)
    m = build_model(dict(MM_CFG, compute_dtype="bfloat16"))
    assert m.compute_dtype == torch.bfloat16
    head = build_head(dict(type="I3DHead", num_classes=5, in_channels=6,
                           mode="3D"))
    assert isinstance(head, build_head(HEADS["simple"][0]).__class__)
    with pytest.raises(NotImplementedError, match="RecognizerFoo"):
        build_model(dict(type="RecognizerFoo", backbone=BACKBONES["c3d"][0],
                         cls_head=dict(type="I3DHead", num_classes=3,
                                       in_channels=32)))


def _flax_fan_out(shape):
    """flax's ``variance_scaling`` fan_out of a kernel shape (the output
    features times the receptive field), for Conv and ConvTranspose."""
    return shape[-1] * int(np.prod(shape[:-2]))


def test_init_draws_follow_jax_moments():
    """``init_weights_`` on X3D (grouped convs, SE's biased convs, the
    BatchNorm-less stem, zero-gamma projections), PoTion's 2-D convs, the
    pathway pair's forward and transposed laterals and the three heads:
    each conv kernel's mean square within 25% of flax's ``variance_scaling
    (2, 'fan_out', 'normal')`` variance over its JAX shape (each has 1,000+
    entries; pooled over a model, within 5%), SE biases 0, zero-gamma
    scales 0 and other scales 1, head weights std 0.01 and zero biases."""
    gen = torch.Generator().manual_seed(0)
    specs = [
        (build_backbone(BACKBONES["x3d_se_swish"][0]),
         j_build_backbone(BACKBONES["x3d_se_swish"][0]),
         (jnp.zeros(BACKBONES["x3d_se_swish"][1]),)),
        (build_backbone(dict(BACKBONES["potion"][0], channels=[32, 64])),
         j_build_backbone(dict(BACKBONES["potion"][0], channels=[32, 64])),
         (jnp.zeros(BACKBONES["potion"][1]),)),
        (_PortPair(), _JaxPair(), tuple(jnp.zeros(s) for s in PAIR_X)),
    ]
    for port, jmod, args in specs:
        init_weights_(port, gen)
        shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                                  *args, train=False))
        sd = convert_jax_variables(jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), dict(shapes)))
        flat = dict(jax.tree_util.tree_flatten_with_path(
            shapes["params"])[0])
        ratios, sizes = [], []
        for path, s in flat.items():
            keys = [k.key for k in path]
            if keys[-1] != "kernel":
                continue
            name = ".".join(keys[:-1]) + ".weight"
            w = port.state_dict()[name].double()
            assert w.shape == sd[name].shape, name
            var = 2.0 / _flax_fan_out(s.shape)
            r = (w ** 2).mean().item() / var
            if w.numel() >= 1000:
                assert abs(r - 1) < 0.25, (name, r)
            ratios.append(r * w.numel())
            sizes.append(w.numel())
        assert abs(sum(ratios) / sum(sizes) - 1) < 0.05
        for name, t in port.state_dict().items():
            if ".se_module." in name and name.endswith("bias"):
                assert not t.any(), name
    x3d = specs[0][0]
    for name, m in x3d.named_modules():
        if isinstance(m, cnns.ConvBN3d):
            if not m.with_bn:
                assert name == "conv1_s" and not hasattr(m, "running_mean")
            elif name.endswith("conv3"):
                assert not m.weight.any(), name
            else:
                assert bool((m.weight == 1).all()), name
    for cfg, _ in HEADS.values():
        head = build_head(cfg)
        init_weights_(head, gen)
        for n, p in head.named_parameters():
            if n.endswith("bias"):
                assert not p.any(), n
            else:
                assert abs(p.std().item() / 0.01 - 1) < 0.5, n
    big = build_head(dict(type="RGBPoseHead", num_classes=60,
                          in_channels=[2048, 512]))
    init_weights_(big, gen)
    for fc in (big.fc_rgb, big.fc_pose):
        assert abs(fc.weight.std().item() / 0.01 - 1) < 0.05


def test_data_parallel_stats_skip_the_batchnorm_less_stem():
    """The data-parallel step's statistics (``running_stats``) take every
    ``ConvBN3d`` that keeps a BatchNorm, and X3D's ``conv1_s`` keeps
    none."""
    from dsgcn_tpu_torch.parallel.train import running_stats
    model = build_backbone(BACKBONES["x3d_se_swish"][0])
    with_bn = [m for m in model.modules()
               if isinstance(m, cnns.ConvBN3d) and m.with_bn]
    assert len(running_stats(model)) == 2 * len(with_bn)
    assert math.isclose(len(with_bn) + 1, sum(
        isinstance(m, cnns.ConvBN3d) for m in model.modules()))


def test_train_and_test_cli_on_a_recognizer3d(tmp_path, capsys, one_thread):
    """A narrow X3D ``Recognizer3D`` in place of the PoseC3D config's model
    (``test_torch_port_posec3d._cli_config``'s narrow pipelines): the
    train CLI steps on the heatmap ``imgs`` (the nc = 1 axis dropped by
    ``squeeze_clip``), validates and checkpoints; the test CLI scores the
    val split (2 clips averaged) in float32 and with ``--bf16`` (its
    ``compute_dtype``: float32 scores within 2e-2 of float32's), and the
    feature flags refuse it, as JAX's ``extract_pooled_feat`` takes GCN
    features only."""
    from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
    from dsgcn_tpu_torch.tools import test as test_cli
    from dsgcn_tpu_torch.tools import train as train_cli
    from test_torch_port_posec3d import _cli_config
    ann = tmp_path / "synth.pkl"
    make_synthetic_pose_dataset(num_samples=8, num_classes=5, t=20, seed=19,
                                layout="coco", path=str(ann))
    model = dict(type="Recognizer3D", backbone=dict(
        BACKBONES["x3d_se_swish"][0], in_channels=17),
        cls_head=dict(type="I3DHead", num_classes=5, in_channels=36),
        _delete_=True)
    cfg = tmp_path / "x3d.py"
    cfg.write_text(f"_base_ = ['{_cli_config(tmp_path, ann)}']\n"
                   f"model = {model!r}\n")
    wd = str(tmp_path / "wd")
    trainer = train_cli.main([str(cfg), "--work-dir", wd, "--total-epochs",
                              "1", "--device", "cpu", "--test-last"])
    assert isinstance(trainer.model, Recognizer3D) and trainer.step == 3
    assert "final: {" in capsys.readouterr().out
    scores = {}
    for extra in ([], ["--bf16"]):
        pkl = str(tmp_path / f"scores{len(extra)}.pkl")
        test_cli.main([str(cfg), wd, "--out", pkl, "--device", "cpu"]
                      + extra)
        assert "top1_acc: " in capsys.readouterr().out
        with open(pkl, "rb") as f:
            scores[len(extra)] = pickle.load(f)["scores"]
    assert scores[0].shape == (2, 5)
    assert_rel(scores[1], scores[0], 2e-2, "bf16 scores")
    with pytest.raises(NotImplementedError, match="RecognizerGCN"):
        test_cli.main([str(cfg), wd, "--feat-ext", "--device", "cpu"])
