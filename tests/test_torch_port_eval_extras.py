"""Port parity, feature extraction and the evaluation extras:
``models/recognizer.py:extract_pooled_feat`` (every ``pool_opt``, with and
without ``score_ext``), the test CLI's ``--feat-ext``, ``--score-ext`` and
``--pool-opt``, the metrics (``confusion_matrix(normalize=)``, the
precision-recall curve, mAP, ``per_class_graph``, ``evaluate``'s names and
multi-head recursion), ``utils/analysis.py:tsne_map`` and
``core/losses.py:bce_with_logits`` of ``dsgcn_tpu_torch`` against
``dsgcn_tpu`` on the CPU.

The model is a narrow DS-GCN (two blocks of 16 channels); its JAX
variables are drawn with ``jax.eval_shape`` + numpy and converted.  JAX's
``extract_pooled_feat`` runs on the JAX backbone's features (jitted once)
through a stand-in model whose ``backbone.apply`` returns them, so every
pooling runs JAX's own code without a recompile.  Tolerances: features
1e-5 (``MODULE_TOL``); the CLI's float16 dump within 1e-3 of the largest
feature; metrics 1e-12; a short t-SNE 1e-6 (float64 on both sides); the
loss 1e-6.
"""
import pickle
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.configs.config import Config as JConfig
from dsgcn_tpu.core import losses as jlosses
from dsgcn_tpu.core import metrics as jmetrics
from dsgcn_tpu.data import dataset as JD
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu.models.recognizer import \
    extract_pooled_feat as j_extract_pooled_feat
from dsgcn_tpu.utils.analysis import tsne_map as j_tsne_map
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.core import losses, metrics
from dsgcn_tpu_torch.core.checkpoint import CheckpointManager
from dsgcn_tpu_torch.core.train import make_optimizer
from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
from dsgcn_tpu_torch.models.builder import build_model, model_cfg
from dsgcn_tpu_torch.models.recognizer import extract_pooled_feat
from dsgcn_tpu_torch.tools import test as test_cli
from dsgcn_tpu_torch.utils.analysis import tsne_map
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _variables
from test_torch_port_model import MODULE_TOL, _load
from test_torch_port_test_cli import NTU, _printed, one_thread  # noqa: F401

NARROW = dict(num_stages=2, base_channels=16, inflate_stages=(),
              down_stages=())


def _stand_in(jmodel, feats):
    """A model for JAX's extract_pooled_feat whose backbone returns
    ``feats`` (JAX's backbone features of the input)."""
    return types.SimpleNamespace(backbone=types.SimpleNamespace(
        apply=lambda v, x, train: feats), head=jmodel.head)


@pytest.fixture(scope="module")
def dsgcn():
    """(port model, JAX model, variables, input, JAX backbone features)."""
    j, t = (f("dsgcn", num_classes=5) for f in (j_model_cfg, model_cfg))
    for c in (j, t):
        c["backbone"].update(NARROW)
        c["cls_head"]["in_channels"] = 16
    jmodel = j_build_model(j)
    x = np.random.default_rng(50).standard_normal(
        (3, 2, 12, 25, 3)).astype(np.float32)
    v = _variables(jmodel, x, seed=51)
    feats = jax.jit(lambda vv, xx: jmodel.backbone.apply(
        {"params": vv["params"]["backbone"],
         "batch_stats": vv["batch_stats"]["backbone"]}, xx, train=False))(
            v, jnp.asarray(x))
    return _load(build_model(t), v), jmodel, v, x, feats


@pytest.mark.parametrize("score_ext", [False, True])
@pytest.mark.parametrize("pool_opt", ["nmtv", "tv", "mt", "n", "none"])
def test_extract_pooled_feat_matches_jax(dsgcn, pool_opt, score_ext):
    """The pooled features or per-location scores, with the model's mode
    put back (a model in training stays in training)."""
    port, jmodel, v, x, feats = dsgcn
    port.train()
    got = extract_pooled_feat(port, torch.from_numpy(x), pool_opt, score_ext)
    assert port.training
    want = j_extract_pooled_feat(_stand_in(jmodel, feats), v, jnp.asarray(x),
                                 pool_opt, score_ext)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)


def _cli_config(tmp, ann):
    """The DS-GCN j config at two blocks of 16 channels, 5 classes, its
    test split (3 videos, 10 clips each) in one batch."""
    path = tmp / "j.py"
    path.write_text(
        f"_base_ = ['{NTU}/j.py']\n"
        "model = dict(backbone=dict(num_stages=2, base_channels=16,\n"
        "                           inflate_stages=[], down_stages=[]),\n"
        "             cls_head=dict(num_classes=5, in_channels=16))\n"
        "data = dict(workers_per_gpu=0,\n"
        "            test_dataloader=dict(videos_per_gpu=3),\n"
        f"            test=dict(ann_file='{ann}', split='val'))\n")
    return str(path)


def test_test_cli_feature_flags_match_jax(tmp_path, capsys, one_thread):
    """``--feat-ext --pool-opt all``, ``--pool-opt tv`` and ``--score-ext``
    from a checkpoint of the port's trainer (JAX's variables, converted):
    the float16 dump against JAX's CLI loop (tools/test.py:99-118: clips
    folded, pooled without 'n', the clip axis averaged for 'n') on the
    same batches within 1e-3 of the largest feature, the same labels, and
    the TSNEmap and graph lines of JAX's metrics on the dump."""
    ann = tmp_path / "synth.pkl"
    make_synthetic_pose_dataset(num_samples=12, num_classes=5, t=40, seed=3,
                                path=str(ann))
    cfg = _cli_config(tmp_path, ann)
    jcfg = JConfig.fromfile(cfg)
    jmodel = j_build_model(jcfg["model"])
    batch = next(JD.Loader(JD.build_dataset(jcfg["data"]["test"],
                                            test_mode=True),
                           batch_size=3, shuffle=False,
                           num_workers=0).epoch(0))
    kp = batch["keypoint"]                          # (3, 10, 2, 60, 25, 3)
    folded = jnp.asarray(kp.reshape((-1,) + kp.shape[2:]))
    v = _variables(jmodel, np.asarray(folded[:1]), seed=52)
    feats = jax.jit(lambda vv, xx: jmodel.backbone.apply(
        {"params": vv["params"]["backbone"],
         "batch_stats": vv["batch_stats"]["backbone"]}, xx, train=False))(
            v, folded)
    port = build_model(Config.fromfile(cfg)["model"])
    port.load_state_dict(convert_jax_variables(v), strict=True)
    opt, sched = make_optimizer(port, total_steps=1)
    wd = tmp_path / "wd"
    CheckpointManager(str(wd)).save(1, port, opt, sched, epoch=1)
    for flags, pool, score in ((["--feat-ext", "--pool-opt", "all"], "nmtv",
                                False),
                               (["--feat-ext", "--pool-opt", "tv"], "tv",
                                False),
                               (["--score-ext"], "nmtv", True)):
        out = str(tmp_path / "f.pkl")
        test_cli.main([cfg, str(wd), *flags, "--out", out, "--device", "cpu",
                       "--metrics", "TSNEmap", "graph"])
        printed = capsys.readouterr().out
        with open(out, "rb") as f:
            d = pickle.load(f)
        per_clip = "".join(c for c in pool if c != "n")
        want = np.asarray(j_extract_pooled_feat(
            _stand_in(jmodel, feats), v, folded, per_clip, score), np.float32)
        want = want.reshape((3, 10) + want.shape[1:])
        if "n" in pool:
            want = want.mean(axis=1)
        assert d["features"].dtype == np.float16
        assert d["features"].shape == want.shape
        err = np.abs(d["features"].astype(np.float32) - want).max()
        assert err <= 1e-3 * np.abs(want).max(), err
        assert d["labels"] == batch["label"].tolist()
        flat = d["features"].reshape(3, -1).astype(np.float32)
        emb = jmetrics.evaluate(flat, np.asarray(d["labels"]),
                                ("TSNEmap",))["TSNEmap"]
        assert _printed(printed, "TSNEmap") == f"embedding {emb.shape}"
        per_cls = jmetrics.evaluate(d["features"].astype(np.float32),
                                    np.asarray(d["labels"]),
                                    ("graph",))["graph"]
        assert _printed(printed, "graph") == (
            f"{len(per_cls)} per-class means of shape {per_cls[0].shape}")


# ---------------------------------------------------------------------------
# metrics, t-SNE, the loss
# ---------------------------------------------------------------------------

def _scores(seed, n=40, k=6):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, k)), rng.integers(0, k, n)


@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
def test_confusion_matrix_matches_jax(normalize):
    s, labels = _scores(53)
    pred = s.argmax(1)
    pred[:3] = 7                                   # a class no label has
    np.testing.assert_allclose(
        metrics.confusion_matrix(pred, labels, normalize),
        jmetrics.confusion_matrix(pred, labels, normalize), rtol=1e-12)
    with pytest.raises(ValueError, match="normalize"):
        metrics.confusion_matrix(pred, labels, "rows")


def test_precision_recall_and_map_match_jax():
    rng = np.random.default_rng(54)
    scores = rng.standard_normal((30, 5))
    scores[:4, 0] = scores[4:8, 0] = 0.5           # tied scores
    labels = (rng.random((30, 5)) < 0.3).astype(int)
    labels[:, 4] = 0                               # a class without positives
    for c in range(5):
        for g, w in zip(metrics.binary_precision_recall_curve(
                scores[:, c], labels[:, c]),
                jmetrics.binary_precision_recall_curve(
                    scores[:, c], labels[:, c])):
            np.testing.assert_allclose(g, w, rtol=1e-12)
    assert metrics.mean_average_precision(scores, labels) == pytest.approx(
        jmetrics.mean_average_precision(scores, labels), abs=1e-12)


def test_evaluate_names_and_recursion_match_jax():
    """Every name of JAX's METRICS (TSNEmap on the CPU), the array-valued
    ones equal, and multi-head results per position with _i keys."""
    assert sorted(metrics.METRICS) == sorted(jmetrics.METRICS)
    s, labels = _scores(55, n=24)
    names = ["top_k_accuracy", "mean_class_accuracy", "confusion_matrix",
             "graph", "TSNEmap"]
    got = metrics.evaluate(s, labels, names, device="cpu")
    want = jmetrics.evaluate(s, labels, names)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "graph":
            assert len(got[k]) == len(want[k]) == labels.max()
            for g, w in zip(got[k], want[k]):
                np.testing.assert_allclose(g, w, rtol=1e-12)
        elif k == "TSNEmap":    # its values: the float64 test below
            assert got[k].shape == want[k].shape == (24, 2)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    multi = [(a, b) for a, b in zip(s, s[::-1])]
    got = metrics.evaluate(multi, labels, ["top_k_accuracy"])
    want = jmetrics.evaluate(multi, labels, ["top_k_accuracy"])
    assert got == pytest.approx(want, abs=1e-12)
    ml = (np.random.default_rng(56).random((24, 6)) < 0.4).astype(int)
    assert metrics.evaluate(s, ml, ["mean_average_precision"]) == \
        pytest.approx(jmetrics.evaluate(s, ml, ["mean_average_precision"]))
    with pytest.raises(KeyError, match="unknown metrics"):
        metrics.evaluate(s, labels, ["top1"])


def test_tsne_map_matches_jax_in_float64():
    """A short run on the CPU (N = 30, 20 iterations of the early
    exaggeration) within 1e-6 of JAX's numpy.  Longer runs part: the
    iteration is chaotic at this learning rate, and the two libraries'
    rounding (6.8e-8 relative after 20 iterations) grows to order one by
    50; the full run is held by what it does (the next test)."""
    x = np.random.default_rng(57).standard_normal((30, 8))
    got = tsne_map(x, n_iter=20, device="cpu")
    want = j_tsne_map(x, n_iter=20)
    assert got.dtype == np.float32 and got.shape == (30, 2)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_tsne_map_separates_clusters():
    """The full default run on three well-apart clusters: each point's
    nearest neighbour in the map is of its own cluster."""
    rng = np.random.default_rng(58)
    centers = rng.standard_normal((3, 16)) * 10
    lab = np.repeat(np.arange(3), 20)
    x = centers[lab] + rng.standard_normal((60, 16))
    y = tsne_map(x, device="cpu")
    d = ((y[:, None] - y[None]) ** 2).sum(-1)
    np.fill_diagonal(d, np.inf)
    assert (lab[d.argmin(1)] == lab).all()


def test_tsne_needs_a_device_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsne_map(np.zeros((4, 3)))


@pytest.mark.parametrize("weighted", [False, True])
def test_bce_with_logits_matches_jax(weighted):
    rng = np.random.default_rng(59)
    s = rng.standard_normal((8, 5)) * 4
    y = (rng.random((8, 5)) < 0.5).astype(np.float64)
    w = rng.random(5) if weighted else None
    got = losses.bce_with_logits(torch.from_numpy(s), torch.from_numpy(y),
                                 None if w is None else torch.from_numpy(w),
                                 loss_weight=0.7)
    jax.config.update("jax_enable_x64", True)
    try:
        want = jlosses.bce_with_logits(jnp.asarray(s), jnp.asarray(y),
                                       None if w is None else jnp.asarray(w),
                                       loss_weight=0.7)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert got.item() == pytest.approx(float(want), rel=1e-6)
