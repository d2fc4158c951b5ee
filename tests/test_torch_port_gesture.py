"""The gesture config in the port: ``GestureDataset`` and
``ConcatDataset``, ``configs/gesture/stgcnpp_hand.py`` (STGCN++ on the
21-joint MediaPipe hand, 2D, 40 classes) and its CLIs, against
``dsgcn_tpu`` on the CPU.

The data is a synthetic pickle built like ``tests/test_gesture.py``'s: a
split dict, hands with leading empty frames, ``valid_frames``,
``hand_score`` and ``hand_lr``.  JAX's datasets and pipelines are numpy
only.  Tolerances: the pipeline within 1e-5 (both normalize in float32);
full-width logits within 1e-5 of the largest (float32, the same sums in
another order).
"""
import json
import pathlib
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.configs.config import Config as JConfig
from dsgcn_tpu.data import dataset as JD
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.data import dataset as D
from dsgcn_tpu_torch.data.transforms import build_pipeline
from dsgcn_tpu_torch.models.builder import build_model
from dsgcn_tpu_torch.tools import fuse_scores as fuse_cli
from dsgcn_tpu_torch.tools import test as test_cli
from dsgcn_tpu_torch.tools import train as train_cli
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _variables
from test_torch_port_family_configs import _printed, one_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(REPO / "configs" / "gesture" / "stgcnpp_hand.py")


def _gesture_pickle(path, n=16, t=16, seed=3):
    """``n`` one-hand clips of ``t`` frames (x, y, score), each with 3
    leading empty frames (scores 0), labels cycling over 4 of the 40
    classes; splits train 6, val 3, test the rest."""
    rng = np.random.default_rng(seed)
    annos, names = [], []
    for i in range(n):
        name = f"clip{i:03d}"
        kp = rng.standard_normal((1, t, 21, 3)).astype(np.float32)
        kp[..., 2] = rng.uniform(0.2, 1.0, (1, t, 21))
        kp[0, :3, :, 2] = 0.0
        annos.append(dict(
            frame_dir=name, label=i % 4, keypoint=kp, total_frames=t,
            hand_score=rng.uniform(size=(1, t)).astype(np.float32),
            hand_lr=np.zeros((1, t), np.int64), valid_frames=t - 3 - i % 3))
        names.append(name)
    with open(path, "wb") as f:
        pickle.dump(dict(split=dict(train=names[:6], val=names[6:9],
                                    test=names[9:]), annotations=annos), f)
    return str(path)


@pytest.fixture(scope="module")
def gesture_pkl(tmp_path_factory):
    return _gesture_pickle(tmp_path_factory.mktemp("gesture") / "g.pkl")


def _pipe(split="test"):
    return Config.fromfile(CONFIG)["data"][split]["pipeline"]


def _same_infos(ours, ref):
    assert len(ours.video_infos) == len(ref.video_infos)
    for a, b in zip(ours.video_infos, ref.video_infos):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize("kw", [
    dict(split="train"), dict(split="train+val"), dict(split="test"),
    dict(split="train", valid_frames_thr=12),
    dict(split="train+val", subset=[0, 1]),
    dict(split="val", squeeze=False, mode="3D")],
    ids=["train", "train+val", "test", "valid_frames_thr", "subset",
         "no-squeeze-3d"])
def test_gesture_dataset_matches_jax(gesture_pkl, kw):
    """The split union, ``valid_frames_thr`` (train splits only), the
    empty-frame squeeze with ``total_frames``, ``hand_score`` and
    ``hand_lr``, the 2D slice and ``subset``: the same annos as JAX's, the
    same samples through the test pipeline, the same labels."""
    ours = D.GestureDataset(gesture_pkl, _pipe(), test_mode=True, **kw)
    ref = JD.GestureDataset(gesture_pkl, _pipe(), test_mode=True, **kw)
    _same_infos(ours, ref)
    np.testing.assert_array_equal(ours.labels, ref.labels)
    if kw.get("mode", "2D") == "2D":
        for i in (0, len(ours) - 1):
            a, b = ours.prepare(i), ref.prepare(i)
            assert a["keypoint"].shape == (1, 1, 10, 21, 2)
            np.testing.assert_allclose(a["keypoint"], b["keypoint"],
                                       rtol=1e-5, atol=1e-5)
            assert a["label"] == b["label"]


def test_gesture_dataset_squeezes_and_evaluates(gesture_pkl):
    """The squeeze drops the three empty frames; ``evaluate`` gives JAX's
    top-1, top-5 and per-class top-1 over the 40 gesture names."""
    ours = D.GestureDataset(gesture_pkl, _pipe(), split="test",
                            test_mode=True)
    ref = JD.GestureDataset(gesture_pkl, _pipe(), split="test",
                            test_mode=True)
    item = ours.video_infos[0]
    assert item["keypoint"].shape == (1, 13, 21, 2)
    assert item["total_frames"] == 13 and item["hand_lr"].shape == (1, 13)
    assert D.GESTURE_LABEL_NAMES == JD.GESTURE_LABEL_NAMES
    assert len(D.GESTURE_LABEL_NAMES) == 40
    scores = np.random.default_rng(5).standard_normal((len(ours), 40))
    assert ours.evaluate(scores) == ref.evaluate(scores)
    right = np.eye(40)[ours.labels]
    res = ours.evaluate(right)
    assert res["top1_acc"] == res["top5_acc"] == 1.0
    assert set(res["per_class"]) == {D.GESTURE_LABEL_NAMES[i]
                                     for i in range(4)}


def test_build_dataset_dispatches_gesture_and_concat(gesture_pkl, tmp_path):
    """``build_dataset`` builds ``GestureDataset`` and ``ConcatDataset``
    (JAX data/dataset.py:406-415): a concat of the gesture test split and
    an NTU-shaped PoseDataset yields JAX's samples at every index."""
    ntu = str(tmp_path / "ntu.pkl")
    D.make_synthetic_pose_dataset(num_samples=4, num_classes=5, t=30,
                                  path=ntu)
    ntu_pipe = Config.fromfile(str(REPO / "configs" / "stgcnpp" /
                                   "ntu60_xsub_3dkp" / "j.py"))["data"][
        "test"]["pipeline"]
    cfg = dict(type="ConcatDataset", datasets=[
        dict(type="GestureDataset", ann_file=gesture_pkl, pipeline=_pipe(),
             split="test"),
        dict(type="PoseDataset", ann_file=ntu, pipeline=ntu_pipe,
             split="train")])
    ours = D.build_dataset(cfg, test_mode=True)
    ref = JD.build_dataset(cfg, test_mode=True)
    assert isinstance(ours, D.ConcatDataset)
    assert isinstance(ours.datasets[0], D.GestureDataset)
    assert len(ours) == len(ref) == 7 + 3
    np.testing.assert_array_equal(ours.labels, ref.labels)
    for i in range(len(ours)):
        a, b = ours.prepare(i), ref.prepare(i)
        np.testing.assert_allclose(a["keypoint"], b["keypoint"], rtol=1e-5,
                                   atol=1e-5)


def test_gesture_config_reads_as_jax():
    """The config, both pipelines built, and the model: STGCN on 'handmp'
    (V = 21), 2 input channels, six blocks (the stem and stride 2 at the
    sixth), 40 classes, 197,478 parameters."""
    cfg, jcfg = Config.fromfile(CONFIG), JConfig.fromfile(CONFIG)
    assert cfg["model"] == jcfg["model"]
    assert cfg["data"] == jcfg["data"]
    for split in ("train", "test"):
        build_pipeline(cfg["data"][split]["pipeline"])
    model = build_model(cfg["model"])
    assert model.backbone.num_blocks == 6
    assert sum(p.numel() for p in model.parameters()) == 197_478


def test_gesture_model_matches_jax(gesture_pkl):
    """Full width: JAX's variables load strictly, and a batch of the test
    pipeline's clips (with and without K7's plain version,
    ``tcn_use_pallas``) gives JAX's logits within 1e-5 of the largest."""
    cfg = Config.fromfile(CONFIG)
    ds = D.GestureDataset(gesture_pkl, cfg["data"]["test"]["pipeline"],
                          split="train+val", test_mode=True)
    x = np.concatenate([ds.prepare(i)["keypoint"] for i in range(4)])
    assert x.shape == (4, 1, 10, 21, 2)
    jmodel = j_build_model(cfg["model"])
    v = _variables(jmodel, x, seed=60)
    want = np.asarray(jax.jit(lambda vv, xx: jmodel.apply(
        vv, xx, train=False))(v, jnp.asarray(x)))
    for k7 in (False, True):
        mcfg = dict(cfg["model"])
        mcfg["backbone"] = dict(mcfg["backbone"], tcn_use_pallas=k7)
        model = build_model(mcfg)
        model.load_state_dict(convert_jax_variables(v), strict=True)
        with torch.no_grad():
            got = model.eval()(torch.from_numpy(x)).numpy()
        assert got.shape == (4, 40)
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= 1e-5, (k7, err)


def test_gesture_train_test_and_fuse(gesture_pkl, tmp_path, capsys,
                                     one_thread):  # noqa: F811
    """The committed config at full width on the synthetic pickle, 4 clips
    a batch: one epoch of 'train+val' through the train CLI for two seeds,
    the 'test' split through the test CLI for each, and the two seeds'
    scores through the fusion CLI, equal to the numpy sum."""
    cfg = tmp_path / "gesture.py"
    cfg.write_text(
        f"_base_ = ['{CONFIG}']\n"
        "data = dict(videos_per_gpu=4, workers_per_gpu=0,\n"
        "            test_dataloader=dict(videos_per_gpu=4),\n"
        f"            train=dict(ann_file='{gesture_pkl}'),\n"
        f"            test=dict(ann_file='{gesture_pkl}'))\n")
    pkls = []
    for seed in (1, 2):
        wd = tmp_path / f"wd{seed}"
        trainer = train_cli.main([str(cfg), "--work-dir", str(wd),
                                  "--total-epochs", "1", "--device", "cpu",
                                  "--seed", str(seed)])
        assert trainer.step == 2              # 9 clips, batches of 4
        assert trainer.val_loader is None     # the config has no val split
        records = [json.loads(line) for f in wd.glob("*.log.jsonl")
                   for line in f.read_text().splitlines()]
        assert all(np.isfinite(r["loss"]) for r in records
                   if r.get("mode") == "train")
        out = str(tmp_path / f"s{seed}.pkl")
        test_cli.main([str(cfg), str(wd), "--out", out, "--device", "cpu"])
        assert 0 <= float(_printed(capsys.readouterr().out, "top1_acc")) <= 1
        with open(out, "rb") as f:
            d = pickle.load(f)
        assert d["scores"].shape == (7, 40)
        assert np.isfinite(d["scores"]).all()
        pkls.append(d)
    fused, labels, _ = fuse_cli.main([str(tmp_path / "s1.pkl"),
                                      str(tmp_path / "s2.pkl"),
                                      "--device", "cpu"])
    np.testing.assert_array_equal(fused, pkls[0]["scores"]
                                  + pkls[1]["scores"])
    assert labels == pkls[0]["labels"] == [i % 4 for i in range(9, 16)]
