"""Port parity, the four streams and the 2D pipelines: the bone and motion
transforms, ``GenSkeFeat``'s streams, ``PreNormalize2D``,
``DecompressPose``, ``PoseCompact``, the COCO synthetic dataset, and the
train, val and test pipelines of every committed DS-GCN config
(``configs/dsgcn/*/{j,b,jm,bm}.py``) of ``dsgcn_tpu_torch`` against
``dsgcn_tpu``.

Numpy on both sides, no JAX: ``dsgcn_tpu/data/transforms.py``,
``pose_aug.py``, ``dataset.py`` and ``configs/config.py`` import only
numpy.  Every comparison is exact (``assert_array_equal``): the same numpy
arithmetic on the same inputs.  Both ``PreNormalize3D``s are asked for
their numpy path (``use_native=False``); the native paths are held to each
other in ``tests/test_torch_port_data_extras.py``.
"""
import copy
import pathlib
import pickle

import numpy as np
import pytest

from dsgcn_tpu.configs.config import Config as JConfig
from dsgcn_tpu.data import dataset as JD
from dsgcn_tpu.data import pose_aug as JP
from dsgcn_tpu.data import transforms as JT
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.data import dataset as D
from dsgcn_tpu_torch.data import pose_aug as P
from dsgcn_tpu_torch.data import transforms as T

REPO = pathlib.Path(__file__).resolve().parents[1]
FEATS = ["j", "b", "jm", "bm", ["j", "b"]]


def _same(ours, ref):
    assert sorted(ours) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
        else:
            assert ours[k] == ref[k], k


def _both(make, anno):
    """(port, JAX) results of the transform ``make`` builds from each
    module, on copies of ``anno``."""
    return [make(mod)(copy.deepcopy(anno)) for mod in (T, JT)]


def _dense(layout, c, seed=0, t=12):
    """A dense anno: NTU xyz (V 25) or hrnet pixels (V 17) with or without
    the score as a third channel."""
    rng = np.random.default_rng(seed)
    if layout == "nturgb+d":
        kp = rng.standard_normal((2, t, 25, c))
    else:
        kp = rng.standard_normal((2, t, 17, c)) * 80 + 500
        if c == 3:
            kp[..., 2] = rng.uniform(0.3, 1.0, (2, t, 17))
    kp = kp.astype(np.float32)
    kp[1, t // 2:] = 0
    return dict(keypoint=kp, total_frames=t, label=1)


# ---------------------------------------------------------------------------
# the stream transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout,c", [("nturgb+d", 3), ("coco", 2),
                                      ("coco", 3)])
def test_joint_to_bone_and_motion_match_jax(layout, c):
    anno = _dense(layout, c)
    _same(*_both(lambda m: m.JointToBone(dataset=layout, target="b"), anno))
    _same(*_both(lambda m: m.ToMotion(dataset=layout), anno))
    assert T.BONE_PAIRS == JT.BONE_PAIRS


@pytest.mark.parametrize("feats", FEATS, ids=str)
@pytest.mark.parametrize("layout,score", [("nturgb+d", False),
                                          ("coco", False), ("coco", True)])
def test_gen_ske_feat_matches_jax(layout, score, feats):
    """Every stream and the pair ['j', 'b']; a 2D anno's keypoint_score
    joins as the third channel first."""
    anno = _dense(layout, 3 if layout == "nturgb+d" else 2)
    if score:
        anno["keypoint_score"] = np.random.default_rng(4).uniform(
            0.3, 1, anno["keypoint"].shape[:-1]).astype(np.float32)
    feats = [feats] if isinstance(feats, str) else feats
    ours, ref = _both(lambda m: m.GenSkeFeat(dataset=layout, feats=feats),
                      anno)
    _same(ours, ref)
    c = anno["keypoint"].shape[-1] + score
    assert ours["keypoint"].shape[-1] == c * len(feats)


def test_motion_keeps_the_last_frame_zero_and_means_scores():
    anno = _dense("coco", 3)
    kp = anno["keypoint"]
    m = T.ToMotion(dataset="coco")(copy.deepcopy(anno))["motion"]
    assert not m[:, -1].any()
    np.testing.assert_array_equal(m[:, :-1, :, :2],
                                  np.diff(kp[..., :2], axis=1))
    np.testing.assert_array_equal(m[:, :-1, :, 2],
                                  (kp[:, :-1, :, 2] + kp[:, 1:, :, 2]) / 2)


@pytest.mark.parametrize("kw", [dict(), dict(img_shape=(480, 640)),
                                dict(mode="auto", threshold=0.01),
                                dict(mode="auto", threshold=1e3)])
def test_prenormalize2d_matches_jax(kw):
    """'fix' by the anno's img_shape and by the transform's own; 'auto'
    with keypoints over the threshold and with none over it."""
    anno = _dense("coco", 2)
    if "img_shape" not in kw and "mode" not in kw:
        anno["img_shape"] = (720, 1280)
    _same(*_both(lambda m: m.PreNormalize2D(**kw), anno))
    with pytest.raises(ValueError):
        T.PreNormalize2D(mode="other")


@pytest.mark.parametrize("squeeze,max_person", [(True, 10), (False, 10),
                                                (True, 2), (False, 1)])
def test_decompress_pose_matches_jax(squeeze, max_person):
    """squeeze renumbers the frames with a pose; above max_person the
    bodies of each frame are ordered by score and cut."""
    anno = D.make_compressed_pose_anno(seed=3, t=30, max_per_frame=4)
    ours, ref = _both(lambda m: m.DecompressPose(squeeze=squeeze,
                                                 max_person=max_person), anno)
    _same(ours, ref)
    assert ours["keypoint"].dtype == np.float16
    assert ours["keypoint"].shape[0] == min(4, max_person)
    if squeeze:
        assert ours["total_frames"] < 30     # frames without a pose dropped


def test_decompress_pose_takes_anno_inds_and_rng():
    anno = D.make_compressed_pose_anno(seed=4, t=20)
    anno["anno_inds"] = np.arange(0, len(anno["frame_inds"]), 2)
    ours, ref = _both(lambda m: m.DecompressPose(), anno)
    _same(ours, ref)
    assert not T.DecompressPose.randomized
    T.DecompressPose()(copy.deepcopy(anno), rng=np.random.RandomState(0))


@pytest.mark.parametrize("hw_ratio", [1.0, None])
@pytest.mark.parametrize("allow_imgpad", [True, False])
def test_pose_compact_matches_jax(hw_ratio, allow_imgpad):
    """On a decoded compressed anno (zero joints stay zero), and on one
    whose extent is under the threshold (no change)."""
    anno = D.make_compressed_pose_anno(seed=5, t=16)
    anno = T.PoseDecode()(T.UniformSampleFrames(8, test_mode=True)(
        T.DecompressPose()(anno)))
    anno["keypoint"][0, :2, :3] = 0
    for a in (anno, dict(anno, keypoint=np.full((1, 4, 17, 2), 7.0,
                                                np.float32))):
        ours, ref = [mod.PoseCompact(hw_ratio=hw_ratio,
                                     allow_imgpad=allow_imgpad)(
            copy.deepcopy(a)) for mod in (P, JP)]
        _same(ours, ref)


def test_synthetic_coco_dataset_matches_jax(tmp_path):
    ours = D.make_synthetic_pose_dataset(num_samples=6, t=9, layout="coco",
                                         seed=2, path=str(tmp_path / "a.pkl"))
    ref = JD.make_synthetic_pose_dataset(num_samples=6, t=9, layout="coco",
                                         seed=2)
    assert ours["split"] == ref["split"]
    for a, b in zip(ours["annotations"], ref["annotations"]):
        _same(a, b)
    assert ours["annotations"][0]["keypoint"].shape == (2, 9, 17, 2)
    with open(tmp_path / "a.pkl", "rb") as f:
        assert pickle.load(f)["split"] == ref["split"]


@pytest.mark.parametrize("valid_ratio", [None, 0.0, 0.5])
def test_pose_dataset_filters_2d_annos_as_jax(tmp_path, valid_ratio):
    """box_thr / valid_ratio on hrnet annos read each anno's 'valid' count
    at box_thr, as JAX's; valid_ratio None or 0 keeps every anno."""
    data = D.make_synthetic_pose_dataset(num_samples=8, t=10, layout="coco")
    for i, a in enumerate(data["annotations"]):
        a["valid"] = {0.5: i + 2}
    path = str(tmp_path / "c.pkl")
    with open(path, "wb") as f:
        pickle.dump(data, f)
    pipe = [dict(type="PreNormalize2D"),
            dict(type="GenSkeFeat", dataset="coco", feats=["j"]),
            dict(type="UniformSample", clip_len=4), dict(type="PoseDecode"),
            dict(type="FormatGCNInput"), dict(type="Collect",
                                              keys=["keypoint", "label"])]
    kw = dict(split="train", box_thr=0.5, valid_ratio=valid_ratio)
    ours = D.PoseDataset(path, pipe, **kw)
    ref = JD.PoseDataset(path, pipe, **kw)
    assert [a["frame_dir"] for a in ours.video_infos] == \
        [a["frame_dir"] for a in ref.video_infos]
    assert len(ours) == (6 if not valid_ratio else 3)
    _same(ours.prepare(0, np.random.RandomState(1)),
          ref.prepare(0, np.random.RandomState(1)))


# ---------------------------------------------------------------------------
# every committed DS-GCN pipeline
# ---------------------------------------------------------------------------

DIRS = sorted(p.name for p in (REPO / "configs" / "dsgcn").iterdir()
              if p.is_dir())
PIPELINE_CASES = [(d, s, split) for d in DIRS for s in ("j", "b", "jm", "bm")
                  for split in ("train", "val", "test")]


def _pipeline(cfg, split):
    d = cfg["data"][split]
    return (d["dataset"] if d.get("type") == "RepeatDataset" else d)[
        "pipeline"]


def _anno_for(pipe, seed):
    types = [p["type"] for p in pipe]
    if "DecompressPose" in types:
        return D.make_compressed_pose_anno(seed=seed, t=140, label=1)
    layout = "coco" if "PreNormalize2D" in types else "nturgb+d"
    a = D.make_synthetic_pose_dataset(num_samples=1, t=130, layout=layout,
                                      seed=seed)["annotations"][0]
    if layout == "nturgb+d":
        a["keypoint"][1, 90:] = 0       # the second body leaves
    return a


def test_every_committed_dsgcn_config_is_covered():
    assert len(DIRS) == 10 and len(PIPELINE_CASES) == 120


@pytest.mark.parametrize("cfg_dir,stream,split", PIPELINE_CASES)
def test_committed_pipeline_matches_jax(cfg_dir, stream, split):
    """The config's pipeline through both packages on one synthetic anno
    (hrnet dense, compressed or NTU as the config reads) with the same
    seeded RandomState: array for array equal."""
    path = str(REPO / "configs" / "dsgcn" / cfg_dir / f"{stream}.py")
    pipe = _pipeline(Config.fromfile(path), split)
    jpipe = copy.deepcopy(_pipeline(JConfig.fromfile(path), split))
    assert pipe == jpipe
    for p in pipe + jpipe:
        if p["type"] == "PreNormalize3D":
            p["use_native"] = False
    anno = _anno_for(pipe, seed=len(cfg_dir) + len(stream))
    ours = T.build_pipeline(pipe)(copy.deepcopy(anno),
                                  rng=np.random.RandomState(11))
    ref = JT.build_pipeline(jpipe)(copy.deepcopy(anno),
                                   rng=np.random.RandomState(11))
    _same(ours, ref)
    nc = 10 if split == "test" else 1
    assert ours["keypoint"].shape[:1] == (nc,)
    assert ours["keypoint"].dtype == np.float32
    assert np.isfinite(ours["keypoint"]).all()
