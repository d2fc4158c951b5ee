"""``PoseDataset``'s valid-frame filter in the port against the JAX
package's: both keep an anno when its valid frames at ``box_thr`` over its
``total_frames`` reach ``valid_ratio`` (``pose_dataset.py:101-102``), and
``build_dataset`` passes both keys through.  numpy only, no JAX."""
import pickle

import numpy as np
import pytest

from dsgcn_tpu.data import dataset as JD
from dsgcn_tpu_torch.data import dataset as D

PIPELINE = [dict(type="PoseDecode")]


def _ann_file(tmp_path, seed=0, n=24):
    """Annos whose ``valid`` dicts count frames at two box thresholds, some
    without a ``valid`` dict or without an entry at one threshold."""
    rng = np.random.default_rng(seed)
    annos = []
    for i in range(n):
        t = int(rng.integers(20, 120))
        anno = dict(frame_dir=f"S{i:03d}", label=i % 5, total_frames=t,
                    keypoint=np.zeros((1, t, 17, 2), np.float32))
        if i % 6:
            anno["valid"] = {0.5: int(rng.integers(0, t + 1))}
            if i % 4:
                anno["valid"][0.7] = int(rng.integers(0, t + 1))
        annos.append(anno)
    data = dict(split=dict(train=[a["frame_dir"] for a in annos[::2]]),
                annotations=annos)
    path = tmp_path / "annos.pkl"
    path.write_bytes(pickle.dumps(data))
    return str(path)


def _kept(ds):
    return [a["frame_dir"] for a in ds.video_infos]


@pytest.mark.parametrize("split", [None, "train"])
@pytest.mark.parametrize("box_thr", [0.5, 0.7])
@pytest.mark.parametrize("valid_ratio", [0, 0.5, 1])
def test_pose_dataset_keeps_the_annos_jax_keeps(tmp_path, valid_ratio,
                                                box_thr, split):
    path = _ann_file(tmp_path)
    kw = dict(split=split, valid_ratio=valid_ratio, box_thr=box_thr)
    ours = _kept(D.PoseDataset(path, PIPELINE, **kw))
    ref = _kept(JD.PoseDataset(path, PIPELINE, **kw))
    assert ours == ref
    everything = _kept(D.PoseDataset(path, PIPELINE, split=split))
    if valid_ratio == 0:
        assert ours == everything
    else:
        assert 0 < len(ours) < len(everything)


@pytest.mark.parametrize("valid_ratio", [0, 0.5, 1])
def test_build_dataset_passes_the_filter_through(tmp_path, valid_ratio):
    path = _ann_file(tmp_path, seed=1)
    cfg = dict(type="PoseDataset", ann_file=path, pipeline=PIPELINE,
               split="train", valid_ratio=valid_ratio, box_thr=0.5)
    ours = _kept(D.build_dataset(cfg))
    assert ours == _kept(JD.build_dataset(cfg))
    assert ours == _kept(D.PoseDataset(path, PIPELINE, split="train",
                                       valid_ratio=valid_ratio, box_thr=0.5))
    rep = D.build_dataset(dict(type="RepeatDataset", times=2, dataset=cfg))
    assert _kept(rep.dataset) == ours
