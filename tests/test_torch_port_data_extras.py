"""Port parity, the data no committed config names: ``RandomScale``,
``RandomGaussianNoise``, ``GaussAug``, ``UniformSampleOrder`` and
``PadTo``; ``class_prob`` in ``epoch_indices`` and the ``Loader``; and the
native ``PreNormalize3D`` (``dsgcn_tpu_torch/data/native.py`` over the
port's copy of ``skel_ops.cpp``) of ``dsgcn_tpu_torch`` against
``dsgcn_tpu`` on the CPU.

Numpy on both sides, no JAX: ``dsgcn_tpu/data/transforms.py``,
``dataset.py`` and ``native.py`` import only numpy.  Random transforms draw
from the same seeded ``RandomState`` and must give equal arrays; the two
native libraries are built by the same compiler with the same flags and
must agree bit for bit, and with the numpy path within 1e-5.
"""
import numpy as np
import pytest

from dsgcn_tpu.data import dataset as JD
from dsgcn_tpu.data import native as jnative
from dsgcn_tpu.data import transforms as JT
from dsgcn_tpu_torch.data import dataset as D
from dsgcn_tpu_torch.data import native
from dsgcn_tpu_torch.data import transforms as T


def _kp(seed, m=2, t=30, v=25, c=3):
    return np.random.default_rng(seed).standard_normal(
        (m, t, v, c)).astype(np.float32)


TRANSFORMS = {
    "RandomScale": (dict(scale=0.2), None),
    "RandomScale_per_axis": (dict(scale=(0.1, 0.2, 0.3)), None),
    "RandomGaussianNoise": (dict(sigma=0.05), None),
    "GaussAug_fires": (dict(thr=-1.0, ratio=0.02), None),
    "GaussAug_skips": (dict(thr=2.0), None),
    "UniformSampleOrder_short": (dict(clip_len=40, p_interval=(0.5, 1)), 30),
    "UniformSampleOrder_mid": (dict(clip_len=20, num_clips=2), 30),
    "UniformSampleOrder_long_test": (dict(clip_len=8, num_clips=3,
                                          test_mode=True), 30),
    "PadTo_loop": (dict(length=48), 30),
    "PadTo_zero": (dict(length=48, mode="zero"), 30),
}


@pytest.mark.parametrize("case", sorted(TRANSFORMS))
def test_transform_matches_jax(case):
    """The transform through ``build_pipeline`` of both packages on the
    same anno and the same ``RandomState``: every key equal."""
    kw, frames = TRANSFORMS[case]
    cfg = [dict(type=case.split("_")[0], **kw)]
    kp = _kp(len(case))
    anno = dict(keypoint=kp, total_frames=kp.shape[1], label=1)
    ours = T.build_pipeline(cfg)(dict(anno, keypoint=kp.copy()),
                                 rng=np.random.RandomState(3))
    ref = JT.build_pipeline(cfg)(dict(anno, keypoint=kp.copy()),
                                 rng=np.random.RandomState(3))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    if case == "GaussAug_fires":      # the reference's misspelled key
        assert "keyoint" in ours
        np.testing.assert_array_equal(ours["keypoint"], kp)
    if frames and case.startswith("UniformSampleOrder"):
        assert ours["frame_inds"].max() < frames


def test_uniform_sample_order_differs_as_documented():
    """Train clips of a short video start at frame 0 and clamp to its last
    frame, where UniformSampleFrames loops."""
    res = dict(total_frames=10)
    inds = T.UniformSampleOrder(clip_len=16)(dict(res),
                                            np.random.RandomState(0))
    np.testing.assert_array_equal(inds["frame_inds"],
                                  np.minimum(np.arange(16), 9))
    loop = T.UniformSampleFrames(clip_len=16)(dict(res),
                                              np.random.RandomState(0))
    assert (np.diff(loop["frame_inds"]) < 0).any()


@pytest.mark.parametrize("num_shards,shuffle", [(1, True), (3, True),
                                                (2, False)])
def test_class_prob_epoch_indices_match_jax(num_shards, shuffle):
    """Replication by class, fractional factors included, over epochs and
    shards: the same draws in the same order as JAX."""
    labels = np.random.default_rng(5).integers(0, 4, 23)
    prob = {0: 2.5, 1: 0.4, 3: 1.0}
    for epoch in range(4):
        for shard in range(num_shards):
            got = D.epoch_indices(23, epoch, shard, num_shards, shuffle,
                                  seed=9, class_prob=prob, labels=labels)
            want = JD.epoch_indices(23, epoch, shard, num_shards, shuffle,
                                    seed=9, class_prob=prob, labels=labels)
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="labels"):
        D.epoch_indices(23, 0, class_prob=prob)


def test_class_prob_loader_matches_jax(tmp_path):
    """Two epochs of a class_prob loader over two shards: the batches'
    labels and keypoints equal JAX's loader's."""
    path = str(tmp_path / "synth.pkl")
    D.make_synthetic_pose_dataset(num_samples=15, num_classes=3, t=20,
                                  seed=6, path=path)
    pipe = [dict(type="UniformSample", clip_len=8), dict(type="PoseDecode"),
            dict(type="FormatGCNInput"),
            dict(type="Collect", keys=["keypoint", "label"])]
    prob = {0: 3.0, 2: 0.5}
    for shard in range(2):
        kw = dict(batch_size=4, seed=1, num_workers=0, shard=shard,
                  num_shards=2, class_prob=prob)
        ours = D.Loader(D.PoseDataset(path, pipe, split="train"), **kw)
        ref = JD.Loader(JD.PoseDataset(path, pipe, split="train"), **kw)
        assert ours.steps_per_epoch() == ref.steps_per_epoch()
        for epoch in (0, 1):
            got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) >= 1
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g["label"], w["label"])
                np.testing.assert_array_equal(g["keypoint"], w["keypoint"])


# ---------------------------------------------------------------------------
# the native PreNormalize3D
# ---------------------------------------------------------------------------

def _ntu_skeleton(seed, m=2, t=40, empty=(0, 1, 7, 20)):
    """An NTU-like skeleton: body 0 with empty frames (so with m = 2 body 1
    is the denser and the bodies swap), a few zero joints."""
    kp = _kp(seed, m, t)
    kp[0, list(empty)] = 0
    kp[:, :, 3] *= np.random.default_rng(seed).random((m, t, 1)) > 0.1
    return kp


@pytest.mark.parametrize("m,align_spine", [(2, True), (1, True),
                                           (2, False)])
def test_native_prenormalize_matches_jax_native(m, align_spine):
    """The port's library against JAX's on the same input: bit-equal;
    against the numpy path: within 1e-5.  ``PreNormalize3D`` takes it by
    default, as JAX's does."""
    kp = _ntu_skeleton(m, m)
    got = native.prenormalize3d(kp, align_spine=align_spine)
    want = jnative.prenormalize3d(kp, align_spine=align_spine)
    assert want is not None, "JAX's native library did not build"
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == (40 if m == 2 else 36)
    np.testing.assert_array_equal(got[2], want[2])
    anno = dict(keypoint=kp, total_frames=kp.shape[1])
    ours = T.PreNormalize3D(align_spine=align_spine)(dict(anno))
    ref = JT.PreNormalize3D(align_spine=align_spine)(dict(anno))
    plain = T.PreNormalize3D(align_spine=align_spine, use_native=False)(
        dict(anno))
    for k in ("keypoint", "total_frames", "body_center"):
        np.testing.assert_array_equal(ours[k], ref[k])
        np.testing.assert_allclose(ours[k], plain[k], rtol=1e-5, atol=1e-5)
    assert ours["keypoint"].dtype == np.float32


def test_native_takes_jax_inputs_and_refusals():
    """C != 3 or more than two bodies: the library returns None (JAX's
    contract) and PreNormalize3D takes the numpy path as JAX's; the bone
    features equal JAX's native ones."""
    assert native.prenormalize3d(_kp(1, 3)) is None
    assert native.prenormalize3d(_kp(1, 2, c=2)) is None
    kp2 = _kp(2, 1, c=2)
    np.testing.assert_array_equal(
        T.PreNormalize3D(align_spine=False)(dict(keypoint=kp2.copy(),
                                                 total_frames=30))["keypoint"],
        JT.PreNormalize3D(align_spine=False)(dict(keypoint=kp2.copy(),
                                                  total_frames=30))[
            "keypoint"])
    pairs = T.BONE_PAIRS["nturgb+d"]
    kp = _kp(3)
    np.testing.assert_array_equal(native.joint_to_bone(kp, pairs),
                                  jnative.joint_to_bone(kp, pairs))


def test_native_build_is_named_by_its_source_and_raises(tmp_path,
                                                        monkeypatch):
    """The library lands in build/native as libskel_ops-<hash>.so (never
    beside the source); a source that does not compile raises with the
    compiler's message, and nothing falls back."""
    path = native.library_path()
    assert path.parent.name == "native" and path.parent.parent.name == \
        "build" and path.name.startswith("libskel_ops-")
    assert native.build() == path and path.exists()
    bad = tmp_path / "skel_ops.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        T.PreNormalize3D()(dict(keypoint=_kp(4), total_frames=30))
