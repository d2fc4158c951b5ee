"""Port parity, the video and multimodal data path: ``data/video.py``
(``SampleFrames``, ``ArrayDecode``, ``RawFrameDecode``, the decord pair),
``data/multimodal.py`` (``MMPad``, ``MMUniformSampleFrames``,
``MMDecode``, ``MMCompact``), ``RandomCrop``, ``Normalize``,
``ThreeCrop``, ``TenCrop``, ``FormatShape``, ``Heatmap2Potion``, the
registry and ``VideoDataset`` through the ``Loader``, against the numpy
modules of ``dsgcn_tpu`` on the same dicts and ``RandomState`` seeds.

Tolerances: exact (the same numpy arithmetic), 1e-6 after bilinear
resizes and for ``Heatmap2Potion``'s float32 colour sums.  The port's
``RandomResizedCrop``, ``CenterCrop`` and ``Flip`` also take frames
without keypoints (JAX's raise a KeyError there): on such a dict they
equal JAX's run with keypoints and those keypoints dropped.
"""
import copy

import numpy as np
import pytest
import torch

from dsgcn_tpu.data import dataset as JD
from dsgcn_tpu.data import heatmap as JH
from dsgcn_tpu.data import multimodal as JM
from dsgcn_tpu.data import pose_aug as JP
from dsgcn_tpu.data import transforms as JT
from dsgcn_tpu.data import video as JV
from dsgcn_tpu_torch.data import dataset as D
from dsgcn_tpu_torch.data import heatmap as H
from dsgcn_tpu_torch.data import multimodal as M
from dsgcn_tpu_torch.data import pose_aug as P
from dsgcn_tpu_torch.data import transforms as T
from dsgcn_tpu_torch.data import video as V

RNG = np.random.default_rng(19)


def _same(ours, ref, atol=1e-6):
    """The same keys and, recursively, the same values: arrays of one
    dtype within ``atol``, lists, tuples and dicts item by item, anything
    else equal."""
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref)
        for k in ref:
            try:
                _same(ours[k], ref[k], atol)
            except AssertionError as e:
                raise AssertionError(f"{k}: {e}") from None
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype
        assert ours.shape == ref.shape, (ours.shape, ref.shape)
        np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)
    elif isinstance(ref, (list, tuple)):
        assert type(ours) is type(ref) and len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _same(a, b, atol)
    else:
        assert ours == ref, (ours, ref)


def _frames(n=6, h=24, w=32, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (h, w, c), dtype=np.uint8)
            for _ in range(n)]


def _both(ours_t, ref_t, res, seed=None):
    """Each side's transform on its own deep copy of ``res`` (the random
    ones on a RandomState of ``seed``)."""
    if seed is None:
        return ours_t(copy.deepcopy(res)), ref_t(copy.deepcopy(res))
    return (ours_t(copy.deepcopy(res), np.random.RandomState(seed)),
            ref_t(copy.deepcopy(res), np.random.RandomState(seed)))


# ---------------------------------------------------------------------------
# data/video.py
# ---------------------------------------------------------------------------

SAMPLE_CASES = [
    dict(clip_len=8, frame_interval=2, num_clips=3),
    dict(clip_len=8, frame_interval=2, num_clips=3, total=10),
    dict(clip_len=4, frame_interval=3, num_clips=2, total=6),
    dict(clip_len=8, frame_interval=2, num_clips=3, test_mode=True),
    dict(clip_len=6, frame_interval=2, num_clips=2, test_mode=True,
         twice_sample=True),
    dict(clip_len=6, frame_interval=3, num_clips=2, temporal_jitter=True),
    dict(clip_len=8, frame_interval=4, num_clips=1,
         out_of_bound_opt="repeat_last", total=20),
    dict(clip_len=8, frame_interval=2, num_clips=3, keep_tail_frames=True),
    dict(clip_len=32, frame_interval=2, num_clips=1, keep_tail_frames=True,
         total=40),
    dict(clip_len=32, frame_interval=2, num_clips=1, total=300),
]


@pytest.mark.parametrize("kw", SAMPLE_CASES, ids=str)
def test_sample_frames_matches_jax(kw):
    """Train and test clips, short videos, twice-sampling, temporal jitter,
    'repeat_last', ``keep_tail_frames``, a start index: frame indices and
    the records, three draws each side."""
    kw = dict(kw)
    total = kw.pop("total", 100)
    ours_t, ref_t = V.SampleFrames(**kw), JV.SampleFrames(**kw)
    rngs = (np.random.RandomState(7), np.random.RandomState(7))
    for start in (0, 1, 0):
        res = dict(total_frames=total, start_index=start)
        _same(ours_t(dict(res), rngs[0]), ref_t(dict(res), rngs[1]))


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
def test_array_decode_matches_jax(modality):
    arr = RNG.integers(0, 255, (20, 8, 10, 3 if modality == "RGB" else 2),
                       dtype=np.uint8)
    res = dict(array=arr, frame_inds=np.array([[0, 3, 7, 19]]),
               modality=modality, offset=0)
    _same(*_both(V.ArrayDecode(), JV.ArrayDecode(), res))
    with pytest.raises(NotImplementedError):
        V.ArrayDecode()(dict(res, modality="Pose"))


def test_raw_frame_decode_matches_jax(tmp_path):
    from PIL import Image
    for i, img in enumerate(_frames(5)):
        Image.fromarray(img).save(tmp_path / f"f_{i:03}.jpg")
    res = dict(frame_dir=str(tmp_path), frame_inds=np.array([4, 0, 2, 2]))
    kw = dict(filename_tmpl="f_{:03}.jpg")
    _same(*_both(V.RawFrameDecode(**kw), JV.RawFrameDecode(**kw), res))


def test_decord_pair_refuses_without_decord():
    """Both build (configs name them) and, without decord, raise an
    ImportError that points to the array and frame decoders; so do both
    packages' ``MMDecode`` RGB branches without an ``array``."""
    for mod in (V, JV):
        mod.DecordDecode(mode="efficient")
        with pytest.raises(ImportError, match="ArrayDecode"):
            mod.DecordInit(num_threads=2)(dict(filename="x.mp4"))
    for mod in (M, JM):
        with pytest.raises(ImportError, match="array"):
            mod.MMDecode()(dict(modality=["RGB"], RGB_inds=np.arange(2),
                                frame_dir="x"))
    with pytest.raises(AssertionError):
        V.DecordDecode(mode="fast")


# ---------------------------------------------------------------------------
# the pixel crops, Normalize, FormatShape
# ---------------------------------------------------------------------------

def _pixels(seed, h=24, w=32, n=4, kp=True):
    rng = np.random.default_rng(seed)
    res = dict(imgs=_frames(n, h, w, seed=seed), img_shape=(h, w),
               modality="RGB")
    if kp:
        res["keypoint"] = (rng.random((1, n, 17, 2)) * [w, h]).astype(
            np.float32)
    return res


@pytest.mark.parametrize("size", [16, 24])
def test_random_crop_matches_jax(size):
    for seed in range(3):
        res = _pixels(seed)
        res["crop_quadruple"] = (0.1, 0.2, 0.5, 0.6)
        _same(*_both(P.RandomCrop(size), JP.RandomCrop(size), res, seed))
        del res["keypoint"]
        _same(*_both(P.RandomCrop(size), JP.RandomCrop(size), res, seed))


NORMALIZE = [dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375]),
             dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                  to_bgr=True),
             dict(mean=[128, 128], std=[128, 128]),
             dict(mean=[128, 128], std=[128, 128], adjust_magnitude=True)]


@pytest.mark.parametrize("kw", NORMALIZE, ids=str)
def test_normalize_matches_jax(kw):
    """RGB (and ``to_bgr``) and Flow (x/y frames paired, and
    ``adjust_magnitude`` by the scale factor); another modality raises, as
    JAX's does (a multimodal list among them)."""
    flow = len(kw["mean"]) == 2
    res = dict(imgs=_frames(6, c=1 if flow else 3),
               modality="Flow" if flow else "RGB",
               scale_factor=np.array([0.5, 2.0], np.float32))
    if flow:
        res["imgs"] = [f[..., 0] for f in res["imgs"]]
    _same(*_both(P.Normalize(**kw), JP.Normalize(**kw), res))
    for modality in ("Pose", ["RGB", "Pose"]):
        for mod in (P, JP):
            with pytest.raises(NotImplementedError):
                mod.Normalize(**kw)(dict(res, modality=modality))


@pytest.mark.parametrize("crop", [(16, 24), 24, (32, 16)])
def test_three_crop_matches_jax(crop):
    """Along the long side (the frames' width, then their height)."""
    res = _pixels(1, kp=False)
    if crop == (32, 16):
        res = _pixels(1, h=32, w=24, kp=False)
        crop = (24, 16)
    _same(*_both(P.ThreeCrop(crop), JP.ThreeCrop(crop), res))


@pytest.mark.parametrize("crop", [16, (20, 12)])
def test_ten_crop_matches_jax(crop):
    _same(*_both(P.TenCrop(crop), JP.TenCrop(crop), _pixels(2, kp=False)))


@pytest.mark.parametrize("fmt", ["NTHWC", "THWC", "NCTHW"])
def test_format_shape_matches_jax(fmt):
    """Every format stacks to channels-last (T, H, W, C), a list or an
    array; an unknown format is refused."""
    for imgs in (_frames(3), np.stack(_frames(3)).astype(np.float32)):
        _same(*_both(T.FormatShape(fmt), JT.FormatShape(fmt),
                     dict(imgs=imgs)))
    with pytest.raises(AssertionError):
        T.FormatShape("NCHW")


@pytest.mark.parametrize("name,kw", [("RandomResizedCrop", {}),
                                     ("CenterCrop", dict(crop_size=16)),
                                     ("Flip", dict(flip_ratio=1.0)),
                                     ("Flip", dict(flip_ratio=0.5))],
                         ids=str)
def test_pixel_only_crops_and_flip(name, kw):
    """Without keypoints the port's transform crops or mirrors the frames
    as JAX's does with keypoints (whose KeyError without them the port
    does not copy)."""
    ours_t, ref_t = getattr(P, name)(**kw), getattr(JP, name)(**kw)
    for seed in range(3):
        res = _pixels(seed)
        frames_only = {k: v for k, v in res.items() if k != "keypoint"}
        if ours_t.randomized:
            ours = ours_t(copy.deepcopy(frames_only),
                          np.random.RandomState(seed))
            ref = ref_t(copy.deepcopy(res), np.random.RandomState(seed))
        else:
            ours, ref = ours_t(copy.deepcopy(frames_only)), ref_t(
                copy.deepcopy(res))
        ref.pop("keypoint")
        _same(ours, ref)
        with pytest.raises(KeyError):
            r = copy.deepcopy(frames_only)
            if ref_t.randomized:
                JP.Flip(flip_ratio=1.0)(r, np.random.RandomState(0)) \
                    if name == "Flip" else ref_t(r, np.random.RandomState(0))
            else:
                ref_t(r)


# ---------------------------------------------------------------------------
# Heatmap2Potion
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option", ["U", "I", "N", "full"])
@pytest.mark.parametrize("channels_last", [True, False])
def test_heatmap2potion_matches_jax(option, channels_last):
    """Each option on two clips of 5 frames (clip_len from the results, a
    multimodal dict's Pose entry too), in both layouts, C = 2 and 3."""
    heat = RNG.random((10, 6, 7, 17)).astype(np.float32)
    if not channels_last:
        heat = np.ascontiguousarray(heat.transpose(0, 3, 1, 2))
    for C in (2, 3):
        kw = dict(C=C, option=option, channels_last=channels_last)
        for clip_len in (5, dict(Pose=5, RGB=2)):
            res = dict(imgs=heat.copy(), clip_len=clip_len)
            ours, ref = _both(H.Heatmap2Potion(**kw),
                              JH.Heatmap2Potion(**kw), res)
            _same(ours, ref)
    assert ours["imgs"].shape[-1] == {"U": 17 * 3, "I": 17, "N": 17 * 3,
                                      "full": 17 * 7}[option]


# ---------------------------------------------------------------------------
# data/multimodal.py
# ---------------------------------------------------------------------------

def _mm_sample(h=48, w=64, t=16, imgs=True, seed=3):
    rng = np.random.default_rng(seed)
    res = dict(keypoint=(rng.random((1, t, 17, 2)) * [w, h]).astype(
        np.float32), keypoint_score=rng.random((1, t, 17)).astype(
        np.float32), img_shape=(h, w), original_shape=(h, w),
        total_frames=t, modality="Pose", test_mode=False, start_index=0,
        label=1)
    if imgs:
        res["imgs"] = _frames(4, h, w, seed=seed)
    return res


@pytest.mark.parametrize("hw_ratio,padding", [(None, 0.25), (1.0, 0.0),
                                              ((4 / 3, 2.0), 0.1)])
def test_mmpad_matches_jax(hw_ratio, padding):
    kw = dict(hw_ratio=hw_ratio, padding=padding)
    _same(*_both(M.MMPad(**kw), JM.MMPad(**kw), _mm_sample()))


@pytest.mark.parametrize("test_mode", [False, True])
def test_mm_uniform_sample_frames_matches_jax(test_mode):
    """Modality by modality from one RandomState in training, reseeded for
    each modality in test mode; three draws each side, short and long
    videos."""
    kw = dict(clip_len=dict(RGB=4, Pose=8), num_clips=2, test_mode=test_mode,
              seed=255)
    ours_t, ref_t = M.MMUniformSampleFrames(**kw), \
        JM.MMUniformSampleFrames(**kw)
    rngs = (np.random.RandomState(5), np.random.RandomState(5))
    for t in (19, 6, 40):
        res = _mm_sample(t=t, imgs=False)
        res["test_mode"] = test_mode
        _same(ours_t(copy.deepcopy(res), rngs[0]),
              ref_t(copy.deepcopy(res), rngs[1]))


@pytest.mark.parametrize("shape", [(48, 64), (32, 40)])
def test_mmdecode_matches_jax(shape):
    """RGB from a preloaded array and Pose by frame gather (scores made
    where absent); keypoints rescaled where the frames' size differs from
    ``img_shape``."""
    res = _mm_sample(t=10, imgs=False)
    res.update(modality=["RGB", "Pose"], RGB_inds=np.array([[1, 5, 9]]),
               Pose_inds=np.arange(10) % 7)
    res["array"] = RNG.integers(0, 255, (10,) + shape + (3,),
                                dtype=np.uint8)
    _same(*_both(M.MMDecode(), JM.MMDecode(), res))
    del res["keypoint_score"]
    _same(*_both(M.MMDecode(), JM.MMDecode(), res))


@pytest.mark.parametrize("allow_imgpad,hw_ratio,padding",
                         [(True, 1, 0.25), (False, 1, 0.25),
                          (True, None, 0.25), (True, (1.5, 0.8), 1.0)])
def test_mmcompact_matches_jax(allow_imgpad, hw_ratio, padding):
    kw = dict(padding=padding, threshold=10, hw_ratio=hw_ratio,
              allow_imgpad=allow_imgpad)
    res = _mm_sample(t=4)
    res["keypoint"][0, 0, 0] = np.nan              # missing, zeroed
    _same(*_both(M.MMCompact(**kw), JM.MMCompact(**kw), res))
    res["keypoint"] = np.full_like(res["keypoint"], 20.0)   # under threshold
    _same(*_both(M.MMCompact(**kw), JM.MMCompact(**kw), res))


def test_registry_has_every_jax_transform():
    """Every transform JAX's ``build_pipeline`` registers (the ``MM*`` ones
    on first use) builds in the port; an unknown one is refused."""
    for typ in sorted(JT.TRANSFORMS):
        assert typ in T.TRANSFORMS, typ
    T.build_pipeline([dict(type="MMDecode")])
    assert set(JT.TRANSFORMS) <= set(T.TRANSFORMS)
    with pytest.raises(NotImplementedError, match="not ported"):
        T.build_pipeline([dict(type="NoSuchTransform")])


def _mm_pipeline(mod):
    """The multimodal pipeline of JAX's end-to-end test, from a package's
    ``build_pipeline``: RGB 4 frames at 32 px, pose heatmaps 16 frames at
    8 px (RGBPoseConv3D's speed and spatial ratios of 4)."""
    return mod.build_pipeline([
        dict(type="MMUniformSampleFrames", clip_len=dict(RGB=4, Pose=16),
             num_clips=1),
        dict(type="MMDecode"),
        dict(type="MMPad", hw_ratio=1.0, padding=0.1),
        dict(type="MMCompact", padding=0.25, hw_ratio=1),
        dict(type="Resize", scale=(32, 32), keep_ratio=False),
        dict(type="Rename", mapping=dict(imgs="rgb_imgs")),
        dict(type="Resize", scale=(8, 8), keep_ratio=False),
        dict(type="GeneratePoseTarget", sigma=0.6, use_score=True,
             with_kp=True),
        dict(type="FormatShape", input_format="NCTHW"),
    ])


def test_mm_pipeline_feeds_mm_recognizer3d():
    """The multimodal pipeline built by each package from the same config
    on the same sample and seed gives the same dict (1e-6); its RGB frames
    and heatmap volume feed the port's ``MMRecognizer3D(RGBPoseConv3D,
    RGBPoseHead)``, which gives finite (1, 9) logits a stream."""
    from dsgcn_tpu_torch.models.builder import build_model
    res = _mm_sample(t=16, imgs=False)
    res["array"] = RNG.integers(0, 255, (16, 48, 64, 3), dtype=np.uint8)
    ours = _mm_pipeline(T)(copy.deepcopy(res), np.random.RandomState(0))
    ref = _mm_pipeline(JT)(copy.deepcopy(res), np.random.RandomState(0))
    _same(ours, ref)
    assert ours["imgs"].shape == (16, 8, 8, 17)
    rgb = np.stack(ours["rgb_imgs"]).astype(np.float32) / 255.0
    model = build_model(dict(
        type="MMRecognizer3D", backbone=dict(type="RGBPoseConv3D"),
        cls_head=dict(type="RGBPoseHead", num_classes=9,
                      in_channels=[2048, 512])))
    with torch.no_grad():
        scores = model.eval()(torch.from_numpy(rgb)[None],
                              torch.from_numpy(ours["imgs"])[None])
    assert sorted(scores) == ["pose", "rgb"]
    for s in scores.values():
        assert s.shape == (1, 9) and bool(torch.isfinite(s).all())


# ---------------------------------------------------------------------------
# VideoDataset
# ---------------------------------------------------------------------------

def _rawframe_dataset(tmp_path, n=3, t=8):
    from PIL import Image
    for c in range(n):
        d = tmp_path / f"clip{c}"
        d.mkdir()
        for i, img in enumerate(_frames(t, 20, 28, seed=c)):
            Image.fromarray(img).save(d / f"img_{i:05}.jpg")
    ann = tmp_path / "annos.txt"
    ann.write_text("".join(f"clip{c} {t} {c}\n" for c in range(n)) + "\n")
    return ann


VIDEO_PIPELINE = [
    dict(type="SampleFrames", clip_len=4, frame_interval=2, num_clips=1),
    dict(type="RawFrameDecode", filename_tmpl="img_{:05}.jpg"),
    dict(type="RandomCrop", size=18),
    dict(type="Resize", scale=(16, 16), keep_ratio=False),
    dict(type="Normalize", mean=[127.5] * 3, std=[127.5] * 3),
    dict(type="FormatShape", input_format="NCTHW"),
    dict(type="Collect", keys=["imgs", "label"]),
]
VIDEO_TEST_PIPELINE = [
    dict(type="SampleFrames", clip_len=4, frame_interval=2, num_clips=1,
         test_mode=True),
    dict(type="RawFrameDecode", filename_tmpl="img_{:05}.jpg"),
    dict(type="Resize", scale=(-1, 16)),
    dict(type="ThreeCrop", crop_size=16),
    dict(type="Normalize", mean=[127.5] * 3, std=[127.5] * 3),
    dict(type="FormatShape", input_format="NCTHW"),
    dict(type="Collect", keys=["imgs", "label"]),
]


def test_video_dataset_through_the_loader_matches_jax(tmp_path):
    """Rawframe lines over PIL frames: the train pipeline (a random crop,
    a resize, Normalize, FormatShape; JAX's RandomResizedCrop and Flip
    need keypoints, :func:`test_pixel_only_crops_and_flip`) through each
    package's ``Loader`` gives the same (N, T, H, W, C) batches two epochs
    running, the ThreeCrop test pipeline the same (N, 3 T, H, W, C) ones
    (1e-6 after the bilinear resize); ``build_dataset`` takes the config
    form; a '<filename> <label>' line parses as JAX's."""
    ann = _rawframe_dataset(tmp_path)
    prefix = str(tmp_path) + "/"
    for pipe, test_mode, shape in ((VIDEO_PIPELINE, False, (4, 16, 16, 3)),
                                   (VIDEO_TEST_PIPELINE, True,
                                    (12, 16, 16, 3))):
        ours = D.build_dataset(dict(type="VideoDataset", ann_file=str(ann),
                                    pipeline=pipe, data_prefix=prefix),
                               test_mode=test_mode)
        ref = JD.VideoDataset(str(ann), pipe, data_prefix=prefix,
                              test_mode=test_mode)
        assert isinstance(ours, D.VideoDataset) and len(ours) == 3
        np.testing.assert_array_equal(ours.labels, ref.labels)
        lo = D.Loader(ours, batch_size=2, seed=4, num_workers=2)
        lr = JD.Loader(ref, batch_size=2, seed=4, num_workers=0)
        for epoch in (0, 1):
            for bo, br in zip(lo.epoch(epoch), lr.epoch(epoch)):
                assert bo["imgs"].shape[1:] == shape
                _same(bo, br)
    (tmp_path / "videos.txt").write_text("a.mp4 3\nb.mp4 1\n")
    ours = D.VideoDataset(str(tmp_path / "videos.txt"), [], data_prefix="v/")
    ref = JD.VideoDataset(str(tmp_path / "videos.txt"), [], data_prefix="v/")
    assert ours.video_infos == ref.video_infos
