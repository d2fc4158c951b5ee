"""Skeleton pipeline transforms (host-side NumPy).

The port's copy of the transforms that the committed DS-GCN pipelines
(``configs/dsgcn/*/{j,b,jm,bm}.py``, NTU 3D and hrnet COCO 2D) use, from
``dsgcn_tpu/data/transforms.py``: pre-normalization (3D, with the native
C++ path of ``native.py``, and 2D), random rotation, scale and noise, the
reference's ``GaussAug``, compressed-pose expansion, the joint, bone and
motion stream features, clip sampling (also ``UniformSampleOrder``),
decode, padding, format and collect, and the video input's
``FormatShape`` (``PoseCompact``, PoseC3D's resize, crops, flip and
``FormatHeatmapInput`` and the video crops and ``Normalize`` are in
``pose_aug.py``, ``GeneratePoseTarget`` and ``Heatmap2Potion`` in
``heatmap.py``, the frame samplers and decoders in ``video.py``, the
multimodal ``MM*`` transforms in ``multimodal.py``, registered when a
pipeline names one).  Behavioral parity with the
reference pipelines (pyskl ``pose_related.py``, ``sampling.py``,
``formatting.py``).  Randomized
transforms draw from the ``RandomState`` that ``Compose`` passes them, so
a loader that seeds it as the JAX ``Loader`` does gets the same clips;
test-time sampling seeds a local ``RandomState(seed)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .heatmap import GeneratePoseTarget, Heatmap2Potion
from .pose_aug import (CenterCrop, Flip, FormatHeatmapInput, Normalize,
                       PoseCompact, RandomCrop, RandomResizedCrop, Resize,
                       TenCrop, ThreeCrop)
from .video import (ArrayDecode, DecordDecode, DecordInit, RawFrameDecode,
                    SampleFrames)

__all__ = [
    "Compose", "PreNormalize3D", "PreNormalize2D", "RandomRot", "RandomScale",
    "RandomGaussianNoise", "GaussAug", "Causalmetrix", "BONE_PAIRS",
    "JointToBone",
    "ToMotion", "MergeSkeFeat", "GenSkeFeat", "UniformSampleFrames",
    "UniformSample", "UniformSampleOrder", "PoseDecode", "DecompressPose",
    "PadTo", "FormatGCNInput", "FormatShape", "Collect", "Rename",
    "build_pipeline",
]


class Compose:
    """Sequentially apply transforms; each may consume ``rng``."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, results: Dict, rng: Optional[np.random.RandomState] = None):
        if rng is None:
            rng = np.random.RandomState()
        for t in self.transforms:
            results = t(results, rng=rng) if getattr(t, "randomized", False) \
                else t(results)
            if results is None:
                return None
        return results

    def __repr__(self):
        return f"Compose({self.transforms})"


def _unit(v):
    return v / np.linalg.norm(v)


def _angle_between(v1, v2):
    if np.abs(v1).sum() < 1e-6 or np.abs(v2).sum() < 1e-6:
        return 0
    return np.arccos(np.clip(np.dot(_unit(v1), _unit(v2)), -1.0, 1.0))


def _rotation_matrix(axis, theta):
    """Rodrigues rotation about ``axis`` by ``theta`` (pose_related.py:265-278)."""
    if np.abs(axis).sum() < 1e-6 or np.abs(theta) < 1e-6:
        return np.eye(3)
    axis = np.asarray(axis)
    axis = axis / np.sqrt(np.dot(axis, axis))
    a = np.cos(theta / 2.0)
    b, c, d = -axis * np.sin(theta / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array([[aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
                     [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
                     [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc]])


class PreNormalize3D:
    """NTU 3D keypoint pre-normalization (pose_related.py:250-336).

    Drops empty frames, selects the denser body as primary, centers on the
    spine-base joint, and optionally aligns spine->z and shoulders->x.
    ``use_native`` (JAX's default, True) runs it in the C++ library of
    ``native.py`` (float32 out, built at first use; a failed build raises)
    for centered, non-empty 3D input of one or two bodies; other input,
    and ``use_native=False``, take the numpy path, as in JAX
    (transforms.py:90-107).
    """
    randomized = False

    def __init__(self, zaxis=(0, 1), xaxis=(8, 4), align_spine=True,
                 align_center=True, use_native=True):
        self.zaxis = list(zaxis)
        self.xaxis = list(xaxis)
        self.align_spine = align_spine
        self.align_center = align_center
        self.use_native = use_native

    def __call__(self, results: Dict) -> Dict:
        skeleton = results["keypoint"]
        if (self.use_native and self.align_center and skeleton.ndim == 4
                and skeleton.shape[-1] == 3 and skeleton.sum() != 0):
            from .native import prenormalize3d
            native = prenormalize3d(skeleton, self.align_spine,
                                    self.align_center, self.zaxis, self.xaxis)
            if native is not None:
                results["keypoint"], results["total_frames"], \
                    results["body_center"] = native
                return results
        total_frames = results.get("total_frames", skeleton.shape[1])
        M, T, V, C = skeleton.shape
        if T != total_frames:
            raise ValueError(f"total_frames {total_frames} != keypoint T {T}")
        if skeleton.sum() == 0:
            return results

        index0 = [i for i in range(T)
                  if not np.all(np.isclose(skeleton[0, i], 0))]
        if M not in (1, 2):
            raise ValueError(f"PreNormalize3D takes 1 or 2 bodies, got {M}")
        if M == 2:
            index1 = [i for i in range(T)
                      if not np.all(np.isclose(skeleton[1, i], 0))]
            if len(index0) < len(index1):
                skeleton = skeleton[:, np.array(index1)]
                skeleton = skeleton[[1, 0]]
            else:
                skeleton = skeleton[:, np.array(index0)]
        else:
            skeleton = skeleton[:, np.array(index0)]

        T_new = skeleton.shape[1]

        if self.align_center:
            if skeleton.shape[2] == 25:
                main_body_center = skeleton[0, 0, 1].copy()
            else:
                main_body_center = skeleton[0, 0, -1].copy()
            mask = ((skeleton != 0).sum(-1) > 0)[..., None]
            skeleton = (skeleton - main_body_center) * mask

        if self.align_spine:
            joint_bottom = skeleton[0, 0, self.zaxis[0]]
            joint_top = skeleton[0, 0, self.zaxis[1]]
            axis = np.cross(joint_top - joint_bottom, [0, 0, 1])
            angle = _angle_between(joint_top - joint_bottom, [0, 0, 1])
            skeleton = np.einsum("abcd,kd->abck", skeleton,
                                 _rotation_matrix(axis, angle))
            joint_rshoulder = skeleton[0, 0, self.xaxis[0]]
            joint_lshoulder = skeleton[0, 0, self.xaxis[1]]
            axis = np.cross(joint_rshoulder - joint_lshoulder, [1, 0, 0])
            angle = _angle_between(joint_rshoulder - joint_lshoulder, [1, 0, 0])
            skeleton = np.einsum("abcd,kd->abck", skeleton,
                                 _rotation_matrix(axis, angle))

        results["keypoint"] = skeleton
        results["total_frames"] = T_new
        if self.align_center:
            results["body_center"] = main_body_center
        return results


class PreNormalize2D:
    """2D keypoints to [-1, 1] (pose_related.py:130), in place.

    ``mode='fix'``: by the anno's ``img_shape`` (else ``img_shape`` here),
    x by the width and y by the height.  ``mode='auto'``: centred on the
    extent of the keypoints whose larger coordinate magnitude exceeds
    ``threshold`` and scaled by its larger half-side (for coordinates that
    are already normalized); without such keypoints nothing changes.
    """
    randomized = False

    def __init__(self, img_shape=(1080, 1920), threshold=0.01, mode="fix"):
        if mode not in ("fix", "auto"):
            raise ValueError(f"mode must be 'fix' or 'auto', got {mode!r}")
        self.img_shape = img_shape
        self.threshold = threshold
        self.mode = mode

    def __call__(self, results: Dict) -> Dict:
        kp = results["keypoint"]
        if self.mode == "auto":
            xy = kp[..., :2]
            mask = np.abs(xy).max(axis=-1) > self.threshold
            if mask.any():
                pts = xy[mask]
                lo, hi = pts.min(axis=0), pts.max(axis=0)
                center = (lo + hi) / 2
                scale = np.maximum((hi - lo) / 2, 1e-4).max()
                kp[..., 0] = (kp[..., 0] - center[0]) / scale
                kp[..., 1] = (kp[..., 1] - center[1]) / scale
            return results
        h, w = results.get("img_shape", self.img_shape)
        kp[..., 0] = (kp[..., 0] - w / 2) / (w / 2)
        kp[..., 1] = (kp[..., 1] - h / 2) / (h / 2)
        return results


class RandomRot:
    """Random xyz Euler rotation (pose_related.py:144-179); 2D keypoints
    rotate in the plane."""
    randomized = True

    def __init__(self, theta=0.3):
        self.theta = theta

    @staticmethod
    def _rot3d(theta):
        cos, sin = np.cos(theta), np.sin(theta)
        rx = np.array([[1, 0, 0], [0, cos[0], sin[0]], [0, -sin[0], cos[0]]])
        ry = np.array([[cos[1], 0, -sin[1]], [0, 1, 0], [sin[1], 0, cos[1]]])
        rz = np.array([[cos[2], sin[2], 0], [-sin[2], cos[2], 0], [0, 0, 1]])
        return np.matmul(rz, np.matmul(ry, rx))

    @staticmethod
    def _rot2d(theta):
        cos, sin = np.cos(theta), np.sin(theta)
        return np.array([[cos, -sin], [sin, cos]])

    def __call__(self, results: Dict, rng) -> Dict:
        skeleton = results["keypoint"]
        C = skeleton.shape[-1]
        if np.all(np.isclose(skeleton, 0)):
            return results
        if C not in (2, 3):
            raise ValueError(f"RandomRot takes 2D or 3D keypoints, got {C}")
        if C == 3:
            rot = self._rot3d(rng.uniform(-self.theta, self.theta, size=3))
        else:
            rot = self._rot2d(rng.uniform(-self.theta))
        results["keypoint"] = np.einsum("ab,mtvb->mtva", rot, skeleton)
        return results


class RandomScale:
    """Scale each coordinate by 1 + U(-1, 1) scale (pose_related.py:182);
    ``scale`` a float (every axis) or one per axis."""
    randomized = True

    def __init__(self, scale=0.2):
        self.scale = scale

    def __call__(self, results: Dict, rng) -> Dict:
        skeleton = results["keypoint"]
        scale = self.scale
        if isinstance(scale, float):
            scale = (scale,) * skeleton.shape[-1]
        if len(scale) != skeleton.shape[-1]:
            raise ValueError(f"RandomScale: {len(scale)} scales for "
                             f"{skeleton.shape[-1]} coordinates")
        scale = 1 + rng.uniform(-1, 1, size=len(scale)) * np.array(scale)
        results["keypoint"] = skeleton * scale
        return results


class RandomGaussianNoise:
    """Add N(0, sigma^2) noise to every coordinate (pose_related.py:200);
    float32 out."""
    randomized = True

    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def __call__(self, results: Dict, rng) -> Dict:
        kp = results["keypoint"]
        results["keypoint"] = (kp + rng.standard_normal(kp.shape) * self.sigma
                               ).astype(np.float32)
        return results


class GaussAug:
    """Gaussian keypoint jitter with probability 1 - thr (reference
    pose_related.py:83-104).  As the reference, and JAX, it writes the
    jittered array to the misspelled key ``'keyoint'``
    (pose_related.py:102): ``'keypoint'`` is left as it was."""
    randomized = True

    def __init__(self, thr=0.5, ratio=1e-2):
        self.thr = thr
        self.ratio = ratio

    def __call__(self, results: Dict, rng) -> Dict:
        if rng.rand() > self.thr:
            kp = results["keypoint"]
            n, t, v, c = kp.shape
            aug = rng.multivariate_normal(
                np.zeros(c), np.eye(c) * self.ratio,
                kp.reshape(-1, c).shape[0]).reshape(n, t, v, c)
            results["keyoint"] = kp + aug     # sic (pose_related.py:102)
        return results


class MergeSkeFeat:
    randomized = False

    def __init__(self, feat_list=("keypoint",), target="keypoint", axis=-1):
        self.feat_list = list(feat_list)
        self.target = target
        self.axis = axis

    def __call__(self, results: Dict) -> Dict:
        feats = [results.pop(name) for name in self.feat_list]
        results[self.target] = np.concatenate(feats, axis=self.axis)
        return results


class Rename:
    randomized = False

    def __init__(self, mapping):
        self.mapping = dict(mapping)

    def __call__(self, results: Dict) -> Dict:
        for old, new in self.mapping.items():
            results[new] = results.pop(old)
        return results


# each layout's kinematic pairs (v, parent of v): the bone of joint v is
# v minus its parent; a root pairs with itself
BONE_PAIRS = {
    "nturgb+d": [(0, 1), (1, 20), (2, 20), (3, 2), (4, 20), (5, 4), (6, 5),
                 (7, 6), (8, 20), (9, 8), (10, 9), (11, 10), (12, 0), (13, 12),
                 (14, 13), (15, 14), (16, 0), (17, 16), (18, 17), (19, 18),
                 (21, 22), (20, 20), (22, 7), (23, 24), (24, 11)],
    "openpose": [(0, 0), (1, 0), (2, 1), (3, 2), (4, 3), (5, 1), (6, 5),
                 (7, 6), (8, 2), (9, 8), (10, 9), (11, 5), (12, 11), (13, 12),
                 (14, 0), (15, 0), (16, 14), (17, 15)],
    "coco": [(0, 0), (1, 0), (2, 0), (3, 1), (4, 2), (5, 0), (6, 0), (7, 5),
             (8, 6), (9, 7), (10, 8), (11, 0), (12, 0), (13, 11), (14, 12),
             (15, 13), (16, 14)],
}
# 2D layouts whose third channel is a detection score, not a coordinate
SCORED = ("openpose", "coco")


def _xy_or_xyz(C: int, what: str) -> None:
    if C not in (2, 3):
        raise ValueError(f"{what} takes 2 or 3 channels, got {C}")


class JointToBone:
    """Joint -> bone vectors over the layout's kinematic pairs
    (pose_related.py:340-373), float32.  On a scored 2D layout with C = 3
    the third channel is the mean of the two joints' scores."""
    randomized = False

    def __init__(self, dataset="nturgb+d", target="keypoint"):
        self.dataset = dataset
        self.target = target
        self.pairs = BONE_PAIRS[dataset]

    def __call__(self, results: Dict) -> Dict:
        keypoint = results["keypoint"]
        C = keypoint.shape[-1]
        _xy_or_xyz(C, "JointToBone")
        bone = np.zeros(keypoint.shape, dtype=np.float32)
        scored = C == 3 and self.dataset in SCORED
        for v1, v2 in self.pairs:
            bone[..., v1, :] = keypoint[..., v1, :] - keypoint[..., v2, :]
            if scored:
                bone[..., v1, 2] = (keypoint[..., v1, 2]
                                    + keypoint[..., v2, 2]) / 2
        results[self.target] = bone
        return results


class ToMotion:
    """Temporal difference (pose_related.py:377-397) in the source's dtype:
    motion[t] = x[t + 1] - x[t], the last frame zero.  On a scored 2D
    layout with C = 3 the third channel is the mean of consecutive
    scores."""
    randomized = False

    def __init__(self, dataset="nturgb+d", source="keypoint", target="motion"):
        self.dataset = dataset
        self.source = source
        self.target = target

    def __call__(self, results: Dict) -> Dict:
        data = results[self.source]
        T, C = data.shape[1], data.shape[-1]
        _xy_or_xyz(C, "ToMotion")
        motion = np.zeros_like(data)
        motion[:, :T - 1] = np.diff(data, axis=1)
        if C == 3 and self.dataset in SCORED:
            motion[:, :T - 1, :, 2] = (data[:, :T - 1, :, 2]
                                       + data[:, 1:, :, 2]) / 2
        results[self.target] = motion
        return results


class GenSkeFeat:
    """Compose the stream features ``feats`` (any of 'j', 'b', 'jm', 'bm',
    concatenated on ``axis`` in the order given; pose_related.py:419-442).  A
    2D anno's ``keypoint_score`` joins its keypoints as a third channel
    first."""
    randomized = False

    def __init__(self, dataset="nturgb+d", feats=("j",), axis=-1):
        self.dataset = dataset
        self.feats = list(feats)
        unknown = [f for f in self.feats if f not in ("j", "b", "jm", "bm")]
        if unknown:
            raise ValueError(f"GenSkeFeat: unknown streams {unknown}")
        ops = []
        if "b" in self.feats or "bm" in self.feats:
            ops.append(JointToBone(dataset=dataset, target="b"))
        ops.append(Rename({"keypoint": "j"}))
        if "jm" in self.feats:
            ops.append(ToMotion(dataset=dataset, source="j", target="jm"))
        if "bm" in self.feats:
            ops.append(ToMotion(dataset=dataset, source="b", target="bm"))
        ops.append(MergeSkeFeat(feat_list=self.feats, axis=axis))
        self.ops = Compose(ops)

    def __call__(self, results: Dict) -> Dict:
        if "keypoint_score" in results and "keypoint" in results:
            if self.dataset == "nturgb+d" or results["keypoint"].shape[-1] != 2:
                raise ValueError("keypoint_score expects 2D keypoints of a "
                                 "non-NTU layout")
            keypoint = results.pop("keypoint")
            score = results.pop("keypoint_score")
            results["keypoint"] = np.concatenate([keypoint, score[..., None]], -1)
        return self.ops(results)


class UniformSampleFrames:
    """Uniform clip sampling (sampling.py:10-188).

    Train: one random index per equal segment; short videos loop with random
    offset.  Test: a local RandomState(seed) reproduces the reference's
    bit-exact deterministic clips (seed=255 default).
    """
    randomized = True

    def __init__(self, clip_len, num_clips=1, test_mode=False, p_interval=1,
                 seed=255):
        self.clip_len = clip_len
        self.num_clips = num_clips
        self.test_mode = test_mode
        self.seed = seed
        self.p_interval = p_interval if isinstance(p_interval, tuple) \
            else (p_interval, p_interval)

    def _sample_one(self, num_frames, clip_len, rng, clip_idx):
        pi = self.p_interval
        old_num_frames = num_frames
        ratio = rng.rand() * (pi[1] - pi[0]) + pi[0]
        num_frames = int(ratio * num_frames)
        off = rng.randint(old_num_frames - num_frames + 1)
        if num_frames < clip_len:
            if self.test_mode:
                start = (clip_idx if num_frames < self.num_clips
                         else clip_idx * num_frames // self.num_clips)
            else:
                start = rng.randint(0, num_frames)
            inds = np.arange(start, start + clip_len)
        elif clip_len <= num_frames < 2 * clip_len:
            basic = np.arange(clip_len)
            chosen = rng.choice(clip_len + 1, num_frames - clip_len,
                                replace=False)
            offset = np.zeros(clip_len + 1, dtype=np.int64)
            offset[chosen] = 1
            offset = np.cumsum(offset)
            inds = basic + offset[:-1]
        else:
            bids = np.array([i * num_frames // clip_len
                             for i in range(clip_len + 1)])
            bsize = np.diff(bids)
            bst = bids[:clip_len]
            offset = rng.randint(bsize)
            inds = bst + offset
        return inds + off

    def _get_clips(self, num_frames, clip_len, rng):
        return np.concatenate([
            self._sample_one(num_frames, clip_len, rng, i)
            for i in range(self.num_clips)])

    def __call__(self, results: Dict, rng=None) -> Dict:
        num_frames = results["total_frames"]
        if self.test_mode:
            rng = np.random.RandomState(self.seed)
        elif rng is None:
            rng = np.random.RandomState()
        inds = self._get_clips(num_frames, self.clip_len, rng)
        inds = np.mod(inds, num_frames)
        inds = inds + results.get("start_index", 0)
        results["frame_inds"] = inds.astype(np.int64)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = None
        results["num_clips"] = self.num_clips
        return results


class UniformSample(UniformSampleFrames):
    pass


class UniformSampleOrder(UniformSampleFrames):
    """UniformSample_order (reference sampling.py:195-282): as
    UniformSampleFrames, except that a short video's train clip always
    starts at frame 0 (:241-243) and indices past the end clamp to the
    last frame instead of looping (:254)."""

    def _sample_one(self, num_frames, clip_len, rng, clip_idx):
        pi = self.p_interval
        old_num_frames = num_frames
        ratio = rng.rand() * (pi[1] - pi[0]) + pi[0]
        num_frames = int(ratio * num_frames)
        off = rng.randint(old_num_frames - num_frames + 1)
        if not self.test_mode and num_frames < clip_len:
            return np.arange(0, clip_len) + off
        if num_frames < clip_len:
            start = (clip_idx if num_frames < self.num_clips
                     else clip_idx * num_frames // self.num_clips)
            inds = np.arange(start, start + clip_len)
        elif clip_len <= num_frames < 2 * clip_len:
            basic = np.arange(clip_len)
            chosen = rng.choice(clip_len + 1, num_frames - clip_len,
                                replace=False)
            offset = np.zeros(clip_len + 1, dtype=np.int64)
            offset[chosen] = 1
            inds = basic + np.cumsum(offset)[:-1]
        else:
            bids = np.array([i * num_frames // clip_len
                             for i in range(clip_len + 1)])
            inds = bids[:clip_len] + rng.randint(np.diff(bids))
        return inds + off

    def __call__(self, results: Dict, rng=None) -> Dict:
        num_frames = results["total_frames"]
        if self.test_mode:
            rng = np.random.RandomState(self.seed)
        elif rng is None:
            rng = np.random.RandomState()
        inds = self._get_clips(num_frames, self.clip_len, rng)
        inds[inds >= num_frames] = num_frames - 1    # clamp (sampling.py:254)
        inds = inds + results.get("start_index", 0)
        results["frame_inds"] = inds.astype(np.int64)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = None
        results["num_clips"] = self.num_clips
        return results


class PoseDecode:
    """Gather sampled frames (pose_related.py:19)."""
    randomized = False

    def __call__(self, results: Dict) -> Dict:
        inds = results["frame_inds"]
        results["keypoint"] = results["keypoint"][:, inds].astype(np.float32)
        if "keypoint_score" in results:
            results["keypoint_score"] = \
                results["keypoint_score"][:, inds].astype(np.float32)
        return results


class DecompressPose:
    """Expand a compressed 2D pose anno (pose_related.py:521-609), the
    storage of the public hrnet skeleton pickles: a flat (n_annos, V, 3)
    ``keypoint`` array (x, y, score) with each anno's ``frame_inds`` (and
    an optional ``anno_inds`` selection) becomes dense float16 keypoints
    (M, total_frames, V, 2) and scores (M, total_frames, V), M the most
    annos any frame has.

    ``squeeze`` drops the frames without an anno and renumbers the rest
    densely; above ``max_person`` bodies each frame's are ordered by their
    summed score (a stable sort) and the first ``max_person`` kept.  Not
    randomized: it takes ``rng`` only to share the randomized transforms'
    signature.
    """
    randomized = False

    def __init__(self, squeeze: bool = True, max_person: int = 10):
        self.squeeze = squeeze
        self.max_person = max_person

    def __call__(self, results: Dict, rng=None) -> Dict:
        missing = [k for k in ("total_frames", "frame_inds", "keypoint")
                   if k not in results]
        if missing:
            raise KeyError(f"DecompressPose needs {missing}")
        total_frames = results["total_frames"]
        frame_inds = results.pop("frame_inds")
        keypoint = results["keypoint"]
        if "anno_inds" in results:
            frame_inds = frame_inds[results["anno_inds"]]
            keypoint = keypoint[results["anno_inds"]]
        if np.any(np.diff(frame_inds) < 0):
            raise ValueError("frame_inds must not decrease")
        if self.squeeze:
            _, frame_inds = np.unique(frame_inds, return_inverse=True)
            frame_inds = frame_inds.astype(np.int16)
            total_frames = int(frame_inds.max()) + 1
        results["total_frames"] = total_frames

        V = keypoint.shape[1]
        num_person = int(np.bincount(frame_inds,
                                     minlength=total_frames).max())
        new_kp = np.zeros((num_person, total_frames, V, 2), dtype=np.float16)
        new_score = np.zeros((num_person, total_frames, V), dtype=np.float16)
        nperson = np.zeros(total_frames, dtype=np.int16)
        for f, kp in zip(frame_inds, keypoint):
            p = nperson[f]
            new_kp[p, f] = kp[:, :2]
            new_score[p, f] = kp[:, 2]
            nperson[f] += 1

        if num_person > self.max_person:
            for f in range(total_frames):
                n_f = nperson[f]
                order = np.argsort(-new_score[:n_f, f].sum(-1), kind="stable")
                new_score[:n_f, f] = new_score[order, f]
                new_kp[:n_f, f] = new_kp[order, f]
            num_person = self.max_person
            results["num_person"] = num_person
        results["keypoint"] = new_kp[:num_person]
        results["keypoint_score"] = new_score[:num_person]
        return results


class PadTo:
    """Pad the frames to ``length`` by looping them, or with zeros past the
    last frame (``mode='zero'``); videos longer than ``length`` are
    refused."""
    randomized = False

    def __init__(self, length, mode="loop"):
        if mode not in ("loop", "zero"):
            raise ValueError(f"PadTo mode {mode!r} ('loop' or 'zero')")
        self.length = length
        self.mode = mode

    def __call__(self, results: Dict) -> Dict:
        total_frames = results["total_frames"]
        if total_frames > self.length:
            raise ValueError(f"PadTo: {total_frames} frames exceed "
                             f"{self.length}")
        inds = np.mod(np.arange(self.length), total_frames)
        keypoint = results["keypoint"][:, inds].copy()
        if self.mode == "zero":
            keypoint[:, total_frames:] = 0
        results["keypoint"] = keypoint
        results["total_frames"] = self.length
        return results


class FormatGCNInput:
    """Pad/trim persons and split clips: (M, T, V, C) -> (nc, M, T/nc, V, C)
    (pose_related.py:468-514)."""
    randomized = False

    def __init__(self, num_person=2, mode="zero"):
        if mode not in ("zero", "loop"):
            raise ValueError(f"mode must be 'zero' or 'loop', got {mode!r}")
        self.num_person = num_person
        self.mode = mode

    def __call__(self, results: Dict) -> Dict:
        keypoint = results["keypoint"]
        if "keypoint_score" in results:
            keypoint = np.concatenate(
                [keypoint, results["keypoint_score"][..., None]], axis=-1)

        if keypoint.shape[0] < self.num_person:
            pad_dim = self.num_person - keypoint.shape[0]
            pad = np.zeros((pad_dim,) + keypoint.shape[1:], dtype=keypoint.dtype)
            keypoint = np.concatenate([keypoint, pad], axis=0)
            if self.mode == "loop":
                for i in range(1, self.num_person):
                    keypoint[i] = keypoint[0]
        elif keypoint.shape[0] > self.num_person:
            keypoint = keypoint[:self.num_person]

        M, T, V, C = keypoint.shape
        nc = results.get("num_clips", 1)
        if T % nc:
            raise ValueError(f"{T} frames do not split into {nc} clips")
        keypoint = keypoint.reshape((M, nc, T // nc, V, C)) \
                           .transpose(1, 0, 2, 3, 4)
        results["keypoint"] = np.ascontiguousarray(keypoint)
        return results


class Causalmetrix:
    """Percentile-threshold a precomputed causality matrix
    (reference pose_related.py:106-127; JAX ``transforms.py:Causalmetrix``):
    every entry of ``results['causal']`` below its ``thr``-th percentile
    becomes 0, in place.  The in-pipeline pTE of the reference is
    commented out upstream; the matrix arrives precomputed
    (``data/causal_pte.py:pte`` computes one)."""
    randomized = False

    def __init__(self, thr=75):
        self.thr = thr

    def __call__(self, results: Dict) -> Dict:
        causal = results["causal"]
        causal[causal < np.percentile(causal, self.thr)] = 0
        results["causal"] = causal
        return results


class FormatShape:
    """Stack decoded frames into the model input (reference
    formatting.py:164-231 FormatShape), as JAX's: channels-last (T, H, W,
    C) for every format (T = num_clips x clip_len; the recognizers take
    (N, T, H, W, C) and permute once inside), 'NCTHW' and 'THWC' accepted
    as aliases of 'NTHWC'."""
    randomized = False

    def __init__(self, input_format: str = "NTHWC"):
        assert input_format in ("NTHWC", "THWC", "NCTHW")
        self.input_format = input_format

    def __call__(self, results: Dict, rng=None) -> Dict:
        imgs = results["imgs"]
        if isinstance(imgs, (list, tuple)):
            imgs = np.stack(imgs)
        results["imgs"] = np.ascontiguousarray(imgs)
        results["input_shape"] = results["imgs"].shape
        return results


class Collect:
    randomized = False

    def __init__(self, keys=("keypoint", "label"), meta_keys=()):
        self.keys = list(keys)
        self.meta_keys = list(meta_keys)

    def __call__(self, results: Dict) -> Dict:
        return {k: results[k] for k in self.keys}


TRANSFORMS = {c.__name__: c for c in
              [PreNormalize3D, PreNormalize2D, RandomRot, RandomScale,
               RandomGaussianNoise, GaussAug, Causalmetrix, JointToBone,
               ToMotion, MergeSkeFeat, GenSkeFeat, UniformSampleFrames, UniformSample,
               UniformSampleOrder, PoseDecode, DecompressPose, PoseCompact,
               PadTo, FormatGCNInput, Collect, Rename, Resize,
               RandomResizedCrop, CenterCrop, Flip, GeneratePoseTarget,
               FormatHeatmapInput, FormatShape, Heatmap2Potion, RandomCrop,
               Normalize, ThreeCrop, TenCrop, SampleFrames, ArrayDecode,
               RawFrameDecode, DecordInit, DecordDecode]}


def build_pipeline(cfgs: Sequence[Dict]) -> Compose:
    """Config-dict pipeline builder mirroring the reference PIPELINES registry."""
    ops = []
    for cfg in cfgs:
        cfg = dict(cfg)
        typ = cfg.pop("type")
        if typ == "ToTensor":   # tensors are created at batch level here
            continue
        if typ not in TRANSFORMS and typ.startswith("MM"):
            from . import multimodal  # noqa: F401  (registers MM*)
        if typ not in TRANSFORMS:
            raise NotImplementedError(f"transform {typ!r} is not ported yet")
        ops.append(TRANSFORMS[typ](**cfg))
    return Compose(ops)
