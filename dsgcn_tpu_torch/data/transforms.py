"""Skeleton pipeline transforms (host-side NumPy).

The port's copy of the transforms that the DS-GCN train and test pipelines
(``configs/dsgcn/ntu60_xsub_3dkp/j.py``) use, from
``dsgcn_tpu/data/transforms.py``: pre-normalization, random rotation,
joint-stream feature generation, clip sampling, decode, format and
collect.  Behavioral parity with the reference pipelines (pyskl
``pose_related.py``, ``sampling.py``, ``formatting.py``).  Randomized
transforms draw from the ``RandomState`` that ``Compose`` passes them, so
a loader that seeds it as the JAX ``Loader`` does gets the same clips;
test-time sampling seeds a local ``RandomState(seed)``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = [
    "Compose", "PreNormalize3D", "RandomRot", "MergeSkeFeat", "GenSkeFeat",
    "UniformSampleFrames", "UniformSample", "PoseDecode", "FormatGCNInput",
    "Collect", "Rename", "build_pipeline",
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
    """
    randomized = False

    def __init__(self, zaxis=(0, 1), xaxis=(8, 4), align_spine=True,
                 align_center=True):
        self.zaxis = list(zaxis)
        self.xaxis = list(xaxis)
        self.align_spine = align_spine
        self.align_center = align_center

    def __call__(self, results: Dict) -> Dict:
        skeleton = results["keypoint"]
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


class GenSkeFeat:
    """Compose stream features (pose_related.py:419-442).  The port has the
    joint stream ``'j'``; the bone and motion streams come with their
    transforms (JointToBone, ToMotion) in a later slice."""
    randomized = False

    def __init__(self, dataset="nturgb+d", feats=("j",), axis=-1):
        self.dataset = dataset
        self.feats = list(feats)
        unported = [f for f in self.feats if f != "j"]
        if unported:
            raise NotImplementedError(
                f"GenSkeFeat streams {unported} need JointToBone/ToMotion, "
                "which are not ported yet")
        self.ops = Compose([Rename({"keypoint": "j"}),
                            MergeSkeFeat(feat_list=self.feats, axis=axis)])

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

    def __call__(self, results: Dict, rng=None) -> Dict:
        num_frames = results["total_frames"]
        if self.test_mode:
            rng = np.random.RandomState(self.seed)
        elif rng is None:
            rng = np.random.RandomState()
        inds = np.concatenate([
            self._sample_one(num_frames, self.clip_len, rng, i)
            for i in range(self.num_clips)])
        inds = np.mod(inds, num_frames)
        inds = inds + results.get("start_index", 0)
        results["frame_inds"] = inds.astype(np.int64)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = None
        results["num_clips"] = self.num_clips
        return results


class UniformSample(UniformSampleFrames):
    pass


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


class Collect:
    randomized = False

    def __init__(self, keys=("keypoint", "label"), meta_keys=()):
        self.keys = list(keys)
        self.meta_keys = list(meta_keys)

    def __call__(self, results: Dict) -> Dict:
        return {k: results[k] for k in self.keys}


TRANSFORMS = {c.__name__: c for c in
              [PreNormalize3D, RandomRot, MergeSkeFeat, GenSkeFeat,
               UniformSampleFrames,
               UniformSample, PoseDecode, FormatGCNInput, Collect, Rename]}


def build_pipeline(cfgs: Sequence[Dict]) -> Compose:
    """Config-dict pipeline builder mirroring the reference PIPELINES registry."""
    ops = []
    for cfg in cfgs:
        cfg = dict(cfg)
        typ = cfg.pop("type")
        if typ == "ToTensor":   # tensors are created at batch level here
            continue
        if typ not in TRANSFORMS:
            raise NotImplementedError(f"transform {typ!r} is not ported yet")
        ops.append(TRANSFORMS[typ](**cfg))
    return Compose(ops)
