"""Multimodal (RGB + pose) pipeline transforms (the port's copy of
``dsgcn_tpu/data/multimodal.py``; reference
datasets/pipelines/multi_modality.py:13-229), the data path of
``RGBPoseConv3D`` / ``MMRecognizer3D``.

As JAX's, ``MMDecode``'s RGB branch decodes from a preloaded ``array``
(or through decord where it is installed): the reference's RGB branch
calls methods its fork does not have (multi_modality.py:98-99).
``MMUniformSampleFrames`` draws modality by modality from one
``RandomState`` in training, and reseeds ``RandomState(seed)`` for each
modality in test mode, as JAX's does.  ``build_pipeline`` registers these
transforms on first use of an ``MM*`` name.  Numpy only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np

from .transforms import TRANSFORMS, UniformSampleFrames

__all__ = ["MMPad", "MMUniformSampleFrames", "MMDecode", "MMCompact"]

EPS = 1e-4


def _pair(x):
    return tuple(x) if isinstance(x, (tuple, list)) else (x, x)


class MMPad:
    """Pad frames/keypoints to a target aspect ratio (multi_modality.py:13-55).

    New canvas is ``(1+padding)`` times the old, then grown to satisfy
    ``hw_ratio``; keypoints shift by the centering offset, images pad with
    gray (127)."""
    randomized = False

    def __init__(self,
                 hw_ratio: Optional[Union[float, Tuple[float, float]]] = None,
                 padding: float = 0.0):
        if isinstance(hw_ratio, float):
            hw_ratio = (hw_ratio, hw_ratio)
        self.hw_ratio = hw_ratio
        self.padding = padding

    def __call__(self, results: Dict, rng=None) -> Dict:
        h, w = results["img_shape"]
        new_h, new_w = h * (1 + self.padding), w * (1 + self.padding)
        if self.hw_ratio is not None:
            new_h = max(self.hw_ratio[0] * new_w, new_h)
            new_w = max(1 / self.hw_ratio[1] * new_h, new_w)
        new_h, new_w = int(new_h + 0.5), int(new_w + 0.5)

        if "keypoint" in results:
            off = np.array([(new_w - w) // 2, (new_h - h) // 2],
                           dtype=np.float32)
            kp = results["keypoint"]
            kp[..., :2] += off
            results["keypoint"] = kp
        if "imgs" in results:
            dy, dx = new_h - h, new_w - w
            results["imgs"] = [
                np.pad(img, ((dy // 2, dy - dy // 2),
                             (dx // 2, dx - dx // 2), (0, 0)),
                       "constant", constant_values=127)
                for img in results["imgs"]]
        results["img_shape"] = (new_h, new_w)
        return results


class MMUniformSampleFrames(UniformSampleFrames):
    """Per-modality uniform clip sampling (multi_modality.py:59-78):
    ``clip_len`` is a dict {modality: clip_len}; emits ``{modality}_inds``
    and overrides ``modality`` with the sampled list.  Same train/test clip
    logic as UniformSampleFrames, drawn sequentially per modality from one
    RNG stream (matching the reference's sequential global-np.random use)."""

    def __call__(self, results: Dict, rng=None) -> Dict:
        num_frames = results["total_frames"]
        test_mode = results.get("test_mode", self.test_mode)
        if rng is None and not test_mode:
            rng = np.random.RandomState()
        modalities = []
        for modality, clip_len in self.clip_len.items():
            if test_mode:
                # the reference reseeds inside _get_test_clips, i.e. per
                # modality (sampling.py:103)
                rng = np.random.RandomState(self.seed)
            inds = self._get_clips(num_frames, clip_len, rng)
            results[f"{modality}_inds"] = np.mod(inds, num_frames).astype(int)
            modalities.append(modality)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = None
        results["num_clips"] = self.num_clips
        if not isinstance(results.get("modality"), list):
            results["modality"] = modalities
        return results


class MMDecode:
    """Decode each sampled modality (multi_modality.py:82-129): RGB frames
    from video, pose keypoints/scores by frame gather, then rescale keypoint
    coordinates if the decoded image size differs from ``img_shape``."""
    randomized = False

    def __init__(self, io_backend: str = "disk", **kwargs):
        self.io_backend = io_backend
        self.kwargs = kwargs

    def _decode_rgb(self, results, frame_inds):
        if "array" in results:           # preloaded video array
            return [results["array"][i] for i in frame_inds]
        try:
            import decord
        except ImportError as e:
            raise ImportError(
                "MMDecode RGB needs a preloaded 'array' or decord "
                "(decord is not installed)") from e
        if "filename" not in results:
            results["filename"] = results["frame_dir"] + ".mp4"
        vr = decord.VideoReader(results["filename"])
        return list(vr.get_batch(frame_inds).asnumpy())

    def __call__(self, results: Dict, rng=None) -> Dict:
        for mod in results["modality"]:
            inds = results[f"{mod}_inds"]
            if inds.ndim != 1:
                inds = results[f"{mod}_inds"] = np.squeeze(inds)
            if mod == "RGB":
                results["imgs"] = self._decode_rgb(results, inds)
            elif mod == "Pose":
                assert "keypoint" in results
                if "keypoint_score" not in results:
                    results["keypoint_score"] = np.ones(
                        results["keypoint"].shape[:-1], dtype=np.float32)
                results["keypoint"] = \
                    results["keypoint"][:, inds].astype(np.float32)
                results["keypoint_score"] = \
                    results["keypoint_score"][:, inds].astype(np.float32)
            else:
                raise NotImplementedError(f"MMDecode: modality {mod}")

        if "imgs" in results:
            real = results["imgs"][0].shape[:2]
            if real != tuple(results["img_shape"]):
                oh, ow = results["img_shape"]
                nh, nw = real
                assert results["keypoint"].shape[-1] in (2, 3)
                results["keypoint"][..., 0] *= nw / ow
                results["keypoint"][..., 1] *= nh / oh
                results["img_shape"] = real
                results["original_shape"] = real
        return results


class MMCompact:
    """Crop frames+keypoints to the tight person box
    (multi_modality.py:133-222):
    box from nonzero keypoints, padded by ``padding`` and grown to
    ``hw_ratio``; images are padded when the box exceeds the canvas
    (allow_imgpad) else clamped."""
    randomized = False

    def __init__(self, padding: float = 0.25, threshold: int = 10,
                 hw_ratio: Union[float, Tuple[float, float], None] = 1,
                 allow_imgpad: bool = True):
        self.padding = padding
        self.threshold = threshold
        self.hw_ratio = None if hw_ratio is None else _pair(hw_ratio)
        self.allow_imgpad = allow_imgpad
        assert self.padding >= 0

    def _get_box(self, keypoint, img_shape):
        h, w = img_shape
        kp_x, kp_y = keypoint[..., 0], keypoint[..., 1]
        min_x = np.min(kp_x[kp_x != 0], initial=np.inf)
        min_y = np.min(kp_y[kp_y != 0], initial=np.inf)
        max_x = np.max(kp_x[kp_x != 0], initial=-np.inf)
        max_y = np.max(kp_y[kp_y != 0], initial=-np.inf)
        if max_x - min_x < self.threshold or max_y - min_y < self.threshold:
            return (0, 0, w, h)
        cx, cy = (max_x + min_x) / 2, (max_y + min_y) / 2
        half_w = (max_x - min_x) / 2 * (1 + self.padding)
        half_h = (max_y - min_y) / 2 * (1 + self.padding)
        if self.hw_ratio is not None:
            half_h = max(self.hw_ratio[0] * half_w, half_h)
            half_w = max(1 / self.hw_ratio[1] * half_h, half_w)
        min_x, max_x = cx - half_w, cx + half_w
        min_y, max_y = cy - half_h, cy + half_h
        if not self.allow_imgpad:
            min_x, min_y = int(max(0, min_x)), int(max(0, min_y))
            max_x, max_y = int(min(w, max_x)), int(min(h, max_y))
        else:
            min_x, min_y = int(min_x), int(min_y)
            max_x, max_y = int(max_x), int(max_y)
        return (min_x, min_y, max_x, max_y)

    def _compact_images(self, imgs, img_shape, box):
        h, w = img_shape
        min_x, min_y, max_x, max_y = box
        pad_l = -min_x if min_x < 0 else 0
        pad_u = -min_y if min_y < 0 else 0
        if pad_l:
            min_x, max_x = 0, max_x + pad_l
            w += pad_l
        if pad_u:
            min_y, max_y = 0, max_y + pad_u
            h += pad_u
        pad_r = max_x - w if max_x > w else 0
        pad_d = max_y - h if max_y > h else 0
        if pad_l or pad_r or pad_u or pad_d:
            imgs = [np.pad(img, ((pad_u, pad_d), (pad_l, pad_r), (0, 0)))
                    for img in imgs]
        return [img[min_y:max_y, min_x:max_x] for img in imgs]

    def __call__(self, results: Dict, rng=None) -> Dict:
        img_shape = results["img_shape"]
        kp = results["keypoint"]
        kp[np.isnan(kp)] = 0.0
        box = self._get_box(kp, img_shape)
        min_x, min_y = box[:2]
        kp_x, kp_y = kp[..., 0], kp[..., 1]
        kp_x[kp_x != 0] -= min_x
        kp_y[kp_y != 0] -= min_y
        results["img_shape"] = (box[3] - min_y, box[2] - min_x)
        results["imgs"] = self._compact_images(results["imgs"], img_shape, box)
        return results


TRANSFORMS.update({c.__name__: c for c in
                   [MMPad, MMUniformSampleFrames, MMDecode, MMCompact]})
