"""Keypoint- and pixel-space augmentations of the 2D pose and video
pipelines (port of ``dsgcn_tpu/data/pose_aug.py``; reference
datasets/pipelines/augmentations.py).  The hrnet DS-GCN pipelines
(``configs/dsgcn/kinetics400_hrnet``, ``fight_detection``) run
``PoseCompact`` after ``PoseDecode``; PoseC3D's heatmap pipelines
(``configs/posec3d``) also resize, crop and flip in keypoint space before
``GeneratePoseTarget`` (``heatmap.py``) draws the volume, so no pixels
exist until then: only the keypoints, ``img_shape`` and the crop and
scale records change (and ``imgs``, where a results dict holds frames).
The random transforms draw from the ``RandomState`` that ``Compose``
passes them, in JAX's order, so the same seed gives the same crop and
flip.  The video pipelines crop (``RandomCrop``, ``ThreeCrop``,
``TenCrop``), resize, flip and ``Normalize`` decoded frames; where a
results dict holds frames and no keypoints, ``RandomResizedCrop``,
``CenterCrop`` and ``Flip`` act on the frames alone (JAX's raise a
KeyError on the missing ``keypoint``)."""
from __future__ import annotations

from typing import Dict

import numpy as np

from .heatmap import COCO_LEFT_KP, COCO_RIGHT_KP

__all__ = ["PoseCompact", "RandomResizedCrop", "CenterCrop", "Resize",
           "Flip", "FormatHeatmapInput", "bilinear_resize", "RandomCrop",
           "Normalize", "ThreeCrop", "TenCrop"]


def _combine_quadruple(a, b):
    """Crop box ``b`` (x, y, w, h as fractions) inside crop box ``a``."""
    return (a[0] + a[2] * b[0], a[1] + a[3] * b[1], a[2] * b[2], a[3] * b[3])


class PoseCompact:
    """Re-frame the keypoints on the padded box around every non-zero joint.

    The box is the joints' extent grown by ``padding``, widened to the
    height-width ratio ``hw_ratio`` (a number or an (h/w, h/w) pair) where
    given, and inside the image unless ``allow_imgpad``; its corners are
    truncated to ints.  Non-zero coordinates shift by the box's corner, in
    place; ``img_shape`` becomes the box's and ``crop_quadruple`` the box in
    the original image's fractions.  Where the extent is under
    ``threshold`` pixels on either axis nothing changes.
    """
    randomized = False

    def __init__(self, padding=0.25, threshold=10, hw_ratio=None,
                 allow_imgpad=True):
        self.padding = padding
        self.threshold = threshold
        self.hw_ratio = ((hw_ratio, hw_ratio)
                         if isinstance(hw_ratio, (int, float)) else hw_ratio)
        self.allow_imgpad = allow_imgpad

    def __call__(self, results: Dict) -> Dict:
        h, w = results["img_shape"]
        kp = results["keypoint"]
        kp[np.isnan(kp)] = 0.0
        kp_x, kp_y = kp[..., 0], kp[..., 1]
        min_x = np.min(kp_x[kp_x != 0], initial=np.inf)
        min_y = np.min(kp_y[kp_y != 0], initial=np.inf)
        max_x = np.max(kp_x[kp_x != 0], initial=-np.inf)
        max_y = np.max(kp_y[kp_y != 0], initial=-np.inf)
        if max_x - min_x < self.threshold or max_y - min_y < self.threshold:
            return results
        center = ((max_x + min_x) / 2, (max_y + min_y) / 2)
        half_w = (max_x - min_x) / 2 * (1 + self.padding)
        half_h = (max_y - min_y) / 2 * (1 + self.padding)
        if self.hw_ratio is not None:
            half_h = max(self.hw_ratio[0] * half_w, half_h)
            half_w = max(1 / self.hw_ratio[1] * half_h, half_w)
        min_x, max_x = center[0] - half_w, center[0] + half_w
        min_y, max_y = center[1] - half_h, center[1] + half_h
        if self.allow_imgpad:
            min_x, min_y = int(min_x), int(min_y)
            max_x, max_y = int(max_x), int(max_y)
        else:
            min_x, min_y = int(max(0, min_x)), int(max(0, min_y))
            max_x, max_y = int(min(w, max_x)), int(min(h, max_y))
        kp_x[kp_x != 0] -= min_x
        kp_y[kp_y != 0] -= min_y
        results["img_shape"] = (max_y - min_y, max_x - min_x)
        quad = results.get("crop_quadruple", (0.0, 0.0, 1.0, 1.0))
        results["crop_quadruple"] = _combine_quadruple(
            quad, (min_x / w, min_y / h, (max_x - min_x) / w,
                   (max_y - min_y) / h))
        return results


class RandomResizedCrop:
    """A crop of random area (``area_range`` of the image's) and aspect
    ratio (log-uniform in ``aspect_ratio_range``) in keypoint space
    (augmentations.py:242-370): ten (aspect, area) pairs are drawn at once
    and the first that fits is placed at a random corner; when none fits,
    the centred square.  Keypoints shift by the corner."""
    randomized = True

    def __init__(self, area_range=(0.56, 1.0),
                 aspect_ratio_range=(3 / 4, 4 / 3)):
        self.area_range = area_range
        self.aspect_ratio_range = aspect_ratio_range

    def _get_crop_bbox(self, img_shape, rng, max_attempts=10):
        img_h, img_w = img_shape
        area = img_h * img_w
        min_ar, max_ar = self.aspect_ratio_range
        ars = np.exp(rng.uniform(np.log(min_ar), np.log(max_ar),
                                 size=max_attempts))
        areas = rng.uniform(*self.area_range, size=max_attempts) * area
        ws = np.round(np.sqrt(areas * ars)).astype(np.int32)
        hs = np.round(np.sqrt(areas / ars)).astype(np.int32)
        for i in range(max_attempts):
            if hs[i] <= img_h and ws[i] <= img_w:
                x = rng.randint(0, img_w - ws[i] + 1)
                y = rng.randint(0, img_h - hs[i] + 1)
                return x, y, x + ws[i], y + hs[i]
        size = min(img_h, img_w)
        x = (img_w - size) // 2
        y = (img_h - size) // 2
        return x, y, x + size, y + size

    def __call__(self, results: Dict, rng) -> Dict:
        img_h, img_w = results["img_shape"]
        left, top, right, bottom = self._get_crop_bbox((img_h, img_w), rng)
        new_h, new_w = bottom - top, right - left
        quad = results.get("crop_quadruple", (0.0, 0.0, 1.0, 1.0))
        results["crop_quadruple"] = _combine_quadruple(
            quad, (left / img_w, top / img_h, new_w / img_w, new_h / img_h))
        results["crop_bbox"] = np.array([left, top, right, bottom])
        results["img_shape"] = (new_h, new_w)
        _shift_keypoints(results, left, top)
        _crop_imgs_inplace(results, left, top, right, bottom)
        return results


class CenterCrop:
    """The centred ``crop_size`` (an int, or (w, h)) crop
    (augmentations.py:699)."""
    randomized = False

    def __init__(self, crop_size):
        self.crop_size = ((crop_size, crop_size) if isinstance(crop_size, int)
                          else tuple(crop_size))

    def __call__(self, results: Dict) -> Dict:
        img_h, img_w = results["img_shape"]
        cw, ch = self.crop_size
        left = (img_w - cw) // 2
        top = (img_h - ch) // 2
        quad = results.get("crop_quadruple", (0.0, 0.0, 1.0, 1.0))
        results["crop_quadruple"] = _combine_quadruple(
            quad, (left / img_w, top / img_h, cw / img_w, ch / img_h))
        results["crop_bbox"] = np.array([left, top, left + cw, top + ch])
        results["img_shape"] = (ch, cw)
        _shift_keypoints(results, left, top)
        _crop_imgs_inplace(results, left, top, left + cw, top + ch)
        return results


def _rescale_size(old_size, scale):
    """mmcv's ``rescale_size``: (w, h) scaled by a number, or fitted into
    the (long, short) edges of ``scale`` keeping its aspect, rounded half
    up."""
    w, h = old_size
    if isinstance(scale, (float, int)) and not isinstance(scale, bool):
        factor = scale
    else:
        max_long, max_short = max(scale), min(scale)
        factor = min(max_long / max(h, w), max_short / min(h, w))
    return int(w * factor + 0.5), int(h * factor + 0.5)


class Resize:
    """Keypoint-space resize (augmentations.py:373-480): to ``scale`` (w, h)
    as given, or with ``keep_ratio`` fitted into it (a -1 edge is
    unbounded: ``(-1, 64)`` sets the short edge to 64).  The keypoints and
    the accumulated ``scale_factor`` scale by the float32 (w, h) factor;
    ``imgs``, where present, resize bilinearly."""
    randomized = False

    def __init__(self, scale, keep_ratio=True):
        if isinstance(scale, (list, tuple)):
            scale = tuple(scale)
            if min(scale) == -1:
                scale = (np.inf, max(scale))
        self.scale = scale
        self.keep_ratio = keep_ratio

    def __call__(self, results: Dict) -> Dict:
        if "scale_factor" not in results:
            results["scale_factor"] = np.array([1, 1], np.float32)
        img_h, img_w = results["img_shape"]
        if self.keep_ratio:
            new_w, new_h = _rescale_size((img_w, img_h), self.scale)
        else:
            new_w, new_h = self.scale
        sf = np.array([new_w / img_w, new_h / img_h], np.float32)
        results["img_shape"] = (new_h, new_w)
        results["keep_ratio"] = self.keep_ratio
        results["scale_factor"] = results["scale_factor"] * sf
        if "keypoint" in results:
            results["keypoint"] = results["keypoint"] * sf
        if "imgs" in results:
            results["imgs"] = [bilinear_resize(img, (new_w, new_h))
                               for img in results["imgs"]]
        return results


class Flip:
    """Horizontal flip with probability ``flip_ratio``, one draw a clip
    (augmentations.py:482-610): non-zero x coordinates become
    ``img_w - x`` and the left and right joints swap (keypoints and
    scores); ``imgs``, where present, mirror."""
    randomized = True

    def __init__(self, flip_ratio=0.5, direction="horizontal",
                 left_kp=COCO_LEFT_KP, right_kp=COCO_RIGHT_KP):
        if direction != "horizontal":
            raise ValueError(f"Flip: keypoint mode flips horizontally, not "
                             f"{direction!r}")
        self.flip_ratio = flip_ratio
        self.left_kp = left_kp
        self.right_kp = right_kp

    def __call__(self, results: Dict, rng) -> Dict:
        flip = rng.rand() < self.flip_ratio
        results["flip"] = flip
        results["flip_direction"] = "horizontal"
        if not flip:
            return results
        if "imgs" in results:
            results["imgs"] = [np.ascontiguousarray(img[:, ::-1])
                               for img in results["imgs"]]
        if "keypoint" not in results:
            return results
        img_w = results["img_shape"][1]
        kps = results["keypoint"]
        kp_x = kps[..., 0]
        kp_x[kp_x != 0] = img_w - kp_x[kp_x != 0]
        new_order = list(range(kps.shape[2]))
        if self.left_kp is not None and self.right_kp is not None:
            for lt, rt in zip(self.left_kp, self.right_kp):
                new_order[lt] = rt
                new_order[rt] = lt
        results["keypoint"] = kps[:, :, new_order]
        if "keypoint_score" in results:
            results["keypoint_score"] = \
                results["keypoint_score"][:, :, new_order]
        return results


class FormatHeatmapInput:
    """The (T, H, W, C) volume split into its clips: (nc, T/nc, H, W, C),
    as ``FormatGCNInput`` splits skeletons."""
    randomized = False

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        nc = results.get("num_clips", 1)
        t = imgs.shape[0]
        if t % nc:
            raise ValueError(f"{t} frames do not split into {nc} clips")
        results["imgs"] = np.ascontiguousarray(
            imgs.reshape((nc, t // nc) + imgs.shape[1:]))
        return results


def _shift_keypoints(results: Dict, left, top):
    if "keypoint" in results:
        results["keypoint"] = results["keypoint"] - np.array([left, top],
                                                             np.float32)


def _crop_imgs_inplace(results: Dict, x1, y1, x2, y2):
    if "imgs" in results:
        results["imgs"] = [img[y1:y2, x1:x2] for img in results["imgs"]]


def bilinear_resize(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize of an (H, W) or (H, W, C) image to ``size`` (w, h),
    cv2's pixel-centre mapping (align_corners=False), in float64; integer
    images round and clip to their type."""
    new_w, new_h = size
    h, w = img.shape[:2]
    if (w, h) == (new_w, new_h):
        return img.copy()
    x = (np.arange(new_w, dtype=np.float64) + 0.5) * (w / new_w) - 0.5
    y = (np.arange(new_h, dtype=np.float64) + 0.5) * (h / new_h) - 0.5
    x = np.clip(x, 0, w - 1)
    y = np.clip(y, 0, h - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    wx = (x - x0)[None, :]
    wy = (y - y0)[:, None]
    if img.ndim == 3:
        wx, wy = wx[..., None], wy[..., None]
    f = img.astype(np.float64)
    out = (f[y0][:, x0] * (1 - wy) * (1 - wx) + f[y0][:, x1] * (1 - wy) * wx
           + f[y1][:, x0] * wy * (1 - wx) + f[y1][:, x1] * wy * wx)
    if np.issubdtype(img.dtype, np.integer):
        out = np.clip(np.round(out), np.iinfo(img.dtype).min,
                      np.iinfo(img.dtype).max)
    return out.astype(img.dtype)


class RandomCrop:
    """Square random crop over pixels + keypoints
    (augmentations.py:124-239)."""
    randomized = True

    def __init__(self, size):
        assert isinstance(size, int)
        self.size = size

    def __call__(self, results: Dict, rng) -> Dict:
        img_h, img_w = results["img_shape"]
        assert self.size <= img_h and self.size <= img_w
        y_off = (int(rng.randint(0, img_h - self.size))
                 if img_h > self.size else 0)
        x_off = (int(rng.randint(0, img_w - self.size))
                 if img_w > self.size else 0)

        quad = results.get("crop_quadruple", (0.0, 0.0, 1.0, 1.0))
        results["crop_quadruple"] = np.array(_combine_quadruple(
            quad, (x_off / img_w, y_off / img_h,
                   self.size / img_w, self.size / img_h)), np.float32)
        bbox = np.array([x_off, y_off, x_off + self.size, y_off + self.size])
        results["crop_bbox"] = bbox
        results["img_shape"] = (self.size, self.size)
        if "keypoint" in results:
            results["keypoint"] = results["keypoint"] - bbox[:2]
        _crop_imgs_inplace(results, *bbox)
        return results


class Normalize:
    """Mean/std image normalization (augmentations.py:612-695); RGB stacks the
    frame list to (N, H, W, C), Flow pairs x/y frames into (N, H, W, 2)."""
    randomized = False

    def __init__(self, mean, std, to_bgr=False, adjust_magnitude=False):
        self.mean = np.array(mean, np.float32)
        self.std = np.array(std, np.float32)
        self.to_bgr = to_bgr
        self.adjust_magnitude = adjust_magnitude

    def __call__(self, results: Dict) -> Dict:
        modality = results.get("modality", "RGB")
        if modality == "RGB":
            imgs = np.stack(results["imgs"]).astype(np.float32)
            if self.to_bgr:
                imgs = imgs[..., ::-1]
            imgs = (imgs - self.mean) / self.std
            results["imgs"] = imgs
            results["img_norm_cfg"] = dict(mean=self.mean, std=self.std,
                                           to_bgr=self.to_bgr)
            return results
        if modality == "Flow":
            n = len(results["imgs"]) // 2
            x = np.stack(results["imgs"][0::2]).astype(np.float32)
            y = np.stack(results["imgs"][1::2]).astype(np.float32)
            x = (x - self.mean[0]) / self.std[0]
            y = (y - self.mean[1]) / self.std[1]
            if self.adjust_magnitude:
                x = x * results["scale_factor"][0]
                y = y * results["scale_factor"][1]
            results["imgs"] = np.stack([x, y], axis=-1)
            return results
        raise NotImplementedError(modality)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class ThreeCrop:
    """Three equal crops along the long side (augmentations.py:769-838);
    frames triple: (T,) -> (3T,)."""
    randomized = False

    def __init__(self, crop_size):
        self.crop_size = _pair(crop_size)

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        img_h, img_w = imgs[0].shape[:2]
        cw, ch = self.crop_size
        assert ch == img_h or cw == img_w
        if ch == img_h:
            step = (img_w - cw) // 2
            offsets = [(0, 0), (2 * step, 0), (step, 0)]
        else:
            step = (img_h - ch) // 2
            offsets = [(0, 0), (0, 2 * step), (0, step)]
        cropped, bboxes = [], []
        for x_off, y_off in offsets:
            cropped.extend(img[y_off:y_off + ch, x_off:x_off + cw]
                           for img in imgs)
            bboxes.extend([[x_off, y_off, x_off + cw, y_off + ch]] * len(imgs))
        results["imgs"] = cropped
        results["crop_bbox"] = np.array(bboxes)
        results["img_shape"] = (ch, cw)
        return results


class TenCrop:
    """Four corners + center, each plus horizontal flip
    (augmentations.py:840-920); frames x10."""
    randomized = False

    def __init__(self, crop_size):
        self.crop_size = _pair(crop_size)

    def __call__(self, results: Dict) -> Dict:
        imgs = results["imgs"]
        img_h, img_w = imgs[0].shape[:2]
        cw, ch = self.crop_size
        w_step = (img_w - cw) // 4
        h_step = (img_h - ch) // 4
        offsets = [(0, 0), (4 * w_step, 0), (0, 4 * h_step),
                   (4 * w_step, 4 * h_step), (2 * w_step, 2 * h_step)]
        out, bboxes = [], []
        for x_off, y_off in offsets:
            crop = [img[y_off:y_off + ch, x_off:x_off + cw] for img in imgs]
            out.extend(crop)
            out.extend(np.ascontiguousarray(c[:, ::-1]) for c in crop)
            bboxes.extend([[x_off, y_off, x_off + cw, y_off + ch]]
                          * (len(imgs) * 2))
        results["imgs"] = out
        results["crop_bbox"] = np.array(bboxes)
        results["img_shape"] = (ch, cw)
        return results
