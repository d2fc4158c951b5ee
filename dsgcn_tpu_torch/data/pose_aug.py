"""Keypoint-space crop of the 2D pose pipelines (port of ``PoseCompact``
and ``_combine_quadruple`` from ``dsgcn_tpu/data/pose_aug.py``; reference
datasets/pipelines/augmentations.py:22-117).  The hrnet DS-GCN pipelines
(``configs/dsgcn/kinetics400_hrnet``, ``fight_detection``) run it after
``PoseDecode``; only the keypoints and ``img_shape`` change, no pixels
exist."""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["PoseCompact"]


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
