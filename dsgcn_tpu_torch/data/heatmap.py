"""Pseudo-heatmap volumes for PoseC3D (the port's copy of
``GeneratePoseTarget``, ``Heatmap2Potion`` and the COCO constants of
``dsgcn_tpu/data/heatmap.py``; reference
datasets/pipelines/heatmap_related.py:10-339).

Per frame, a Gaussian bump per person at each joint (or a Gaussian of the
distance to each limb's segment), its amplitude the joint's score, drawn
in a 3-sigma patch whose bounds truncate toward zero (``int``) over
float32 ``arange`` grids, as the reference draws them.  The volume is
channels-last ``imgs: (T, H, W, C)`` for the 3D-CNN (the reference's
(T, C, H, W) with ``channels_last=False``).  ``Heatmap2Potion`` colours
such a volume over time into PoTion's (num_clips, H, W, K (2C + 1))
images.  Numpy only.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["GeneratePoseTarget", "Heatmap2Potion", "COCO_SKELETONS", "COCO_LEFT_KP",
           "COCO_RIGHT_KP", "COCO_LEFT_LIMB", "COCO_RIGHT_LIMB"]

EPS = 1e-3

COCO_SKELETONS = ((0, 1), (0, 2), (1, 3), (2, 4), (0, 5), (5, 7), (7, 9),
                  (0, 6), (6, 8), (8, 10), (5, 11), (11, 13), (13, 15),
                  (6, 12), (12, 14), (14, 16), (11, 12))
COCO_LEFT_KP = (1, 3, 5, 7, 9, 11, 13, 15)
COCO_RIGHT_KP = (2, 4, 6, 8, 10, 12, 14, 16)
COCO_LEFT_LIMB = (0, 2, 4, 5, 6, 10, 11, 12)
COCO_RIGHT_LIMB = (1, 3, 7, 8, 9, 13, 14, 15)


class GeneratePoseTarget:
    """Keypoint (``with_kp``) or limb (``with_limb``) heatmaps of the
    results' ``keypoint`` (M, T, V, 2) in an ``img_shape`` canvas, scaled
    by ``keypoint_score`` when ``use_score`` (else 1); a joint or limb under
    a score of 1e-3 draws nothing.  ``double`` appends the left-right
    swapped, horizontally flipped volume along T.  Writes ``imgs``."""
    randomized = False

    def __init__(self, sigma=0.6, use_score=True, with_kp=True,
                 with_limb=False, skeletons=COCO_SKELETONS, double=False,
                 left_kp=COCO_LEFT_KP, right_kp=COCO_RIGHT_KP,
                 left_limb=COCO_LEFT_LIMB, right_limb=COCO_RIGHT_LIMB,
                 channels_last=True):
        if with_kp + with_limb != 1:
            raise ValueError("GeneratePoseTarget draws keypoints or limbs: "
                             "set exactly one of with_kp and with_limb")
        self.sigma = sigma
        self.use_score = use_score
        self.with_kp = with_kp
        self.with_limb = with_limb
        self.skeletons = skeletons
        self.double = double
        self.left_kp = left_kp
        self.right_kp = right_kp
        self.left_limb = left_limb
        self.right_limb = right_limb
        self.channels_last = channels_last

    def _kp_heatmap(self, arr, centers, max_values):
        """A Gaussian bump per person at one joint (reference :72-106)."""
        sigma = self.sigma
        img_h, img_w = arr.shape
        for center, max_value in zip(centers, max_values):
            if max_value < EPS:
                continue
            mu_x, mu_y = center[0], center[1]
            st_x = max(int(mu_x - 3 * sigma), 0)
            ed_x = min(int(mu_x + 3 * sigma) + 1, img_w)
            st_y = max(int(mu_y - 3 * sigma), 0)
            ed_y = min(int(mu_y + 3 * sigma) + 1, img_h)
            x = np.arange(st_x, ed_x, 1, np.float32)
            y = np.arange(st_y, ed_y, 1, np.float32)
            if not (len(x) and len(y)):
                continue
            y = y[:, None]
            patch = np.exp(-((x - mu_x) ** 2 + (y - mu_y) ** 2) / 2
                           / sigma ** 2)
            arr[st_y:ed_y, st_x:ed_x] = np.maximum(
                arr[st_y:ed_y, st_x:ed_x], patch * max_value)

    def _limb_heatmap(self, arr, starts, ends, start_values, end_values):
        """A Gaussian of the distance to each person's limb segment
        (reference :108-174)."""
        sigma = self.sigma
        img_h, img_w = arr.shape
        for start, end, sv, ev in zip(starts, ends, start_values,
                                      end_values):
            value_coeff = min(sv, ev)
            if value_coeff < EPS:
                continue
            min_x = max(int(min(start[0], end[0]) - 3 * sigma), 0)
            max_x = min(int(max(start[0], end[0]) + 3 * sigma) + 1, img_w)
            min_y = max(int(min(start[1], end[1]) - 3 * sigma), 0)
            max_y = min(int(max(start[1], end[1]) + 3 * sigma) + 1, img_h)
            x = np.arange(min_x, max_x, 1, np.float32)
            y = np.arange(min_y, max_y, 1, np.float32)
            if not (len(x) and len(y)):
                continue
            y = y[:, None]
            d2_start = (x - start[0]) ** 2 + (y - start[1]) ** 2
            d2_end = (x - end[0]) ** 2 + (y - end[1]) ** 2
            d2_ab = (start[0] - end[0]) ** 2 + (start[1] - end[1]) ** 2
            if d2_ab < 1:
                self._kp_heatmap(arr, start[None], np.asarray([sv]))
                continue
            coeff = (d2_start - d2_end + d2_ab) / 2.0 / d2_ab
            a_dom = coeff <= 0
            b_dom = coeff >= 1
            seg_dom = 1 - a_dom - b_dom
            proj_x = start[0] + coeff * (end[0] - start[0])
            proj_y = start[1] + coeff * (end[1] - start[1])
            d2_line = (x + 0 * y - proj_x) ** 2 + (y + 0 * x - proj_y) ** 2
            d2_seg = a_dom * d2_start + b_dom * d2_end + seg_dom * d2_line
            patch = np.exp(-d2_seg / 2.0 / sigma ** 2) * value_coeff
            arr[min_y:max_y, min_x:max_x] = np.maximum(
                arr[min_y:max_y, min_x:max_x], patch)

    def __call__(self, results: Dict) -> Dict:
        all_kps = results["keypoint"]            # (M, T, V, 2)
        if "keypoint_score" in results:
            all_scores = results["keypoint_score"]
        else:
            all_scores = np.ones(all_kps.shape[:-1], np.float32)
        img_h, img_w = results["img_shape"]
        _, T, V, _ = all_kps.shape
        C = V if self.with_kp else len(self.skeletons)
        heat = np.zeros((T, C, img_h, img_w), np.float32)
        for t in range(T):
            kps = all_kps[:, t]
            scores = (all_scores[:, t] if self.use_score
                      else np.ones_like(all_scores[:, t]))
            if self.with_kp:
                for i in range(V):
                    self._kp_heatmap(heat[t, i], kps[:, i], scores[:, i])
            else:
                for i, (s, e) in enumerate(self.skeletons):
                    self._limb_heatmap(heat[t, i], kps[:, s], kps[:, e],
                                       scores[:, s], scores[:, e])
        if self.double:
            indices = np.arange(C, dtype=np.int64)
            left, right = ((self.left_kp, self.right_kp) if self.with_kp
                           else (self.left_limb, self.right_limb))
            for lt, rt in zip(left, right):
                indices[lt], indices[rt] = rt, lt
            heat = np.concatenate([heat, heat[..., ::-1][:, indices]])
        if self.channels_last:
            heat = np.transpose(heat, (0, 2, 3, 1))   # (T, H, W, C)
        results["imgs"] = np.ascontiguousarray(heat)
        return results


class Heatmap2Potion:
    """Temporal color-coding of joint heatmaps into a PoTion image
    (reference heatmap_related.py:272-339): each frame's heatmap is weighted
    by a C-bin linear color ramp over time and summed; emits the U
    (max-normalized), I (intensity), N (I-normalized) maps or their 'full'
    concat, flattened to (num_clips, H, W, K*(2C+1)).

    Input 'imgs': (N*T, H, W, K) channels-last volumes (the layout of
    ``GeneratePoseTarget``; with ``channels_last=False``, the reference's
    (N*T, K, H, W))."""
    randomized = False

    def __init__(self, C: int, option: str = "full",
                 channels_last: bool = True):
        assert isinstance(C, int) and C >= 2
        assert option in ("U", "N", "I", "full")
        self.C = C
        self.option = option
        self.eps = 1e-4
        self.channels_last = channels_last

    def _colors(self, clip_len: int) -> np.ndarray:
        """(T, C) linear interpolation ramp (idx2color, :291-303)."""
        C = self.C
        out = np.zeros((clip_len, C), np.float32)
        for t in range(clip_len):
            if t == clip_len - 1:
                out[t, C - 1] = 1.0
                continue
            val = t / (clip_len - 1) * (C - 1)
            b = int(val)
            val -= b
            out[t, b] = 1 - val
            out[t, b + 1] = val
        return out

    def __call__(self, results: Dict, rng=None) -> Dict:
        heat = results["imgs"]
        clip_len = results.get("clip_len", heat.shape[0])
        if isinstance(clip_len, dict):
            clip_len = clip_len.get("Pose", heat.shape[0])
        heat = heat.reshape((-1, clip_len) + heat.shape[1:])
        if not self.channels_last:                # (n, t, K, H, W) ->
            heat = heat.transpose(0, 1, 3, 4, 2)  # (n, t, H, W, K)
        colors = self._colors(clip_len)
        heat_s = np.einsum("nthwk,tc->nhwkc", heat.astype(np.float32), colors)
        u_norm = heat_s.max(axis=(1, 2), keepdims=True)
        heat_u = heat_s / (u_norm + self.eps)
        heat_i = heat_u.sum(axis=-1, keepdims=True)
        heat_n = heat_u / (heat_i + 1)
        if self.option == "U":
            out = heat_u
        elif self.option == "I":
            out = heat_i
        elif self.option == "N":
            out = heat_n
        else:
            out = np.concatenate([heat_u, heat_i, heat_n], axis=-1)
        results["imgs"] = out.reshape(out.shape[:3] + (-1,))
        return results
