"""Video loading and sampling transforms (the port's copy of
``dsgcn_tpu/data/video.py``; reference datasets/pipelines/loading.py
DecordInit :11-59, DecordDecode :62-119, ArrayDecode :123-180, and
sampling.py SampleFrames :284-470).

``SampleFrames`` draws its train clips from the ``RandomState`` that
``Compose`` passes it, as JAX's does, so the same seed gives the same
frames.  ``ArrayDecode`` picks frames from a preloaded (T, H, W, C) array
and ``RawFrameDecode`` reads an extracted frame directory with PIL; the
decord pair builds without decord and raises when called, as JAX's does
(neither this package nor the GPU machine ships decord).  Numpy only.
"""
from __future__ import annotations

import os.path as osp
from typing import Dict

import numpy as np

__all__ = ["SampleFrames", "ArrayDecode", "RawFrameDecode", "DecordInit",
           "DecordDecode"]


class SampleFrames:
    """Fixed-interval clip sampler (reference sampling.py:284-470)."""
    randomized = True

    def __init__(self, clip_len, frame_interval=1, num_clips=1,
                 temporal_jitter=False, twice_sample=False,
                 out_of_bound_opt="loop", test_mode=False,
                 keep_tail_frames=False):
        assert out_of_bound_opt in ("loop", "repeat_last")
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.temporal_jitter = temporal_jitter
        self.twice_sample = twice_sample
        self.out_of_bound_opt = out_of_bound_opt
        self.test_mode = test_mode
        self.keep_tail_frames = keep_tail_frames

    def _get_train_clips(self, num_frames, rng):
        ori_clip_len = self.clip_len * self.frame_interval
        if self.keep_tail_frames:
            avg = (num_frames - ori_clip_len + 1) / float(self.num_clips)
            if num_frames > ori_clip_len - 1:
                base = np.arange(self.num_clips) * avg
                return (base + rng.uniform(0, avg, self.num_clips)).astype(
                    np.int64)
            return np.zeros((self.num_clips,), np.int64)
        avg = (num_frames - ori_clip_len + 1) // self.num_clips
        if avg > 0:
            base = np.arange(self.num_clips) * avg
            return base + rng.randint(avg, size=self.num_clips)
        if num_frames > max(self.num_clips, ori_clip_len):
            return np.sort(rng.randint(num_frames - ori_clip_len + 1,
                                       size=self.num_clips))
        if avg == 0:
            ratio = (num_frames - ori_clip_len + 1.0) / self.num_clips
            return np.around(np.arange(self.num_clips) * ratio)
        return np.zeros((self.num_clips,), np.int64)

    def _get_test_clips(self, num_frames):
        ori_clip_len = self.clip_len * self.frame_interval
        avg = (num_frames - ori_clip_len + 1) / float(self.num_clips)
        if num_frames > ori_clip_len - 1:
            base = np.arange(self.num_clips) * avg
            offsets = (base + avg / 2.0).astype(np.int64)
            if self.twice_sample:
                offsets = np.concatenate([offsets, base.astype(np.int64)])
            return offsets
        return np.zeros((self.num_clips,), np.int64)

    def __call__(self, results: Dict, rng) -> Dict:
        total_frames = results["total_frames"]
        offsets = self._get_test_clips(total_frames) if self.test_mode \
            else self._get_train_clips(total_frames, rng)
        inds = offsets[:, None] + np.arange(self.clip_len)[None] \
            * self.frame_interval
        inds = np.concatenate(inds)
        if self.temporal_jitter:
            inds = inds + rng.randint(self.frame_interval, size=len(inds))
        inds = inds.reshape((-1, self.clip_len))
        if self.out_of_bound_opt == "loop":
            inds = np.mod(inds, total_frames)
        else:   # repeat_last (sampling.py:446-451)
            safe = inds < total_frames
            last = np.max(safe * inds, axis=1)
            inds = safe * inds + ((1 - safe).T * last).T
        inds = np.concatenate(inds) + results.get("start_index", 0)
        results["frame_inds"] = inds.astype(np.int64)
        results["clip_len"] = self.clip_len
        results["frame_interval"] = self.frame_interval
        results["num_clips"] = self.num_clips \
            * (2 if (self.test_mode and self.twice_sample) else 1)
        return results


class ArrayDecode:
    """Pick frames from a preloaded 4D array (reference loading.py:122-180)."""
    randomized = False

    def __call__(self, results: Dict) -> Dict:
        modality = results.get("modality", "RGB")
        array = results["array"]
        inds = np.squeeze(results["frame_inds"]) + results.get("offset", 0)
        imgs = []
        for idx in inds:
            if modality == "RGB":
                imgs.append(array[idx])
            elif modality == "Flow":
                imgs.extend([array[idx, ..., 0], array[idx, ..., 1]])
            else:
                raise NotImplementedError(modality)
        results["imgs"] = imgs
        results["original_shape"] = imgs[0].shape[:2]
        results["img_shape"] = imgs[0].shape[:2]
        return results


class RawFrameDecode:
    """Load frames from an extracted frame directory via PIL (the cv2/decord
    free analog of mmaction RawFrameDecode; reference pyskl relies on decord
    videos instead)."""
    randomized = False

    def __init__(self, filename_tmpl="img_{:05}.jpg"):
        self.filename_tmpl = filename_tmpl

    def __call__(self, results: Dict) -> Dict:
        from PIL import Image
        frame_dir = results["frame_dir"]
        inds = np.squeeze(results["frame_inds"])
        imgs = []
        for idx in inds:
            path = osp.join(frame_dir, self.filename_tmpl.format(int(idx)))
            with Image.open(path) as im:
                imgs.append(np.asarray(im.convert("RGB")))
        results["imgs"] = imgs
        results["original_shape"] = imgs[0].shape[:2]
        results["img_shape"] = imgs[0].shape[:2]
        return results


class DecordInit:
    """Open a video with decord (reference loading.py:11-59).  It builds
    without decord (configs may name it); called without decord it raises
    and points to ``ArrayDecode`` / ``RawFrameDecode``."""
    randomized = False

    def __init__(self, num_threads=1, **kw):
        self.num_threads = num_threads

    def __call__(self, results: Dict) -> Dict:
        try:
            import decord
        except ImportError as e:
            raise ImportError(
                "decord is not installed; use "
                "ArrayDecode (preloaded arrays) or RawFrameDecode "
                "(extracted frame dirs) instead") from e
        container = decord.VideoReader(results["filename"],
                                       num_threads=self.num_threads)
        results["video_reader"] = container
        results["total_frames"] = len(container)
        return results


class DecordDecode:
    """Decode sampled frames with decord (reference loading.py:62-119)."""
    randomized = False

    def __init__(self, mode="accurate"):
        assert mode in ("accurate", "efficient")
        self.mode = mode

    def __call__(self, results: Dict) -> Dict:
        container = results["video_reader"]
        inds = np.squeeze(results["frame_inds"])
        if self.mode == "accurate":
            imgs = list(container.get_batch(inds).asnumpy())
        else:
            container.seek(0)
            imgs = []
            for idx in inds:
                container.seek(int(idx))
                imgs.append(container.next().asnumpy())
        results["video_reader"] = None
        results["imgs"] = imgs
        results["original_shape"] = imgs[0].shape[:2]
        results["img_shape"] = imgs[0].shape[:2]
        return results
