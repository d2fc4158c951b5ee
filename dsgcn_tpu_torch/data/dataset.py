"""Skeleton and video datasets and batch loading (port of
``dsgcn_tpu/data/dataset.py``: ``PoseDataset``, ``GestureDataset``,
``VideoDataset``, ``RepeatDataset``, ``ConcatDataset``,
``epoch_indices``, ``Loader``,
``prefetch``, ``make_synthetic_pose_dataset``, ``build_dataset``).

Reference parity targets: PoseDataset (datasets/pose_dataset.py:12-125)
and the deterministic per-epoch sampler (samplers/distributed_sampler.py).
The per-epoch permutation and every sample's ``RandomState`` are seeded
exactly as in the JAX ``Loader``, so both packages yield the same batches
for one seed.  Batches are stacked numpy arrays; the trainer moves them to
the device.
"""
from __future__ import annotations

import copy as cp
import pickle
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from .transforms import Compose, build_pipeline


def load_annotations(ann_file: str) -> Dict:
    with open(ann_file, "rb") as f:
        return pickle.load(f)


class PoseDataset:
    """Skeleton pickle dataset with named splits (pose_dataset.py:12-125).

    anno file layout: {'split': {name: [frame_dir, ...]}, 'annotations':
    [{frame_dir, label, keypoint (M, T, V, C), total_frames, ...}, ...]}.
    """

    def __init__(self, ann_file: str, pipeline, split: Optional[str] = None,
                 valid_ratio: Optional[float] = None,
                 box_thr: Optional[float] = None, test_mode: bool = False):
        self.ann_file = ann_file
        self.pipeline = (pipeline if isinstance(pipeline, Compose)
                         else build_pipeline(pipeline))
        self.test_mode = test_mode
        data = load_annotations(ann_file)
        annos = data["annotations"] if isinstance(data, dict) else data
        if split is not None:
            if not (isinstance(data, dict) and "split" in data):
                raise ValueError("split requested but the annotation file "
                                 "has no split dict")
            allowed = set(data["split"][split])
            key = "frame_dir" if "frame_dir" in annos[0] else "filename"
            annos = [a for a in annos if a[key] in allowed]
        # keep the annos whose share of valid frames at box_thr reaches
        # valid_ratio (pose_dataset.py:101-102)
        if valid_ratio is not None and valid_ratio > 0:
            annos = [a for a in annos
                     if a.get("valid", {}).get(box_thr, a.get("total_frames", 1))
                     / a.get("total_frames", 1) >= valid_ratio]
        self.video_infos = annos

    def __len__(self) -> int:
        return len(self.video_infos)

    def prepare(self, idx: int, rng: Optional[np.random.RandomState] = None):
        results = cp.deepcopy(self.video_infos[idx])
        results.setdefault("start_index", 0)
        results.setdefault("total_frames", results["keypoint"].shape[1])
        results["test_mode"] = self.test_mode
        return self.pipeline(results, rng=rng)

    __getitem__ = prepare

    @property
    def labels(self) -> np.ndarray:
        return np.array([a["label"] for a in self.video_infos])


GESTURE_LABEL_NAMES = [
    "Doing other things", "Drumming Fingers", "No gesture",
    "Pulling Hand In", "Pulling Two Fingers In", "Pushing Hand Away",
    "Pushing Two Fingers Away", "Rolling Hand Backward",
    "Rolling Hand Forward", "Shaking Hand", "Sliding Two Fingers Down",
    "Sliding Two Fingers Left", "Sliding Two Fingers Right",
    "Sliding Two Fingers Up", "Stop Sign", "Swiping Down", "Swiping Left",
    "Swiping Right", "Swiping Up", "Dislike", "Like",
    "Turning Hand Clockwise", "Turning Hand Counterclockwise",
    "Zooming In With Full Hand", "Zooming In With Two Fingers",
    "Zooming Out With Full Hand", "Zooming Out With Two Fingers",
    "Call", "Fist", "Four", "Mute", "OK", "One", "Palm", "Peace", "Rock",
    "Three-Middle", "Three-Left", "Two Up", "No Gesture",
]


class GestureDataset(PoseDataset):
    """Hand-gesture pose dataset (reference datasets/gesture_dataset.py:
    14-155; JAX ``data/dataset.py:GestureDataset``): the 'train+val' split
    is the union of both; splits with 'train' in the name keep the annos
    with at least ``valid_frames_thr`` valid frames; ``squeeze`` drops the
    frames whose keypoint scores are all <= 0 (``total_frames``,
    ``hand_score`` and ``hand_lr`` follow); ``mode='2D'`` keeps x, y;
    ``subset`` keeps those labels.  :meth:`evaluate` gives top-1, top-5
    and top-1 per class of the 40 jester/hagrid gestures."""

    label_names = GESTURE_LABEL_NAMES

    def __init__(self, ann_file: str, pipeline, split: str,
                 valid_frames_thr: int = 0, squeeze: bool = True,
                 mode: str = "2D", subset=None, test_mode: bool = False):
        self.valid_frames_thr, self.squeeze, self.mode = (
            valid_frames_thr, squeeze, mode)
        data = load_annotations(ann_file)
        annos, splits = data["annotations"], data["split"]
        allowed = (set(splits["train"] + splits["val"])
                   if split == "train+val" else set(splits[split]))
        key = "filename" if "filename" in annos[0] else "frame_dir"
        annos = [a for a in annos if a[key] in allowed]
        if "train" in split and "valid_frames" in annos[0]:
            annos = [a for a in annos
                     if a["valid_frames"] >= valid_frames_thr]
        out = []
        for item in annos:
            item = dict(item)
            kp = np.asarray(item["keypoint"])
            if kp.ndim == 2:
                kp = kp[None, None]
            elif squeeze and kp.ndim == 4:
                if kp.shape[0] != 1:
                    raise ValueError(f"gesture anno {item[key]}: {kp.shape[0]}"
                                     " hands, one expected")
                flag = (kp[0, ..., 2] > 0).sum(axis=1) > 0
                item["total_frames"] = int(flag.sum())
                kp = kp[:, flag]
                for extra in ("hand_score", "hand_lr"):
                    if extra in item:
                        item[extra] = np.asarray(item[extra])[:, flag]
            if mode == "2D":
                kp = kp[..., :2]
            item["keypoint"] = kp
            if subset is None or item["label"] in subset:
                out.append(item)
        self.ann_file = ann_file
        self.pipeline = (pipeline if isinstance(pipeline, Compose)
                         else build_pipeline(pipeline))
        self.test_mode = test_mode
        self.video_infos = out

    def evaluate(self, scores: np.ndarray) -> Dict:
        """Top-1, top-5 and per-class top-1 (gesture_dataset.py:105-155)."""
        gt = self.labels
        order = np.argsort(-np.asarray(scores), axis=1)
        hit1 = order[:, 0] == gt
        hit5 = (order[:, :5] == gt[:, None]).any(axis=1)
        res = {"top1_acc": float(hit1.mean()), "top5_acc": float(hit5.mean()),
               "per_class": {}}
        for i, name in enumerate(self.label_names):
            mask = gt == i
            if mask.any():
                res["per_class"][name] = float(hit1[mask].mean())
        return res


class RepeatDataset:
    """A dataset repeated ``times`` times (dataset_wrappers.py:8-38): the
    reference's way of scaling an epoch (the STGCN++ configs train on
    ``RepeatDataset(times=5)``)."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self) -> int:
        return self.times * len(self.dataset)

    def prepare(self, idx: int, rng: Optional[np.random.RandomState] = None):
        return self.dataset.prepare(idx % len(self.dataset), rng=rng)

    __getitem__ = prepare

    @property
    def labels(self) -> np.ndarray:
        return np.tile(self.dataset.labels, self.times)


class ConcatDataset:
    """Datasets one after another (dataset_wrappers.py:42-73)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def prepare(self, idx: int, rng: Optional[np.random.RandomState] = None):
        d = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[d].prepare(idx - self._offsets[d], rng=rng)

    __getitem__ = prepare

    @property
    def labels(self) -> np.ndarray:
        return np.concatenate([d.labels for d in self.datasets])


class VideoDataset:
    """Text-annotation dataset (reference datasets/video_dataset.py:9).

    Line formats: "<filename> <label>" (video files, decord pipelines) or
    the rawframe form "<frame_dir> <total_frames> <label>" (mmaction
    RawframeDataset convention) for RawFrameDecode pipelines."""

    def __init__(self, ann_file: str, pipeline, data_prefix: str = "",
                 test_mode: bool = False):
        self.pipeline = (pipeline if isinstance(pipeline, Compose)
                         else build_pipeline(pipeline))
        self.test_mode = test_mode
        self.video_infos = []
        with open(ann_file) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                if len(parts) == 3:
                    self.video_infos.append(dict(
                        frame_dir=data_prefix + parts[0],
                        total_frames=int(parts[1]), label=int(parts[2])))
                else:
                    name, label = parts
                    self.video_infos.append(dict(
                        filename=data_prefix + name, label=int(label)))

    def __len__(self):
        return len(self.video_infos)

    def prepare(self, idx, rng=None):
        results = cp.deepcopy(self.video_infos[idx])
        results["test_mode"] = self.test_mode
        results.setdefault("start_index", 0)
        return self.pipeline(results, rng=rng)

    __getitem__ = prepare

    @property
    def labels(self):
        return np.array([a["label"] for a in self.video_infos])


def epoch_indices(n: int, epoch: int, shard: int = 0, num_shards: int = 1,
                  shuffle: bool = True, seed: int = 0,
                  drop_last_to_multiple: Optional[int] = None,
                  class_prob: Optional[dict] = None,
                  labels: Optional[np.ndarray] = None) -> np.ndarray:
    """Deterministic per-epoch shard indices (distributed_sampler.py:9-43),
    as the JAX package computes them: every process draws the same
    permutation of range(n) from ``RandomState(seed + epoch)``, pads it to a
    multiple of ``num_shards`` by wrapping, and takes the strided slice
    ``shard::num_shards``; ``drop_last_to_multiple`` then cuts the slice to
    a multiple of it.  With ``class_prob`` (label -> replication factor r,
    1 for a label it omits) sample i appears floor(r) times, once more with
    probability frac(r), before the shuffle (ClassSpecificDistributedSampler,
    samplers/distributed_sampler.py:46-112): the same generator draws the
    extra copies, then the permutation, as in JAX."""
    g = np.random.RandomState(seed + epoch)
    if class_prob is not None:
        if labels is None:
            raise ValueError("class_prob needs the samples' labels")
        reps = np.array([class_prob.get(int(lab), 1.0) for lab in labels])
        counts = np.floor(reps).astype(int)
        counts += (g.rand(n) < (reps - counts)).astype(int)
        inds = np.repeat(np.arange(n), counts)
        n = len(inds)
        if shuffle:
            inds = inds[g.permutation(n)]
    elif shuffle:
        inds = g.permutation(n)
    else:
        inds = np.arange(n)
    total = ((n + num_shards - 1) // num_shards) * num_shards
    if total > n:
        inds = np.concatenate([inds, inds[:total - n]])
    inds = inds[shard::num_shards]
    if drop_last_to_multiple:
        keep = (len(inds) // drop_last_to_multiple) * drop_last_to_multiple
        inds = inds[:keep]
    return inds


class Loader:
    """Maps the pipeline over an index shard into stacked numpy batches.

    Sample ``idx`` of epoch ``e`` runs the pipeline with
    ``RandomState((seed * 1_000_003 + e * 7919 + idx) % 2**31)``, so the
    batches do not depend on worker scheduling and equal the JAX loader's.
    ``shard``/``num_shards``: this process's share of every epoch
    (:func:`epoch_indices`); one process a device takes shard = its data
    rank and num_shards = the data axis, so the graph ranks of one data row
    load the same batches.  ``class_prob`` (label -> replication factor)
    replicates samples by class each epoch (:func:`epoch_indices`), so an
    epoch's length may vary; ``steps_per_epoch`` counts epoch 0's.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 drop_last: bool = False, shard: int = 0,
                 num_shards: int = 1, class_prob: Optional[dict] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.shard, self.num_shards = shard, num_shards
        self.class_prob = class_prob
        self._pool = ThreadPoolExecutor(num_workers) if num_workers else None

    def _indices(self, epoch: int) -> np.ndarray:
        labels = self.dataset.labels if self.class_prob is not None else None
        return epoch_indices(len(self.dataset), epoch, self.shard,
                             self.num_shards, self.shuffle, self.seed,
                             class_prob=self.class_prob, labels=labels)

    def _steps(self, n: int) -> int:
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def steps_per_epoch(self) -> int:
        return self._steps(len(self._indices(0)))

    def _prepare(self, idx: int, epoch: int):
        rng = np.random.RandomState(
            (self.seed * 1_000_003 + epoch * 7919 + int(idx)) % (2 ** 31))
        return self.dataset.prepare(int(idx), rng=rng)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        inds = self._indices(epoch)
        for b in range(self._steps(len(inds))):
            chunk = inds[b * self.batch_size:(b + 1) * self.batch_size]
            if self._pool is not None:
                samples = list(self._pool.map(
                    lambda i: self._prepare(i, epoch), chunk))
            else:
                samples = [self._prepare(i, epoch) for i in chunk]
            yield _collate(samples)


def prefetch(iterable, fn=None, depth: int = 2):
    """Run an iterator (and ``fn`` on each item) ``depth`` items ahead in a
    background thread, so the host pipeline of step s+1 overlaps the
    device's step s.  A producer's exception re-raises at the consumer.
    ``depth=0`` maps in line, without a thread."""
    if depth <= 0:
        for item in iterable:
            yield fn(item) if fn is not None else item
        return
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    failure: List[BaseException] = []

    def producer():
        try:
            for item in iterable:
                q.put(fn(item) if fn is not None else item)
        except BaseException as e:   # noqa: BLE001 -- re-raised below
            failure.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if failure:
                raise failure[0]
            return
        yield item


def _collate(samples: List[Dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = (np.stack(vals) if isinstance(vals[0], np.ndarray)
                  else np.asarray(vals))
    return out


def make_synthetic_pose_dataset(num_samples=64, num_classes=10, m=2, t=80,
                                v=25, c=3, seed=0, path=None,
                                layout="nturgb+d"):
    """Synthetic NTU-like annotations (no real data needed), the same draws
    as the JAX package's: a per-sample scale carries the class, so it
    survives centering and random rotations.  ``layout='coco'`` gives
    hrnet-style 2D annos instead: pixel keypoints (m, t, 17, 2) about the
    centre of a 1080 x 1920 ``img_shape`` and scores (m, t, 17) in [0.3,
    1).  Splits 'train' (the first 3/4) and 'val'.  Written to ``path`` as
    a pickle when given."""
    rng = np.random.default_rng(seed)
    coco = layout == "coco"
    if coco:
        v, c = 17, 2
    annos = []
    for i in range(num_samples):
        label = int(rng.integers(num_classes))
        kp = (rng.standard_normal((m, t, v, c)) * (1.0 + 0.75 * label)
              ).astype(np.float32)
        a = dict(frame_dir=f"S{i:05d}", label=label, keypoint=kp,
                 total_frames=t)
        if coco:
            a["keypoint"] = (kp * 80.0 + np.float32([960, 540])
                             ).astype(np.float32)
            a["keypoint_score"] = rng.uniform(
                0.3, 1.0, size=(m, t, v)).astype(np.float32)
            a["img_shape"] = (1080, 1920)
        annos.append(a)
    cut = num_samples * 3 // 4
    data = dict(split={"train": [a["frame_dir"] for a in annos[:cut]],
                       "val": [a["frame_dir"] for a in annos[cut:]]},
                annotations=annos)
    if path is not None:
        with open(path, "wb") as f:
            pickle.dump(data, f)
    return data


def make_compressed_pose_anno(seed=0, t=120, v=17, max_per_frame=3,
                              label=0, img_shape=(1080, 1920),
                              frame_dir="X"):
    """One synthetic anno in the compressed storage of the hrnet pickles
    (what ``DecompressPose`` expands): each of ``t`` frames holds 0 to
    ``max_per_frame`` poses, stored flat as ``keypoint`` (n_annos, v, 3) =
    pixel x, y about the image centre and a score in [0.3, 1), with each
    pose's ``frame_inds``."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, max_per_frame + 1, size=t)
    frame_inds = np.repeat(np.arange(t), counts)
    h, w = img_shape
    xy = rng.standard_normal((len(frame_inds), v, 2)) * [w / 12, h / 12] \
        + [w / 2, h / 2]
    score = rng.uniform(0.3, 1.0, size=(len(frame_inds), v, 1))
    return dict(frame_dir=frame_dir, label=label, total_frames=t,
                frame_inds=frame_inds, img_shape=tuple(img_shape),
                keypoint=np.concatenate([xy, score], -1).astype(np.float32))


def build_dataset(dcfg: Dict, test_mode: bool = False):
    """Config-dict dataset factory (reference datasets/builder.py:42):
    ``PoseDataset``, ``GestureDataset``, ``VideoDataset`` and the
    ``RepeatDataset`` and ``ConcatDataset`` wrappers."""
    dcfg = dict(dcfg)
    typ = dcfg.pop("type", "PoseDataset")
    if typ == "RepeatDataset":
        return RepeatDataset(build_dataset(dcfg["dataset"], test_mode),
                             dcfg.get("times", 1))
    if typ == "ConcatDataset":
        return ConcatDataset([build_dataset(d, test_mode)
                              for d in dcfg["datasets"]])
    if typ == "GestureDataset":
        return GestureDataset(
            dcfg["ann_file"], dcfg["pipeline"], split=dcfg["split"],
            valid_frames_thr=dcfg.get("valid_frames_thr", 0),
            squeeze=dcfg.get("squeeze", True), mode=dcfg.get("mode", "2D"),
            subset=dcfg.get("subset"), test_mode=test_mode)
    if typ == "VideoDataset":
        return VideoDataset(dcfg["ann_file"], dcfg["pipeline"],
                            data_prefix=dcfg.get("data_prefix", ""),
                            test_mode=test_mode)
    if typ != "PoseDataset":
        raise NotImplementedError(f"dataset {typ!r} is not ported yet (the "
                                  "port has 'PoseDataset', "
                                  "'GestureDataset', 'VideoDataset', "
                                  "'RepeatDataset' and 'ConcatDataset')")
    return PoseDataset(dcfg["ann_file"], dcfg["pipeline"],
                       split=dcfg.get("split"),
                       valid_ratio=dcfg.get("valid_ratio"),
                       box_thr=dcfg.get("box_thr"), test_mode=test_mode)
