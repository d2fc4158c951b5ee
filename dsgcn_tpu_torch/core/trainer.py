"""The training loop: epochs, validation, checkpoints and a JSONL log
(port of ``dsgcn_tpu/core/trainer.py``; reference EpochBasedSparseRunner
and apis/train.py).

The model trains on the CUDA device unless the caller asks for
``device='cpu'``.  Its random weights come from a ``torch.Generator``
seeded with ``seed`` (``models/builder.py:init_weights_``), its dropout
masks from a generator on the device seeded the same way.

Inside an initialized ``torch.distributed`` group (one process a device,
as ``torch.distributed.run`` launches them) it trains on the (data x
graph) mesh of ``parallel/``: the device is ``cuda:LOCAL_RANK``, the
module is wrapped in DistributedDataParallel, the steps are
``make_dp_train_step``'s (``make_jp_train_step``'s with ``n_graph`` > 1,
for a backbone built with ``graph_axis``), each process's loader holds its
data rank's shard, and validation is distributed (:func:`clip_scores`).
Rank 0 alone writes the log and the checkpoints; every rank resumes from
the same checkpoint, behind a barrier.
"""
from __future__ import annotations

import functools
import json
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..apis import resolve_device
from ..data.dataset import Loader, prefetch
from ..models.builder import init_weights_, set_dropout_generator
from ..models.recognizer import average_clip
from ..parallel.mesh import DATA_AXIS, Mesh, local_rank, make_mesh
from ..parallel.train import (distribute, make_dp_eval_step,
                              make_dp_train_step, make_jp_eval_step,
                              make_jp_train_step)
from .checkpoint import CheckpointManager
from .metrics import evaluate
from .train import eval_step, input_key, make_optimizer, train_step


def squeeze_clip(batch) -> Dict[str, np.ndarray]:
    """A train batch as the step takes it: its input (``keypoint``, else
    ``imgs``) at its first clip, (N, nc=1, M, T, V, C) -> (N, M, T, V, C)
    and (N, nc=1, T, H, W, C) -> (N, T, H, W, C), and its labels.  JAX's
    trainer drops the clip axis for ``keypoint`` only
    (``dsgcn_tpu/core/trainer.py:141-147``), so it hands PoseC3D a 6-D
    batch; the port drops it for both."""
    key = input_key(batch)
    x = batch[key]
    if x.ndim == 6:
        x = x[:, 0]
    return {key: x, "label": batch["label"]}


class JsonlLogger:
    """One JSON object per record in ``<work_dir>/<time>.log.jsonl``,
    echoed to standard output; a logger that is not ``enabled`` (a rank
    other than 0) writes and prints nothing."""

    def __init__(self, work_dir: str, enabled: bool = True):
        self.enabled = enabled
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(
            work_dir, f"{time.strftime('%Y%m%d_%H%M%S')}.log.jsonl")

    def log(self, record: Dict[str, Any]):
        if not self.enabled:
            return
        record = {k: (float(v) if isinstance(v, (np.floating, torch.Tensor))
                      else v) for k, v in record.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        print(" ".join(f"{k}={v:.4f}" if isinstance(v, float)
                       else f"{k}={v}" for k, v in record.items()),
              flush=True)


class Trainer:
    def __init__(self, model, work_dir: str, train_loader: Loader,
                 val_loader: Optional[Loader] = None, total_epochs: int = 80,
                 lr: float = 0.1, momentum: float = 0.9,
                 weight_decay: float = 5e-4, grad_clip: Optional[float] = None,
                 seed: int = 0, log_interval: int = 20,
                 ckpt_interval_epochs: int = 5, eval_interval: int = 1,
                 eval_metrics: Sequence[str] = ("top_k_accuracy",),
                 average_clips: str = "prob", paramwise_cfg=None,
                 prefetch_depth: int = 2,
                 compute_dtype: Optional[str] = None, device=None,
                 n_graph: int = 1, mesh: Optional[Mesh] = None):
        self.mesh = mesh
        if mesh is None and dist.is_available() and dist.is_initialized():
            self.mesh = make_mesh(n_graph=n_graph)
        if self.mesh is not None:
            if device is None and torch.cuda.is_available():
                device = torch.device("cuda", local_rank())
        elif n_graph > 1:
            raise ValueError("n_graph > 1 trains on the processes of a "
                             "torch.distributed group: launch with "
                             "python -m torch.distributed.run")
        if n_graph > 1 and getattr(model.backbone, "graph_axis",
                                   None) is None:
            raise ValueError("n_graph > 1 needs a backbone built with "
                             "graph_axis='graph'")
        self.is_main = self.mesh is None or dist.get_rank() == 0
        self.device = resolve_device(device)
        self.work_dir = work_dir
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.total_epochs = total_epochs
        self.log_interval = log_interval
        self.ckpt_interval_epochs = ckpt_interval_epochs
        self.eval_interval = eval_interval
        self.eval_metrics = list(eval_metrics)
        self.average_clips = average_clips
        self.prefetch_depth = prefetch_depth
        self.compute_dtype = compute_dtype
        self.logger = JsonlLogger(work_dir, enabled=self.is_main)

        init_weights_(model, torch.Generator().manual_seed(seed))
        self.model = model.to(self.device)
        if self.mesh is None:
            set_dropout_generator(self.model, torch.Generator(
                device=self.device).manual_seed(seed))
            self.ddp = self.model
            self._step = functools.partial(train_step,
                                           compute_dtype=compute_dtype)
        else:
            self.ddp = distribute(self.model, self.mesh, seed)
            self._step = (make_jp_train_step if n_graph > 1
                          else make_dp_train_step)(self.mesh, compute_dtype)
        total_steps = train_loader.steps_per_epoch() * total_epochs
        self.opt, self.sched = make_optimizer(
            self.model, max(total_steps, 1), lr=lr, momentum=momentum,
            weight_decay=weight_decay, grad_clip=grad_clip,
            paramwise_cfg=paramwise_cfg)
        self.step = 0
        self.ckpt = CheckpointManager(work_dir)
        self.best = (-1.0, None)
        self.start_epoch = 0

    def _barrier(self):
        if self.mesh is not None:
            dist.barrier(group=self.mesh.world)

    def resume_if_possible(self) -> bool:
        self._barrier()
        meta = self.ckpt.restore(self.model, self.opt, self.sched)
        if meta is None:
            return False
        self.step, self.start_epoch = int(meta["step"]), int(meta["epoch"])
        if meta.get("score") is not None:
            self.best = (float(meta["score"]), meta.get("best_epoch"))
        self.logger.log(dict(event="resume", epoch=self.start_epoch,
                             step=self.step))
        return True

    def _device_batches(self, epoch: int):
        def to_device(batch):
            return {k: torch.from_numpy(v).to(self.device, non_blocking=True)
                    for k, v in squeeze_clip(batch).items()}
        return prefetch(self.train_loader.epoch(epoch), to_device,
                        depth=self.prefetch_depth)

    def fit(self):
        for epoch in range(self.start_epoch, self.total_epochs):
            t_ep = time.perf_counter()
            n_seen = 0
            for it, batch in enumerate(self._device_batches(epoch)):
                metrics = self._step(self.ddp, self.opt, self.sched, batch)
                self.step += 1
                n_seen += batch["label"].shape[0]
                if it % self.log_interval == 0:
                    self.logger.log(dict(
                        mode="train", epoch=epoch, iter=it, step=self.step,
                        lr=self.opt.param_groups[0]["lr"],
                        **{k: v.item() for k, v in metrics.items()}))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t_ep
            self.logger.log(dict(event="epoch_done", epoch=epoch, seconds=dt,
                                 clips_per_sec=n_seen / max(dt, 1e-9)))
            is_best = False
            if self.val_loader is not None and \
                    (epoch + 1) % self.eval_interval == 0:
                results = self.validate()
                self.logger.log(dict(mode="val", epoch=epoch, **results))
                # best by top-1 (the reference's save_best='auto'), else the
                # first metric reported
                key = next((k for k in results if "top1" in k),
                           next(iter(results)))
                if results[key] > self.best[0]:
                    self.best = (results[key], epoch)
                    is_best = True
            if (epoch + 1) % self.ckpt_interval_epochs == 0 or \
                    epoch + 1 == self.total_epochs or is_best:
                if self.is_main:
                    self.ckpt.save(self.step, self.model, self.opt,
                                   self.sched, epoch + 1, meta=dict(
                                       best=is_best, score=self.best[0],
                                       best_epoch=self.best[1]))
                self._barrier()
        return self.model

    def validate(self, loader: Optional[Loader] = None) -> Dict[str, float]:
        """Eval-mode scores of the validation set (or of ``loader``), clips
        averaged per sample (``average_clips``), then the named metrics."""
        scores, labels = clip_scores(
            self.model, self.val_loader if loader is None else loader,
            self.average_clips, self.prefetch_depth, self.mesh)
        return {k: float(v) for k, v in evaluate(
            scores, labels, self.eval_metrics).items()}


def clip_scores(model, loader: Loader, average_clips: Optional[str] = "prob",
                prefetch_depth: int = 2, mesh: Optional[Mesh] = None):
    """(scores, labels) of every sample ``loader`` yields: each batch's
    clips (its ``keypoint`` (N, nc, M, T, V, C), else its ``imgs`` (N, nc,
    T, H, W, C)) folded into the batch for one eval forward, then averaged
    per sample (``average_clips``; None keeps (N, nc, classes)).

    With a ``mesh`` (JAX ``core/trainer.py:203-240``) every process folds
    the same batch, wraps the clips round to a multiple of the data axis,
    scores its data rank's rows (its graph ranks together for a
    ``graph_axis`` model), all-gathers the logits and keeps the first
    N nc: every process returns the same scores."""
    fwd, n_data = eval_step, 1
    if mesh is not None:
        fwd = (make_jp_eval_step
               if getattr(model.backbone, "graph_axis", None) is not None
               else make_dp_eval_step)(mesh)
        n_data = mesh.shape[DATA_AXIS]
    scores, labels = [], []
    for batch in prefetch(loader.epoch(0), depth=prefetch_depth):
        kp = batch[input_key(batch)]
        n, nc = kp.shape[:2]
        folded = kp.reshape((n * nc,) + kp.shape[2:])
        pad = (-len(folded)) % n_data
        if pad:     # wrap round, as often as the last batch needs
            folded = folded[np.arange(len(folded) + pad) % len(folded)]
        logits = fwd(model, folded)[:n * nc]
        avg = average_clip(logits.float().reshape(n, nc, -1), average_clips)
        scores.append(avg.cpu().numpy())
        labels.extend(batch["label"].tolist())
    if not scores:
        raise ValueError("the loader yields no batch")
    return np.concatenate(scores, axis=0), labels
