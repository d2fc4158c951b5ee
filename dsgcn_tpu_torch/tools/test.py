"""Test CLI of the port (counterpart of the repository's ``tools/test.py``):
score a config's test split with a checkpoint of the port's trainer.

    python -m dsgcn_tpu_torch.tools.test CONFIG WORK_DIR [--step S]
        [--out scores.pkl] [--metrics top_k_accuracy mean_class_accuracy]
        [--average-clips prob|score|none] [--bf16] [--device cpu]
        [--feat-ext | --score-ext] [--pool-opt nmtv|all|none|...]
        [--dist-backend gloo] [--dist-url URL]

It loads the latest checkpoint under ``WORK_DIR/ckpt`` (or step ``S``),
runs the config's test pipeline over ``data.test`` on the CUDA device
unless ``--device`` names another (without a GPU it stops and says so),
folds each batch's clips (skeletons, or PoseC3D's heatmap volumes) into
the batch, averages each sample's clip scores (``--average-clips``),
prints the metrics (``top1_acc: 0.xxxx``) and, with ``--out``, dumps ``{'scores': (N, classes), 'labels': [...]}``
for ``dsgcn_tpu_torch.tools.fuse_scores``.  One device pads nothing.  On
a GPU it also prints the forwards and the port's kernel launches.

``--feat-ext`` (or ``--score-ext``, the head's classifier applied at every
location) harvests pooled backbone features instead of scores (JAX
``tools/test.py:91-134``; reference recognizergcn.py:53-107): each batch's
(n nc) folded clips go through ``models/recognizer.py:
extract_pooled_feat`` pooled over ``--pool-opt`` without 'n' ('all' means
'nmtv'), and with 'n' the clip axis is averaged; ``--out`` dumps
``{'features': float16 array, 'labels': [...]}``, and the metrics
'TSNEmap' and 'graph' print the embedding's and the per-class means'
shapes.  They take a ``RecognizerGCN`` only, as JAX's
``extract_pooled_feat`` does, and refuse another recognizer; ``--bf16``
refuses a model without a ``compute_dtype`` (``RecognizerPoseC3D``).

Under ``python -m torch.distributed.run --nproc-per-node N`` each process
joins the group (as the train CLI does) and the evaluation is distributed
(JAX ``tools/test.py:143-160``): every process folds the same batch, wraps
it round to a multiple of N, scores its rows and all-gathers the logits,
so the scores equal one process's; rank 0 prints and writes them.  The
feature harvest is not distributed, as JAX's is not: every process
extracts every clip on its own device, and rank 0 prints and writes.
"""
from __future__ import annotations

import argparse
import json
import pickle

import numpy as np

from .train import add_dist_args, join_launcher, shutdown


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a skeleton-GCN "
                                            "recognizer with the port")
    p.add_argument("config")
    p.add_argument("work_dir", help="the training work dir (holds ckpt/)")
    p.add_argument("--step", type=int, help="checkpoint step (default: the "
                                            "latest)")
    p.add_argument("--out", help="dump the scores and labels to this pickle")
    p.add_argument("--metrics", nargs="+",
                   default=["top_k_accuracy", "mean_class_accuracy"])
    p.add_argument("--average-clips", default="prob",
                   choices=["prob", "score", "none"])
    p.add_argument("--bf16", action="store_true",
                   help="serve in bfloat16 (apis.to_bf16_inference)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--feat-ext", action="store_true",
                   help="dump pooled backbone features instead of scores "
                        "(reference test_cfg feat_ext, recognizergcn.py:65)")
    p.add_argument("--score-ext", action="store_true",
                   help="per-location class scores before pooling "
                        "(recognizergcn.py:86-93)")
    p.add_argument("--pool-opt", default="nmtv",
                   help="subset of 'nmtv' dims to mean over, or 'none'; "
                        "'all' means 'nmtv' (the reference's alias is a "
                        "no-op upstream, recognizergcn.py:74)")
    add_dist_args(p)
    return p.parse_args(argv)


def extract_features(model, loader, pool_opt: str = "nmtv",
                     score_ext: bool = False):
    """(features float16 (N, ...), labels) of every sample ``loader``
    yields (JAX ``tools/test.py:99-118``): the reference runs one video at
    a time, so its 'n' means the video's clips; here each batch's (n nc)
    folded clips are pooled over ``pool_opt`` without 'n', and the clip
    axis is averaged when 'n' is asked for."""
    import torch

    from ..data.dataset import prefetch
    from ..models.recognizer import extract_pooled_feat

    pool_opt = "nmtv" if pool_opt == "all" else pool_opt
    per_clip = ("".join(d for d in pool_opt if d != "n")
                if pool_opt != "none" else "none")
    device = next(model.parameters()).device
    feats, labels = [], []
    for batch in prefetch(loader.epoch(0), depth=2):
        kp = batch["keypoint"]
        n, nc = kp.shape[:2]
        folded = torch.as_tensor(kp.reshape((n * nc,) + kp.shape[2:]))
        f = extract_pooled_feat(model, folded.to(device),
                                pool_opt=per_clip or "none",
                                score_ext=score_ext)
        f = f.float().cpu().numpy()
        f = f.reshape((n, nc) + f.shape[1:])
        if pool_opt != "none" and "n" in pool_opt:
            f = f.mean(axis=1)
        feats.append(f.astype(np.float16))       # recognizergcn.py:93
        labels.extend(batch["label"].tolist())
    if not feats:
        raise ValueError("the loader yields no batch")
    return np.concatenate(feats, axis=0), labels


def _report_features(args, feats, labels, device) -> None:
    """The dump and the feature-space metrics (JAX tools/test.py:119-134)."""
    from ..core.metrics import evaluate
    if args.out:
        with open(args.out, "wb") as fh:
            pickle.dump(dict(features=feats, labels=labels), fh)
        print(f"dumped features {feats.shape} -> {args.out}", flush=True)
    lab = np.asarray(labels)
    if "TSNEmap" in args.metrics:
        emb = evaluate(feats.reshape(len(feats), -1).astype(np.float32),
                       lab, ("TSNEmap",), device=device)["TSNEmap"]
        print(f"TSNEmap: embedding {emb.shape}", flush=True)
    if "graph" in args.metrics:
        per_cls = evaluate(feats.astype(np.float32), lab,
                           ("graph",))["graph"]
        print(f"graph: {len(per_cls)} per-class means of shape "
              f"{per_cls[0].shape}", flush=True)


def _print_launches(loader, device) -> None:
    if device.type == "cuda":
        from ..ops.kernels import launch_counts
        print(f"forwards: {loader.steps_per_epoch()}, kernel launches: "
              f"{json.dumps(launch_counts())}", flush=True)


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed as dist

    from ..apis import resolve_device, to_bf16_inference
    from ..configs.config import Config
    from ..core.checkpoint import CheckpointManager
    from ..core.metrics import evaluate
    from ..core.trainer import clip_scores
    from ..data.dataset import Loader, build_dataset
    from ..models.builder import build_model
    from ..models.recognizer import RecognizerGCN

    launched, device = join_launcher(args)
    device = resolve_device(device)
    features = args.feat_ext or args.score_ext
    cfg = Config.fromfile(args.config)
    model = build_model(cfg["model"])
    if features and not isinstance(model, RecognizerGCN):
        raise NotImplementedError(
            f"--feat-ext/--score-ext: feature extraction takes a "
            f"RecognizerGCN's (N, M, T, V, C) features (JAX's "
            f"extract_pooled_feat), not a {type(model).__name__}'s")
    mesh = None
    if launched and not features:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh()
    is_main = not launched or dist.get_rank() == 0
    meta = CheckpointManager(args.work_dir).restore(model, step=args.step)
    if meta is None:
        raise FileNotFoundError(f"no checkpoint under {args.work_dir}/ckpt")
    if is_main:
        print(f"loaded step={meta['step']} meta={meta}", flush=True)
    model = model.to(device).eval()
    data = cfg["data"]
    loader = Loader(build_dataset(data["test"], test_mode=True),
                    batch_size=data.get("test_dataloader", {}).get(
                        "videos_per_gpu", 16),
                    shuffle=False, num_workers=data.get("workers_per_gpu", 8))
    if features:
        feats, labels = extract_features(model, loader, args.pool_opt,
                                         args.score_ext)
        if is_main:
            _print_launches(loader, device)
            _report_features(args, feats, labels, device)
        return feats, labels
    if args.bf16:
        model = to_bf16_inference(model)
    scores, labels = clip_scores(
        model, loader,
        None if args.average_clips == "none" else args.average_clips,
        mesh=mesh)
    if not is_main:
        return scores, labels
    _print_launches(loader, device)
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(dict(scores=scores, labels=labels), f)
        print(f"dumped -> {args.out}", flush=True)
    for k, v in evaluate(scores, labels, args.metrics,
                         device=device).items():
        if np.ndim(v) == 0:
            print(f"{k}: {float(v):.4f}", flush=True)
        else:   # array-valued metrics (confusion_matrix, graph, TSNEmap)
            print(f"{k}: array{np.shape(v)}", flush=True)
    return scores, labels


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
