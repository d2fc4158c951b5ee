"""Test CLI of the port (counterpart of the repository's ``tools/test.py``):
score a config's test split with a checkpoint of the port's trainer.

    python -m dsgcn_tpu_torch.tools.test CONFIG WORK_DIR [--step S]
        [--out scores.pkl] [--metrics top_k_accuracy mean_class_accuracy]
        [--average-clips prob|score|none] [--bf16] [--device cpu]
        [--dist-backend gloo] [--dist-url URL]

It loads the latest checkpoint under ``WORK_DIR/ckpt`` (or step ``S``),
runs the config's test pipeline over ``data.test`` on the CUDA device
unless ``--device`` names another (without a GPU it stops and says so),
folds each batch's clips into the batch, averages each sample's clip
scores (``--average-clips``), prints the metrics (``top1_acc: 0.xxxx``)
and, with ``--out``, dumps ``{'scores': (N, classes), 'labels': [...]}``
for ``dsgcn_tpu_torch.tools.fuse_scores``.  One device pads nothing.  On
a GPU it also prints the forwards and the port's kernel launches.

Under ``python -m torch.distributed.run --nproc-per-node N`` each process
joins the group (as the train CLI does) and the evaluation is distributed
(JAX ``tools/test.py:143-160``): every process folds the same batch, wraps
it round to a multiple of N, scores its rows and all-gathers the logits,
so the scores equal one process's; rank 0 prints and writes them.
"""
from __future__ import annotations

import argparse
import json
import pickle

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
    for flag in ("--feat-ext", "--score-ext"):
        p.add_argument(flag, action="store_true",
                       help="not ported: features for the TSNE and graph "
                            "metrics")
    p.add_argument("--pool-opt", default=None, help="not ported (--feat-ext)")
    add_dist_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.feat_ext or args.score_ext or args.pool_opt is not None:
        raise NotImplementedError(
            "--feat-ext, --score-ext and --pool-opt are not ported: they "
            "feed the feature-space metrics 'TSNEmap' and 'graph', which the "
            "port does not have yet")
    import torch.distributed as dist

    from ..apis import resolve_device, to_bf16_inference
    from ..configs.config import Config
    from ..core.checkpoint import CheckpointManager
    from ..core.metrics import evaluate
    from ..core.trainer import clip_scores
    from ..data.dataset import Loader, build_dataset
    from ..models.builder import build_model

    launched, device = join_launcher(args)
    device = resolve_device(device)
    mesh = None
    if launched:
        from ..parallel.mesh import make_mesh
        mesh = make_mesh()
    is_main = not launched or dist.get_rank() == 0
    cfg = Config.fromfile(args.config)
    model = build_model(cfg["model"])
    meta = CheckpointManager(args.work_dir).restore(model, step=args.step)
    if meta is None:
        raise FileNotFoundError(f"no checkpoint under {args.work_dir}/ckpt")
    if is_main:
        print(f"loaded step={meta['step']} meta={meta}", flush=True)
    model = model.to(device).eval()
    if args.bf16:
        model = to_bf16_inference(model)

    data = cfg["data"]
    loader = Loader(build_dataset(data["test"], test_mode=True),
                    batch_size=data.get("test_dataloader", {}).get(
                        "videos_per_gpu", 16),
                    shuffle=False, num_workers=data.get("workers_per_gpu", 8))
    scores, labels = clip_scores(
        model, loader,
        None if args.average_clips == "none" else args.average_clips,
        mesh=mesh)
    if not is_main:
        return scores, labels
    if device.type == "cuda":
        from ..ops.kernels import launch_counts
        print(f"forwards: {loader.steps_per_epoch()}, kernel launches: "
              f"{json.dumps(launch_counts())}", flush=True)
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(dict(scores=scores, labels=labels), f)
        print(f"dumped -> {args.out}", flush=True)
    for k, v in evaluate(scores, labels, args.metrics).items():
        print(f"{k}: {float(v):.4f}", flush=True)
    return scores, labels


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
