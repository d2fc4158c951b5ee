"""Multi-stream score fusion of the port (counterpart of the repository's
``tools/fuse_scores.py``): a weighted sum of the score pickles that
``dsgcn_tpu_torch.tools.test --out`` writes, then the metrics.

    python -m dsgcn_tpu_torch.tools.fuse_scores j.pkl b.pkl [jm.pkl bm.pkl]
        [--weights 2 2 1 1] [--metrics top_k_accuracy mean_class_accuracy]
        [--out fused.pkl] [--device cpu]

The weights default to 1.0 each; the four-stream DS-GCN ensemble of the
paper weighs j:b:jm:bm 2:2:1:1.  Every pickle must list the same labels in
the same order.  The sum runs on the CUDA device unless ``--device`` names
another (without a GPU it stops and says so), one product and one add a
stream in the scores' dtype, as numpy would; the metrics on the host.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Optional, Sequence

import numpy as np


def fuse(paths: Sequence[str], weights: Optional[Sequence[float]] = None,
         device=None):
    """(sum_i weights[i] * scores_i, labels) over the pickles ``paths``,
    summed on ``device`` (default: the CUDA device)."""
    import torch

    from ..apis import resolve_device

    dev = resolve_device(device)
    weights = list(weights) if weights else [1.0] * len(paths)
    if len(weights) != len(paths):
        raise ValueError(f"{len(weights)} weights for {len(paths)} score "
                         "files")
    fused, labels = None, None
    for w, path in zip(weights, paths):
        with open(path, "rb") as f:
            d = pickle.load(f)
        s = torch.as_tensor(np.asarray(d["scores"]), device=dev) * w
        fused = s if fused is None else fused + s
        if labels is None:
            labels = list(d["labels"])
        elif labels != list(d["labels"]):
            raise ValueError(f"{path} lists its labels in another order")
    return fused.cpu().numpy(), labels


def main(argv=None):
    p = argparse.ArgumentParser(description="Fuse the score pickles of "
                                            "several streams")
    p.add_argument("score_files", nargs="+")
    p.add_argument("--weights", nargs="+", type=float)
    p.add_argument("--metrics", nargs="+",
                   default=["top_k_accuracy", "mean_class_accuracy"])
    p.add_argument("--out", help="dump the fused scores and labels here")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    args = p.parse_args(argv)
    from ..core.metrics import evaluate

    fused, labels = fuse(args.score_files, args.weights, args.device)
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(dict(scores=fused, labels=labels), f)
    results = evaluate(fused, labels, args.metrics)
    for k, v in results.items():
        print(f"{k}: {float(v):.4f}", flush=True)
    return fused, labels, results


if __name__ == "__main__":
    main()
