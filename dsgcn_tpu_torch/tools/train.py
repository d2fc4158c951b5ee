"""Training CLI of the port (counterpart of the repository's
``tools/train.py``).

    python -m dsgcn_tpu_torch.tools.train CONFIG --work-dir D [--validate]
        [--test-last] [--total-epochs N] [--seed S] [--device cpu]
        [--no-auto-resume]

It trains on the CUDA device unless ``--device`` names another (without a
GPU it stops and says so).  From the config it reads the model, the data
(``videos_per_gpu`` is the batch), ``optimizer`` (lr, momentum,
weight_decay, paramwise_cfg), ``optimizer_config.grad_clip``,
``total_epochs``, ``checkpoint_config``, ``evaluation`` and the top-level
``compute_dtype`` ('bfloat16' trains in bfloat16 over float32 master
weights).  As JAX's ``tools/train.py`` does, it validates every
``evaluation.interval`` epochs (and keeps the best checkpoint) whenever the
config has a ``data.val`` split; ``--validate`` is accepted and changes
nothing.  It resumes from the latest checkpoint in the work dir unless
told not to.  ``--test-last`` scores the val split with the final weights
after training and prints ``final: {metrics}``.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a skeleton-GCN "
                                            "recognizer with the port")
    p.add_argument("config")
    p.add_argument("--work-dir")
    p.add_argument("--validate", action="store_true",
                   help="validate during training (the default wherever "
                   "the config has data.val)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--total-epochs", type=int)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    p.add_argument("--no-auto-resume", action="store_true")
    p.add_argument("--test-last", action="store_true",
                   help="after training, print the val split's metrics")
    return p.parse_args(argv)


def build_loaders(cfg, seed):
    """(train, val) loaders; val (None without a val split) takes the test
    batch size, in order (JAX ``tools/train.py:52``)."""
    from ..data.dataset import Loader, build_dataset

    data = cfg["data"]
    batch = data.get("videos_per_gpu", 16)
    workers = data.get("workers_per_gpu", 8)
    train = Loader(build_dataset(data["train"]), batch_size=batch,
                   drop_last=True, seed=seed, num_workers=workers)
    val = None
    if "val" in data:
        val = Loader(build_dataset(data["val"], test_mode=True),
                     batch_size=data.get("test_dataloader", {}).get(
                         "videos_per_gpu", batch),
                     shuffle=False, num_workers=workers)
    return train, val


def main(argv=None):
    args = parse_args(argv)
    from ..configs.config import Config
    from ..core.trainer import Trainer
    from ..models.builder import build_model

    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    cfg.dump(os.path.join(work_dir, "config.json"))

    model = build_model(cfg["model"])
    train_loader, val_loader = build_loaders(cfg, args.seed)
    opt = cfg.get("optimizer", {})
    trainer = Trainer(
        model, work_dir, train_loader, val_loader,
        total_epochs=args.total_epochs or cfg.get("total_epochs", 80),
        lr=opt.get("lr", 0.1), momentum=opt.get("momentum", 0.9),
        weight_decay=opt.get("weight_decay", 5e-4),
        paramwise_cfg=opt.get("paramwise_cfg"),
        grad_clip=(cfg.get("optimizer_config", {}) or {}).get("grad_clip"),
        seed=args.seed,
        log_interval=cfg.get("log_config", {}).get("interval", 20),
        ckpt_interval_epochs=cfg.get("checkpoint_config", {}).get(
            "interval", 5),
        eval_interval=cfg.get("evaluation", {}).get("interval", 1),
        eval_metrics=cfg.get("evaluation", {}).get(
            "metrics", ["top_k_accuracy"]),
        average_clips=cfg["model"].get("test_cfg", {}).get(
            "average_clips", "prob"),
        prefetch_depth=cfg.get("data", {}).get("prefetch_depth", 2),
        compute_dtype=cfg.get("compute_dtype"), device=args.device)
    if not args.no_auto_resume:
        trainer.resume_if_possible()
    trainer.fit()
    if args.test_last and val_loader is not None:
        print("final:", trainer.validate(val_loader), flush=True)
    return trainer


if __name__ == "__main__":
    main()
