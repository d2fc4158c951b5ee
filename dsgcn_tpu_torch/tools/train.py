"""Training CLI of the port (counterpart of the repository's
``tools/train.py``).

    python -m dsgcn_tpu_torch.tools.train CONFIG --work-dir D [--validate]
        [--test-last] [--total-epochs N] [--seed S] [--device cpu]
        [--no-auto-resume] [--dist-backend gloo] [--dist-url URL]

On N GPUs, one process each:

    python -m torch.distributed.run --nproc-per-node N \
        -m dsgcn_tpu_torch.tools.train CONFIG --work-dir D

It trains on the CUDA device unless ``--device`` names another (without a
GPU it stops and says so); launched with ``WORLD_SIZE`` in the
environment, each process joins the group (``parallel/mesh.py:
init_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``; ``--dist-url`` another rendezvous, e.g. a ``file://`` store) and
trains data-parallel, ``videos_per_gpu`` clips a process and its data
rank's shard of every epoch.  The config's top-level ``n_graph`` (> 1,
dividing the process count and V) splits the joints over graph groups of
that many consecutive ranks (the backbone's ``graph_axis``; DS-GCN and
DG-STGCN with ``dgmstcn`` or ``unit_tcn``).  From the config it reads the
model, the data (``videos_per_gpu`` is the batch), ``optimizer`` (lr,
momentum,
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
    add_dist_args(p)
    return p.parse_args(argv)


def add_dist_args(p):
    p.add_argument("--dist-backend", default=None,
                   help="torch.distributed backend under a launcher "
                   "(default: nccl on a CUDA device, gloo on the CPU)")
    p.add_argument("--dist-url", default=None,
                   help="rendezvous of the process group (default: the "
                   "launcher's env://)")


def join_launcher(args):
    """(launched, device): join the launcher's process group when
    ``WORLD_SIZE`` is set (the device is then ``cuda:LOCAL_RANK`` unless
    ``--device`` names another); else ``args.device``."""
    if "WORLD_SIZE" not in os.environ:
        return False, args.device
    from ..parallel.mesh import init_distributed
    return True, init_distributed(args.dist_backend, args.device,
                                  init_method=args.dist_url)


def build_loaders(cfg, seed, shard=0, num_shards=1):
    """(train, val) loaders: the train loader takes ``videos_per_gpu`` clips
    a process from its shard of every epoch (shard = the data rank); val
    (None without a val split), unsharded, takes the test batch size, in
    order (JAX ``tools/train.py:32-60``)."""
    from ..data.dataset import Loader, build_dataset

    data = cfg["data"]
    batch = data.get("videos_per_gpu", 16)
    workers = data.get("workers_per_gpu", 8)
    print(f"batch: {batch}/device x 1 device = {batch}/process "
          f"({batch * num_shards} global)", flush=True)
    train = Loader(build_dataset(data["train"]), batch_size=batch,
                   drop_last=True, seed=seed, num_workers=workers,
                   shard=shard, num_shards=num_shards)
    val = None
    if "val" in data:
        val = Loader(build_dataset(data["val"], test_mode=True),
                     batch_size=data.get("test_dataloader", {}).get(
                         "videos_per_gpu", batch),
                     shuffle=False, num_workers=workers)
    return train, val


def main(argv=None):
    args = parse_args(argv)
    import torch.distributed

    from ..configs.config import Config
    from ..core.trainer import Trainer
    from ..models.builder import build_model

    launched, device = join_launcher(args)
    cfg = Config.fromfile(args.config)
    work_dir = args.work_dir or cfg.get("work_dir", "./work_dirs/default")
    os.makedirs(work_dir, exist_ok=True)
    # joint partition: n_graph > 1 shards the joints over graph groups (JAX
    # tools/train.py:89-96)
    n_graph = int(cfg.get("n_graph", 1))
    mesh, shard, num_shards = None, 0, 1
    if launched:
        from ..parallel.mesh import DATA_AXIS, GRAPH_AXIS, make_mesh
        mesh = make_mesh(n_graph=n_graph)
        if n_graph > 1:
            cfg["model"]["backbone"]["graph_axis"] = GRAPH_AXIS
        shard, num_shards = (mesh.axis(DATA_AXIS).index,
                             mesh.shape[DATA_AXIS])
    elif n_graph > 1:
        raise ValueError("n_graph > 1 needs a process group: launch with "
                         "python -m torch.distributed.run")
    if not launched or torch.distributed.get_rank() == 0:
        cfg.dump(os.path.join(work_dir, "config.json"))

    model = build_model(cfg["model"])
    train_loader, val_loader = build_loaders(cfg, args.seed, shard,
                                             num_shards)
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
        compute_dtype=cfg.get("compute_dtype"), device=device,
        n_graph=n_graph, mesh=mesh)
    if not args.no_auto_resume:
        trainer.resume_if_possible()
    trainer.fit()
    if args.test_last and val_loader is not None:
        results = trainer.validate(val_loader)
        if trainer.is_main:
            print("final:", results, flush=True)
    return trainer


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_initialized():
        from ..parallel.mesh import release_mesh
        release_mesh()
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()
