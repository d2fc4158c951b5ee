"""Export CLI of the port (counterpart of the repository's
``tools/export.py``): write a recognizer as a standalone ``torch.export``
serving artifact (``dsgcn_tpu_torch/serving.py``).

    python -m dsgcn_tpu_torch.tools.export CONFIG --out OUT_DIR
        [--work-dir WORK_DIR] [--step S] [--batch 1 16] [--no-poly]
        [--bf16] [--clip-len T] [--device cpu]

The weights are the latest checkpoint of the port's trainer under
``WORK_DIR/ckpt`` (or step ``S``); without ``--work-dir``, the initial
ones.  The sample shape (M, T, V, C) comes from the config: V from the
backbone's graph, C its input channels, T the test pipeline's
``clip_len`` (or ``--clip-len``), M ``FormatGCNInput``'s ``num_person``.
The program is exported on the CUDA device unless ``--device`` names
another (without a GPU it stops and says so) and is served there:
``load_exported(OUT_DIR).predict(clips)``.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="export a recognizer for "
                                            "serving")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None,
                   help="checkpoint dir (omit to export the initial "
                        "weights)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, nargs="+", default=[1, 16],
                   help="batch sizes of the per-batch programs, where the "
                        "dynamic-batch export fails or --no-poly")
    p.add_argument("--no-poly", action="store_true",
                   help="force per-batch-size programs")
    p.add_argument("--bf16", action="store_true",
                   help="export the bf16 serving path (bf16 weights, f32 "
                        "logits; see apis.to_bf16_inference)")
    p.add_argument("--clip-len", type=int, default=None,
                   help="T of the exported input (default: the test "
                        "pipeline's clip_len)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device)")
    return p.parse_args(argv)


def sample_shape(cfg, clip_len=None):
    """(M, T, V, C) of one sample of ``cfg``'s test pipeline (JAX
    ``tools/export.py:50-68``)."""
    from ..graph import Graph
    bb = cfg["model"].get("backbone", {})
    v = (Graph(**dict(bb["graph_cfg"])).num_node if "graph_cfg" in bb
         else 25)
    c = bb.get("in_channels", 3)
    pipeline = cfg.get("data", {}).get("test", {}).get("pipeline", [])
    t = clip_len
    if t is None:
        t = 100
        for tr in pipeline:
            if "clip_len" in tr:
                t = int(tr["clip_len"])
    m = 2
    for tr in pipeline:
        if tr.get("type") == "FormatGCNInput":
            m = int(tr.get("num_person", 2))
    return m, t, v, c


def main(argv=None):
    args = parse_args(argv)
    from ..apis import init_recognizer
    from ..configs.config import Config
    from ..core.checkpoint import CheckpointManager
    from ..serving import export_recognizer

    cfg = Config.fromfile(args.config)
    model = init_recognizer(cfg, device=args.device)
    if args.work_dir is not None:
        meta = CheckpointManager(args.work_dir).restore(model,
                                                        step=args.step)
        if meta is None:
            raise FileNotFoundError(f"no checkpoint under "
                                    f"{args.work_dir}/ckpt")
        print(f"loaded step={meta['step']}", flush=True)
    t0 = time.perf_counter()
    manifest = export_recognizer(
        model, args.out, sample_shape=sample_shape(cfg, args.clip_len),
        batch_sizes=args.batch, polymorphic=not args.no_poly,
        serve_dtype="bfloat16" if args.bf16 else "float32",
        average_clips=cfg["model"].get("test_cfg", {}).get(
            "average_clips", "prob"))
    print(f"exported -> {args.out}")
    print(f"export_s: {time.perf_counter() - t0:.3f}")
    for k in ("polymorphic_batch", "device", "sample_shape", "num_classes",
              "num_params", "modules"):
        print(f"  {k}: {manifest[k]}")
    return manifest


if __name__ == "__main__":
    main()
