"""One rank of the port's multi-process tests (no JAX here).

    python tests/torch_port_dist_worker.py JOB RANK WORLD STORE OUT

joins a gloo group of WORLD processes through the ``file://`` store STORE,
runs the cases of JOB (a ``torch.save``d dict, see ``run_case``) on the CPU
with one intra-op thread, and writes every case's arrays to OUT (an .npz,
keys ``<case>/<name>``).  ``python tests/torch_port_dist_worker.py cli
ARGS`` instead runs the port's train CLI (``cli test ARGS``: its test CLI)
with ARGS under the launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK)
and prints a hash of the trained weights.
"""
import hashlib
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from dsgcn_tpu_torch.core.train import make_optimizer, train_step  # noqa: E402
from dsgcn_tpu_torch.models.builder import build_model  # noqa: E402
from dsgcn_tpu_torch.parallel import joint_partition as jpart  # noqa: E402
from dsgcn_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from dsgcn_tpu_torch.parallel import train as ptrain  # noqa: E402


def state_hash(model) -> str:
    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def _model(case):
    model = build_model(case["cfg"]).to(getattr(torch, case["dtype"]))
    model.load_state_dict(case["state"], strict=True)
    return model


def _state(model):
    return {f"state/{k}": v.detach().numpy()
            for k, v in model.state_dict().items()}


def run_case(case, mesh):
    """{name: array} of one case.  Kinds: 'ring' (ring_spatial_aggregate of
    this rank's joints of ``x`` against ``A``), 'unit_gcn'
    (jp_unit_gcn_forward of this rank's joints), 'eval' (the mesh's eval
    step on the global ``keypoint``; the bytes the ring sent), 'train'
    (one step of the mesh's train step on this data rank's ``batch``: the
    metrics and the state after it), 'g1' (the graph_axis model on a
    (world, 1) mesh against the plain model: eval logits and one train
    step's state each), 'ep' (the expert-parallel eval of the SMoE that
    ``smoe`` and ``graph`` configure, rank e running expert e, from the
    whole model's ``state``: the feature, the balance loss and the
    parameters this rank holds)."""
    kind = case["kind"]
    if kind == "ring":
        x, A = case["x"], case["A"]
        ax = pmesh.axis(pmesh.GRAPH_AXIS)
        vl = x.shape[-3] // ax.size
        return {"y": jpart.ring_spatial_aggregate(
            x[..., ax.index * vl:(ax.index + 1) * vl, :, :], A).numpy()}
    if kind == "unit_gcn":
        x = case["x"]
        ax = pmesh.axis(pmesh.GRAPH_AXIS)
        vl = x.shape[2] // ax.size
        return {"y": jpart.jp_unit_gcn_forward(
            x[:, :, ax.index * vl:(ax.index + 1) * vl], case["A"],
            case["weight"], case["bias"]).numpy()}
    if kind == "eval":
        model = _model(case)
        before = jpart.ring_permute.bytes_sent
        fwd = (ptrain.make_jp_eval_step if case.get("jp")
               else ptrain.make_dp_eval_step)(mesh)
        logits = fwd(model, case["keypoint"])
        return {"logits": logits.numpy(), "ring_bytes": np.asarray(
            jpart.ring_permute.bytes_sent - before)}
    if kind == "train":
        model = _model(case)
        ddp = ptrain.distribute(model, mesh, seed=0)
        opt, sched = make_optimizer(model, total_steps=case["total_steps"],
                                    lr=case["lr"])
        step = (ptrain.make_jp_train_step if case.get("jp")
                else ptrain.make_dp_train_step)(mesh)
        metrics = step(ddp, opt, sched, case["batch"])
        out = {f"metric/{k}": v.numpy() for k, v in metrics.items()}
        out.update(_state(model))
        return out
    if kind == "g1":
        world = mesh.world_size
        pmesh.make_mesh(n_data=world, n_graph=1)
        out = {}
        for tag, graph_axis in (("plain", None), ("jp", pmesh.GRAPH_AXIS)):
            cfg = dict(case["cfg"])
            cfg["backbone"] = dict(cfg["backbone"], graph_axis=graph_axis)
            model = _model(dict(case, cfg=cfg))
            model.eval()
            with torch.no_grad():
                out[f"{tag}/logits"] = model(case["keypoint"]).numpy()
            opt, sched = make_optimizer(model, total_steps=1, lr=0.1)
            m = train_step(model, opt, sched, case["batch"])
            out[f"{tag}/loss"] = m["loss"].numpy()
            out.update({f"{tag}/{k}": v for k, v in _state(model).items()})
        return out
    if kind == "ep":
        from dsgcn_tpu_torch.graph import GraphConfig
        from dsgcn_tpu_torch.parallel import expert_parallel as ep
        from dsgcn_tpu_torch.sparse.smoe import SMoEAssembleSparse
        with torch.device("meta"):    # the configuration, no expert's weights
            model = SMoEAssembleSparse(graph_cfg=GraphConfig(**case["graph"]),
                                       **case["smoe"])
        run = ep.make_ep_smoe_eval(ep.make_expert_mesh(mesh.world_size),
                                   model)
        feat, aux = run(case["state"], case["x"], *case["epochs"])
        return {"feat": feat.numpy(), "aux": aux.numpy(), "params": np.asarray(
            sum(p.numel() for m in run.modules for p in m.parameters()))}
    raise ValueError(f"unknown case kind {kind!r}")


def run_job(job_path, rank, world, store, out_path):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=True)
    pmesh.init_distributed("gloo", device="cpu",
                           init_method=f"file://{store}", rank=rank,
                           world_size=world)
    try:
        arrays = {}
        for case in job["cases"]:
            mesh = pmesh.make_mesh(*job["mesh"])
            shard = case.get("shards")
            if shard is not None:       # this data rank's batch
                d = mesh.axis(pmesh.DATA_AXIS).index
                case = dict(case, batch=shard[d])
            for k, v in run_case(case, mesh).items():
                arrays[f"{case['name']}/{k}"] = np.asarray(v)
        np.savez(out_path, **arrays)
    finally:
        pmesh.release_mesh()
        torch.distributed.destroy_process_group()


def run_cli(argv):
    """The port's train CLI (or, with ``test`` first, its test CLI) on
    ARGS under the launcher's environment; after training it prints
    ``PARAM_HASH <sha256>`` of the weights and the validation metrics."""
    torch.set_num_threads(1)
    try:
        if argv[0] == "test":
            from dsgcn_tpu_torch.tools import test as cli
            cli.main(argv[1:])
            return
        from dsgcn_tpu_torch.tools import train as cli
        trainer = cli.main(argv)
        print(f"PARAM_HASH {state_hash(trainer.model)}", flush=True)
        print(f"VAL {trainer.validate()}", flush=True)
    finally:
        if torch.distributed.is_initialized():
            pmesh.release_mesh()
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "cli":
        run_cli(sys.argv[2:])
    else:
        run_job(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                sys.argv[4], sys.argv[5])


def launch(job, world: int, tmp):
    """Start WORLD ranks of ``job`` (a dict, saved under ``tmp``) as child
    processes with one intra-op thread each; :func:`collect` waits."""
    import subprocess
    job_path, store = os.path.join(tmp, "job.pt"), os.path.join(tmp, "store")
    torch.save(job, job_path)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job_path, str(r),
         str(world), store, os.path.join(tmp, f"out{r}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def collect(procs, tmp, timeout: float = 300):
    """Wait for the ranks of :func:`launch`; each rank's arrays.  A rank
    that fails ends the others."""
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                raise RuntimeError(
                    f"rank exited {p.returncode}:\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(os.path.join(tmp, f"out{r}.npz")))
            for r in range(len(procs))]
