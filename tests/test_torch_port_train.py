"""Port parity, training: losses, metrics, the optimizer and schedule, the
data loader, and DS-GCN train steps of ``dsgcn_tpu_torch`` against
``dsgcn_tpu`` on the CPU; and the port's trainer and CLI end to end.

Tolerances: 1e-6 for losses and metrics (float32, one reduction); 1e-6
relative to the parameter scale for five optimizer steps on the same
gradients (float32 rounding of the same arithmetic); 1e-5 for loader
batches (the JAX pipeline may pre-normalize in its native C++ op).  The
narrow DS-GCN steps: in float64, 1e-8 relative after 3 steps on the dense
path (``tests/test_training_dynamics_parity.py`` says why float64: at
default init the untrained BatchNorm stacks amplify float32 rounding); in
float32, one step on the kernel path (the port's K1+K2 Function against the
Pallas kernels in interpret mode): the loss to 1e-5, each parameter's
update to cosine > 0.995 and norm within 5%, the float32 standard of
``test_training_dynamics_parity.py`` (measured: 1 - cosine under 2e-4,
norms within 2.3%, the widest on the small gate updates; the port's and
JAX's dense paths differ as much in float32 while they agree to 1e-13 in
float64), and the BatchNorm running statistics (forward only) to 1e-4.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.core.losses import cross_entropy as j_cross_entropy
from dsgcn_tpu.core.losses import top_k_correct as j_top_k_correct
from dsgcn_tpu.core.metrics import evaluate as j_evaluate
from dsgcn_tpu.core.train import TrainState
from dsgcn_tpu.core.train import make_optimizer as j_make_optimizer
from dsgcn_tpu.core.train import train_step as j_train_step
from dsgcn_tpu.data import dataset as JD
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.core.losses import cross_entropy, top_k_correct
from dsgcn_tpu_torch.core.metrics import evaluate
from dsgcn_tpu_torch.core.train import make_optimizer, train_step
from dsgcn_tpu_torch.core.trainer import Trainer
from dsgcn_tpu_torch.data import dataset as D
from dsgcn_tpu_torch.models.builder import build_model
from dsgcn_tpu_torch.ops.kernels.dyn_graph import fused_dyn_graph_agg
from dsgcn_tpu_torch.tools import train as cli
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_model import _cfgs
from torch_port_cases import one_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "dsgcn" / "ntu60_xsub_3dkp" / "j.py"


def assert_rel(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: {err:.3e} relative (tol {rtol})"


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(soft, weighted):
    rng = np.random.default_rng(20 + 2 * soft + weighted)
    logits = (rng.standard_normal((6, 7)) * 3).astype(np.float32)
    if soft:
        label = rng.uniform(0, 1, (6, 7)).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = rng.integers(0, 7, 6)
    w = rng.uniform(0.5, 2, 7).astype(np.float32) if weighted else None
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(label),
                        None if w is None else torch.from_numpy(w),
                        loss_weight=0.7)
    want = j_cross_entropy(jnp.asarray(logits), jnp.asarray(label),
                           None if w is None else jnp.asarray(w),
                           loss_weight=0.7)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("k", [1, 5])
def test_top_k_correct_matches_jax(k):
    rng = np.random.default_rng(30 + k)
    logits = rng.standard_normal((16, 9)).astype(np.float32)
    label = rng.integers(0, 9, 16)
    got = top_k_correct(torch.from_numpy(logits), torch.from_numpy(label), k)
    want = j_top_k_correct(jnp.asarray(logits), jnp.asarray(label), k)
    assert got.item() == pytest.approx(float(want))


def test_metrics_match_jax():
    rng = np.random.default_rng(40)
    scores = rng.standard_normal((50, 6))
    labels = rng.integers(0, 6, 50).tolist()
    names = ["top_k_accuracy", "mean_class_accuracy"]
    got, want = evaluate(scores, labels, names), j_evaluate(scores, labels,
                                                            names)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-12)


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------

PARAMWISE = dict(custom_keys={"fc_cls": dict(lr_mult=10.0, decay_mult=0.0)},
                 norm_decay_mult=0.0, bias_lr_mult=2.0, bias_decay_mult=0.5)


@pytest.fixture(scope="module")
def narrow_vars():
    """Initial JAX variables of the narrow DS-GCN (one jitted init)."""
    jcfg, _ = _cfgs(False)
    x = jnp.zeros((1, 2, 8, 25, 3), jnp.float32)
    init = jax.jit(lambda k: j_build_model(jcfg).init(k, x, train=False))
    return jax.device_get(init(jax.random.PRNGKey(1)))


@pytest.mark.parametrize("grad_clip", [None, 3.0])
@pytest.mark.parametrize("paramwise", [False, True])
def test_optimizer_matches_optax(narrow_vars, paramwise, grad_clip):
    """Five SGD steps (Nesterov, coupled weight decay, cosine by step) on
    the same gradients: the port's torch.optim chain against the optax
    chain, with the paramwise multipliers and the global-norm clip."""
    _, tcfg = _cfgs(False)
    v = narrow_vars
    params = v["params"]
    pw = PARAMWISE if paramwise else None
    tx, _ = j_make_optimizer(lr=0.1, momentum=0.9, weight_decay=5e-4,
                             nesterov=True, total_steps=5,
                             grad_clip=grad_clip, paramwise_cfg=pw,
                             params=params)
    port = build_model(tcfg)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    opt, sched = make_optimizer(port, 5, lr=0.1, momentum=0.9,
                                weight_decay=5e-4, grad_clip=grad_clip,
                                paramwise_cfg=pw)
    opt_state = tx.init(params)
    rng = np.random.default_rng(50)
    named = dict(port.named_parameters())
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))
    for _ in range(5):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.device_get(jax.tree.map(lambda p, u: p + u, params,
                                             updates))
        for name, g in convert_jax_variables({"params": grads}).items():
            named[name].grad = g.clone()
        opt.step()
        sched.step()
    want = convert_jax_variables({"params": params})
    for name, p in named.items():
        assert_rel(p.detach().numpy(), want[name].numpy(), 1e-6, name)


def test_paramwise_groups():
    _, tcfg = _cfgs(False)
    opt, _ = make_optimizer(build_model(tcfg), total_steps=10,
                            paramwise_cfg=PARAMWISE)
    by_mults = {(g["lr"] / 0.1, g["weight_decay"] / 5e-4): len(g["params"])
                for g in opt.param_groups}
    assert by_mults[(10.0, 0.0)] == 2            # head.fc_cls
    assert (1.0, 0.0) in by_mults                # norms
    assert (2.0, 0.5) in by_mults                # conv biases
    assert (1.0, 1.0) in by_mults                # the rest


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_loader_matches_jax(tmp_path):
    """The config's train pipeline (RandomRot, random clip sampling) through
    both loaders: same permutation, same per-sample RandomStates, same
    batches."""
    path = str(tmp_path / "synth.pkl")
    data = D.make_synthetic_pose_dataset(num_samples=12, num_classes=5, t=70,
                                         seed=3, path=path)
    jdata = JD.make_synthetic_pose_dataset(num_samples=12, num_classes=5,
                                           t=70, seed=3)
    for a, b in zip(data["annotations"], jdata["annotations"]):
        np.testing.assert_array_equal(a["keypoint"], b["keypoint"])
        assert a["label"] == b["label"]
    pipe = Config.fromfile(str(CONFIG))["data"]["train"]["pipeline"]
    ours = D.Loader(D.PoseDataset(path, pipe, split="train"), batch_size=4,
                    seed=3, num_workers=2, drop_last=True)
    ref = JD.Loader(JD.PoseDataset(path, pipe, split="train"), batch_size=4,
                    seed=3, num_workers=2, drop_last=True)
    assert ours.steps_per_epoch() == ref.steps_per_epoch() == 2
    for epoch in (0, 1):
        for got, want in zip(ours.epoch(epoch), ref.epoch(epoch)):
            assert got["keypoint"].shape == (4, 1, 2, 60, 25, 3)
            np.testing.assert_array_equal(got["label"], want["label"])
            np.testing.assert_allclose(got["keypoint"], want["keypoint"],
                                       rtol=1e-5, atol=1e-5)


def test_prefetch_maps_in_order_and_reraises():
    assert list(D.prefetch(iter(range(5)), lambda i: i * i, depth=2)) == [
        0, 1, 4, 9, 16]

    def bad():
        yield 1
        raise ValueError("producer failed")
    with pytest.raises(ValueError, match="producer failed"):
        list(D.prefetch(bad(), depth=1))


# ---------------------------------------------------------------------------
# narrow DS-GCN train steps against the JAX train_step
# ---------------------------------------------------------------------------

def _batches(n_steps, dtype, seed=60):
    rng = np.random.default_rng(seed)
    return [dict(keypoint=rng.standard_normal((4, 2, 16, 25, 3)).astype(
                 dtype), label=rng.integers(0, 11, 4))
            for _ in range(n_steps)]


def _run_both(jcfg, tcfg, v, batches, cast, lr=0.1):
    """The same steps through the JAX train_step and the port's; returns
    ((jax losses, jax variables), (port losses, port model))."""
    jmodel = j_build_model(jcfg)
    tx, _ = j_make_optimizer(lr=lr, total_steps=len(batches))
    v = jax.tree.map(lambda a: jnp.asarray(a).astype(cast), v)
    state = TrainState.create(jmodel.apply, v["params"], v["batch_stats"],
                              tx)
    step = jax.jit(j_train_step)
    j_losses = []
    for b in batches:
        state, m = step(state, dict(keypoint=jnp.asarray(b["keypoint"]),
                                    label=jnp.asarray(b["label"])),
                        jax.random.PRNGKey(0))
        j_losses.append(float(m["loss"]))
    port = build_model(tcfg)
    port.load_state_dict(convert_jax_variables(jax.device_get(
        jax.tree.map(lambda a: np.asarray(a, np.float32), v))), strict=True)
    if cast == jnp.float64:
        port = port.double()
    opt, sched = make_optimizer(port, lr=lr, total_steps=len(batches))
    t_losses = [train_step(port, opt, sched, b)["loss"].item()
                for b in batches]
    want = convert_jax_variables(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    return (j_losses, want), (t_losses, port)


def _gates_nudged(v, seed):
    """The variables with the gates off zero, so the ctr and ada graphs
    carry gradient from the first step."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
                      if p[-1].key in ("alpha", "beta") else np.asarray(a)),
        v)


def test_narrow_dsgcn_train_float64_matches_jax(narrow_vars):
    """Three steps on the dense path in float64: losses, parameters and
    BatchNorm statistics to 1e-8 relative."""
    v = _gates_nudged(narrow_vars, seed=2)
    jcfg, tcfg = _cfgs(False)
    tcfg["backbone"]["gcn_use_pallas"] = False     # the port's dense path
    jax.config.update("jax_enable_x64", True)
    try:
        (jl, want), (tl, port) = _run_both(
            jcfg, tcfg, v, _batches(3, np.float64), jnp.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(tl, jl, rtol=1e-8)
    state = port.state_dict()
    for name, w in want.items():
        assert_rel(state[name].numpy(), w.numpy(), 1e-8, name)


def test_narrow_dsgcn_train_kernel_path_matches_jax(narrow_vars):
    """One float32 step on the kernel path: the port's K1+K2 Function (CPU
    branch) against the JAX Pallas kernels in interpret mode."""
    v = _gates_nudged(narrow_vars, seed=3)
    init = convert_jax_variables(v)
    jcfg, tcfg = _cfgs(True)
    tcfg["backbone"]["gcn_eval_kernel"] = "bd"    # training ignores it
    before = fused_dyn_graph_agg.launches
    (jl, want), (tl, port) = _run_both(jcfg, tcfg, v,
                                       _batches(1, np.float32, seed=61),
                                       jnp.float32)
    assert fused_dyn_graph_agg.launches == before     # CPU: plain versions
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for name, p in port.named_parameters():
        du_got = (p.detach().numpy() - init[name].numpy()).ravel()
        du_want = (want[name].numpy() - init[name].numpy()).ravel()
        n_want = np.linalg.norm(du_want)
        cos = du_got @ du_want / (np.linalg.norm(du_got) * n_want)
        assert cos > 0.995, (name, cos)
        assert abs(np.linalg.norm(du_got) / n_want - 1) < 5e-2, name
    state = port.state_dict()
    for name, w in want.items():        # the BatchNorm statistics
        if "running" in name:
            assert_rel(state[name].numpy(), w.numpy(), 1e-4, name)


def test_bf16_compute_keeps_float32_master_weights():
    _, tcfg = _cfgs(True)
    port = build_model(tcfg)
    opt, sched = make_optimizer(port, total_steps=2)
    m = train_step(port, opt, sched, _batches(1, np.float32)[0],
                   compute_dtype="bfloat16")
    assert m["loss"].dtype == torch.float32 and torch.isfinite(m["loss"])
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert port.backbone.block0.gcn.bn.running_var.dtype == torch.float32


# ---------------------------------------------------------------------------
# trainer and CLI on the CPU
# ---------------------------------------------------------------------------

def _cli_config(tmp_path):
    ann = tmp_path / "synth.pkl"
    D.make_synthetic_pose_dataset(num_samples=16, num_classes=5, t=40,
                                  path=str(ann))
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"""
_base_ = [{str(CONFIG)!r}]
clip_len = 16
model = dict(backbone=dict(num_stages=4, base_channels=32,
                           inflate_stages=(3,), down_stages=(3,),
                           gcn_ratio=0.25),
             cls_head=dict(num_classes=5, in_channels=64))
data = dict(videos_per_gpu=4, workers_per_gpu=2,
            test_dataloader=dict(videos_per_gpu=4),
            train=dict(ann_file={str(ann)!r}, split='train'),
            val=dict(ann_file={str(ann)!r}, split='val'))
checkpoint_config = dict(interval=1)
""")
    return str(cfg)


def test_train_cli_checkpoints_and_resumes(tmp_path,
                                           one_thread):  # noqa: F811
    cfg = _cli_config(tmp_path)
    wd = tmp_path / "wd"
    base = [cfg, "--work-dir", str(wd), "--validate", "--device", "cpu",
            "--seed", "1"]
    t1 = cli.main(base + ["--total-epochs", "1"])
    assert t1.step == 3 and (wd / "ckpt" / "3.pt").exists()
    assert json.loads((wd / "ckpt" / "3.json").read_text())["epoch"] == 1
    t2 = cli.main(base + ["--total-epochs", "2"])
    assert t2.start_epoch == 1 and t2.step == 6
    assert (wd / "ckpt" / "6.pt").exists()
    records = [json.loads(line) for f in sorted(wd.glob("*.log.jsonl"))
               for line in f.read_text().splitlines()]
    assert any(r.get("event") == "resume" for r in records)
    vals = [r for r in records if r.get("mode") == "val"]
    assert len(vals) == 2 and "mean_class_accuracy" in vals[-1]
    losses = [r["loss"] for r in records if r.get("mode") == "train"]
    assert losses and all(np.isfinite(losses))


def test_train_cli_validates_without_the_flag(tmp_path,
                                              one_thread):  # noqa: F811
    """As JAX's tools/train.py (:52, :105): a config with ``data.val`` is
    validated every ``evaluation.interval`` epochs, and the best
    checkpoint kept, with no ``--validate`` on the command line."""
    cfg = _cli_config(tmp_path)
    wd = tmp_path / "wd"
    trainer = cli.main([cfg, "--work-dir", str(wd), "--device", "cpu",
                        "--total-epochs", "2", "--seed", "2"])
    assert trainer.val_loader is not None
    records = [json.loads(line) for f in sorted(wd.glob("*.log.jsonl"))
               for line in f.read_text().splitlines()]
    vals = [r for r in records if r.get("mode") == "val"]
    assert [r["epoch"] for r in vals] == [0, 1]
    assert all(0 <= r["top1_acc"] <= 1 for r in vals)
    metas = [json.loads((wd / "ckpt" / f"{s}.json").read_text())
             for s in (3, 6)]
    best = max(vals, key=lambda r: r["top1_acc"])
    assert metas[-1]["score"] == best["top1_acc"]
    assert metas[-1]["best_epoch"] == best["epoch"]
    assert metas[0]["best"]                 # the first score is the best yet


def test_trainer_needs_cuda_unless_cpu_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _cfgs(False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(build_model(tcfg), str(tmp_path), train_loader=None)
