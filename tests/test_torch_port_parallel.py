"""Port parity, data parallelism: the loader's shards, the joint-partition
helpers, and the data-parallel train and eval steps of
``dsgcn_tpu_torch/parallel`` against ``dsgcn_tpu/parallel`` on the CPU.

The port's two ranks run once for the module, as child processes joined
over gloo through a ``file://`` store (``tests/torch_port_dist_worker.py``,
which imports no JAX); JAX runs the same step in this process on a data=2
mesh of the virtual CPU devices, on the same shards.  The narrow DS-GCN (4
stages, 2 clips a rank, T 8) runs on the dense path in float64, where the
two agree to rounding (``tests/test_jp_model.py`` says why float64): the
loss to 1e-11, parameters and BatchNorm statistics to 1e-9 relative, the
logits to 1e-11.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.core.train import TrainState
from dsgcn_tpu.core.train import make_optimizer as j_make_optimizer
from dsgcn_tpu.data import dataset as JD
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.parallel import joint_partition as JP
from dsgcn_tpu.parallel.mesh import make_mesh as j_make_mesh
from dsgcn_tpu.parallel.mesh import replicate, shard_batch
from dsgcn_tpu.parallel.train import make_dp_eval_step, make_dp_train_step
from dsgcn_tpu_torch.data import dataset as D
from dsgcn_tpu_torch.parallel import joint_partition as P
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _random_variables
from test_torch_port_model import _cfgs
from torch_port_dist_worker import collect, launch

N_RANK, LR = 2, 0.1


# ---------------------------------------------------------------------------
# the loader's shards and the joint-partition helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,num_shards,drop", [
    (10, 1, None), (10, 2, None), (11, 3, None), (11, 4, 2), (7, 8, None),
    (25, 5, 4)])
def test_epoch_indices_match_jax(n, num_shards, drop):
    for epoch in (0, 3):
        for shuffle in (True, False):
            for shard in range(num_shards):
                got = D.epoch_indices(n, epoch, shard, num_shards, shuffle,
                                      seed=5, drop_last_to_multiple=drop)
                want = JD.epoch_indices(n, epoch, shard, num_shards,
                                        shuffle, seed=5,
                                        drop_last_to_multiple=drop)
                np.testing.assert_array_equal(got, want)


def test_loader_shards_match_jax(tmp_path):
    """Each shard's batches through both loaders (the same permutation,
    padding and per-sample RandomStates)."""
    path = str(tmp_path / "synth.pkl")
    D.make_synthetic_pose_dataset(num_samples=19, num_classes=5, t=20,
                                  seed=4, path=path)
    pipe = [dict(type="UniformSample", clip_len=8),
            dict(type="PoseDecode"), dict(type="FormatGCNInput"),
            dict(type="Collect", keys=["keypoint", "label"])]
    for shard in range(2):
        kw = dict(batch_size=3, seed=2, num_workers=0, drop_last=True,
                  shard=shard, num_shards=2)
        ours = D.Loader(D.PoseDataset(path, pipe, split="train"), **kw)
        ref = JD.Loader(JD.PoseDataset(path, pipe, split="train"), **kw)
        assert ours.steps_per_epoch() == ref.steps_per_epoch() >= 1
        for got, want in zip(ours.epoch(1), ref.epoch(1)):
            np.testing.assert_array_equal(got["label"], want["label"])
            np.testing.assert_allclose(got["keypoint"], want["keypoint"],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shards", [1, 4, 5, 7])
def test_padding_matches_jax(shards):
    rng = np.random.default_rng(shards)
    x = rng.standard_normal((2, 3, 25, 4)).astype(np.float32)
    A = rng.standard_normal((3, 25, 25)).astype(np.float32)
    assert P.pad_to_multiple(25, shards) == JP.pad_to_multiple(25, shards)
    for ax in (2, -2):
        np.testing.assert_array_equal(
            P.pad_joints(torch.from_numpy(x), shards, ax).numpy(),
            np.asarray(JP.pad_joints(jnp.asarray(x), shards, ax)))
    np.testing.assert_array_equal(
        P.pad_adjacency(torch.from_numpy(A), shards).numpy(),
        np.asarray(JP.pad_adjacency(jnp.asarray(A), shards)))


@pytest.mark.parametrize("G", [1, 5, 25])
def test_comm_volume_and_rate_match_jax(G):
    kw = dict(n=64, t=100, V=25, K=3, mid=16, G=G)
    assert P.jp_comm_volume(**kw) == JP.jp_comm_volume(**kw)
    assert P.jp_comm_volume(**kw, itemsize=2) == JP.jp_comm_volume(
        **kw, itemsize=2)
    assert P.edges_per_second(25, 3, 64, 100, 0.5) == \
        JP.edges_per_second(25, 3, 64, 100, 0.5)


def test_init_distributed_refuses_nccl_on_the_cpu():
    """NCCL never starts on a CPU device, and nothing falls back to
    gloo."""
    from dsgcn_tpu_torch.parallel.mesh import init_distributed
    with pytest.raises(ValueError, match="nccl"):
        init_distributed("nccl", device="cpu")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the data-parallel steps: 2 gloo ranks against JAX's data=2 mesh
# ---------------------------------------------------------------------------

def _narrow():
    jcfg, tcfg = _cfgs(False)
    for cfg in (jcfg, tcfg):
        cfg["backbone"]["gcn_use_pallas"] = False
    return jcfg, tcfg


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The port's ranks (started first) and JAX's steps (meanwhile): the
    DP train step on the 4-clip batch split 2 + 2, and the DP eval step on
    a 6-clip batch."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(70)
    x = rng.standard_normal((2 * N_RANK, 2, 8, 25, 3))
    y = rng.integers(0, 11, 2 * N_RANK)
    x_eval = rng.standard_normal((6, 2, 8, 25, 3))
    jcfg, tcfg = _narrow()
    jmodel = j_build_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 25, 3)), train=False))
    v = jax.tree.map(lambda a: np.asarray(a, np.float64),
                     _random_variables(shapes, seed=71))
    state = convert_jax_variables(v)
    shards = [dict(keypoint=torch.from_numpy(x[2 * r:2 * r + 2]),
                   label=torch.from_numpy(y[2 * r:2 * r + 2]))
              for r in range(N_RANK)]
    common = dict(cfg=tcfg, state=state, dtype="float64")
    procs = launch(dict(mesh=(N_RANK, 1), cases=[
        dict(common, name="train", kind="train", lr=LR, total_steps=10,
             shards=shards),
        dict(common, name="eval", kind="eval",
             keypoint=torch.from_numpy(x_eval))]), N_RANK, str(tmp))
    jax.config.update("jax_enable_x64", True)
    want = {}
    try:
        mesh = j_make_mesh(n_data=N_RANK, devices=jax.devices()[:N_RANK])

        def train():
            tx, _ = j_make_optimizer(lr=LR, total_steps=10)
            state = replicate(TrainState.create(
                jmodel.apply, v["params"], v["batch_stats"], tx), mesh)
            batch = shard_batch(dict(keypoint=jnp.asarray(x),
                                     label=jnp.asarray(y)), mesh)
            state, metrics = make_dp_train_step(mesh)(state, batch,
                                                      jax.random.PRNGKey(3))
            want["loss"] = float(metrics["loss"])
            want["state"] = convert_jax_variables(jax.device_get(dict(
                params=state.params, batch_stats=state.batch_stats)))

        def evaluate():
            want["logits"] = np.asarray(make_dp_eval_step(
                mesh, jmodel.apply)(v["params"], v["batch_stats"],
                                    jnp.asarray(x_eval)))
        # one program a thread: XLA compiles them side by side
        with ThreadPoolExecutor(2) as ex:
            for f in [ex.submit(train), ex.submit(evaluate)]:
                f.result()
    finally:
        jax.config.update("jax_enable_x64", False)
    return collect(procs, str(tmp)), want


def test_dp_train_step_matches_jax(dp_runs):
    ranks, want = dp_runs
    got = ranks[0]
    assert abs(float(got["train/metric/loss"]) - want["loss"]) < 1e-11
    for name, w in want["state"].items():
        w = w.numpy()
        g = got[f"train/state/{name}"]
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-10 * scale,
                                   err_msg=name)


def test_dp_ranks_end_equal(dp_runs):
    """Every rank holds the same weights, statistics and metrics after the
    step (gradients and running statistics reduced across processes)."""
    ranks, _ = dp_runs
    keys = [k for k in ranks[0] if k.startswith("train/")]
    assert any("running_var" in k for k in keys)
    for other in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


def test_dp_eval_step_matches_jax(dp_runs):
    ranks, want = dp_runs
    for r in ranks:        # every rank returns the whole batch's logits
        np.testing.assert_allclose(r["eval/logits"], want["logits"],
                                   rtol=1e-11, atol=1e-11)
