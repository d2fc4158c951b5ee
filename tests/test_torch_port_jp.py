"""Port parity, joint partition: the graph-axis ring and the joint-partitioned
DG-STGCN (``dggcn``) and DS-GCN (``dgphgcn1``) of ``dsgcn_tpu_torch``
against ``dsgcn_tpu`` on the CPU.

The port's five ranks (V = 25 joints, G = 5 blocks of 5) run once for the
module, as child processes joined over gloo through a ``file://`` store
(``tests/torch_port_dist_worker.py``, which imports no JAX); JAX runs
``make_jp_eval_step`` and ``make_jp_train_step`` in this process on a (1, 5)
mesh of the virtual CPU devices.  The models are ``tests/test_jp_model.py``'s
two configs, in float64 with its tolerances: logits to 1e-11, the loss to
1e-11, parameters and BatchNorm statistics to 1e-9 relative.  The ring's
bytes are held to ``jp_comm_volume``, and the graph_axis models on a G = 1
mesh (the degenerate ring, every collective of the path in place) to the
plain models.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as JPSpec

from dsgcn_tpu.core.train import TrainState
from dsgcn_tpu.core.train import make_optimizer as j_make_optimizer
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.parallel.joint_partition import jp_unit_gcn_forward as j_unit
from dsgcn_tpu.parallel.joint_partition import \
    ring_spatial_aggregate as j_ring
from dsgcn_tpu.parallel.mesh import GRAPH_AXIS
from dsgcn_tpu.parallel.mesh import make_mesh as j_make_mesh
from dsgcn_tpu.parallel.mesh import replicate, shard_batch
from dsgcn_tpu.parallel.train import make_jp_eval_step, make_jp_train_step
from dsgcn_tpu_torch.parallel.joint_partition import jp_comm_volume
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_jp_model import _cfg, _dsgcn_cfg
from test_torch_port_dggcn import _random_variables
from torch_port_dist_worker import collect, launch

G, N_CLASSES, LR = 5, 7, 0.1
CONFIGS = {"dggcn": _cfg, "dgphgcn1": _dsgcn_cfg}


def _port_cfg(cfg_of, graph_axis):
    cfg = cfg_of(graph_axis)
    cfg["backbone"]["gcn_use_pallas"] = False    # the plain model: dense
    return cfg


@pytest.fixture(scope="module")
def jp_runs(tmp_path_factory):
    """The port's five ranks (started first), then JAX's: the ring on a
    (2, 3, 25, 3, 4) block, unit_gcn on a (2, 3, 25, 6) one, and per
    config the jp eval step and one jp train step on a (4, 2, 8, 25, 3)
    batch."""
    tmp = tmp_path_factory.mktemp("jp")
    rng = np.random.default_rng(80)
    xr = rng.standard_normal((2, 3, 25, 3, 4))
    A = rng.standard_normal((3, 25, 25))
    x = rng.standard_normal((4, 2, 8, 25, 3))
    y = rng.integers(0, N_CLASSES, 4)
    batch = dict(keypoint=torch.from_numpy(x), label=torch.from_numpy(y))
    xu = rng.standard_normal((2, 3, 25, 6))
    wu, bu = rng.standard_normal((6, 3 * 4)), rng.standard_normal(3 * 4)
    variables, cases = {}, [
        dict(name="ring", kind="ring", x=torch.from_numpy(xr),
             A=torch.from_numpy(A)),
        dict(name="unit", kind="unit_gcn", x=torch.from_numpy(xu),
             A=torch.from_numpy(A), weight=torch.from_numpy(wu.T.copy()),
             bias=torch.from_numpy(bu))]
    for name, cfg_of in CONFIGS.items():
        shapes = jax.eval_shape(lambda: j_build_model(cfg_of()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 25, 3)),
            train=False))
        v = jax.tree.map(lambda a: np.asarray(a, np.float64),
                         _random_variables(shapes, seed=81))
        variables[name] = v
        common = dict(cfg=_port_cfg(cfg_of, GRAPH_AXIS), dtype="float64",
                      state=convert_jax_variables(v), jp=True)
        cases += [dict(common, name=f"{name}/eval", kind="eval",
                       keypoint=batch["keypoint"]),
                  dict(common, name=f"{name}/train", kind="train", lr=LR,
                       total_steps=10, shards=[batch]),
                  dict(common, name=f"{name}/g1", kind="g1", batch=batch,
                       cfg=_port_cfg(cfg_of, None),
                       keypoint=batch["keypoint"])]
    procs = launch(dict(mesh=(1, G), cases=cases), G, str(tmp))
    jax.config.update("jax_enable_x64", True)
    want = {}
    try:
        mesh = j_make_mesh(n_data=1, n_graph=G, devices=jax.devices()[:G])
        want["ring"] = np.asarray(jax.jit(jax.shard_map(
            lambda xs, a: j_ring(xs, a, GRAPH_AXIS), mesh=mesh,
            in_specs=(JPSpec(None, None, GRAPH_AXIS), JPSpec()),
            out_specs=JPSpec(None, None, GRAPH_AXIS), check_vma=False))(
                jnp.asarray(xr), jnp.asarray(A)))
        want["unit"] = np.asarray(jax.jit(jax.shard_map(
            lambda xs, a, w, b: j_unit(xs, a, w, b, GRAPH_AXIS), mesh=mesh,
            in_specs=(JPSpec(None, None, GRAPH_AXIS), JPSpec(), JPSpec(),
                      JPSpec()),
            out_specs=JPSpec(None, None, GRAPH_AXIS), check_vma=False))(
                jnp.asarray(xu), jnp.asarray(A), jnp.asarray(wu),
                jnp.asarray(bu)))
        tx, _ = j_make_optimizer(lr=LR, total_steps=10, schedule="constant")

        def reference(job):
            # one program a thread: XLA compiles them side by side
            name, kind = job
            jp = j_build_model(CONFIGS[name](GRAPH_AXIS))
            v = variables[name]
            if kind == "eval":
                want[f"{name}/logits"] = np.asarray(make_jp_eval_step(
                    mesh, jp.apply)(v["params"], v["batch_stats"],
                                    jnp.asarray(x)))
                return
            state = replicate(TrainState.create(
                jp.apply, v["params"], v["batch_stats"], tx), mesh)
            state, m = make_jp_train_step(mesh)(
                state, shard_batch(dict(keypoint=jnp.asarray(x),
                                        label=jnp.asarray(y)), mesh),
                jax.random.PRNGKey(3))
            want[f"{name}/loss"] = float(m["loss"])
            want[f"{name}/state"] = convert_jax_variables(jax.device_get(
                dict(params=state.params, batch_stats=state.batch_stats)))
        jobs = [(name, kind) for name in CONFIGS for kind in ("train",
                                                              "eval")]
        with ThreadPoolExecutor(len(jobs)) as ex:
            list(ex.map(reference, jobs))
    finally:
        jax.config.update("jax_enable_x64", False)
    return collect(procs, str(tmp)), want


@pytest.mark.parametrize("case,axis", [("ring", -2), ("unit", 2)])
def test_ring_spatial_aggregate_matches_jax(jp_runs, case, axis):
    """ring_spatial_aggregate of a (2, 3, 25, 3, 4) block, and
    jp_unit_gcn_forward (a 6 -> 3 x 4 pre 1x1, then the ring) of a (2, 3,
    25, 6) one: the five ranks' output joints together."""
    ranks, want = jp_runs
    got = np.concatenate([r[f"{case}/y"] for r in ranks], axis=axis)
    np.testing.assert_allclose(got, want[case], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jp_forward_matches_jax(jp_runs, name):
    ranks, want = jp_runs
    for r in ranks:      # every rank of the graph group has the logits
        np.testing.assert_allclose(r[f"{name}/eval/logits"],
                                   want[f"{name}/logits"],
                                   rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jp_train_step_matches_jax(jp_runs, name):
    ranks, want = jp_runs
    got = ranks[0]
    assert abs(float(got[f"{name}/train/metric/loss"])
               - want[f"{name}/loss"]) < 1e-11
    for key, w in want[f"{name}/state"].items():
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[f"{name}/train/state/{key}"], w,
                                   rtol=1e-9, atol=1e-10 * scale,
                                   err_msg=key)
    for other in ranks[1:]:     # gradients and statistics agree everywhere
        for k in got:
            if k.startswith(f"{name}/train/"):
                np.testing.assert_array_equal(other[k], got[k], err_msg=k)


def _ring_shapes(name):
    """(n, t, mid) of each block's ring at the (4, 2, 8, 25, 3) input: the
    configs' stages run at T 8, 8, 8, 4 (the stride-2 stage's GCN sees T
    before its TCN halves it), widths 64, 64, 128, 128."""
    ratio = 0.25 if name == "dggcn" else 0.125
    return [(8, t, int(ratio * c)) for t, c in ((8, 64), (8, 64), (8, 128),
                                                (4, 128))]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_ring_bytes_match_comm_volume(jp_runs, name):
    """What each rank's ring_permute sent in the eval forward: every
    block's ``jp_comm_volume(...)['ppermute_bytes']``, float64."""
    ranks, _ = jp_runs
    want = sum(jp_comm_volume(n, t, 25, 3, mid, G, itemsize=8)
               ["ppermute_bytes"] for n, t, mid in _ring_shapes(name))
    for r in ranks:
        assert int(r[f"{name}/eval/ring_bytes"]) == want


@pytest.mark.parametrize("name", list(CONFIGS))
def test_g1_model_equals_plain(jp_runs, name):
    """At G = 1 the graph_axis model (the ring of one hop, the synced
    BatchNorms, the gathers) computes the plain model's logits, loss and
    step to rounding."""
    ranks, _ = jp_runs
    r = ranks[0]
    pre = f"{name}/g1"
    np.testing.assert_allclose(r[f"{pre}/jp/logits"], r[f"{pre}/plain/logits"],
                               rtol=1e-11, atol=1e-11)
    assert abs(float(r[f"{pre}/jp/loss"]) - float(r[f"{pre}/plain/loss"])) \
        < 1e-11
    for k in r:
        if k.startswith(f"{pre}/plain/state/"):
            w = r[k]
            scale = max(float(np.abs(w).max()), 1e-6)
            np.testing.assert_allclose(
                r[k.replace("/plain/", "/jp/")], w, rtol=1e-9,
                atol=1e-10 * scale, err_msg=k)
