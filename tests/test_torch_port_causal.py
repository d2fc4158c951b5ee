"""Port parity, the Granger-causality learners: ``GCSparse`` (in the
``GCGCN`` backbone), ``GCComponent`` (``GCGCN_component``), ``GCHead`` and
``gc_recognizer_losses`` of ``dsgcn_tpu_torch`` against ``dsgcn_tpu`` on
the CPU; the conversion of JAX's 'constants' collection; the init rules
of the raw banks.

None of these reaches a Pallas kernel in JAX or launches a kernel of the
port.  Narrow widths, T = 12 against V = 25 joints (a (joint, time)
buffer read as (time, joint) cannot pass for itself).  In float64 at
1e-8 relative: each learner's eval outputs (loss terms and graph) and
its GCHead logits; one SGD step by hand (lr 0.1) on both sides with the
objective ``gc_recognizer_losses``: the loss, the parameters and the
BatchNorm statistics, and GCComponent's ``weight_norm``, which stays the
init-time norm.  The JAX side of each learner is one jitted program.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.core.flows import gc_recognizer_losses as j_gc_losses
from dsgcn_tpu.models.builder import build_backbone as j_build_backbone
from dsgcn_tpu.models.builder import build_head as j_build_head
from dsgcn_tpu.ops.causal import GCSparse as JGCSparse
from dsgcn_tpu_torch.core.flows import gc_recognizer_losses
from dsgcn_tpu_torch.models.builder import (build_backbone, build_head,
                                            init_weights_)
from dsgcn_tpu_torch.ops.causal import GCComponent, GCSparse
from dsgcn_tpu_torch.ops.kernels import launch_counts
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _random_variables
from test_torch_port_gcn_families import F64, _f64, _x, x64
from test_torch_port_grad import assert_rel

V = 9                              # joints: the learners need no graph
SHAPE = (2, 2, 12, V, 3)           # N, M, T, V, C
LEARNERS = {
    "GCGCN": dict(type="GCGCN", mid_channels=6, feature_hidden=(4, 8, 4, 1),
                  causal_hidden=(8,), ms_cfg=((3, 1), (3, 2))),
    "GCGCN_component": dict(type="GCGCN_component", causal_channel=8,
                            feature_update=(8, 16, 1),
                            feature_hidden=(8, 4, 1), time_len=4),
}
# the port sizes the banks from num_joints (JAX from its input)
PORT = {k: dict(v, num_joints=V) for k, v in LEARNERS.items()
}
HEAD = dict(type="GCHead", num_classes=5, in_channels=V * V, dropout=0.0)


def _graph_of(outputs):
    """The (N, M, V, V) graph among a learner's outputs."""
    return outputs[0] if len(outputs) == 4 else outputs[1]


def _variables(jb, jh, seed):
    x = jnp.zeros(SHAPE)
    vb = _random_variables(jax.eval_shape(lambda: jb.init(
        jax.random.PRNGKey(0), x, train=False)), seed)
    if "constants" in vb:          # the init-time norm of the generator
        w = vb["params"]["weight"]
        vb["constants"]["weight_norm"] = np.sqrt((w ** 2).sum(0)).astype(
            np.float32)
    vh = _random_variables(jax.eval_shape(lambda: jh.init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE[:2] + (V, V)),
        train=False)), seed + 1)
    return vb, vh


def _jax_side(jb, jh, vb, vh, x, label):
    """JAX's float64 eval outputs and logits, and one SGD step (lr 0.1) on
    the GC objective, as one program."""
    consts = {k: vb[k] for k in ("constants",) if k in vb}

    def objective(p, stats, train):
        out, mut = jb.apply({"params": p["b"], "batch_stats": stats,
                             **consts}, x, train=train,
                            mutable=["batch_stats"])
        logits = jh.apply({"params": p["h"]}, _graph_of(out), train=train)
        total, parts = j_gc_losses(out, logits, label)
        return total, (out, logits, parts, mut)

    def both(p, stats):
        _, (out, logits, parts, _) = objective(p, stats, False)
        (loss, (_, _, _, mut)), g = jax.value_and_grad(
            lambda q: objective(q, stats, True), has_aux=True)(p)
        new = jax.tree.map(lambda a, b: a - 0.1 * b, p, g)
        return out, logits, parts, loss, new, mut
    params = _f64({"b": vb["params"], "h": vh["params"]})
    return jax.device_get(jax.jit(both)(params, _f64(vb["batch_stats"])))


@pytest.fixture(scope="module", params=list(LEARNERS))
def learner(request):
    """(name, port backbone and head loaded from JAX's variables, JAX's
    results, input, labels)."""
    cfg = LEARNERS[request.param]
    jb, jh = j_build_backbone(cfg), j_build_head(HEAD)
    vb, vh = _variables(jb, jh, seed=len(request.param))
    x = _x(7, *SHAPE)
    label = np.random.default_rng(8).integers(0, 5, SHAPE[0])
    with x64():
        want = _jax_side(jb, jh, vb, vh, jnp.asarray(x), jnp.asarray(label))
    backbone, head = build_backbone(PORT[request.param]), build_head(HEAD)
    backbone.load_state_dict(convert_jax_variables(vb), strict=True)
    head.load_state_dict(convert_jax_variables(vh), strict=True)
    return (request.param, backbone.double(), head.double(), vb, want, x,
            label)


def test_learner_eval_float64_matches_jax(learner):
    """The eval outputs: the prediction error, the graph, the penalties;
    the GCHead logits over the graph; the objective's terms."""
    name, backbone, head, _, (out_j, logits_j, parts_j, *_), x, label = \
        learner
    before = launch_counts()
    with torch.no_grad():
        out = backbone.eval()(torch.from_numpy(x))
        logits = head.eval()(_graph_of(out))
        _, parts = gc_recognizer_losses(out, logits, torch.from_numpy(label))
    assert launch_counts() == before
    assert len(out) == len(out_j) == (3 if name == "GCGCN" else 4)
    for i, (g, w) in enumerate(zip(out, out_j)):
        assert_rel(g.numpy(), np.asarray(w), F64, f"{name} output {i}")
    assert_rel(logits.numpy(), logits_j, F64, "GCHead logits")
    assert parts.keys() == parts_j.keys()
    for k in parts:
        assert_rel(parts[k].numpy(), parts_j[k], F64, k)


def test_learner_sgd_step_float64_matches_jax(learner):
    """One SGD step by hand on the GC objective in train mode: the loss,
    every parameter, the BatchNorm statistics; GCComponent's
    ``weight_norm`` stays JAX's constant (the init-time norm), not the
    norm of the stepped weight."""
    name, backbone, head, vb, (*_, loss_j, new, mut), x, label = learner
    backbone, head = backbone.train(), head.train()
    out = backbone(torch.from_numpy(x))
    total, _ = gc_recognizer_losses(out, head(_graph_of(out)),
                                    torch.from_numpy(label))
    params = list(backbone.parameters()) + list(head.parameters())
    opt = torch.optim.SGD(params, lr=0.1)
    opt.zero_grad()
    total.backward()
    opt.step()
    np.testing.assert_allclose(total.item(), float(loss_j), rtol=F64)
    for mod, tree in ((backbone, {"params": new["b"], **mut,
                                  **{k: vb[k] for k in ("constants",)
                                     if k in vb}}),
                      (head, {"params": new["h"]})):
        want = convert_jax_variables(jax.tree.map(np.array, tree))
        state = mod.state_dict()
        assert state.keys() == want.keys()
        for k, w in want.items():
            assert_rel(state[k].numpy(), w.numpy(), F64, f"{name} {k}")
    if name == "GCGCN_component":
        norm = torch.sqrt((backbone.weight ** 2).sum(0))
        assert not torch.allclose(norm, backbone.weight_norm, rtol=1e-6)


def test_gc_losses_match_jax_on_both_output_forms():
    """The objective on GCGCN_component's four outputs and GCGCN's three:
    the mean of the prediction error, the penalties and the cross
    entropy, float32 at 1e-6."""
    rng = np.random.default_rng(9)
    logits, label = rng.standard_normal((3, 5)), rng.integers(0, 5, 3)
    pred = rng.random((6, V, 11))
    g = rng.random((3, 2, V, V))
    pen, ridge = rng.random(), rng.random()
    for out in ((g, pred, pen, ridge), (pred, g, pen)):
        f32 = [np.float32(a) for a in out]
        tot_j, parts_j = j_gc_losses(tuple(map(jnp.asarray, f32)),
                                     jnp.asarray(logits, jnp.float32),
                                     jnp.asarray(label))
        tot, parts = gc_recognizer_losses(
            tuple(torch.as_tensor(a) for a in f32),
            torch.as_tensor(logits, dtype=torch.float32),
            torch.as_tensor(label))
        assert parts.keys() == parts_j.keys()
        np.testing.assert_allclose(tot.item(), float(tot_j), rtol=1e-6)
        for k in parts:
            np.testing.assert_allclose(parts[k].item(), float(parts_j[k]),
                                       rtol=1e-6)


def test_unequal_kernels_refused():
    """The graph stacks the branches' weights: JAX asserts equal kernel
    sizes at the call, the port at construction."""
    ms = ((3, 1), (5, 1))
    with pytest.raises(AssertionError, match="equal kernels"):
        jax.eval_shape(lambda: JGCSparse(ms_cfg=ms).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 8, 25, 3)), train=False))
    with pytest.raises(ValueError, match="equal kernels"):
        GCSparse(ms_cfg=ms)


def test_init_rules_follow_jax():
    """init_weights_ draws the raw banks from JAX's torch_default_kernel /
    torch_default_bias over JAX's fans and takes GCComponent's
    ``weight_norm`` from the drawn weight; GCHead's classifier is
    normal(0.01) with a zero bias."""
    gen = torch.Generator().manual_seed(0)
    sp = init_weights_(build_backbone(dict(type="GCGCN")), gen).net
    for name, bound in (("branch0_w", (25 * 25 * 50) ** -0.5),
                        ("branch1_b", (25 * 3) ** -0.5),
                        ("follow_w", 25 ** -0.5),
                        ("follow_b", 200 ** -0.5)):
        t = getattr(sp, name)
        assert t.abs().max() <= bound and t.std() > 0.5 * bound, name
    comp = init_weights_(build_backbone(dict(type="GCGCN_component")), gen)
    assert isinstance(comp, GCComponent)
    bound = (25 * 100) ** -0.5
    assert comp.weight.abs().max() <= bound
    torch.testing.assert_close(comp.weight_norm,
                               torch.sqrt((comp.weight ** 2).sum(0)))
    assert comp.follow1_b.abs().max() <= 100 ** -0.5
    head = init_weights_(build_head(dict(HEAD, dropout=0.5)), gen)
    assert (head.fc_cls.bias == 0).all()
    assert abs(head.fc_cls.weight.std().item() / 0.01 - 1) < 0.1
