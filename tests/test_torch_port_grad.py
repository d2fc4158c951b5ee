"""Port parity, gradients: the plain K2 backward, train-mode BatchNorm,
and the train-mode DGPHGCN1 and DGMSTCN of ``dsgcn_tpu_torch`` against
``dsgcn_tpu`` on the CPU.

JAX's K2 runs in interpret mode through ``jax.vjp`` of the Pallas
``fused_dyn_graph_agg``.  Tolerances, relative to each output's largest
entry: 1e-5 for the plain backward in float32 (the same sums in another
order), one bfloat16 rounding (2^-8, doubled to 8e-3) for a bfloat16 dpre;
1e-5 for BatchNorm; 2e-4 for module outputs and gradients (float32 through
two 1x1 convs, a BatchNorm whose batch statistics divide by a small
variance, and the graph chain), each gradient against the larger of its
own scale and 1e-2 of the module's largest gradient.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu.ops.common import BatchNorm as JBatchNorm
from dsgcn_tpu.ops.gcn import DGPHGCN1 as JDGPHGCN1
from dsgcn_tpu.ops.pallas.dyn_graph import fused_dyn_graph_agg as j_fused
from dsgcn_tpu.ops.tcn import DGMSTCN as JDGMSTCN
from dsgcn_tpu_torch.ops.common import BatchNorm
from dsgcn_tpu_torch.ops.gcn import DGPHGCN1
from dsgcn_tpu_torch.ops.kernels.dyn_graph import (
    fused_dyn_graph_agg, fused_dyn_graph_agg_bwd,
    reference_dyn_graph_agg, reference_dyn_graph_agg_bwd)
from dsgcn_tpu_torch.ops.tcn import DGMSTCN
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_model import GCN_KW, nudge
from torch_port_cases import E, block_inputs, to_torch

OUTS = ("dpre", "dx1", "dx2", "dA", "dalpha", "dbeta", "dedge_w", "dedge_b")
K2_ARGS = ("pre", "x1", "x2", "A", "alpha", "beta", "ew", "eb")
MODULE_RTOL = 2e-4


def assert_rel(got, want, rtol, what="", floor=1e-12):
    """max |got - want| <= rtol * max(max |want|, floor)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), floor)
    err = np.abs(got - want).max() / scale
    assert err <= rtol, f"{what}: {err:.3e} relative (tol {rtol})"


def _k2_case(edge, dtype, seed=0):
    d = block_inputs(seed=seed, N=2, T=8, V=25, Cm=4, edge=edge)
    d["dy"] = np.random.default_rng(seed + 100).standard_normal(
        d["pre"].shape).astype(np.float32)
    if dtype == "bfloat16":   # both sides start from the same bf16 values
        for k in ("pre", "dy"):
            d[k] = torch.from_numpy(d[k]).bfloat16().float().numpy()
    return d


def _jax_k2(d, edge, dtype):
    """JAX's backward kernel (interpret mode) through jax.vjp."""
    K, Cm = 3, 4
    cast = (lambda a: jnp.asarray(a, jnp.bfloat16)) if dtype == "bfloat16" \
        else jnp.asarray
    sel = jnp.asarray(d["sel"]) if edge else None
    prim = [cast(d["pre"])] + [jnp.asarray(d[k]) for k in K2_ARGS[1:6]]
    if edge:
        prim += [jnp.asarray(d["ew"]), jnp.asarray(d["eb"])]

    def f(*a):
        ew, eb = (a[6], a[7]) if edge else (None, None)
        return j_fused(*a[:6], ew, eb, sel, K, Cm, 1 if edge else -1, E,
                       True)
    _, vjp = jax.vjp(f, *prim)
    grads = vjp(cast(d["dy"]))
    return [np.asarray(g, np.float32) for g in grads] + (
        [] if edge else [None, None])


def _port_k2_args(d, edge, dtype):
    t = {k: to_torch(d.get(k)) for k in K2_ARGS + ("sel", "dy")}
    if dtype == "bfloat16":
        t["pre"], t["dy"] = t["pre"].bfloat16(), t["dy"].bfloat16()
    if not edge:
        t["ew"] = t["eb"] = t["sel"] = None
    return ([t[k] for k in K2_ARGS] + [t["sel"], t["dy"]],
            dict(K=3, Cm=4, edge_k=1 if edge else -1, edge_num=E))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", [False, True])
def test_plain_backward_matches_jax_k2(edge, dtype):
    d = _k2_case(edge, dtype, seed=1 + edge)
    args, kw = _port_k2_args(d, edge, dtype)
    before = fused_dyn_graph_agg_bwd.launches
    got = fused_dyn_graph_agg_bwd(*args, **kw)      # CPU: the plain version
    assert fused_dyn_graph_agg_bwd.launches == before
    assert got[0].dtype == args[0].dtype
    want = _jax_k2(d, edge, dtype)
    for name, g, w in zip(OUTS, got, want):
        if w is None:
            assert g is None, name
            continue
        tol = 8e-3 if name == "dpre" and dtype == "bfloat16" else 1e-5
        assert_rel(g.float().numpy(), w, tol, name)


@pytest.mark.parametrize("edge", [False, True])
def test_plain_backward_matches_autograd(edge):
    """reference_dyn_graph_agg_bwd == torch.autograd through the plain
    forward (float32)."""
    d = _k2_case(edge, "float32", seed=3)
    args, kw = _port_k2_args(d, edge, "float32")
    ins = [a.clone().requires_grad_() for a in args[:8] if a is not None]
    full = ins[:6] + (ins[6:] if edge else [None, None]) + [args[8]]
    y = reference_dyn_graph_agg(*full, **kw)
    auto = torch.autograd.grad(y, ins, args[9])
    got = [g for g in reference_dyn_graph_agg_bwd(*args, **kw)
           if g is not None]
    for name, g, w in zip(OUTS, got, auto):
        assert_rel(g.numpy(), w.numpy(), 1e-5, name)


def test_function_backward_is_k2_and_once_differentiable():
    """The autograd Function on CPU tensors: forward = the plain K1, backward
    = the plain K2; grad-of-grad raises; v_real with a gradient raises."""
    d = _k2_case(True, "float32", seed=4)
    args, kw = _port_k2_args(d, True, "float32")
    ins = [a.clone().requires_grad_() for a in args[:8]]
    y = fused_dyn_graph_agg(*ins, args[8], **kw)
    grads = torch.autograd.grad(y, ins, args[9])
    want = reference_dyn_graph_agg_bwd(*args, **kw)
    for name, g, w in zip(OUTS, grads, want):
        assert_rel(g.numpy(), w.numpy(), 1e-6, name)
    y = fused_dyn_graph_agg(*ins, args[8], **kw)
    (g1,) = torch.autograd.grad((y * y).sum(), ins[1], create_graph=True)
    with pytest.raises(RuntimeError):
        g1.sum().backward()
    with pytest.raises(NotImplementedError, match="v_real"):
        fused_dyn_graph_agg(*ins, args[8], **kw, v_real=20)


@pytest.mark.parametrize("shape", [(4, 6, 25, 16), (3, 40, 75)])
def test_batchnorm_train_matches_jax(shape):
    """Output and running statistics of one train step (and the eval form
    after it), against JAX's BatchNorm with mutable=['batch_stats']."""
    x = (np.random.default_rng(5).standard_normal(shape) * 3 + 1).astype(
        np.float32)
    C = shape[-1]
    ref = JBatchNorm()
    v = nudge(ref.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       use_running_average=True), seed=6)
    y_j, mut = ref.apply(v, jnp.asarray(x), use_running_average=False,
                         mutable=["batch_stats"])
    port = BatchNorm(C)
    port.load_state_dict(convert_jax_variables(v), strict=True)
    y = port.train()(torch.from_numpy(x))
    assert_rel(y.detach().numpy(), y_j, 1e-5, "y")
    new = convert_jax_variables({"params": v["params"],
                                 "batch_stats": mut["batch_stats"]})
    for k in ("running_mean", "running_var"):
        assert_rel(getattr(port, k).numpy(), new[k].numpy(), 1e-5, k)
    with torch.no_grad():
        y_eval = port.eval()(torch.from_numpy(x))
    y_j_eval = ref.apply({"params": v["params"],
                          "batch_stats": mut["batch_stats"]},
                         jnp.asarray(x), use_running_average=True)
    assert_rel(y_eval.numpy(), y_j_eval, 1e-5, "eval after the update")


def _jit_eval(jmod, v, x):
    """JAX's eval-mode output of ``jmod`` on ``x`` as one program."""
    return np.asarray(jax.jit(lambda vv, xx: jmod.apply(vv, xx, train=False))(
        v, jnp.asarray(x)))


def _jit_init(jmod, x):
    """JAX's eval-mode init of ``jmod`` on ``x`` as one program."""
    return jax.jit(lambda xx: jmod.init(jax.random.PRNGKey(0), xx,
                                        train=False))(jnp.asarray(x))


def _train_parity(jmod, port, v, x, out_shape, seed, jit=True):
    """One train-mode forward and backward of a JAX module and its port from
    the same variables: outputs, updated statistics, parameter and input
    gradients (the loss is <y, g> for a fixed random g).  ``jit`` compiles
    JAX's forward and backward as one program (far cheaper on the CPU than
    op by op for modules of many small ops); ``jit=False`` runs it op by
    op."""
    g = np.random.default_rng(seed).standard_normal(out_shape).astype(
        np.float32)

    def loss(params, xx):
        y, mut = jmod.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut)
    grad = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    (_, (y_j, mut)), (gp, gx) = (jax.jit(grad) if jit else grad)(
        v["params"], jnp.asarray(x))

    port.load_state_dict(convert_jax_variables(v), strict=True)
    port.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = port(xt)
    (y * torch.from_numpy(g)).sum().backward()
    assert_rel(y.detach().numpy(), y_j, MODULE_RTOL, "output")
    assert_rel(xt.grad.numpy(), gx, MODULE_RTOL, "input grad")
    want_grads = convert_jax_variables({"params": jax.device_get(gp)})
    # the bias of a conv that feeds a train-mode BatchNorm has a zero
    # gradient (both sides give rounding noise): floor the scale at 1e-2 of
    # the module's largest gradient
    floor = 1e-2 * max(np.abs(w.numpy()).max() for w in want_grads.values())
    for name, p in port.named_parameters():
        assert_rel(p.grad.numpy(), want_grads[name].numpy(), MODULE_RTOL,
                   f"grad {name}", floor)
    stats = convert_jax_variables({"batch_stats": mut["batch_stats"]})
    for name, b in port.named_buffers():
        if name in stats:
            assert_rel(b.numpy(), stats[name].numpy(), MODULE_RTOL, name)


@pytest.mark.parametrize("path", ["kernel", "dense"])
def test_dgphgcn1_train_matches_jax(path):
    """DGPHGCN1 (16 -> 32 channels, mid 8, node and edge attention) in
    train mode: the kernel path through the K1+K2 Function (JAX: the Pallas
    kernels in interpret mode), the dense path through autograd."""
    g = JGraph(layout="nturgb+d", mode="random", num_filter=3, seed=0)
    graph = dict(A_init=g.A.astype(np.float32), edge_type=g.edge_type,
                 node_type=np.array(g.node_type))
    x = np.random.default_rng(7).standard_normal((2, 8, 25, 16)).astype(
        np.float32)
    use = path == "kernel"
    jmod = JDGPHGCN1(32, use_pallas=use, pallas_interpret=True, **graph,
                     **GCN_KW)
    v = nudge(_jit_init(jmod, x), seed=8)
    port = DGPHGCN1(16, 32, **graph, **GCN_KW, use_pallas=use)
    _train_parity(jmod, port, v, x, (2, 8, 25, 32), seed=9)


@pytest.mark.parametrize("stride", [1, 2])
def test_dgmstcn_train_matches_jax(stride):
    """DGMSTCN in train mode: the branch BatchNorms see the mean joint."""
    x = np.random.default_rng(10 + stride).standard_normal(
        (2, 8, 25, 24)).astype(np.float32)
    jmod = JDGMSTCN(24, stride=stride)
    v = nudge(_jit_init(jmod, x), seed=stride)
    _train_parity(jmod, DGMSTCN(24, 24, stride=stride), v, x,
                  (2, 8 // stride, 25, 24), seed=12)


def test_dgmstcn_dropout_in_train_only():
    x = torch.randn(2, 8, 25, 24)
    m = DGMSTCN(24, 24, dropout=0.5)
    m.generator = torch.Generator().manual_seed(0)
    with torch.no_grad():
        y_eval = m.eval()(x)
        m.train()
        a = m(x)
        m.generator = torch.Generator().manual_seed(0)
        b = m(x)
    torch.testing.assert_close(a, b)            # one generator, one mask
    zero = (a == 0).float().mean().item()
    assert 0.4 < zero < 0.6
    assert (y_eval != 0).float().mean().item() > 0.99
