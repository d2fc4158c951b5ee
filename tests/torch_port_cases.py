"""Inputs shared by the port's tests: one DS-GCN block aggregation (K1
packaging) as numpy arrays, K3's packaging of the same graph, the kernels'
custom-op calls for ``opcheck``, seeded state dicts, and the
``one_thread`` fixture of the in-process CLI and trainer tests.  No JAX
here: the CUDA tests import it on machines without JAX."""
import numpy as np
import pytest
import torch

from dsgcn_tpu_torch.graph import Graph
from dsgcn_tpu_torch.ops.kernels.dyn_graph import edge_onehot

E = 15


def block_inputs(seed=0, N=2, T=6, V=25, K=3, Cm=8, edge=True):
    """K1-packaged inputs as numpy arrays; the edge classes are COCO's at
    V = 17, else NTU's (padded past 25 joints)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    d = dict(pre=f(N, T, V, K * Cm), x1=f(N, K, Cm, V), x2=f(N, K, Cm, V),
             A=f(K, V, V) * 0.04,
             alpha=rng.uniform(-1, 1, K).astype(np.float32),
             beta=rng.uniform(-1, 1, K).astype(np.float32))
    if edge:
        et = Graph(layout="coco" if V == 17 else "nturgb+d",
                   mode="spatial").edge_type
        sel = edge_onehot(et, E)
        if V > et.shape[0]:    # padded joints select no class
            pad = V - et.shape[0]
            sel = np.pad(sel, ((0, 0), (0, pad), (0, pad)))
        d.update(ew=f(Cm, E * Cm) * 0.3, eb=f(E * Cm) * 0.1, sel=sel)
    return d


def k3_packaging(d, K, Cm, edge_k):
    """bd_dyn_graph_agg's inputs from the K1 inputs, as DGPHGCN1 builds
    them (JAX gcn.py:1175-1187)."""
    N, T, V, _ = d["pre"].shape
    out = dict(pre2=d["pre"].reshape(N, T, V * K * Cm),
               x1t=np.ascontiguousarray(d["x1"].transpose(0, 1, 3, 2)))
    if edge_k >= 0:
        p1 = np.einsum("ncv,cf->nfv", d["x1"][:, edge_k], d["ew"]).reshape(
            N, E, Cm, V)
        p2 = np.einsum("ncv,cf->nfv", d["x2"][:, edge_k], d["ew"]).reshape(
            N, E, Cm, V)
        out.update(p1t=np.ascontiguousarray(p1.transpose(0, 1, 3, 2)),
                   p2=p2.astype(np.float32),
                   ebias=np.einsum("evw,ec->vcw", d["sel"],
                                   d["eb"].reshape(E, Cm)).astype(np.float32))
    return out


def to_torch(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


# (edge attention, V, v_real): plain, edge, edge on joints padded 25 -> 32,
# and a source mask on unpadded joints
CASES = [
    (False, 25, -1), (True, 25, -1), (True, 32, 25), (False, 25, 21)]


def opcheck_cases(device):
    """{case: (custom op, args)} of each kernel's op on ``device``, for
    ``torch.library.opcheck``: K3 plain and with edge attention on joints
    padded 25 -> 32 (v_real), K1 with edge attention, K2, K4 in channel
    groups with a source mask, K5, K6 with the down path and edge
    attention, K7 with and without the pseudo-joint and stride 2.  Shapes
    are ones the CUDA kernels take (DS-GCN's K = 3, Cm = 16; C 64)."""
    from dsgcn_tpu_torch.ops.kernels import (bd_agg, dggcn_block,
                                             dyn_graph, ms_tcn)
    K, Cm, C, Cout, edge_k = 3, 16, 64, 128, 1
    g = torch.Generator().manual_seed(0)

    def r(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(device)

    def agg(V, v_real):
        d = block_inputs(seed=V, N=2, T=4, V=V, K=K, Cm=Cm)
        t = {k: to_torch(v).to(device)
             for k, v in {**d, **k3_packaging(d, K, Cm, edge_k)}.items()}
        return t, (t["pre"], t["x1"], t["x2"], t["A"], t["alpha"],
                   t["beta"]), (t["pre2"], t["x1t"], t["x2"], t["A"],
                                t["alpha"], t["beta"])
    t, k1, k3 = agg(25, -1)
    tp, _, k3p = agg(32, 25)
    edge = (t["ew"], t["eb"], t["sel"])
    x = r(2, 4, 25, C)
    w_pre, b_pre = r(C, K * Cm, scale=C ** -0.5), r(K * Cm, scale=0.1)
    mid = C // 6
    rem = C - 5 * mid
    taps = ([r(3, cb, cb, scale=cb ** -0.5) for cb in (rem, mid, mid, mid)],
            [r(cb, scale=0.1) for cb in (rem, mid, mid, mid)])
    k7 = (x, r(C, rem + 4 * mid, scale=C ** -0.5), r(rem + 4 * mid), *taps,
          r(C, mid, scale=C ** -0.5), r(mid), r(C).abs() + 0.5, r(C),
          r(C, C, scale=C ** -0.5), r(C), r(C).abs() + 0.5, r(C))
    return {
        "k3": (bd_agg.bd_agg_op, (*k3, None, None, None, None, K, Cm, -1,
                                  E, -1)),
        "k3_edge_v_real": (bd_agg.bd_agg_op, (
            *k3p, tp["p1t"], tp["p2"], tp["sel"], tp["ebias"], K, Cm,
            edge_k, E, 25)),
        "k1": (dyn_graph.dyn_graph_agg_op, (*k1, *edge, K, Cm, edge_k, E,
                                            -1)),
        "k2": (dyn_graph.dyn_graph_agg_bwd_op, (
            *k1, *edge, r(*t["pre"].shape), K, Cm, edge_k, E)),
        "k4": (bd_agg.bd_agg_subset_op, (*k3, K, Cm, 8, 21)),
        "k5": (dyn_graph.dyn_graph_agg_eval_op, (
            x, w_pre, b_pre, t["x1"], t["x2"], t["A"], t["alpha"],
            t["beta"], K, Cm, -1)),
        "k6": (dggcn_block.dggcn_block_op, (
            x, t["x1"], t["x2"], w_pre, b_pre, t["A"], t["alpha"],
            t["beta"], r(K * Cm, Cout, scale=(K * Cm) ** -0.5), r(Cout),
            r(C, Cout, scale=C ** -0.5), r(Cout), *edge, K, Cm, edge_k, E)),
        "k7": (ms_tcn.ms_tcn_op, (*k7, None, [1, 2, 3, 4], 1)),
        "k7_coeff_stride2": (ms_tcn.ms_tcn_op, (*k7, r(25), [1, 2, 3, 4],
                                                2)),
    }


def seeded_state_dict(model, seed):
    """The model's state dict drawn from a seed: weights N(0, 1/fan_in),
    BN scales 1 + 0.1 N, variances U(0.5, 1.5), gates and coefficients
    U(-1, 1), graphs around 0.04, the rest 0.1 N."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, t in model.state_dict().items():
        leaf, shape = k.split(".")[-1], tuple(t.shape)
        n = rng.standard_normal(shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = t
            continue
        if leaf == "weight" and len(shape) > 1:
            a = n / np.sqrt(np.prod(shape[1:]))
        elif leaf == "weight":
            a = 1 + 0.1 * n
        elif leaf == "running_var":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("alpha", "beta", "add_coeff"):
            a = rng.uniform(-1, 1, shape)
        elif leaf == "A":
            a = 0.04 + 0.02 * n
        else:
            a = 0.1 * n
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd


@pytest.fixture
def one_thread():
    """One intra-op thread for the in-process CLI and trainer runs: their
    many small ops slow down tenfold and more when the test workers'
    thread pools outnumber the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
