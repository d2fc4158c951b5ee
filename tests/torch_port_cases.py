"""Inputs shared by the port's kernel tests: one DS-GCN block aggregation
(K1 packaging) as numpy arrays, and K3's packaging of the same graph.  No
JAX here: the CUDA tests import it on machines without JAX."""
import numpy as np
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
