"""Import reference (pyskl) checkpoints into the port (port of
``dsgcn_tpu/utils/torch_import.py``).

Maps a pyskl ``state_dict`` (flat name -> array; key layout
``backbone.gcn.{i}.{gcn,tcn,residual}...``, ``cls_head.fc_cls``) by name
onto the JAX package's variable tree (``{'params', 'batch_stats'}`` named
after the flax scopes), which ``utils/convert.py:convert_jax_variables``
turns into the port's ``state_dict``, loaded with ``strict=True``.  The
name mapping is the JAX package's, kept here as its own copy (the port
imports nothing of ``dsgcn_tpu``).  Covers STGCN/STGCN++, AAGCN
(+aahgcn), CTRGCN (+ctrhgcn) and DGSTGCN with ``dggcn``, ``dghgcn`` and
``dgphgcn1``, and every temporal unit (``unit_tcn``, ``mstcn``,
``dgmstcn``, CTR-GCN's MSTCN and the author's temporal MLPs ``unitmlp``,
``msmlp`` and ``dgmsmlp``; like JAX's, it reads no ``gcmlp``, which has no
transform stage).  ``to_pyskl_state_dict`` is the inverse: the port's
``state_dict`` under pyskl's names.
"""
from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .convert import convert_jax_variables

Arrays = Mapping[str, np.ndarray]


class _Scope:
    """View of a flat name->array dict under a prefix."""

    def __init__(self, d: Arrays, prefix: str = ""):
        self.d = d
        self.prefix = prefix

    def sub(self, name: str) -> "_Scope":
        return _Scope(self.d, f"{self.prefix}{name}.")

    def __getitem__(self, name: str) -> np.ndarray:
        return np.asarray(self.d[self.prefix + name])

    def __contains__(self, name: str) -> bool:
        return (self.prefix + name) in self.d

    def has_sub(self, name: str) -> bool:
        p = f"{self.prefix}{name}."
        return any(k.startswith(p) for k in self.d)


def _dense(s: _Scope, name="") -> Dict:
    pfx = f"{name}." if name else ""
    w = s[f"{pfx}weight"]
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    out = {"kernel": w.T}
    if f"{pfx}bias" in s:
        out["bias"] = s[f"{pfx}bias"]
    return out


def _tconv(s: _Scope, name="conv") -> Dict:
    w = s[f"{name}.weight"]
    out = {"kernel": np.transpose(w, (2, 3, 1, 0))}
    if f"{name}.bias" in s:
        out["bias"] = s[f"{name}.bias"]
    return out


def _bn(s: _Scope, name="") -> Tuple[Dict, Dict]:
    pfx = f"{name}." if name else ""
    p = {"bn": {"scale": s[f"{pfx}weight"], "bias": s[f"{pfx}bias"]}}
    st = {"bn": {"mean": s[f"{pfx}running_mean"],
                 "var": s[f"{pfx}running_var"]}}
    return p, st


def _down(s: _Scope) -> Tuple[Dict, Dict]:
    """Sequential(Conv2d, BN) residual projection -> down_conv/down_bn."""
    p, st = {}, {}
    if s.has_sub("down"):
        p["down_conv"] = _dense(s, "down.0")
        p["down_bn"], st["down_bn"] = _bn(s, "down.1")
    return p, st


# ---------------------------------------------------------------------------
# GCN units
# ---------------------------------------------------------------------------

def _unit_gcn(s: _Scope) -> Tuple[Dict, Dict]:
    p = {"conv": _dense(s, "conv")}
    p["bn"], bs = _bn(s, "bn")
    st = {"bn": bs}
    for k in ("A", "PA"):
        if k in s:
            p[k] = s[k]
    dp, ds = _down(s)
    p.update(dp)
    st.update(ds)
    return p, st


def _unit_aagcn(s: _Scope) -> Tuple[Dict, Dict]:
    p, st = {}, {}
    p["bn"], st["bn"] = _bn(s, "bn")
    dp, ds = _down(s)
    p.update(dp)
    st.update(ds)
    i = 0
    while s.has_sub(f"conv_d.{i}"):
        p[f"conv_d{i}"] = _dense(s, f"conv_d.{i}")
        if s.has_sub(f"conv_a.{i}"):
            p[f"conv_a{i}"] = _dense(s, f"conv_a.{i}")
            p[f"conv_b{i}"] = _dense(s, f"conv_b.{i}")
        if s.has_sub(f"conv_edge.{i}"):
            p[f"conv_edge{i}"] = _dense(s, f"conv_edge.{i}")
        i += 1
    for k in ("A", "alpha"):
        if k in s:
            p[k] = s[k]
    if s.has_sub("conv_sa"):
        def c1d(name):
            return {"kernel": np.transpose(s[f"{name}.weight"], (2, 1, 0)),
                    "bias": s[f"{name}.bias"]}
        p["att"] = {"conv_sa": c1d("conv_sa"), "conv_ta": c1d("conv_ta"),
                    "fc1c": _dense(s, "fc1c"), "fc2c": _dense(s, "fc2c")}
    return p, st


def _ctrgc(s: _Scope) -> Dict:
    out = {f"conv{j}": _dense(s, f"conv{j}") for j in (1, 2, 3, 4)
           if s.has_sub(f"conv{j}")}
    for name in ("edge_att_conv", "nodeconv"):
        if s.has_sub(name):
            out[name] = _dense(s, name)
    if "beta" in s:
        out["beta"] = s["beta"]
    return out


def _unit_ctrgcn(s: _Scope) -> Tuple[Dict, Dict]:
    p, st = {}, {}
    p["bn"], st["bn"] = _bn(s, "bn")
    dp, ds = _down(s)
    p.update(dp)
    st.update(ds)
    i = 0
    while s.has_sub(f"convs.{i}"):
        p[f"convs{i}"] = _ctrgc(s.sub(f"convs.{i}"))
        i += 1
    for k in ("A", "alpha"):
        p[k] = s[k]
    return p, st


def _dg_gcn(s: _Scope) -> Tuple[Dict, Dict]:
    """dggcn / dghgcn / dgphgcn1 (shared naming)."""
    p, st = {}, {}
    for k in ("A", "alpha", "beta"):
        p[k] = s[k]
    p["pre_conv"] = _dense(s, "pre.0")
    p["pre_bn"], st["pre_bn"] = _bn(s, "pre.1")
    p["post_conv"] = _dense(s, "post")
    p["bn"], st["bn"] = _bn(s, "bn")
    dp, ds = _down(s)
    p.update(dp)
    st.update(ds)
    for name in ("conv1", "conv2", "conv1_se", "edge_linears",
                 "ada_linears", "nodeconv"):
        if s.has_sub(name):
            p[name] = _dense(s, name)
    if s.has_sub("nodeconv.0"):   # dgphgcn1's target_specific Sequential
        p.pop("nodeconv", None)
        p["nodeconv_conv"] = _dense(s, "nodeconv.0")
        p["nodeconv_bn"], st["nodeconv_bn"] = _bn(s, "nodeconv.1")
    if s.has_sub("edge_linears.0"):   # Sequential wrapper variant
        p["edge_linears"] = _dense(s, "edge_linears.0")
    return p, st


# ---------------------------------------------------------------------------
# TCN units
# ---------------------------------------------------------------------------

def _unit_tcn(s: _Scope) -> Tuple[Dict, Dict]:
    p = {"conv": {"conv": _tconv(s, "conv")}}
    st = {}
    if s.has_sub("bn"):
        p["bn"], st["bn"] = _bn(s, "bn")
    return p, st


def _unitmlp(s: _Scope) -> Tuple[Dict, Dict]:
    """unitmlp: the depthwise ``Conv1d`` (C, 1, k) ``conv``, the 1x1
    ``conv1``, an optional ``bn``, and with add_tcn the k x 1 ``conv2`` and
    its gate ``alpha``."""
    w = s["conv.weight"]
    k = w.shape[-1]
    p = {"conv_kernel": np.transpose(w, (2, 1, 0)).reshape(k, 1, 1, -1),
         "conv_bias": s["conv.bias"], "conv1": _dense(s, "conv1")}
    st = {}
    if s.has_sub("bn"):
        p["bn"], st["bn"] = _bn(s, "bn")
    if s.has_sub("conv2"):
        p["conv2"] = {"conv": _tconv(s, "conv2")}
        p["alpha"] = s["alpha"]
    return p, st


def _ms_branches(s: _Scope, kind: str = "tcn") -> Tuple[Dict, Dict]:
    p, st = {}, {}
    i = 0
    while s.has_sub(f"branches.{i}"):
        br = s.sub(f"branches.{i}")
        if br.has_sub("0"):              # (1x1, BN, ReLU[, unit | maxpool])
            p[f"branch{i}_pre"] = _dense(br, "0")
            p[f"branch{i}_bn"], st[f"branch{i}_bn"] = _bn(br, "1")
            if kind == "mlp" and br.has_sub("3.conv1"):
                mp, ms = _unitmlp(br.sub("3"))
                p[f"branch{i}_mlp"] = mp
                if ms:
                    st[f"branch{i}_mlp"] = ms
            elif br.has_sub("3.conv"):
                p[f"branch{i}_tcn"] = {"conv": {"conv": _tconv(br,
                                                               "3.conv")}}
        else:                            # bare 1x1 Conv2d
            p[f"branch{i}_conv"] = {"conv": _tconv(s, f"branches.{i}")}
        i += 1
    return p, st


def _ctr_mstcn(s: _Scope) -> Tuple[Dict, Dict]:
    """CTR-GCN's MSTCN (reference msg3d_utils.py:64-142): per-branch
    Sequentials with trailing BNs and no transform after the concat."""
    p, st = {}, {}
    i = 0
    while s.has_sub(f"branches.{i}"):
        br = s.sub(f"branches.{i}")
        if br.has_sub("3.conv"):          # (1x1, BN, ReLU, unit_tcn{conv,bn})
            p[f"branch{i}_pre"] = _dense(br, "0")
            p[f"branch{i}_bn"], st[f"branch{i}_bn"] = _bn(br, "1")
            tp = {"conv": {"conv": _tconv(br, "3.conv")}}
            tp["bn"], bs = _bn(br, "3.bn")
            p[f"branch{i}_tcn"] = tp
            st[f"branch{i}_tcn"] = {"bn": bs}
        elif br.has_sub("4"):             # (1x1, BN, ReLU, maxpool, BN)
            p[f"branch{i}_pre"] = _dense(br, "0")
            p[f"branch{i}_bn"], st[f"branch{i}_bn"] = _bn(br, "1")
            p[f"branch{i}_bn2"], st[f"branch{i}_bn2"] = _bn(br, "4")
        else:                             # (strided 1x1 conv, BN)
            p[f"branch{i}_conv"] = {"conv": _tconv(br, "0")}
            p[f"branch{i}_bn"], st[f"branch{i}_bn"] = _bn(br, "1")
        i += 1
    return p, st


def _mstcn(s: _Scope, kind: str = "tcn") -> Tuple[Dict, Dict]:
    bp, bs = _ms_branches(s, kind)
    p = {"branches": bp}
    st = {"branches": bs} if bs else {}
    p["transform_bn"], st["transform_bn"] = _bn(s, "transform.0")
    p["transform_conv"] = _dense(s, "transform.2")
    p["bn"], st["bn"] = _bn(s, "bn")
    if "add_coeff" in s:
        p["add_coeff"] = s["add_coeff"]
    return p, st


# ---------------------------------------------------------------------------
# block / backbone / model
# ---------------------------------------------------------------------------

_GCN_CONVERTERS = {
    "unit_gcn": _unit_gcn,
    "unit_aagcn": _unit_aagcn,
    "unit_ctrgcn": _unit_ctrgcn,
    "dg": _dg_gcn,
}


def _detect_gcn(s: _Scope) -> str:
    if s.has_sub("pre.0"):
        return "dg"
    if s.has_sub("convs.0"):
        return "unit_ctrgcn"
    if s.has_sub("conv_d.0"):
        return "unit_aagcn"
    return "unit_gcn"


def _detect_tcn(s: _Scope) -> str:
    if s.has_sub("branches.0"):
        if any(k.endswith("conv1.weight") and ".branches." in k
               for k in s.d if k.startswith(s.prefix)):
            return "msmlp"
        return "mstcn"
    if s.has_sub("conv1"):
        return "unitmlp"
    return "unit_tcn"


def _block(s: _Scope, gcn_attr="gcn", tcn_attr="tcn") -> Tuple[Dict, Dict]:
    p, st = {}, {}
    g = s.sub(gcn_attr)
    p["gcn"], st["gcn"] = _GCN_CONVERTERS[_detect_gcn(g)](g)
    t = s.sub(tcn_attr)
    kind = _detect_tcn(t)
    if kind == "mstcn" and not t.has_sub("transform.0"):
        tp, ts = _ctr_mstcn(t)            # CTR-GCN MSTCN: no transform stage
    elif kind in ("mstcn", "msmlp"):      # msmlp and dgmsmlp
        tp, ts = _mstcn(t, "mlp" if kind == "msmlp" else "tcn")
    elif kind == "unitmlp":
        tp, ts = _unitmlp(t)
    else:
        tp, ts = _unit_tcn(t)
    p["tcn"], st["tcn"] = tp, ts
    if s.has_sub("residual"):
        rp, rs = _unit_tcn(s.sub("residual"))
        p["residual"] = {"down": rp}
        st["residual"] = {"down": rs}
    return p, st


def _variables(state_dict: Arrays, blocks_attr: str, gcn_attr: str,
               tcn_attr: str) -> Dict[str, Any]:
    """The pyskl state dict as the JAX package's variable tree."""
    # copies: torch .numpy() exports are views over live parameter memory
    sd = {k: np.array(v) for k, v in state_dict.items()}
    bb = _Scope(sd).sub("backbone")
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    if "data_bn.weight" in bb:
        params["data_bn"], stats["data_bn"] = _bn(bb, "data_bn")
    i = 0
    while bb.has_sub(f"{blocks_attr}.{i}"):
        params[f"block{i}"], stats[f"block{i}"] = _block(
            bb.sub(f"{blocks_attr}.{i}"), gcn_attr, tcn_attr)
        i += 1
    out = {"params": {"backbone": params}, "batch_stats": {"backbone": stats}}
    if "cls_head.fc_cls.weight" in sd:
        out["params"]["head"] = {"fc_cls": {
            "kernel": sd["cls_head.fc_cls.weight"].T,
            "bias": sd["cls_head.fc_cls.bias"]}}
    return out


def import_state_dict(state_dict: Arrays, blocks_attr: str = "gcn",
                      gcn_attr: str = "gcn",
                      tcn_attr: str = "tcn") -> Dict[str, torch.Tensor]:
    """pyskl RecognizerGCN state_dict (name -> array) -> the port's
    ``state_dict``, for ``load_state_dict(..., strict=True)``.

    ``blocks_attr``: the backbone's ModuleList name ('gcn' for STGCN,
    AAGCN and DGSTGCN, 'net' for CTRGCN); CTRGCN also takes
    gcn_attr='gcn1', tcn_attr='tcn1'."""
    return convert_jax_variables(_variables(state_dict, blocks_attr,
                                            gcn_attr, tcn_attr))


def load_torch_checkpoint(path: str, trusted: bool = False,
                          **kw) -> Dict[str, torch.Tensor]:
    """Read an mmcv/pyskl ``.pth`` checkpoint (its ``state_dict``, or the
    file itself where it is one) and convert it (:func:`import_state_dict`).

    The file is unpickled with ``weights_only=True``: tensors, containers,
    strings and numbers, which is what mmcv and pyskl save, and no code
    runs.  A file holding other objects raises ``ValueError`` naming the
    cause.  ``trusted=True`` unpickles it without that restriction, which
    runs whatever code the file carries: only for a file whose source you
    trust."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=not trusted)
    except pickle.UnpicklingError as err:
        raise ValueError(
            f"{path}: weights_only loading refused an object in the "
            f"checkpoint ({err}); pass trusted=True to unpickle it without "
            "restriction, which runs any code the file holds") from err
    sd = ckpt.get("state_dict", ckpt)
    return import_state_dict({k: v.numpy() for k, v in sd.items()}, **kw)


# the port's (flax-scope) names -> pyskl's, applied in order to the part of
# a key after ``backbone.block{i}.{gcn,tcn}.``
_GCN_NAMES = [(r"^down_conv\.", "down.0."), (r"^down_bn\.", "down.1."),
              (r"^pre_conv\.", "pre.0."), (r"^pre_bn\.", "pre.1."),
              (r"^post_conv\.", "post."),
              (r"^nodeconv_conv\.", "nodeconv.0."),
              (r"^nodeconv_bn\.", "nodeconv.1."),
              (r"^conv_(a|b|d|edge)(\d+)\.", r"conv_\1.\2."),
              (r"^convs(\d+)\.", r"convs.\1."), (r"^att\.", "")]
_TCN_NAMES = [(r"^branches\.branch(\d+)_mlp\.conv2\.conv\.",
               r"branches.\1.3.conv2."),
              (r"^branches\.branch(\d+)_mlp\.", r"branches.\1.3."),
              (r"^conv2\.conv\.", "conv2."),
              (r"^(branches\.)?branch(\d+)_pre\.", r"branches.\2.0."),
              (r"^(branches\.)?branch(\d+)_bn\.", r"branches.\2.1."),
              (r"^(branches\.)?branch(\d+)_bn2\.", r"branches.\2.4."),
              (r"^(branches\.)?branch(\d+)_tcn\.conv\.conv\.",
               r"branches.\2.3.conv."),
              (r"^branch(\d+)_tcn\.bn\.", r"branches.\1.3.bn."),
              (r"^branches\.branch(\d+)_conv\.conv\.", r"branches.\1."),
              (r"^branch(\d+)_conv\.conv\.", r"branches.\1.0."),
              (r"^transform_bn\.", "transform.0."),
              (r"^transform_conv\.", "transform.2."),
              (r"^conv\.conv\.", "conv.")]
_LINEAR = ("fc_cls", "fc1c", "fc2c", "edge_linears", "ada_linears")


def to_pyskl_state_dict(state_dict: Mapping[str, torch.Tensor],
                        blocks_attr: str = "gcn", gcn_attr: str = "gcn",
                        tcn_attr: str = "tcn") -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` under pyskl's names (name -> numpy array),
    the inverse of :func:`import_state_dict` with the same keywords: blocks
    in ``backbone.{blocks_attr}.{i}``, residual projections as unit_tcns,
    1x1 convs as (O, I, 1, 1) Conv2d weights, a unitmlp's depthwise conv
    as a (C, 1, k) Conv1d weight, the head as ``cls_head``;
    BatchNorm's ``num_batches_tracked`` dropped."""
    out = {}
    for key, t in state_dict.items():
        if key.endswith("num_batches_tracked"):
            continue
        a = t.detach().cpu().numpy()
        m = re.match(r"backbone\.block(\d+)\.(gcn|tcn|residual)\.(.*)", key)
        if key.startswith("head."):
            key = "cls_head." + key[5:]
        elif m:
            i, unit, rest = m.groups()
            if unit == "residual":
                rest = rest.replace("down.conv.conv.", "conv.").replace(
                    "down.bn.", "bn.")
            if unit == "tcn" and re.match(r"(branches\.branch\d+_mlp\.)?"
                                          r"conv\.weight$", rest):
                a = a[..., 0]     # a UnitMLP's depthwise Conv1d (C, 1, k)
            for pat, rep in (_GCN_NAMES if unit == "gcn" else
                             _TCN_NAMES if unit == "tcn" else []):
                rest = re.sub(pat, rep, rest)
            attr = dict(gcn=gcn_attr, tcn=tcn_attr).get(unit, unit)
            key = f"backbone.{blocks_attr}.{i}.{attr}.{rest}"
        if (key.endswith(".weight") and a.ndim == 2
                and not any(n in key for n in _LINEAR)):
            a = a[:, :, None, None]
        out[key] = np.ascontiguousarray(a)
    return out
