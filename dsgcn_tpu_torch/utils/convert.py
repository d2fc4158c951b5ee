"""JAX variables -> the port's ``state_dict``.

The port names its submodules after the JAX package's flax scopes
(``backbone.block{i}.gcn.pre_conv``, ``...tcn.branches.branch{j}_tcn.conv.conv``,
``head.fc_cls``, ...), so a conversion only rewrites leaf names and
re-orients kernels:

* ``kernel`` -> ``weight``: a dense (I, O) kernel becomes (O, I); a 1-D
  conv (k, I, O) kernel becomes (O, I, k) (``nn.Conv1d``); a conv
  (k, 1, I, O) or 2-D conv (kh, kw, I, O) kernel becomes (O, I, k, 1) or
  (O, I, kh, kw); a 3-D conv (kt, kh, kw, I, O) kernel becomes (O, I, kt,
  kh, kw) (``nn.Conv3d``; a depthwise (kt, kh, kw, 1, C) one (C, 1, kt,
  kh, kw), X3D's grouped ``nn.Conv3d``);
* the transposed time-upsampling laterals of ``RGBPoseConv3D``'s pose
  pathway (``pose_path/layer{i}_lateral/conv/kernel``, flax
  ``ConvTranspose``, (kt, 1, 1, I, O)) are recognised by that scope: the
  kernel flips in time and becomes ``nn.ConvTranspose3d``'s (I, O, kt, 1,
  1) (``models/cnns.py:_LateralConv``);
* a sparse layer's ``score`` (``dsgcn_tpu_torch/sparse/``) keeps its
  name and turns exactly as its sibling ``kernel``;
* ``UnitMLP``'s depthwise ``conv_kernel`` (k, 1, 1, C) and ``conv_bias``
  become its grouped ``Conv2d``'s ``conv.weight`` (C, 1, k, 1) and
  ``conv.bias``;
* a BatchNorm's ``<name>/bn/{scale,bias}`` params and ``<name>/bn/{mean,var}``
  statistics become ``<name>.{weight,bias,running_mean,running_var}``; so
  do a ``TorchBN``'s (flax's layout, SGN's ``joint_bn``/``motion_bn``),
  whose ``scale``, ``bias``, ``mean`` and ``var`` sit at its own scope
  (a ``ConvBN3d``'s ``TorchBN`` named ``bn`` lands on the ``ConvBN3d``);
* the ``constants`` collection (``GCComponent``'s init-time
  ``weight_norm``) becomes persistent buffers of the same name;
* every other leaf keeps its name and value: biases, ``A``, ``PA``,
  ``alpha``, ``beta``, ``add_coeff``, and the raw kernels the port holds
  in JAX's orientation (MS-G3D's ``out_conv_kernel`` (w, C, O) with
  ``out_conv_bias``; the Granger banks ``branch{i}_w``/``branch{i}_b``,
  ``follow_w``/``follow_b``, ``follow{j}_w``/``follow{j}_b``;
  ``GCComponent.weight``; the necks' prototypes ``protos``/``proto{i}``,
  ``Set2Set``'s ``w_ih``/``w_hh``/``b_ih``/``b_hh``, the cMLP's
  ``l{i}_w``/``l{i}_b`` and the SMoE gate's ``w_gate``/``w_noise``, (C, E)
  as in JAX).  Scopes such as ``stage{i}_branch{j}`` (``AssembleSparse``)
  and ``expert{i}`` (``SMoEAssembleSparse``) are module names like any
  other.

Load the result with ``model.load_state_dict(sd, strict=True)``: together
with the converter's own check that no two leaves land on one name, every
JAX leaf is then used exactly once and every port tensor is filled.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import re

import numpy as np
import torch

_BN_LEAVES = {("params", "scale"): "weight", ("params", "bias"): "bias",
              ("batch_stats", "mean"): "running_mean",
              ("batch_stats", "var"): "running_var"}
# a scale parameter and running statistics belong to a BatchNorm wherever
# they sit (a TorchBN has no inner ``bn`` scope); a bare ``bias`` keeps its
# name either way
_BARE_BN_LEAVES = {k: v for k, v in _BN_LEAVES.items()
                   if k != ("params", "bias")}
_COLLECTIONS = ("params", "batch_stats", "constants")


def _leaves(tree: Mapping[str, Any],
            prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                            Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":   # ml_dtypes bfloat16 from a JAX array
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _transposed_lateral(scope) -> bool:
    """A pose pathway's lateral: JAX's transposed (time-upsampling) conv."""
    return "pose_path" in scope and any(
        re.fullmatch(r"layer\d+_lateral", s) for s in scope)


def _convert_leaf(collection: str, path: Tuple[str, ...],
                  a: np.ndarray) -> Tuple[str, np.ndarray]:
    *scope, leaf = path
    if scope and scope[-1] == "bn" and (collection, leaf) in _BN_LEAVES:
        return ".".join(scope[:-1] + [_BN_LEAVES[collection, leaf]]), a
    if (collection, leaf) in _BARE_BN_LEAVES:
        return ".".join(scope + [_BARE_BN_LEAVES[collection, leaf]]), a
    if collection == "constants":
        return ".".join(path), a
    if collection != "params":
        raise ValueError(f"unexpected {collection} leaf {'/'.join(path)}")
    if leaf in ("conv_kernel", "conv_bias"):      # UnitMLP's depthwise conv
        scope, leaf = scope + ["conv"], leaf[5:]
        if leaf == "bias":
            return ".".join(scope + ["bias"]), a
    if leaf == "kernel" and _transposed_lateral(scope):
        a = a[::-1].transpose(3, 4, 0, 1, 2).copy()
        return ".".join(scope + ["weight"]), a
    if leaf in ("kernel", "score"):   # a sparse score turns as its kernel
        if a.ndim == 2:
            a = a.T
        elif a.ndim == 3:              # a flax 1-D conv: (k, I, O)
            a = a.transpose(2, 1, 0)
        elif a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 5:              # a flax 3-D conv: (kt, kh, kw, I, O)
            a = a.transpose(4, 3, 0, 1, 2)
        else:
            raise ValueError(f"kernel {'/'.join(path)} has rank {a.ndim}")
        return ".".join(scope + ["weight" if leaf == "kernel"
                                 else "score"]), a
    return ".".join(path), a


def convert_jax_variables(variables: Mapping[str, Any]) -> Dict[str,
                                                                torch.Tensor]:
    """Convert the JAX ``{'params', 'batch_stats', 'constants'}`` tree
    (nested dicts of numpy arrays) into the port's ``state_dict``."""
    unknown = set(variables) - set(_COLLECTIONS)
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    sd: Dict[str, torch.Tensor] = {}
    for collection in _COLLECTIONS:
        for path, leaf in _leaves(variables.get(collection, {})):
            key, a = _convert_leaf(collection, path, np.asarray(leaf))
            if key in sd:
                raise ValueError(f"two JAX leaves map to {key}")
            sd[key] = _tensor(a)
    return sd
