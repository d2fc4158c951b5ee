"""pyskl checkpoint import of the port
(``dsgcn_tpu_torch/utils/torch_import.py``) against the JAX package's
(``dsgcn_tpu/utils/torch_import.py``) on the CPU.

No pyskl here: each family's pyskl-named state dict is built from seeded
arrays by the port's ``to_pyskl_state_dict``, the inverse of the name
mapping both importers read (the port's parameter names are the JAX
package's flax scopes), and must come back unchanged through
``import_state_dict``.  The port's import must load strictly into the
port's model and give JAX's logits (``import_state_dict`` + ``apply``,
jitted) within ``MODEL_TOL``; a ``torch.save``d ``.pth`` goes through
``load_torch_checkpoint``, which refuses a pickled object beyond tensors,
containers, strings and numbers unless the caller passes
``trusted=True``; the units ported later (``dghgcn``, the temporal MLPs)
import as JAX's importer reads them (their models in
``tests/test_torch_port_mlp.py``).
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu.utils.torch_import import import_state_dict as j_import
from dsgcn_tpu_torch.models.builder import build_model, model_cfg
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from dsgcn_tpu_torch.utils.torch_import import (import_state_dict,
                                                load_torch_checkpoint,
                                                to_pyskl_state_dict)
from test_torch_port_families import _eval, _x
from test_torch_port_model import MODEL_TOL, _run
from torch_port_cases import seeded_state_dict

NARROW = dict(num_stages=3, base_channels=16, inflate_stages=(3,),
              down_stages=(3,))
# the backbone's block list and the block's unit names in pyskl
ATTRS = {"ctrgcn": dict(blocks_attr="net", gcn_attr="gcn1",
                        tcn_attr="tcn1")}


def _cfgs(family):
    j, t = (f(family, num_classes=5) for f in (j_model_cfg, model_cfg))
    for c in (j, t):
        c["backbone"].update(NARROW)
        c["cls_head"]["in_channels"] = 32
    return j, t


@pytest.fixture(scope="module")
def pyskl():
    """(JAX config, port config, pyskl state dict, importer kwargs, the
    port's state dict) by family."""
    cases = {}

    def get(family):
        if family not in cases:
            jcfg, tcfg = _cfgs(family)
            sd = seeded_state_dict(build_model(tcfg), seed=len(cases))
            kw = ATTRS.get(family, {})
            cases[family] = (jcfg, tcfg, to_pyskl_state_dict(sd, **kw),
                             kw, sd)
        return cases[family]
    return get


@pytest.mark.parametrize("family", ["stgcn", "stgcn++", "aagcn", "ctrgcn",
                                    "dgstgcn", "dsgcn"])
def test_import_matches_jax(pyskl, family):
    jcfg, tcfg, sd, kw, _ = pyskl(family)
    port = build_model(tcfg)
    port.load_state_dict(import_state_dict(sd, **kw), strict=True)
    x = _x(3, 2, 2, 8, 25, 3)
    want = _eval(j_build_model(jcfg), j_import(sd, **kw), x)
    np.testing.assert_allclose(_run(port.eval(), x), want, **MODEL_TOL)


def test_load_torch_checkpoint(pyskl, tmp_path):
    """An mmcv-style ``.pth`` ({'state_dict': tensors, 'meta': ...})
    converts as its arrays do."""
    _, tcfg, sd, kw, _ = pyskl("dsgcn")
    path = tmp_path / "dsgcn.pth"
    torch.save(dict(state_dict={k: torch.from_numpy(v)
                                for k, v in sd.items()},
                    meta=dict(epoch=16)), path)
    got = load_torch_checkpoint(str(path), **kw)
    want = import_state_dict(sd, **kw)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    build_model(tcfg).load_state_dict(got, strict=True)


@pytest.mark.parametrize("family", ["stgcn", "stgcn++", "aagcn", "ctrgcn",
                                    "dgstgcn", "dsgcn"])
def test_to_pyskl_round_trip(pyskl, family):
    """``import_state_dict`` gives back the state dict that
    ``to_pyskl_state_dict`` named, array for array (num_batches_tracked
    aside, which pyskl's importer does not read)."""
    _, _, sd, kw, want = pyskl(family)
    got = import_state_dict(sd, **kw)
    want = {k: v for k, v in want.items()
            if not k.endswith("num_batches_tracked")}
    got = {k: v for k, v in got.items() if k in want}
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_load_torch_checkpoint_refuses_objects(pyskl, tmp_path):
    """A ``.pth`` that pickles an object beyond tensors, containers,
    strings and numbers is refused, naming ``trusted``; with
    ``trusted=True`` it loads as the plain file does."""
    _, _, sd, kw, _ = pyskl("dsgcn")
    path = tmp_path / "dsgcn.pth"
    torch.save(dict(state_dict={k: torch.from_numpy(v)
                                for k, v in sd.items()},
                    meta=dict(lr=Fraction(1, 10))), path)
    with pytest.raises(ValueError, match="trusted=True"):
        load_torch_checkpoint(str(path), **kw)
    got = load_torch_checkpoint(str(path), trusted=True, **kw)
    want = import_state_dict(sd, **kw)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("unit", ["dghgcn_nodeconv", "dghgcn_edge",
                                  "unitmlp"])
def test_unported_units_refused(pyskl, unit):
    """The units this test once saw refused, dghgcn (a plain per-node-type
    ``nodeconv``, or edge attention without ``conv1_se``) and a unitmlp,
    now import as JAX's importer reads them (converted), array for
    array."""
    rng = np.random.default_rng(len(unit))
    sd = dict(pyskl("dgstgcn")[2])
    blk = "backbone.gcn.1."
    if unit == "dghgcn_nodeconv":
        sd[blk + "gcn.nodeconv.weight"] = rng.standard_normal(
            (8, 4, 1, 1)).astype(np.float32)
    elif unit == "dghgcn_edge":
        sd[blk + "gcn.edge_linears.weight"] = rng.standard_normal(
            (8, 4)).astype(np.float32)
    else:
        sd = {k: v for k, v in sd.items() if not k.startswith(blk + "tcn.")}
        f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
        sd.update({blk + "tcn.conv.weight": f(4, 1, 5),
                   blk + "tcn.conv.bias": f(4),
                   blk + "tcn.conv1.weight": f(4, 4, 1, 1),
                   blk + "tcn.conv1.bias": f(4)})
    got = import_state_dict(sd)
    want = convert_jax_variables(j_import(sd))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
