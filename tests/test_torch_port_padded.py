"""Joint-padded mode of the port (``apis.to_padded_inference``, the
backbone's ``joint_pad``, ``v_pad`` of ``DGGCN``, ``DGPHGCN1`` and
``DGMSTCN``) on the CPU (mirrors ``tests/test_joint_padded_eval.py``).

JAX pads the joints to 32 for the TPU's sublanes; the port keeps the
interface and JAX's refusals and runs at the real joints
(``ops/common.py:joint_pad_check``).  The padded model must give the
unpadded model's logits: within 2e-5 of the port's unpadded eval (the JAX
test's tolerance) and within ``MODEL_TOL`` of JAX's unpadded eval
(jitted, on the CPU), for DS-GCN (K3 and K1 with edge attention) and
DG-STGCN (K3, K1, K4, and the dense path), every block on the kernel path
calling the unpadded model's kernel at the real 25 joints.  JAX's
variables are drawn from a seed (BN statistics and gates off their
initial values) and converted with ``convert_jax_variables``.  bf16
composes; training, 'mega' and the other backbones refuse.
"""
import numpy as np
import pytest
import torch

from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu_torch.apis import to_bf16_inference, to_padded_inference
from dsgcn_tpu_torch.models.builder import build_model, model_cfg
from dsgcn_tpu_torch.ops import gcn
from test_torch_port_dggcn import _variables
from test_torch_port_families import _eval, _x
from test_torch_port_model import MODEL_TOL, _load, _run

NARROW = dict(num_stages=3, base_channels=32, inflate_stages=(3,),
              down_stages=(3,))
PAD_TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(name, **backbone):
    j, t = (f(name, num_classes=5) for f in (j_model_cfg, model_cfg))
    for c in (j, t):
        c["backbone"].update(NARROW)
        c["cls_head"]["in_channels"] = 64
    t["backbone"].update(backbone)
    return j, t


@pytest.fixture(scope="module")
def reference():
    """(JAX variables, input, JAX's unpadded logits) by family."""
    cases = {}

    def get(name):
        if name not in cases:
            jcfg, _ = _cfgs(name)
            x = _x(61, 2, 2, 8, 25, 3)
            ref = j_build_model(jcfg)
            v = _variables(ref, x, seed=62)
            cases[name] = (v, x, _eval(ref, v, x))
        return cases[name]
    return get


@pytest.mark.parametrize("name,backbone,calls", [
    ("dsgcn", {}, {"bd_dyn_graph_agg": 3}),
    ("dsgcn", dict(gcn_eval_kernel="fused"), {"fused_dyn_graph_agg": 3}),
    ("dsgcn", dict(tcn_use_pallas=True), {"bd_dyn_graph_agg": 3}),
    ("dgstgcn", {}, {"bd_dyn_graph_agg": 2, "fused_dyn_graph_agg": 1}),
    ("dgstgcn", dict(gcn_eval_kernel="bdg"), {"bd_dyn_graph_agg_subset": 3}),
    ("dgstgcn", dict(gcn_use_pallas=False), {})])
def test_padded_eval_matches_unpadded(reference, monkeypatch, name,
                                      backbone, calls):
    """Each kernel wrapper the blocks call is the unpadded model's, at the
    real joints: a (K, 25, 25) graph and no ``v_real``; the logits are the
    unpadded model's."""
    v, x, want = reference(name)
    model = _load(build_model(_cfgs(name, **backbone)[1]), v)
    unpadded = _run(model, x)
    seen = {}
    for fn in calls:
        def spy(*a, _fn=fn, _inner=getattr(gcn, fn), **kw):
            assert a[3].shape[1:] == (25, 25), a[3].shape
            assert kw.get("v_real", a[13] if len(a) > 13 else -1) == -1
            seen[_fn] = seen.get(_fn, 0) + 1
            return _inner(*a, **kw)
        monkeypatch.setattr(gcn, fn, spy)
    padded = to_padded_inference(model, v_pad=32)
    got = _run(padded, x)
    assert seen == calls
    np.testing.assert_allclose(got, unpadded, **PAD_TOL)
    np.testing.assert_allclose(got, want, **MODEL_TOL)
    # the padded model shares the weights and leaves the model as it was
    assert padded.backbone.block0.gcn.A is model.backbone.block0.gcn.A
    assert model.backbone.joint_pad == 0 and model.backbone.block0.gcn.v_pad \
        == 0 and padded.backbone.block1.tcn.v_pad == 32


@pytest.mark.parametrize("order", ["bf16_then_pad", "pad_then_bf16"])
def test_padded_composes_with_bf16(reference, order):
    """to_padded_inference and to_bf16_inference in either order: top-1 as
    the float32 unpadded model's."""
    v, x, _ = reference("dgstgcn")
    model = _load(build_model(_cfgs("dgstgcn")[1]), v)
    x = np.concatenate([x, _x(63, 2, 2, 8, 25, 3)])
    want = _run(model, x).argmax(-1)
    served = (to_padded_inference(to_bf16_inference(model))
              if order == "bf16_then_pad"
              else to_bf16_inference(to_padded_inference(model)))
    assert served.backbone.joint_pad == 32
    got = _run(served, x)
    assert got.dtype == np.float32
    assert (got.argmax(-1) == want).all()


def test_padded_refusals():
    """Training, 'mega' and the other backbones refuse joint padding; a
    DGSTGCN config may set it (the backbone's ``joint_pad``)."""
    _, tcfg = _cfgs("dsgcn")
    padded = to_padded_inference(build_model(tcfg).eval())
    x = torch.zeros(1, 2, 8, 25, 3)
    with pytest.raises(NotImplementedError, match="eval-only"):
        padded.train()(x)
    for name in ("dsgcn", "dgstgcn"):
        _, tcfg = _cfgs(name, gcn_eval_kernel="mega", joint_pad=32)
        model = build_model(tcfg).eval()
        assert model.backbone.joint_pad == 32
        with pytest.raises(ValueError, match="mega"), torch.no_grad():
            model(x)
    for name in ("stgcn++", "aagcn", "ctrgcn"):
        with pytest.raises(ValueError, match="joint_pad"):
            to_padded_inference(build_model(model_cfg(name, num_classes=5)))
    _, tcfg = _cfgs("stgcn++")
    tcfg["backbone"]["joint_pad"] = 32
    with pytest.raises(ValueError, match="joint_pad"):
        build_model(tcfg)
