"""Serving export of the port (``dsgcn_tpu_torch/serving.py``,
``dsgcn_tpu_torch/tools/export.py``) and the kernels as custom ops, on the
CPU (mirrors ``tests/test_serving_export.py``).

The ``torch.export`` artifact must (a) give the live port model's logits
(rtol 2e-6, atol 1e-6) at several batch sizes, from one dynamic-batch
program or from per-batch programs with padding and tiling, (b) load
without model code, config or checkpoint, (c) average a sample's clips as
the reference does (``predict``), and (d) keep the kernels as ``dsgcn::``
op nodes: a small DS-GCN's artifact gives JAX's logits (within
``MODEL_TOL``, JAX on the CPU, variables from a seed through
``convert_jax_variables``).  ``torch.library.opcheck`` holds each of the
seven ops' schema, fake implementation and dispatch on CPU tensors.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu_torch.models.builder import (build_model, init_weights_,
                                           model_cfg)
from dsgcn_tpu_torch.serving import export_recognizer, load_exported
from dsgcn_tpu_torch.tools import export as export_cli
from test_torch_port_dggcn import _variables
from test_torch_port_families import _eval, _x
from test_torch_port_model import MODEL_TOL, _load
from torch_port_cases import one_thread, opcheck_cases  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
M, T, V, C, NCLS = 2, 12, 25, 3, 7
TIGHT = dict(rtol=2e-6, atol=1e-6)
NARROW = dict(num_stages=3, base_channels=16, inflate_stages=(3,),
              down_stages=(3,))


def _narrow(name, **kw):
    cfg = model_cfg(name, num_classes=NCLS, **kw)
    cfg["backbone"].update(NARROW)
    cfg["cls_head"]["in_channels"] = 32
    return cfg


def _live(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def small_model():
    """A narrow STGCN++ with K7 (``tcn_use_pallas``) and seeded weights."""
    cfg = _narrow("stgcn++")
    cfg["backbone"]["tcn_use_pallas"] = True
    return init_weights_(build_model(cfg),
                         torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def poly_art(small_model, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("art"))
    man = export_recognizer(small_model, out, sample_shape=(M, T, V, C),
                            num_classes=NCLS, average_clips="prob")
    return out, man


def test_export_polymorphic_roundtrip(small_model, poly_art):
    out, man = poly_art
    assert man["polymorphic_batch"] and man["batch_sizes"] is None
    assert man["format"] == "torch.export" and man["device"] == "cpu"
    assert man["torch_version"] == torch.__version__
    assert man["num_classes"] == NCLS and man["out_shape"] == [None, NCLS]
    assert man["num_params"] == sum(p.numel()
                                    for p in small_model.parameters())
    assert man["modules"] == ["module.pt2"]
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == man
    served = load_exported(out)
    for n in (1, 3, 16):
        x = _x(n, n, M, T, V, C)
        np.testing.assert_allclose(served.logits(x), _live(small_model, x),
                                   **TIGHT)


def test_export_fixed_batch_and_padding(small_model, tmp_path):
    out = str(tmp_path / "art_fixed")
    man = export_recognizer(small_model, out, sample_shape=(M, T, V, C),
                            polymorphic=False, batch_sizes=(2, 4))
    assert not man["polymorphic_batch"] and man["batch_sizes"] == [2, 4]
    assert man["modules"] == ["module_b2.pt2", "module_b4.pt2"]
    served = load_exported(out)
    for n, seed in ((3, 5), (9, 6), (2, 7)):  # pad to 4; 4 + 4 + 1 of 4
        x = _x(seed, n, M, T, V, C)
        np.testing.assert_allclose(served.logits(x), _live(small_model, x),
                                   **TIGHT)


def test_predict_multiclip_prob_and_score(small_model, poly_art):
    served = load_exported(poly_art[0])
    clips = _x(11, 4, M, T, V, C)              # one sample's 4 test clips
    lo = _live(small_model, clips)
    e = np.exp(lo - lo.max(axis=-1, keepdims=True))
    want = (e / e.sum(axis=-1, keepdims=True)).mean(axis=0)
    got = served.predict(clips)
    assert got.shape == (NCLS,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(served.predict(clips, average_clips="score"),
                               lo.mean(axis=0), rtol=1e-6, atol=1e-7)


def test_export_bf16_serving(small_model, poly_art, tmp_path):
    """bf16 weights and activations, float32 input and logits; top-1 as the
    f32 artifact's."""
    out = str(tmp_path / "art16")
    man = export_recognizer(small_model, out, sample_shape=(M, T, V, C),
                            serve_dtype="bfloat16")
    assert man["serve_dtype"] == "bfloat16" and man["input_dtype"] == "float32"
    assert next(small_model.parameters()).dtype == torch.float32
    x = _x(1, 4, M, T, V, C)
    got = load_exported(out).logits(x)
    assert got.dtype == np.float32
    want = load_exported(poly_art[0]).logits(x)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_export_cli(tmp_path, capsys, one_thread):  # noqa: F811
    """The export CLI on a committed config: the sample shape from the test
    pipeline, the manifest, a servable artifact."""
    out = str(tmp_path / "cli_art")
    export_cli.main(["configs/synthetic/export_tiny.py", "--out", out,
                     "--batch", "2", "--device", "cpu"])
    assert "polymorphic_batch: True" in capsys.readouterr().out
    served = load_exported(out)
    assert served.manifest["sample_shape"] == [2, 12, 25, 3]
    scores = served.predict(_x(3, 2, 2, 12, 25, 3))
    assert scores.shape == (served.manifest["num_classes"],) == (10,)
    assert np.isfinite(scores).all()


def test_artifact_is_standalone(small_model, poly_art):
    """In a new process, loading and running the artifact imports none of
    the port's models, configs or data, and no JAX."""
    x = _x(9, 2, M, T, V, C)
    np.save(os.path.join(poly_art[0], "x.npy"), x)
    code = (
        "import sys, numpy as np\n"
        "from dsgcn_tpu_torch.serving import load_exported\n"
        f"art = {poly_art[0]!r}\n"
        "y = load_exported(art).logits(np.load(art + '/x.npy'))\n"
        "np.save(art + '/y.npy', y)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'dsgcn_tpu') or m.startswith(('dsgcn_tpu_torch.models', "
        "'dsgcn_tpu_torch.configs', 'dsgcn_tpu_torch.data'))]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    np.testing.assert_allclose(np.load(os.path.join(poly_art[0], "y.npy")),
                               _live(small_model, x), **TIGHT)


def test_dsgcn_artifact_holds_kernel_ops_and_matches_jax(tmp_path):
    """A small DS-GCN on the kernel path (K3 and K7 as ``dsgcn::`` ops in
    the exported graph, and no cast of a tensor to the dtype it has, nor a
    metadata assert on a weight, left in it) against JAX's eval of the
    same variables."""
    jcfg = j_model_cfg("dsgcn", num_classes=NCLS)
    jcfg["backbone"].update(NARROW)
    jcfg["cls_head"]["in_channels"] = 32
    x = _x(21, 2, M, T, V, C)
    ref = j_build_model(jcfg)
    v = _variables(ref, x, seed=22)
    port = _load(build_model(_narrow("dsgcn", use_pallas=True)), v)
    out = str(tmp_path / "ds")
    man = export_recognizer(port, out, sample_shape=(M, T, V, C))
    assert man["polymorphic_batch"]
    program = torch.export.load(os.path.join(out, "module.pt2"))
    ops = {str(n.target) for n in program.graph.nodes
           if str(n.target).startswith("dsgcn.")}
    assert ops == {"dsgcn.bd_agg.default", "dsgcn.ms_tcn.default"}
    aten, inputs = torch.ops.aten, program.graph_signature.user_inputs
    assert not [n for n in program.graph.nodes if (
        n.target is aten._assert_tensor_metadata.default
        and n.args[0].name not in inputs) or (
        n.target is aten.to.dtype
        and n.args[0].meta["val"].dtype == n.args[1])]
    np.testing.assert_allclose(load_exported(out).logits(x), _eval(ref, v, x),
                               **MODEL_TOL)


@pytest.mark.parametrize("case", list(opcheck_cases("cpu")))
def test_opcheck_on_cpu(case):
    """Schema, fake implementation (shapes, dtypes, strides) and dispatch
    of each kernel's custom op on CPU tensors (its plain version)."""
    op, args = opcheck_cases("cpu")[case]
    torch.library.opcheck(op, args)
