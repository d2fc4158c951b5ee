"""The port's test and fusion CLIs, and DS-GCN on the COCO graph (V = 17).

On the CPU (``--device cpu``): the train CLI (with ``--test-last``), then
``dsgcn_tpu_torch.tools.test`` for each of the j, b, jm and bm streams of a
2-block narrow DS-GCN derived from ``configs/dsgcn/ntu60_xsub_3dkp``, then
``dsgcn_tpu_torch.tools.fuse_scores`` at 2:2:1:1.  The fused scores must
equal 2 j + 2 b + jm + bm exactly (the same float32 products and adds), and
the printed metrics must be JAX's ``evaluate`` (numpy only) of them.

Model side: a narrow 2-block DS-GCN on the COCO graph with edge attention,
eval forward against the JAX model (variables drawn from ``jax.eval_shape``
with numpy, converted by ``convert_jax_variables``), logits within 1e-4
(``MODEL_TOL``); and the full-width COCO model's 'auto' takes 'bd' (K3) in
all ten blocks with the 15 semantic edge classes.
"""
import pathlib
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dsgcn_tpu.core.metrics import evaluate as j_evaluate
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu.models.builder import model_cfg as j_model_cfg
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
from dsgcn_tpu_torch.models.builder import build_model, model_cfg
from dsgcn_tpu_torch.ops import gcn as port_gcn
from dsgcn_tpu_torch.tools import fuse_scores as fuse_cli
from dsgcn_tpu_torch.tools import test as test_cli
from dsgcn_tpu_torch.tools import train as train_cli
from test_torch_port_dggcn import _variables
from test_torch_port_model import MODEL_TOL, _load, _run
from torch_port_cases import one_thread  # noqa: F401

STREAMS = ("j", "b", "jm", "bm")
WEIGHTS = (2.0, 2.0, 1.0, 1.0)
REPO = pathlib.Path(__file__).resolve().parents[1]
NTU = REPO / "configs" / "dsgcn" / "ntu60_xsub_3dkp"


def _narrow_cfg(tmp, stream, ann):
    """The stream's NTU config at 2 blocks of 16 channels, 5 classes, on a
    synthetic pickle (train split for training, val for val and test)."""
    path = tmp / f"{stream}.py"
    path.write_text(
        f"_base_ = ['{NTU}/{stream}.py']\n"
        "model = dict(backbone=dict(num_stages=2, base_channels=16,\n"
        "                           inflate_stages=[], down_stages=[]),\n"
        "             cls_head=dict(num_classes=5, in_channels=16))\n"
        "data = dict(videos_per_gpu=4, workers_per_gpu=2,\n"
        "            test_dataloader=dict(videos_per_gpu=2),\n"
        f"            train=dict(ann_file='{ann}', split='train'),\n"
        f"            val=dict(ann_file='{ann}', split='val'),\n"
        f"            test=dict(ann_file='{ann}', split='val'))\n")
    return str(path)


def _printed(out, key):
    return next(line.split(": ", 1)[1] for line in out.splitlines()
                if line.startswith(f"{key}: "))


def test_train_test_and_fuse_four_streams(tmp_path, capsys, one_thread):
    ann = tmp_path / "synth.pkl"
    make_synthetic_pose_dataset(num_samples=12, num_classes=5, t=40, seed=3,
                                path=str(ann))
    pkls = []
    for s in STREAMS:
        cfg = _narrow_cfg(tmp_path, s, ann)
        assert Config.fromfile(cfg)["model"]["backbone"]["num_stages"] == 2
        wd = str(tmp_path / f"wd_{s}")
        train_cli.main([cfg, "--work-dir", wd, "--total-epochs", "1",
                        "--device", "cpu", "--test-last"])
        assert "final: {" in capsys.readouterr().out
        out = str(tmp_path / f"s_{s}.pkl")
        test_cli.main([cfg, wd, "--out", out, "--device", "cpu"])
        printed = capsys.readouterr().out
        with open(out, "rb") as f:
            d = pickle.load(f)
        assert sorted(d) == ["labels", "scores"]
        assert d["scores"].shape == (3, 5) and d["scores"].dtype == np.float32
        assert isinstance(d["labels"], list) and len(d["labels"]) == 3
        np.testing.assert_allclose(d["scores"].sum(1), 1, rtol=1e-5)
        want = j_evaluate(d["scores"], d["labels"],
                          ("top_k_accuracy", "mean_class_accuracy"))
        for k, v in want.items():
            assert _printed(printed, k) == f"{float(v):.4f}"
        pkls.append(out)

    fused_out = str(tmp_path / "fused.pkl")
    fused, labels, _ = fuse_cli.main(
        pkls + ["--weights", *map(str, WEIGHTS), "--out", fused_out,
                "--device", "cpu"])
    printed = capsys.readouterr().out
    scores = []
    for p in pkls:
        with open(p, "rb") as f:
            d = pickle.load(f)
        scores.append(d["scores"])
        assert d["labels"] == labels
    want = (scores[0] * 2.0 + scores[1] * 2.0) + scores[2] + scores[3]
    np.testing.assert_array_equal(fused, want)
    with open(fused_out, "rb") as f:
        np.testing.assert_array_equal(pickle.load(f)["scores"], want)
    for k, v in j_evaluate(want, labels,
                           ("top_k_accuracy", "mean_class_accuracy")).items():
        assert _printed(printed, k) == f"{float(v):.4f}"


def test_fuse_refuses_mismatched_inputs(tmp_path):
    for name, labels in (("a", [0, 1]), ("b", [1, 0])):
        with open(tmp_path / f"{name}.pkl", "wb") as f:
            pickle.dump(dict(scores=np.eye(2, dtype=np.float32),
                             labels=labels), f)
    paths = [str(tmp_path / "a.pkl"), str(tmp_path / "b.pkl")]
    with pytest.raises(ValueError, match="order"):
        fuse_cli.fuse(paths, device="cpu")
    with pytest.raises(ValueError, match="weights"):
        fuse_cli.fuse(paths[:1], [1.0, 2.0], device="cpu")
    fused, _ = fuse_cli.fuse(paths[:1] * 2, device="cpu")
    np.testing.assert_array_equal(fused, 2 * np.eye(2))


def test_cli_needs_cuda_unless_cpu_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with open(tmp_path / "a.pkl", "wb") as f:
        pickle.dump(dict(scores=np.eye(2, dtype=np.float32), labels=[0, 1]),
                    f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fuse_cli.main([str(tmp_path / "a.pkl")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_cli.main([f"{NTU}/j.py", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_cli.main([f"{NTU}/j.py", str(tmp_path), "--feat-ext"])


# ---------------------------------------------------------------------------
# DS-GCN on the COCO graph
# ---------------------------------------------------------------------------

COCO_NARROW = dict(num_stages=2, base_channels=16, inflate_stages=(),
                   down_stages=(), gcn_ratio=0.25)


def _coco(cfg):
    cfg["backbone"]["graph_cfg"] = dict(cfg["backbone"]["graph_cfg"],
                                        layout="coco")
    return cfg


@pytest.fixture(scope="module")
def coco_case():
    x = np.random.default_rng(17).standard_normal((2, 2, 12, 17, 3)).astype(
        np.float32)
    j = _coco(j_model_cfg("dsgcn", num_classes=7))
    j["backbone"].update(COCO_NARROW, gcn_use_pallas=False)
    j["cls_head"]["in_channels"] = 16
    ref = j_build_model(j)
    v = _variables(ref, x, seed=17)
    want = np.asarray(ref.apply(v, jnp.asarray(x), train=False))
    return v, x, want


@pytest.mark.parametrize("path", ["auto", "fused", "dense"])
def test_coco_dsgcn_matches_jax(coco_case, path):
    v, x, want = coco_case
    t = _coco(model_cfg("dsgcn", num_classes=7))
    t["backbone"].update(COCO_NARROW)
    t["cls_head"]["in_channels"] = 16
    if path == "dense":
        t["backbone"]["gcn_use_pallas"] = False
    else:
        t["backbone"]["gcn_eval_kernel"] = path
    port = _load(build_model(t), v)
    assert port.backbone.block0.gcn.edge_sel.shape == (15, 17, 17)
    np.testing.assert_allclose(_run(port, x), want, **MODEL_TOL)


def test_coco_config_takes_k3_in_every_block(monkeypatch):
    """DSGCN_coco_model.py at full width: mid 8/16/32 and V * K * mid <=
    17 * 3 * 32 = 1632, so 'auto' is 'bd' in all ten blocks (JAX's rule),
    with the 15 semantic edge classes of COCO's 5 node types."""
    cfg = Config.fromfile(
        str(REPO / "configs" / "dsgcn" / "kinetics400_hrnet" / "j.py"))
    model = build_model(cfg["model"]).eval()
    calls = []
    real = port_gcn.bd_dyn_graph_agg

    def counted(*a, **kw):
        calls.append(kw["Cm"])
        return real(*a, **kw)
    monkeypatch.setattr(port_gcn, "bd_dyn_graph_agg", counted)
    with torch.no_grad():
        y = model(torch.zeros(1, 2, 4, 17, 3))
    assert y.shape == (1, 400)
    assert calls == [8] * 4 + [16] * 3 + [32] * 3
    assert all(b.gcn.E == 15 for b in (getattr(model.backbone, f"block{i}")
                                       for i in range(10)))
