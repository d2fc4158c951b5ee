"""The 128 committed AAGCN, CTR-GCN, ST-GCN and STGCN++ configs in the
port.

Each of ``configs/{aagcn,ctrgcn,stgcn,stgcnpp}/*/{j,b,jm,bm}.py`` reads
the same with the port's ``Config.fromfile`` as with JAX's (its model and
its train, val and test pipelines, which build in the port); for each of
the sixteen distinct model dicts, JAX's variables (``jax.eval_shape`` +
numpy) convert and load strictly into the port's ``build_model`` at full
width (the classifier's for each class count).  On the CPU (``--device
cpu``), the j stream of AAGCN and the j and b streams of CTR-GCN and
ST-GCN, narrowed to two blocks, go through the train CLI (``--test-last``)
and the test CLI, and each family's two through the fusion CLI; the fused
scores must equal the numpy sum of the two pickles exactly.  Inference
leaves a dense hrnet anno as it was.
"""
import pathlib
import pickle

import numpy as np
import pytest
import torch

from dsgcn_tpu.configs.config import Config as JConfig
from dsgcn_tpu.models.builder import build_model as j_build_model
from dsgcn_tpu_torch.apis import inference_recognizer, init_recognizer
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.data.dataset import make_synthetic_pose_dataset
from dsgcn_tpu_torch.data.transforms import build_pipeline
from dsgcn_tpu_torch.models.builder import build_model
from dsgcn_tpu_torch.tools import fuse_scores as fuse_cli
from dsgcn_tpu_torch.tools import test as test_cli
from dsgcn_tpu_torch.tools import train as train_cli
from dsgcn_tpu_torch.utils.convert import convert_jax_variables
from test_torch_port_dggcn import _variables
from torch_port_cases import one_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("aagcn", "ctrgcn", "stgcn", "stgcnpp")
CONFIGS = sorted(str(p.relative_to(REPO)) for f in FAMILIES
                 for p in (REPO / "configs" / f).glob("*/*.py"))
LAYOUTS = [(f, lay) for f in FAMILIES for lay in ("nturgb+d", "coco")]


def test_every_committed_config_is_covered():
    """Every stream config of the families on disk is held, four streams
    of eight splits each."""
    on_disk = sorted(str(p.relative_to(REPO)) for p in REPO.glob(
        "configs/*/*/*.py") if p.parts[-3] in FAMILIES)
    assert CONFIGS == on_disk and len(CONFIGS) == 128
    for family in FAMILIES:
        for split in {p.split("/")[2] for p in CONFIGS
                      if p.split("/")[1] == family}:
            assert sorted(p.split("/")[-1] for p in CONFIGS
                          if p.split("/")[1:3] == [family, split]) == [
                "b.py", "bm.py", "j.py", "jm.py"], (family, split)
    models = {repr(Config.fromfile(str(REPO / c))["model"]) for c in CONFIGS}
    assert len(models) == 16           # 4 families x 2 layouts x 60/120


def _pipelines(cfg):
    data = cfg["data"]
    train = data["train"]
    return {"train": train.get("dataset", train)["pipeline"],
            "val": data["val"]["pipeline"], "test": data["test"]["pipeline"]}


@pytest.mark.parametrize("path", CONFIGS)
def test_committed_config_reads_as_jax(path):
    cfg = Config.fromfile(str(REPO / path))
    jcfg = JConfig.fromfile(str(REPO / path))
    assert cfg["model"] == jcfg["model"]
    pipes = _pipelines(cfg)
    assert pipes == _pipelines(jcfg)
    for pipe in pipes.values():
        build_pipeline(pipe)


@pytest.mark.parametrize("family,layout", LAYOUTS)
def test_committed_models_load_jax_variables(family, layout):
    """Full width, ten blocks, the 60- and 120-class configs: every JAX
    leaf lands on one port tensor and every port tensor is filled
    (``strict=True``).  JAX's variables are drawn once, for the 60-class
    model; the 120-class model's are the same but for the classifier's,
    drawn for its shape."""
    sub = "hrnet" if layout == "coco" else "3dkp"
    cfgs = [Config.fromfile(str(REPO / "configs" / family / f"{split}_{sub}"
                                / "j.py"))["model"]
            for split in ("ntu60_xsub", "ntu120_xsub")]
    x = np.zeros((1, 2, 4, 17 if layout == "coco" else 25, 3), np.float32)
    v = _variables(j_build_model(cfgs[0]), x, seed=0)
    rng = np.random.default_rng(1)
    for cfg, classes in zip(cfgs, (60, 120)):
        assert cfg["cls_head"]["num_classes"] == classes
        head = dict(kernel=rng.standard_normal((256, classes)).astype(
            np.float32), bias=np.zeros(classes, np.float32))
        params = dict(v["params"], head=dict(fc_cls=head))
        model = build_model(cfg)
        assert model.backbone.num_blocks == 10
        model.load_state_dict(convert_jax_variables(
            dict(v, params=params)), strict=True)


def test_inference_leaves_the_hrnet_anno_as_it_was():
    """``PreNormalize2D`` normalizes keypoints in place: inference on a
    dense hrnet anno (CTR-GCN's hrnet j config, narrowed to two blocks)
    must not change the caller's anno, so the same anno twice gives the
    same answer."""
    cfg = Config.fromfile(str(REPO / "configs/ctrgcn/ntu60_xsub_hrnet/j.py"))
    cfg["model"]["backbone"].update(num_stages=2, base_channels=16)
    cfg["model"]["cls_head"]["in_channels"] = 16
    model = init_recognizer(cfg, device="cpu")
    anno = make_synthetic_pose_dataset(num_samples=1, t=40, seed=5,
                                       layout="coco")["annotations"][0]
    kp = anno["keypoint"].copy()
    first = inference_recognizer(model, anno)
    np.testing.assert_array_equal(anno["keypoint"], kp)
    assert inference_recognizer(model, anno) == first


def _printed(out, key):
    return next(line.split(": ", 1)[1] for line in out.splitlines()
                if line.startswith(f"{key}: "))


@pytest.mark.parametrize("family,streams", [("aagcn", ("j",)),
                                            ("ctrgcn", ("j", "b")),
                                            ("stgcn", ("j", "b"))])
def test_train_test_and_fuse(family, streams, tmp_path, capsys, one_thread):
    """The committed NTU j (and b) configs, narrowed to two blocks of 16
    channels and 5 classes, on a synthetic pickle: one epoch through the
    train CLI with ``--test-last``, the test CLI, then for two streams the
    fusion 1:1."""
    ann = tmp_path / "synth.pkl"
    make_synthetic_pose_dataset(num_samples=8, num_classes=5, t=40, seed=4,
                                path=str(ann))
    pkls = []
    for stream in streams:
        cfg = tmp_path / f"{stream}.py"
        cfg.write_text(
            f"_base_ = ['{REPO}/configs/{family}/ntu60_xsub_3dkp/"
            f"{stream}.py']\n"
            "model = dict(backbone=dict(num_stages=2, base_channels=16),\n"
            "             cls_head=dict(num_classes=5, in_channels=16))\n"
            "data = dict(videos_per_gpu=2, workers_per_gpu=0,\n"
            "            test_dataloader=dict(videos_per_gpu=2),\n"
            f"            train=dict(dataset=dict(ann_file='{ann}',\n"
            "                                    split='train')),\n"
            f"            val=dict(ann_file='{ann}', split='val'),\n"
            f"            test=dict(ann_file='{ann}', split='val'))\n")
        wd = str(tmp_path / f"wd_{stream}")
        trainer = train_cli.main([str(cfg), "--work-dir", wd,
                                  "--total-epochs", "1", "--device", "cpu",
                                  "--test-last"])
        assert type(trainer.model.backbone).__name__ == family.upper()
        assert trainer.val_loader is not None   # data.val: validated
        assert "final: {" in capsys.readouterr().out
        out = str(tmp_path / f"s_{stream}.pkl")
        test_cli.main([str(cfg), wd, "--out", out, "--device", "cpu"])
        assert _printed(capsys.readouterr().out, "top1_acc")
        with open(out, "rb") as f:
            d = pickle.load(f)
        assert d["scores"].shape == (2, 5)
        assert np.isfinite(d["scores"]).all()
        pkls.append(d)
    if len(pkls) < 2:
        return
    fused, labels, _ = fuse_cli.main(
        [str(tmp_path / "s_j.pkl"), str(tmp_path / "s_b.pkl"),
         "--device", "cpu"])
    np.testing.assert_array_equal(fused, pkls[0]["scores"]
                                  + pkls[1]["scores"])
    assert labels == pkls[0]["labels"]
