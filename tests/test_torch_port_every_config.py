"""Every config file under ``configs/`` in the port.

Each reads the same with the port's ``Config.fromfile`` as with JAX's;
each that holds a model builds it with the port's ``build_model`` (full
width), and each that holds data builds its train, val and test
pipelines (those it has: the gesture config has no val split) with the
port's ``build_pipeline``: the stream configs of every
family, the model files, ``_init_/schedule.py``, PoseC3D's, the gesture
config and the synthetic ones.  After PoseC3D the port refuses none of
them.  Numpy and torch only (JAX's ``configs/config.py`` imports no JAX).
"""
import pathlib

import pytest
import torch

from dsgcn_tpu.configs.config import Config as JConfig
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.data.transforms import build_pipeline
from dsgcn_tpu_torch.models.builder import build_model

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO))
                 for p in (REPO / "configs").rglob("*.py"))


def test_every_config_on_disk_is_held():
    """Every family's directory is here, and the files that hold data
    include PoseC3D's, the gesture config and the synthetic ones."""
    tops = {p.split("/")[1] for p in CONFIGS}
    assert tops == {"_init_", "aagcn", "ctrgcn", "dsgcn", "gesture",
                    "posec3d", "stgcn", "stgcnpp", "synthetic"}
    assert len(CONFIGS) >= 190
    for path in ("configs/posec3d/slowonly_ntu60_xsub.py",
                 "configs/gesture/stgcnpp_hand.py",
                 "configs/synthetic/smoke.py"):
        assert path in CONFIGS and "data" in Config.fromfile(
            str(REPO / path))


@pytest.mark.parametrize("path", CONFIGS)
def test_config_reads_as_jax_and_builds(path):
    cfg = Config.fromfile(str(REPO / path))
    jcfg = JConfig.fromfile(str(REPO / path))
    assert sorted(cfg) == sorted(jcfg)
    for key in jcfg:
        assert cfg[key] == jcfg[key], key
    if "model" in cfg:
        model = build_model(cfg["model"])
        assert sum(p.numel() for p in model.parameters()) > 0
        assert all(p.dtype == torch.float32 for p in model.parameters())
    if "data" in cfg:
        data = cfg["data"]
        assert "train" in data and "test" in data
        for split in ("train", "val", "test"):
            if split in data:
                d = data[split]
                build_pipeline(d.get("dataset", d)["pipeline"])
