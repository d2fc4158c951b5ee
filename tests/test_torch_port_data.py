"""Port parity, host side: the graph, the config loader and the DS-GCN test
and train pipelines of ``dsgcn_tpu_torch`` must reproduce ``dsgcn_tpu``
exactly (the port keeps its own copies of these numpy-only modules)."""
import numpy as np
import pytest

from dsgcn_tpu.configs.config import Config as JConfig
from dsgcn_tpu.data import transforms as JT
from dsgcn_tpu.graph import Graph as JGraph
from dsgcn_tpu_torch.configs.config import Config
from dsgcn_tpu_torch.data import transforms as T
from dsgcn_tpu_torch.graph import Graph

CONFIG = "configs/dsgcn/ntu60_xsub_3dkp/j.py"


@pytest.mark.parametrize("kw", [
    dict(layout="nturgb+d", mode="random", num_filter=3, init_off=0.04,
         init_std=0.02, seed=0),
    dict(layout="nturgb+d", mode="spatial"),
])
def test_graph_identity(kw):
    ours, ref = Graph(**kw), JGraph(**kw)
    np.testing.assert_array_equal(ours.A, ref.A)
    assert ours.node_type == ref.node_type
    np.testing.assert_array_equal(ours.edge_type, ref.edge_type)
    np.testing.assert_array_equal(ours.edge_type_num, ref.edge_type_num)


def test_config_identity():
    assert dict(Config.fromfile(CONFIG)) == dict(JConfig.fromfile(CONFIG))


def _anno(seed=0, m=2, t=80):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((m, t, 25, 3)).astype(np.float32)
    kp[1, 50:] = 0          # second body leaves: empty frames on one body
    return dict(frame_dir="S0", label=3, keypoint=kp, total_frames=t)


@pytest.mark.parametrize("t", [80, 45])   # long and short video sampling
def test_test_pipeline_identity(t):
    """One synthetic NTU annotation through the config's 10-clip test
    pipeline; tolerance 1e-5 (the JAX pipeline may pre-normalize in its
    native C++ op)."""
    pipe = Config.fromfile(CONFIG)["data"]["test"]["pipeline"]
    ours = T.build_pipeline(pipe)(_anno(t=t))
    ref = JT.build_pipeline(pipe)(_anno(t=t))
    assert sorted(ours) == sorted(ref) == ["keypoint", "label"]
    assert ours["keypoint"].shape == (10, 2, 60, 25, 3)
    assert ours["keypoint"].dtype == ref["keypoint"].dtype == np.float32
    np.testing.assert_allclose(ours["keypoint"], ref["keypoint"],
                               rtol=1e-5, atol=1e-5)
    assert ours["label"] == ref["label"]


def test_unported_transforms_raise():
    """A transform that is not in the registry raises (every one of JAX's
    registry is ported: test_torch_port_video_data); ``Causalmetrix`` is
    ported: built from its config dict it zeroes the entries JAX's zeroes
    (more in test_torch_port_necks), and ``FormatShape`` builds."""
    causal = np.random.default_rng(3).random((25, 25))
    got = T.build_pipeline([dict(type="Causalmetrix", thr=60)])(
        dict(causal=causal.copy()))["causal"]
    want = JT.Causalmetrix(thr=60)(dict(causal=causal.copy()))["causal"]
    np.testing.assert_array_equal(got, want)
    T.build_pipeline([dict(type="FormatShape", input_format="NCTHW")])
    with pytest.raises(NotImplementedError):
        T.build_pipeline([dict(type="FormatShapes", input_format="NCTHW")])


@pytest.mark.parametrize("c", [3, 2])
def test_random_rot_identity(c):
    """RandomRot draws the same angles from the same RandomState and
    rotates the same way (exact: the same numpy arithmetic)."""
    kp = np.random.default_rng(c).standard_normal((2, 20, 25, c)).astype(
        np.float32)
    ours = T.RandomRot(theta=0.2)(dict(keypoint=kp.copy()),
                                  rng=np.random.RandomState(7))
    ref = JT.RandomRot(theta=0.2)(dict(keypoint=kp.copy()),
                                  rng=np.random.RandomState(7))
    np.testing.assert_array_equal(ours["keypoint"], ref["keypoint"])


@pytest.mark.parametrize("t", [80, 45])
def test_train_pipeline_identity(t):
    """The config's train pipeline (RandomRot, random clip sampling) from one
    RandomState: tolerance 1e-5 as for the test pipeline."""
    pipe = Config.fromfile(CONFIG)["data"]["train"]["pipeline"]
    ours = T.build_pipeline(pipe)(_anno(t=t), rng=np.random.RandomState(3))
    ref = JT.build_pipeline(pipe)(_anno(t=t), rng=np.random.RandomState(3))
    assert ours["keypoint"].shape == (1, 2, 60, 25, 3)
    np.testing.assert_allclose(ours["keypoint"], ref["keypoint"],
                               rtol=1e-5, atol=1e-5)
