"""User-facing inference API (port of ``dsgcn_tpu/apis.py``; reference
pyskl/apis/inference.py:20-184).

``init_recognizer`` builds a model from a config (and loads a checkpoint);
``inference_recognizer`` pushes one skeleton annotation dict through the
config's test pipeline and returns the top-k (label, score) list;
``to_bf16_inference`` gives the bfloat16 serving model and
``to_padded_inference`` the joint-padded one.  Models run on the CUDA
device unless the caller asks for ``device='cpu'``.
"""
from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import torch

from .configs.config import Config
from .data.transforms import build_pipeline
from .models.builder import build_model
from .models.recognizer import average_clip


def resolve_device(device=None) -> torch.device:
    """The CUDA device, unless the caller names another; raises without a
    GPU rather than falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def init_recognizer(config, checkpoint: Optional[str] = None,
                    device=None) -> torch.nn.Module:
    """Build the recognizer of ``config`` (a path or a config dict) in eval
    mode on ``device`` (default: the CUDA device; raises without one).

    ``checkpoint``: a ``torch.save``d ``state_dict`` of the port (e.g. from
    :func:`dsgcn_tpu_torch.utils.convert.convert_jax_variables`) or a
    checkpoint of the port's trainer (``<work_dir>/ckpt/<step>.pt``, one
    process's or a distributed run's), loaded strictly.  Without one the weights are the initial ones, drawn from
    torch's global generator.  The config rides on the model as ``.cfg``.
    """
    dev = resolve_device(device)
    cfg = config if isinstance(config, (dict, Config)) \
        else Config.fromfile(config)
    model = build_model(cfg["model"])
    if checkpoint is not None:
        state = torch.load(checkpoint, map_location="cpu", weights_only=True)
        if "model" in state and "optimizer" in state:
            state = state["model"]       # a checkpoint of the port's trainer
        model.load_state_dict(state, strict=True)
    model.cfg = cfg
    return model.to(dev).eval()


def to_bf16_inference(model: torch.nn.Module) -> torch.nn.Module:
    """The bfloat16 serving model: a copy whose weights are bfloat16 and
    whose input is cast to bfloat16, so every matmul and conv runs in bf16
    with float32 accumulation.  BatchNorm statistics stay float32 (they fold
    into the eval affine in float32), as in the JAX package.  A model
    without a ``compute_dtype`` (``RecognizerPoseC3D``, as in JAX, whose
    ``to_bf16_inference`` clones that field) is refused."""
    if not hasattr(model, "compute_dtype"):
        raise NotImplementedError(
            f"{type(model).__name__} has no bfloat16 serving (no "
            f"compute_dtype)")
    bf16 = copy.deepcopy(model)
    for p in bf16.parameters():
        p.data = p.data.to(torch.bfloat16)
    bf16.compute_dtype = torch.bfloat16
    return bf16


def to_padded_inference(model: torch.nn.Module,
                        v_pad: int = 32) -> torch.nn.Module:
    """Joint-padded serving (JAX ``apis.py:to_padded_inference``): a model
    whose backbone is in joint-padded mode (``joint_pad=v_pad``), with
    JAX's refusals: eval only, DGSTGCN backbones (DG-STGCN, DS-GCN) only,
    no 'mega'.  It runs at the real joints, which on the H100 is exact and
    faster than padding (``ops/common.py:joint_pad_check``).

    The returned model shares ``model``'s parameters and buffers (a new
    module tree over the same tensors); inputs stay (N, M, T, V, C) at the
    real V.  Composes with :func:`to_bf16_inference`, in either order."""
    shared = {id(t): t for t in list(model.parameters())
              + list(model.buffers())}
    padded = copy.deepcopy(model, memo=shared)
    padded.backbone.set_joint_pad(v_pad)
    return padded


@torch.inference_mode()
def inference_recognizer(model: torch.nn.Module, anno: Dict,
                         test_pipeline=None, topk: int = 5,
                         average_clips: str = "prob"
                         ) -> List[Tuple[int, float]]:
    """Run one annotation dict through the test pipeline (default: the
    model config's ``data.test.pipeline``) and the model; returns the top-k
    (label, score) pairs of the clip-averaged scores.  The pipeline gets a
    deep copy of ``anno``: ``PreNormalize2D`` normalizes the keypoints in
    place (as JAX's and pyskl's do), and the caller's anno must come back
    as it went in, so that the same anno twice gives the same answer."""
    if test_pipeline is None:
        test_pipeline = model.cfg["data"]["test"]["pipeline"]
    if not callable(test_pipeline):
        test_pipeline = build_pipeline(test_pipeline)
    results = test_pipeline(copy.deepcopy(anno))
    device = next(model.parameters()).device
    kp = torch.from_numpy(results["keypoint"]).to(device)   # (nc,M,T,V,C)
    logits = model(kp)                                      # (nc, classes)
    scores = average_clip(logits[None], average_clips)[0].cpu()
    top = torch.argsort(scores, descending=True)[:topk]
    return [(int(i), float(scores[i])) for i in top]
