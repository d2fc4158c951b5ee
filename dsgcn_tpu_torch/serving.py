"""Model export and serving (port of ``dsgcn_tpu/serving.py``).

Exports the eval forward of a recognizer with ``torch.export``: the
weights travel inside the program and the port's kernels are the custom
ops ``dsgcn::*`` (``ops/kernels``), so the artifact loads and runs without
model code, config or checkpoint.  Artifacts are directories::

    <path>/manifest.json        input spec, classes, clip averaging, torch
                                version, device, parameter count
    <path>/module.pt2           the program with a dynamic batch dimension
    <path>/module_b<N>.pt2      one program per batch size, written only
                                where the dynamic-batch export fails on the
                                batch dimension

``load_exported`` returns a :class:`ServedRecognizer`, whose ``logits``
runs the loaded program and whose ``predict`` averages a sample's clips
as the reference does (recognizers/base.py:93-116).  Loading imports
torch, numpy and the kernels' op registrations, nothing of the models,
configs or data.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

_MANIFEST = "manifest.json"
_POLY = "module.pt2"


def _is_batch_specialised(err: Exception) -> bool:
    """Whether ``torch.export`` failed because the model does not trace with
    a dynamic batch (a guard on the batch size), not for any other
    reason."""
    from torch._dynamo.exc import UserError, UserErrorType
    from torch.fx.experimental.symbolic_shapes import ConstraintViolationError
    if isinstance(err, ConstraintViolationError):
        return True
    return (isinstance(err, UserError)
            and err.error_type == UserErrorType.CONSTRAINT_VIOLATION)


def _export(model, example, dynamic: bool):
    shapes = ({0: torch.export.Dim("batch", min=1)},) if dynamic else None
    with torch.no_grad():
        return torch.export.export(model, (example,), dynamic_shapes=shapes)


def export_recognizer(model: torch.nn.Module, path: str, *,
                      sample_shape: Tuple[int, ...] = (2, 100, 25, 3),
                      batch_sizes: Sequence[int] = (1, 16),
                      polymorphic: bool = True, average_clips: str = "prob",
                      num_classes: Optional[int] = None,
                      serve_dtype: str = "float32") -> Dict:
    """Export ``model``'s eval forward to ``path`` on the device its
    weights are on; returns the manifest.

    ``sample_shape`` is one sample's input shape without the batch axis,
    (M, T, V, C).  With ``polymorphic`` the batch axis is a
    ``torch.export.Dim`` (traced at a batch of 2) and one program serves
    every batch; if that export fails on the batch dimension, one program
    per entry of ``batch_sizes`` is written instead (the manifest's
    ``polymorphic_batch`` says which).  ``serve_dtype='bfloat16'`` exports
    ``apis.to_bf16_inference(model)``: bf16 weights and activations,
    float32 input and logits.
    """
    if serve_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"serve_dtype {serve_dtype!r}")
    if serve_dtype == "bfloat16":
        from .apis import to_bf16_inference
        model = to_bf16_inference(model)
    model = model.eval()
    dev = next(model.parameters()).device
    os.makedirs(path, exist_ok=True)

    def example(n):
        return torch.zeros((n, *sample_shape), device=dev)

    programs = {}
    if polymorphic:
        try:
            programs[_POLY] = _export(model, example(2), dynamic=True)
        except Exception as err:  # noqa: BLE001 (re-raised unless a guard)
            if not _is_batch_specialised(err):
                raise
    if not programs:
        for n in map(int, batch_sizes):
            programs[f"module_b{n}.pt2"] = _export(model, example(n),
                                                   dynamic=False)
    for fname, program in programs.items():
        torch.export.save(program, os.path.join(path, fname))
    # the logits' shape from the program's output node, without running it
    out = next(iter(programs.values())).graph.output_node().args[0][0]
    out_shape = [int(d) for d in out.meta["val"].shape[1:]]
    poly = _POLY in programs
    manifest = {
        "format": "torch.export",
        "torch_version": torch.__version__,
        "device": dev.type,
        "sample_shape": list(sample_shape),
        "input_dtype": "float32",
        "serve_dtype": serve_dtype,
        "polymorphic_batch": poly,
        "batch_sizes": None if poly else [int(n) for n in batch_sizes],
        "out_shape": [None, *out_shape],
        "num_classes": int(num_classes if num_classes is not None
                           else out_shape[-1]),
        "average_clips": average_clips,
        "num_params": int(sum(p.numel() for p in model.parameters())),
        "modules": sorted(programs),
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class ServedRecognizer:
    """A loaded exported recognizer, on the device its manifest names
    (raises where that is ``cuda`` and no GPU is present)."""

    def __init__(self, path: str):
        from .ops.kernels import wrappers
        with open(os.path.join(path, _MANIFEST)) as f:
            self.manifest = json.load(f)
        self.device = torch.device(self.manifest["device"])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path} was exported for CUDA and no CUDA "
                               "device is available")
        wrappers()                  # registers the dsgcn:: ops
        self._fns = {}
        for fname in self.manifest["modules"]:
            program = torch.export.load(os.path.join(path, fname))
            key = (None if fname == _POLY
                   else int(fname[len("module_b"):-len(".pt2")]))
            self._fns[key] = program.module()

    @torch.no_grad()
    def _run(self, key, x: torch.Tensor) -> torch.Tensor:
        return self._fns[key](x).float()

    def logits(self, x) -> np.ndarray:
        """x: (N, *sample_shape) float32 -> (N, num_classes)."""
        x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        n = x.shape[0]
        if None in self._fns or n in self._fns:
            return self._run(None if None in self._fns else n,
                             x).cpu().numpy()
        # pad to the smallest exported batch that fits, or tile the largest
        sizes = sorted(self._fns)
        fit = [s for s in sizes if s >= n]
        if fit:
            xp = torch.cat([x, x.new_zeros((fit[0] - n, *x.shape[1:]))])
            return self._run(fit[0], xp)[:n].cpu().numpy()
        s = sizes[-1]
        return np.concatenate([self.logits(x[i:i + s].cpu().numpy())
                               for i in range(0, n, s)])

    def predict(self, clips, average_clips: Optional[str] = None
                ) -> np.ndarray:
        """clips: (nc, *sample_shape), one sample's test clips -> (classes,)
        averaged scores (reference recognizers/base.py:113-116)."""
        mode = average_clips or self.manifest["average_clips"]
        lo = self.logits(clips)
        if mode == "prob":
            e = np.exp(lo - lo.max(axis=-1, keepdims=True))
            lo = e / e.sum(axis=-1, keepdims=True)
        return lo.mean(axis=0)


def load_exported(path: str) -> ServedRecognizer:
    return ServedRecognizer(path)
