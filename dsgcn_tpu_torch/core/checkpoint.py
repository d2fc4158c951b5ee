"""Checkpoints of the port's trainer: ``torch.save`` of the model,
optimizer and scheduler states with the step and epoch, plus a JSON meta
beside each (the JAX package uses orbax, ``dsgcn_tpu/core/checkpoint.py``;
its checkpoints are not read here: JAX weights enter the port through
``utils/convert.py:convert_jax_variables``).

Layout: ``<work_dir>/ckpt/<step>.pt`` and ``<step>.json``; the latest is
the highest step, and all but the latest ``MAX_TO_KEEP`` are removed.
A model wrapped in DistributedDataParallel is saved and restored through
the module it wraps, so the state's names carry no ``module.`` prefix and
``apis.init_recognizer``, ``tools/test.py`` and ``serving.py`` load it as
they load a single-process checkpoint.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from ..parallel.train import unwrap

MAX_TO_KEEP = 5


class CheckpointManager:
    def __init__(self, work_dir: str):
        self.dir = os.path.abspath(os.path.join(work_dir, "ckpt"))
        os.makedirs(self.dir, exist_ok=True)

    def steps(self):
        return sorted(int(f[:-3]) for f in os.listdir(self.dir)
                      if f.endswith(".pt") and f[:-3].isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"{step}.pt")

    def save(self, step: int, model, opt, sched, epoch: int,
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Write step ``step`` (atomically: a temp file, then a rename) and
        drop the oldest beyond ``MAX_TO_KEEP``."""
        path = self.path(step)
        state = dict(model=unwrap(model).state_dict(),
                     optimizer=opt.state_dict(),
                     scheduler=sched.state_dict() if sched is not None
                     else None, step=step, epoch=epoch)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        with open(os.path.join(self.dir, f"{step}.json"), "w") as f:
            json.dump(dict(meta or {}, step=step, epoch=epoch), f)
        for old in self.steps()[:-MAX_TO_KEEP]:
            for suffix in (".pt", ".json"):
                p = os.path.join(self.dir, f"{old}{suffix}")
                if os.path.exists(p):
                    os.remove(p)
        return path

    def restore(self, model, opt=None, sched=None,
                step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Load checkpoint ``step`` (default: the latest) into the given
        objects; returns its meta, or None when there is none."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        elif step not in self.steps():
            raise FileNotFoundError(f"no checkpoint of step {step} in "
                                    f"{self.dir} (it has {self.steps()})")
        state = torch.load(self.path(step), map_location="cpu",
                           weights_only=True)
        unwrap(model).load_state_dict(state["model"], strict=True)
        if opt is not None:
            opt.load_state_dict(state["optimizer"])
        if sched is not None and state["scheduler"] is not None:
            sched.load_state_dict(state["scheduler"])
        meta_path = os.path.join(self.dir, f"{step}.json")
        meta = {}
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
        return dict(meta, step=state["step"], epoch=state["epoch"])
