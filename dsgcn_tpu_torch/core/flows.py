"""Training objectives of the reference's variant recognizers (port of
``dsgcn_tpu/core/flows.py``; so far the Granger-causality one)."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .losses import cross_entropy


def gc_recognizer_losses(outputs: Sequence, logits: torch.Tensor,
                         labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The Granger-causality recognizer's objective (Recognizergcn_gc.py:
    26-52): cross entropy of the ``GCHead`` logits over the causality graph
    plus the backbone's terms.  ``outputs`` is GCGCN_component's (graph,
    prediction error, GSGL penalty, ridge penalty) or GCGCN's (prediction
    error, graph, GSGL penalty); the prediction error enters as its mean.
    Returns (total, {'loss_cls', 'predic_loss', 'panelty_loss'[,
    'ridge_loss']}) (the reference's spelling)."""
    if len(outputs) == 4:
        _, predic, panelty, ridge = outputs
        extra = {"predic_loss": torch.mean(predic), "panelty_loss": panelty,
                 "ridge_loss": ridge}
    else:
        predic, _, gsgl = outputs
        extra = {"predic_loss": torch.mean(predic), "panelty_loss": gsgl}
    ce = cross_entropy(logits, labels)
    total = ce + sum(extra.values())
    return total, {"loss_cls": ce, **extra}
