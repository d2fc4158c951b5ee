"""Training objectives of the reference's variant recognizers (port of
``dsgcn_tpu/core/flows.py``): the Granger-causality one, masked
pretraining (``mask_keypoints`` + ``pretrain_losses``,
recognizergcnPre.py:22-78), the readout recognizer's (``gcnr_losses``,
recognizergcnR.py:22-52) and the SMoE recognizer's
(``smoe_recognizer_losses``, RecognizerGCN_sMoE.py:22-70)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .losses import cross_entropy

NTU_NODE_TYPE = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4,
                 0, 1, 1, 2, 2)


def mask_keypoints_at(keypoint: torch.Tensor, drop: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked pretraining's joint masking (recognizergcnPre.py:29-39) at
    given joints: ``drop`` (N M, S) are the joint indices zeroed in each
    (sample, person), over every frame; then, as the reference does
    (``keypoint_mask[keypoint_mask==0]=1.0``, :39), every coordinate that
    is exactly 0, dropped or not, becomes 1.0.  Returns (masked keypoint,
    mask (N, M, T, V, 1))."""
    n, m, t, v, c = keypoint.shape
    mask = keypoint.new_ones(n * m, v)
    mask[torch.arange(n * m, device=keypoint.device)[:, None],
         drop.to(keypoint.device).long()] = 0.0
    mask = mask[:, None, :, None].expand(n * m, t, v, 1).reshape(n, m, t,
                                                                  v, 1)
    masked = keypoint * mask
    masked = torch.where(masked == 0, torch.ones_like(masked), masked)
    return masked, mask


def mask_keypoints(keypoint: torch.Tensor, ratio: float = 0.5,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mask_keypoints_at` with int(ratio V) joints of each (sample,
    person) drawn without replacement from ``generator`` (on the
    keypoint's device; JAX draws a permutation per (sample, person) from
    its key: other bits, the same law)."""
    n, m, t, v, c = keypoint.shape
    draw = torch.rand(n * m, v, generator=generator, device=keypoint.device)
    drop = draw.argsort(dim=1)[:, :int(ratio * v)]
    return mask_keypoints_at(keypoint, drop)


def pretrain_losses(neck, feats: torch.Tensor, feats_masked: torch.Tensor,
                    mask: torch.Tensor,
                    node_type: Sequence[int] = NTU_NODE_TYPE
                    ) -> Dict[str, torch.Tensor]:
    """Masked-pretraining objective (recognizergcnPre.py:52-74): a
    ``PretrainNeck``'s node-type cross entropy on the masked view plus
    its clip-level NCE between the two views."""
    node = neck.node_precost(feats_masked, node_type, mask)
    graph = neck.get_intercost(feats, feats_masked)
    return {"node_loss": node, "graph_loss": graph,
            "loss_cls": node + graph}


def smoe_recognizer_losses(cls_logits: torch.Tensor, labels: torch.Tensor,
                           important_loss: torch.Tensor, *,
                           current_epoch=0, warm_up=0, lam="gradual",
                           penalty_value: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
    """The SMoE recognizer's objective (RecognizerGCN_sMoE.py:22-70): the
    cross entropy of the ``ClsHead`` logits over the gate-combined
    feature, plus the gates' balance loss 'important_loss', plus, only
    while ``current_epoch <= warm_up``, ``lam`` times ``penalty_value``
    (``smoe_regularize`` at lam 1) as 'panelty_loss' (the reference's
    spelling); ``lam='gradual'`` ramps it as min(epoch / warm_up, 1)
    (:46-62).  'loss' is the sum."""
    losses = {"loss_cls": cross_entropy(cls_logits, labels),
              "important_loss": important_loss}
    if penalty_value is not None and current_epoch <= warm_up:
        if lam == "gradual":
            lam = min(current_epoch / max(warm_up, 1), 1.0)
        losses["panelty_loss"] = lam * penalty_value
    losses["loss"] = sum(losses.values())
    return losses


def gcnr_losses(cls_logits: torch.Tensor, labels: torch.Tensor,
                align_cost: torch.Tensor) -> Dict[str, torch.Tensor]:
    """RecognizerGCNR objective (recognizergcnR.py:22-52): cross entropy
    of the head over the neck's readout plus the neck's alignment cost
    (``get_aligncost``) as 'neck_loss'."""
    loss_cls = cross_entropy(cls_logits, labels)
    return {"loss_cls": loss_cls, "neck_loss": align_cost,
            "loss": loss_cls + align_cost}


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
