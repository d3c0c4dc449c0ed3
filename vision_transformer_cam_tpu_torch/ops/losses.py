"""Losses.

The reference trains with the sum of two multilabel soft-margin losses, over
the cls head and the top-16 patch head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def multilabel_soft_margin_loss(logits, targets):
    """torch's F.multilabel_soft_margin_loss (reduction='mean'):

        -mean_b mean_c [ y log sigmoid(x) + (1 - y) log sigmoid(-x) ]

    computed in at least float32: bf16 log-sigmoid tails lose precision
    exactly where the gradient signal lives."""
    logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
    targets = targets.to(logits.dtype)
    per_sample = -(targets * F.logsigmoid(logits)
                   + (1.0 - targets) * F.logsigmoid(-logits)).mean(dim=-1)
    return per_sample.mean()


def dual_head_loss(logits, head1_logits, targets):
    """loss = MLSM(cls head) + MLSM(top-16 head); returns (loss, parts)."""
    l1 = multilabel_soft_margin_loss(logits, targets)
    l2 = multilabel_soft_margin_loss(head1_logits, targets)
    return l1 + l2, {"loss_cls": l1, "loss_head1": l2}
