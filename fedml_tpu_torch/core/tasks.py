"""Task families: mask-aware loss and metric sums (counterpart of
``fedml_tpu/core/tasks.py``; classification only on the ported path).

Padded records carry mask 0 and contribute nothing to loss or metrics.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F


class Task(NamedTuple):
    """``loss`` returns a scalar; ``metrics`` returns a dict of SUMS plus
    'count' so results aggregate across batches and clients."""

    loss: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    metrics: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], dict]


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    return (values * m).sum() / torch.clamp(m.sum(), min=1.0)


def int_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy with integer labels, in f32."""
    logz = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -logz.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)


def classification_loss(logits, targets, mask) -> torch.Tensor:
    return _masked_mean(int_cross_entropy(logits, targets), mask)


def classification_metrics(logits, targets, mask) -> dict:
    m = mask.to(torch.float32)
    pred = logits.argmax(-1)
    per = int_cross_entropy(logits, targets)
    return {
        "correct": ((pred == targets.long()).to(torch.float32) * m).sum(),
        "loss_sum": (per * m).sum(),
        "count": m.sum(),
    }


classification = Task(classification_loss, classification_metrics)

TASKS: dict[str, Task] = {"classification": classification}


def get_task(name: str, class_num=None) -> Task:
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}; ported: {sorted(TASKS)}")
    return TASKS[name]
