"""Task families: mask-aware loss and metric sums (counterpart of
``fedml_tpu/core/tasks.py``): classification, next-word prediction,
multilabel tag prediction and semantic segmentation.

Padded records carry mask 0 and contribute nothing to loss or metrics.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
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


# next-word / next-char prediction: logits [B, T, V], targets [B, T]; the
# mask may be [B] (whole sequence) or [B, T]

def _seq_mask(mask: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    if mask.dim() < targets.dim():
        mask = mask[..., None].expand(targets.shape)
    return mask


def nwp_loss(logits, targets, mask) -> torch.Tensor:
    return classification_loss(logits, targets, _seq_mask(mask, targets))


def nwp_metrics(logits, targets, mask) -> dict:
    return classification_metrics(logits, targets, _seq_mask(mask, targets))


nwp = Task(nwp_loss, nwp_metrics)



# multilabel tag prediction: logits [B, T], float multi-hot targets [B, T]

def binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise sigmoid BCE in f32, in the stable form
    ``max(l, 0) - l*t + log1p(exp(-|l|))``."""
    l = logits.to(torch.float32)
    t = targets.to(torch.float32)
    return torch.clamp(l, min=0.0) - l * t + torch.log1p(torch.exp(-l.abs()))


def tag_loss(logits, targets, mask) -> torch.Tensor:
    return _masked_mean(binary_cross_entropy(logits, targets).sum(-1), mask)


def tag_metrics(logits, targets, mask) -> dict:
    m = mask.to(torch.float32)
    mc = m[:, None]
    pred = (torch.sigmoid(logits.to(torch.float32)) > 0.5).to(torch.float32)
    tgt = targets.to(torch.float32)
    per = binary_cross_entropy(logits, targets).sum(-1)
    return {
        "true_pos": (pred * tgt * mc).sum(),
        "false_pos": (pred * (1 - tgt) * mc).sum(),
        "false_neg": ((1 - pred) * tgt * mc).sum(),
        "loss_sum": (per * m).sum(),
        "count": m.sum(),
    }


tag_prediction = Task(tag_loss, tag_metrics)


# semantic segmentation (the FedSeg Evaluator: pixel acc, mIoU and FWIoU
# from a confusion matrix): logits [B, H, W, C], targets [B, H, W] with
# ``ignore_index`` for unlabelled pixels, the record mask [B]

def make_segmentation_task(num_classes: int, ignore_index: int = 255) -> Task:
    def valid_pixels(targets, mask):
        m = mask.reshape(mask.shape + (1,) * (targets.dim() - mask.dim()))
        return (targets != ignore_index) & (m > 0)

    def seg_loss(logits, targets, mask) -> torch.Tensor:
        valid = valid_pixels(targets, mask)
        per = int_cross_entropy(logits, torch.where(valid, targets, 0))
        return _masked_mean(per, valid)

    def seg_metrics(logits, targets, mask) -> dict:
        # counted in int64: a float count stalls at 2^24 pixels a cell;
        # invalid pixels go to one extra bin, which is dropped
        valid = valid_pixels(targets, mask)
        idx = targets.long() * num_classes + logits.argmax(-1)
        idx = torch.where(valid, idx, num_classes * num_classes).reshape(-1)
        conf = torch.bincount(idx, minlength=num_classes * num_classes + 1)
        return {"confusion": conf[:num_classes * num_classes].view(num_classes, num_classes),
                "count": valid.sum()}

    return Task(seg_loss, seg_metrics)


def segmentation_scores(confusion) -> dict:
    """Acc / Acc_class / mIoU / FWIoU of an accumulated confusion matrix
    (rows: true class, columns: prediction), on the host in float64."""
    conf = np.asarray(confusion.cpu() if torch.is_tensor(confusion) else confusion, np.float64)
    total = max(conf.sum(), 1.0)
    diag = np.diag(conf)
    rows, cols = conf.sum(axis=1), conf.sum(axis=0)
    with np.errstate(invalid="ignore"):
        acc_class = np.nanmean(np.where(rows > 0, diag / np.maximum(rows, 1.0), np.nan))
        union = rows + cols - diag
        miou = np.nanmean(np.where(union > 0, diag / np.maximum(union, 1.0), np.nan))
    fwiou = np.nansum(np.where(union > 0, rows / total * diag / np.maximum(union, 1.0), 0.0))
    return {"Acc": diag.sum() / total, "Acc_class": acc_class, "mIoU": miou, "FWIoU": fwiou}


TASKS: dict[str, Task] = {"classification": classification, "nwp": nwp,
                          "tag_prediction": tag_prediction}


def get_task(name: str, class_num: Optional[int] = None) -> Task:
    """``"segmentation"`` is built for ``class_num`` classes (its metrics
    carry a [C, C] confusion matrix); the other tasks are looked up."""
    if name == "segmentation":
        if not class_num:
            raise ValueError("segmentation task requires class_num")
        return make_segmentation_task(class_num)
    if name not in TASKS:
        raise KeyError(f"unknown task {name!r}; known: {sorted(TASKS) + ['segmentation']}")
    return TASKS[name]
