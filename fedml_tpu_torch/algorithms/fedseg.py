"""FedSeg: federated semantic segmentation (counterpart of
``fedml_tpu/algorithms/fedseg.py``; reference
fedml_api/distributed/fedseg/FedSegAggregator.py:12-190).

FedAvg over a segmentation model: the round, the mesh round and the
captured step are FedAvg's, and the segmentation task (``core/tasks.
make_segmentation_task``) carries the confusion matrix through the same
evaluation. Only the scores differ: the Evaluator's Acc / Acc_class / mIoU
/ FWIoU (``core/tasks.segmentation_scores``), with the pixel accuracy as
``acc`` and 1 - mIoU as ``loss`` for the round loop's history. The
segmentation nets have no lane-stacked twin, so ``pack_lanes`` falls back
to the plain schedule (``FedAvgAPI._packing_hooks``).
"""

from __future__ import annotations

from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
from fedml_tpu_torch.parallel.local import finalize_metrics


class FedSegAPI(FedAvgAPI):
    """Standalone-simulation federated segmentation."""

    def evaluate_global(self) -> dict:
        sums = self.eval_sums()
        return {**finalize_metrics(sums), "confusion_total": float(sums["confusion"].sum())}


class CrossSiloFedSegAPI(CrossSiloFedAvgAPI, FedSegAPI):
    """FedSeg on the cross-silo mesh: the mesh round of
    ``CrossSiloFedAvgAPI`` (the plain weighted mean) and FedSeg's scores."""
