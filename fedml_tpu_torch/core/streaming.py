"""Streaming server-side aggregation: fold contributions as they arrive
(counterpart of ``fedml_tpu/core/streaming.py``).

:class:`StreamAccumulator` holds one running weighted sum of model-shaped
trees (dicts of numpy arrays) and a scalar weight, in place of a
buffer of every contribution: O(1) in the cohort. Two fold orders:

- ``deterministic``: contributions fold in their canonical index order
  (the worker index on the edge); one that arrives early is held until its
  predecessors have folded (none held for in-order arrivals, at most one
  per worker; ``peak_held``). The aggregate is a function of the set of
  contributions, whatever their arrival order.
- ``arrival``: folded at once, so nothing is held; the aggregate depends on
  the arrival order through the summation order only.

The sum is float64 and divided once in :meth:`finalize`, then cast to each
leaf's dtype. A zero-weight contribution (a rejoin's catch-up, a failed
client) folds as a no-op. It serves the edge server's
``StreamingFedAVGAggregator`` (the simulation's streamed rounds fold on the
card, ``algorithms/fedavg._run_streaming_round``).
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np

from fedml_tpu_torch.core.pytree import tree_leaves, tree_map

__all__ = ["StreamAccumulator"]


class StreamAccumulator:
    """Running weighted accumulator (module note); thread-safe."""

    def __init__(self, mode: str = "deterministic"):
        if mode not in ("deterministic", "arrival"):
            raise ValueError(f"stream mode must be deterministic|arrival, got {mode!r}")
        self.mode = mode
        self._lock = threading.Lock()
        self._acc: Optional[Any] = None          # float64 leaf sums
        self._acc_w = 0.0
        self._next = 0                           # deterministic: the fold frontier
        self._held: dict[int, tuple] = {}        # deterministic: early arrivals
        self.folded = 0
        #: most contributions held at once (0 for in-order arrivals)
        self.peak_held = 0

    def _fold(self, tree, weight: float) -> None:
        if weight:
            scaled = tree_map(lambda x: np.asarray(x, np.float64) * weight, tree)
            self._acc = scaled if self._acc is None else tree_map(np.add, self._acc, scaled)
            self._acc_w += weight
        elif self._acc is None:
            # keep the tree's shape, so an all-zero-weight round still
            # finalizes to the no-op
            self._acc = tree_map(lambda x: np.zeros(np.shape(x), np.float64), tree)
        self.folded += 1

    def add(self, index: int, tree, weight: float) -> None:
        """Fold contribution ``index`` (its canonical position) with
        aggregation ``weight``."""
        weight = float(weight)
        with self._lock:
            if self.mode == "arrival":
                self._fold(tree, weight)
                return
            self._held[int(index)] = (tree, weight)
            self.peak_held = max(self.peak_held, len(self._held))
            while self._next in self._held:
                t, w = self._held.pop(self._next)
                self._fold(t, w)
                self._next += 1

    def finalize(self, template) -> Optional[Any]:
        """Close the round: fold what is still held in index order (the
        survivors of workers the deadline dropped), then return the weighted
        mean in ``template``'s leaf dtypes as numpy arrays, or None for a
        zero-weight round (the caller's no-op)."""
        with self._lock:
            for i in sorted(self._held):
                t, w = self._held.pop(i)
                self._fold(t, w)
            if self._acc is None or self._acc_w <= 0.0:
                return None
            inv = 1.0 / self._acc_w
            return tree_map(lambda a, t: (a * inv).astype(np.asarray(t).dtype), self._acc, template)

    @property
    def nbytes(self) -> int:
        """The accumulator's footprint: the float64 sum plus what is held."""
        with self._lock:
            total = sum(a.nbytes for a in tree_leaves(self._acc)) if self._acc is not None else 0
            for t, _w in self._held.values():
                total += sum(np.asarray(x).nbytes for x in tree_leaves(t))
            return int(total)
