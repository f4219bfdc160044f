"""FedBuff: asynchronous buffered aggregation with staleness-weighted folds
(counterpart of ``fedml_tpu/algorithms/fedbuff.py``; Nguyen et al.,
"Federated Learning with Buffered Asynchronous Aggregation").

The server keeps a model version, folds every accepted contribution into a
buffer as it comes, and emits a new version every ``K`` folds. A
contribution trained from version ``v`` and folded while the server is at
``V`` has staleness ``V - v`` and folds with the weight

    ``n * (1 + staleness) ** -alpha``   (``buffer_k``, ``buffer_staleness_alpha``)

so stragglers contribute, attenuated, instead of being dropped at a
deadline.

Contributions are update deltas (the client's model minus the version it
trained from): a stale full model would drag the server back, a stale delta
is the FedBuff rule. One ``core/streaming.StreamAccumulator`` holds the
running weighted sum in float64 (O(1) in K), and an emission adds its mean
to the model. With ``buffer_k`` equal to the cohort and no staleness an
emission is ``G + sum(n_i (w_i - G)) / sum(n_i)``, FedAvg's weighted mean:
the sync-equivalence pin.

Fold order (``buffer_mode``): ``arrival`` folds an upload when it lands;
``deterministic`` folds through the canonical ``(tag, worker)`` frontier
(:class:`DeterministicFrontier`), which makes the whole asynchronous
schedule (which folds share a version, every staleness and weight) a
function of the seeds, so it replays bit for bit under chaos. The
asynchronous edge protocol is ``distributed/fedbuff_edge.py``.

Trees are flat state dicts of host numpy arrays, as on the port's wire.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Optional

import numpy as np

from fedml_tpu_torch.core.streaming import StreamAccumulator

__all__ = ["DeterministicFrontier", "FedBuffBuffer", "staleness_weight"]


def staleness_weight(n: float, staleness: int, alpha: float) -> float:
    """The fold weight ``n * (1 + staleness)^-alpha``: ``alpha == 0`` turns
    the decay off; staleness 0 (or below, clamped) is never decayed."""
    s = max(int(staleness), 0)
    return float(n) * float(1 + s) ** -float(alpha)


class FedBuffBuffer:
    """The versioned staleness-weighted delta buffer (module note).
    Thread-safe; it folds in the order :meth:`fold` is called, so the
    caller owns the order (the frontier's canonical one, or arrival)."""

    def __init__(self, k: int, alpha: float = 0.5, fold_log_cap: int = 4096):
        if k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {k}")
        self.k = int(k)
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._acc = StreamAccumulator("arrival")
        #: the server's model version, bumped at every emission
        self.version = 0
        #: folds since the last emission
        self.pending = 0
        #: folds in all: the exactly-once accounting
        self.folds = 0
        self.zero_weight_folds = 0
        self.versions_emitted = 0
        #: the last ``fold_log_cap`` folds: (version at fold, staleness,
        #: weight, n)
        self.fold_log: deque = deque(maxlen=int(fold_log_cap))
        self._pending_staleness: list[int] = []

    def fold(self, delta: dict, n: float, trained_version: int) -> dict:
        """Fold one contribution's delta; returns its record (``staleness``
        against the current version, ``weight``)."""
        with self._lock:
            staleness = max(self.version - int(trained_version), 0)
            weight = staleness_weight(n, staleness, self.alpha)
            self._acc.add(self.folds, delta, weight)
            self.folds += 1
            self.pending += 1
            if weight <= 0.0:
                self.zero_weight_folds += 1
            self._pending_staleness.append(staleness)
            rec = {"version": self.version, "staleness": staleness, "weight": weight,
                   "n": float(n)}
            self.fold_log.append(rec)
            return rec

    @property
    def ready(self) -> bool:
        with self._lock:
            return self.pending >= self.k

    def emit(self, params: dict) -> tuple[dict, dict]:
        """Close the pending buffer into a new version: ``params`` plus the
        weighted mean of its deltas (an all-zero-weight buffer leaves the
        model as it is and still bumps the version). Returns ``(new params,
        the emission's record)``."""
        with self._lock:
            mean_delta = self._acc.finalize(params)
            stal = self._pending_staleness
            rec = {"version": self.version + 1, "folds": self.pending,
                   "staleness_max": max(stal, default=0),
                   "staleness_mean": round(float(np.mean(stal)), 4) if stal else 0.0}
            self._acc = StreamAccumulator("arrival")
            self.pending = 0
            self._pending_staleness = []
            self.version += 1
            self.versions_emitted += 1
        if mean_delta is not None:
            params = {k: np.asarray(v) + mean_delta[k] for k, v in params.items()}
        return params, rec

    @property
    def nbytes(self) -> int:
        """The buffer's footprint: one model-shaped float64 sum, whatever K
        and the folds."""
        return self._acc.nbytes


class DeterministicFrontier:
    """The canonical ``(tag, worker)`` fold order of deterministic mode.
    Each admitted worker has a next expected tag; the head is the least
    ``(tag, worker)`` over them. An offered contribution is held until it
    reaches the head, and :meth:`drain` yields them in canonical order.
    Ejecting a worker removes its slots and leaves everyone else's order
    as it was, so a late ejection cannot change the fold sequence. Not
    thread-safe: the server's receive loop owns it."""

    def __init__(self, workers):
        self._next: dict[int, int] = {int(w): 0 for w in workers}
        self._held: dict[tuple[int, int], Any] = {}
        self.peak_held = 0

    @property
    def admitted(self) -> set:
        return set(self._next)

    def head(self) -> Optional[tuple[int, int]]:
        """The slot the frontier waits on, or None with no worker admitted."""
        if not self._next:
            return None
        return min((t, w) for w, t in self._next.items())

    def offer(self, worker: int, tag: int, item) -> bool:
        """Hold a contribution at its slot; False for a duplicate, a folded
        slot or a worker not admitted (it must not fold)."""
        w, t = int(worker), int(tag)
        nxt = self._next.get(w)
        if nxt is None or t < nxt or (t, w) in self._held:
            return False
        self._held[(t, w)] = item
        self.peak_held = max(self.peak_held, len(self._held))
        return True

    def drain(self):
        """Yield ``(worker, tag, item)`` in canonical order while the head's
        contribution is held."""
        while True:
            head = self.head()
            if head is None or head not in self._held:
                return
            item = self._held.pop(head)
            t, w = head
            self._next[w] = t + 1
            yield w, t, item

    def eject(self, worker: int) -> None:
        """Remove a dead worker: its slots stop gating, its held ones go."""
        w = int(worker)
        self._next.pop(w, None)
        for slot in [s for s in self._held if s[1] == w]:
            self._held.pop(slot)

    def admit(self, worker: int, from_tag: int) -> None:
        """(Re-)admit a worker at ``from_tag``: the rejoin, the one event of
        deterministic mode that depends on arrival."""
        self._next[int(worker)] = int(from_tag)

    def next_tag(self, worker: int) -> Optional[int]:
        return self._next.get(int(worker))
