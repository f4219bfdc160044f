"""Cohort scheduling for cross-device rounds (counterpart of
``fedml_tpu/data/sched.py``; numpy only, every plan bit-equal to the JAX
package's).

A pluggable cohort-selection policy where ``sample_clients`` used to be
called:

- ``uniform``: :func:`plan_cohort` calls ``core/rng.sample_clients`` with
  the same arguments, so the default is the unscheduled draw bit for bit.
- ``speed``: draw an oversampled candidate pool uniformly (the same
  stream), keep the ``cohort`` candidates with the lowest train-ms in the
  profile snapshot. Candidates the snapshot has not seen rank at the seen
  population's median.
- ``fair``: speed packing with a fixed fraction of the cohort reserved for
  the least-participated candidates (unseen ones count as 0).

:func:`plan_cohort` is pure in ``(seed, round_idx, snapshot)``, so a
prefetcher that computes a round's plan ahead of the round gets the plan
the round would. :class:`CohortScheduler` keeps a bounded ledger of the
plans it computed, so re-requests of a round replay its plan.

The signal. The JAX package feeds the live policies from its pulse plane's
client profiler, snapshotted at round boundaries. The port has no pulse
plane, so the default ``profile_source`` returns None: ``speed`` and
``fair`` then cold-start uniform with one warning. A static snapshot
(``CohortScheduler.set_static_profile``, ``FedAvgAPI.set_cohort_profiler``),
for example :func:`snapshot_from_counts` over the population's record
counts, is the supported signal. A caller may set ``profile_source`` to any
callable that returns an object with a ``snapshot()`` method.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np

from fedml_tpu_torch.core.rng import sample_clients

log = logging.getLogger(__name__)

__all__ = ["COHORT_POLICIES", "SCHED_LAG", "CohortScheduler", "ProfileSnapshot", "plan_cohort",
           "snapshot_from_counts"]

COHORT_POLICIES = ("uniform", "speed", "fair")

#: rounds between a snapshot and the first plan allowed to use it: the plan
#: for round r reads the newest snapshot taken at or before round r - lag
SCHED_LAG = 2

#: the candidate pool of the profile-driven policies, in cohorts
OVERSAMPLE = 4

#: ``fair``: the fraction of the cohort reserved for the least-participated
#: candidates (at least one slot)
FAIR_FRACTION = 0.25


class ProfileSnapshot(NamedTuple):
    """A profile at one schedule point: ``ids`` are the seen client ids,
    ascending; the other arrays align with them."""

    ids: np.ndarray            # [n_seen] int64
    ema_train_ms: np.ndarray   # [n_seen] float32
    participation: np.ndarray  # [n_seen] int32

    @property
    def n_seen(self) -> int:
        return int(self.ids.size)


def _lookup(snap: ProfileSnapshot, pool: np.ndarray):
    """Per candidate ``(seen, ema, participation)`` against the snapshot;
    an id outside it comes back unseen, never raises."""
    idx = np.searchsorted(snap.ids, pool)
    idx_c = np.clip(idx, 0, max(snap.n_seen - 1, 0))
    seen = (idx < snap.n_seen) & (snap.ids[idx_c] == pool)
    ema = np.where(seen, snap.ema_train_ms[idx_c], np.nan)
    part = np.where(seen, snap.participation[idx_c], 0).astype(np.int64)
    return seen, ema, part


def snapshot_from_counts(counts, ms_per_record: float = 1.0,
                         participation=None) -> ProfileSnapshot:
    """A population-wide snapshot from per-client record counts: expected
    train-ms = ``counts * ms_per_record`` (every client reports its dataset
    size at registration, so this prior exists before any round ran)."""
    counts = np.asarray(counts, np.float64)
    n = counts.shape[0]
    part = (np.zeros(n, np.int32) if participation is None
            else np.asarray(participation, np.int32))
    return ProfileSnapshot(ids=np.arange(n, dtype=np.int64),
                           ema_train_ms=(counts * float(ms_per_record)).astype(np.float32),
                           participation=part)


def plan_cohort(round_idx: int, client_num_in_total: int, cohort: int, seed: int,
                policy: str = "uniform",
                snapshot: Optional[ProfileSnapshot] = None) -> np.ndarray:
    """The round's cohort (client ids, ascending like ``sample_clients``),
    pure in its arguments."""
    if policy not in COHORT_POLICIES:
        raise ValueError(f"cohort_policy must be one of {COHORT_POLICIES}, got {policy!r}")
    if (policy == "uniform" or snapshot is None or snapshot.n_seen == 0
            or cohort >= client_num_in_total):
        return sample_clients(round_idx, client_num_in_total, cohort, seed=seed)
    pool = sample_clients(round_idx, client_num_in_total,
                          min(client_num_in_total, cohort * OVERSAMPLE), seed=seed)
    seen, ema, part = _lookup(snapshot, pool)
    fill = float(np.median(snapshot.ema_train_ms))
    key = np.where(seen, ema, np.float32(fill))
    if policy == "speed":
        pick = pool[np.argsort(key, kind="stable")[:cohort]]
    else:  # fair
        reserve = max(1, int(round(FAIR_FRACTION * cohort)))
        reserved = np.argsort(part, kind="stable")[:reserve]
        taken = np.zeros(pool.size, bool)
        taken[reserved] = True
        by_speed = np.argsort(key, kind="stable")
        rest = by_speed[~taken[by_speed]][: cohort - reserve]
        pick = pool[np.concatenate([reserved, rest])]
    return np.sort(pick).astype(np.int64)


class CohortScheduler:
    """Snapshots at round boundaries and the plan ledger around
    :func:`plan_cohort`. Thread-safe: the prefetcher's builds and the
    consuming round may both ask for plans."""

    #: ledger bound (least recently used plans leave first)
    LEDGER_CAP = 4096

    def __init__(self, policy: str, seed: int, client_num_in_total: int, cohort: int,
                 profile_source: Optional[Callable] = None, lag: int = SCHED_LAG):
        if policy not in COHORT_POLICIES:
            raise ValueError(f"cohort_policy must be one of {COHORT_POLICIES}, got {policy!r}")
        self.policy = policy
        self.seed = int(seed)
        self.client_num_in_total = int(client_num_in_total)
        self.cohort = int(cohort)
        self.lag = int(lag)
        #: () -> a profiler with ``snapshot()``, or None (no live signal)
        self.profile_source = profile_source or _no_profiler
        self._lock = threading.Lock()
        self._plans: dict[int, np.ndarray] = {}
        self._snaps: list[tuple[int, ProfileSnapshot]] = []
        self._static: Optional[ProfileSnapshot] = None
        self._warned_no_signal = False

    @property
    def wants_notify(self) -> bool:
        """Whether the consumer should call :meth:`notify_round_done`: only
        a live-fed profile policy needs boundary snapshots."""
        with self._lock:
            return self.policy != "uniform" and self._static is None

    def set_static_profile(self, source) -> None:
        """Freeze the signal: ``source`` is a ProfileSnapshot or a profiler
        (snapshotted once, now); every plan then derives from it. None
        clears it."""
        snap = (None if source is None else source if isinstance(source, ProfileSnapshot)
                else source.snapshot())
        with self._lock:
            self._static = snap
            self._plans.clear()

    def notify_round_done(self, round_idx: int) -> None:
        """Round boundary: take the live profiler's snapshot, labelled
        ``round_idx`` (a no-op for uniform and static modes)."""
        if not self.wants_notify:
            return
        profiler = self.profile_source()
        if profiler is None:
            return
        snap = profiler.snapshot()
        with self._lock:
            if self._snaps and self._snaps[-1][0] >= round_idx:
                return          # revisited rounds keep the store monotone
            self._snaps.append((int(round_idx), snap))
            del self._snaps[:-max(self.lag + 6, 8)]

    def _snapshot_for(self, round_idx: int) -> Optional[ProfileSnapshot]:
        if self._static is not None:
            return self._static
        best = None
        for r, snap in self._snaps:
            if r <= round_idx - self.lag:
                best = snap
            else:
                break
        return best

    def sample(self, round_idx: int) -> np.ndarray:
        """The round's cohort, from the ledger when it was planned before."""
        r = int(round_idx)
        with self._lock:
            plan = self._plans.get(r)
            if plan is None:
                snap = self._snapshot_for(r)
                if (snap is None and self.policy != "uniform" and not self._warned_no_signal
                        and self.profile_source() is None and self._static is None):
                    log.warning("cohort_policy=%r has no profiler signal (no profile source "
                                "and no static profile); scheduling uniform cold-starts until "
                                "one appears", self.policy)
                    self._warned_no_signal = True
                plan = plan_cohort(r, self.client_num_in_total, self.cohort, self.seed,
                                   self.policy, snap)
                if len(self._plans) >= self.LEDGER_CAP:
                    self._plans.pop(next(iter(self._plans)))
                self._plans[r] = plan
            else:
                self._plans[r] = self._plans.pop(r)   # least-recently-used refresh
        return plan


def _no_profiler():
    """The default profile source: the port has no live profiler."""
    return None
