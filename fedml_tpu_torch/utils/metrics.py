"""Observability: round timing, metric logging, the sweep signal and the
profiler hook (counterpart of ``fedml_tpu/utils/metrics.py``).

- :class:`RoundTimer`: per-phase wall-clock sums (train, eval) and
  rounds/s. On CUDA a phase ends on a host sync (``sync``), so the sums are
  wall time of finished work, not of dispatch.
- :class:`MetricsLogger`: the reference's wandb metric names, logged to an
  in-memory history, an optional JSONL file and wandb when it is installed
  (a warning and local logging otherwise).
- :func:`notify_sweep_complete`: the end-of-run message to a sweep
  orchestrator's FIFO (``FEDML_SWEEP_PIPE``).
- :func:`profile_trace`: a ``torch.profiler`` trace of a region written to
  a directory; a no-op when the directory is unset.
- :func:`round_stats`: the host round pipeline's stage rows as one record.
- :func:`wire_stats` / :func:`merge_wire_stats`: the counters of a wire
  middleware stack as ``wire/*`` and ``chaos/*`` keys.

The JAX package's registry and tracer views (``obs/*``) are not ported.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


class RoundTimer:
    """Per-phase seconds, ``with timer.phase("train"): ...``.

    ``sync`` (e.g. ``torch.cuda.synchronize``) runs at the end of every
    phase (unless the phase is opened with ``sync=False``) and before
    ``summary`` reads the wall clock, so queued device work is inside the
    phase that queued it."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sums: dict[str, float] = {}
        self.rounds = 0
        self._sync = sync
        self._start = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = True):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and self._sync is not None:
                self._sync()
            self.sums[name] = self.sums.get(name, 0.0) + (time.perf_counter() - t0)

    def tick_round(self):
        self.rounds += 1

    def summary(self) -> dict:
        if self._sync is not None:
            self._sync()
        wall = max(time.perf_counter() - self._start, 1e-9)
        out = {f"time/{k}_s": round(v, 4) for k, v in self.sums.items()}
        out["time/wall_s"] = round(wall, 4)
        out["rounds_per_sec"] = round(self.rounds / wall, 4) if self.rounds else 0.0
        return out


def round_stats(rows, depth: int = 0) -> dict:
    """Per-round stage timings of the host round pipeline
    (``data/pipeline.CohortPrefetcher``) as one record.

    Each row is one executed round: ``materialize_ms`` (the cohort built and
    cast on the host), ``h2d_ms`` (host to device), ``compute_ms`` (the
    round's training call), ``wait_ms`` (how long the consumer blocked on
    the round's inputs: the exposed part of the host stages; the serial path
    records wait = materialize + h2d). ``overlap_frac`` is the share of the
    host stages hidden behind compute, ``1 - wait / (materialize + h2d)``:
    0 on the serial path."""
    rows = list(rows)
    keys = ("materialize_ms", "h2d_ms", "compute_ms", "wait_ms")
    if not rows:
        return {"rounds": 0, "pipeline_depth": int(depth), "overlap_frac": 0.0,
                **{k: 0.0 for k in keys}}
    tot = {k: float(sum(r.get(k, 0.0) for r in rows)) for k in keys}
    host = tot["materialize_ms"] + tot["h2d_ms"]
    overlap = max(0.0, 1.0 - tot["wait_ms"] / host) if host > 0 else 0.0
    out = {k: round(tot[k] / len(rows), 3) for k in keys}
    out["rounds"] = len(rows)
    out["pipeline_depth"] = int(depth)
    out["overlap_frac"] = round(overlap, 4)
    return out


class MetricsLogger:
    """wandb-compatible logger: 'Train/Loss', 'Test/Acc', 'Test/Loss' keyed
    by 'round' (reference fedavg_api.py:173-179). A context manager (the
    JSONL file is closed even when the run raises)."""

    def __init__(self, run_name: str = "fedml_tpu", enable_wandb: bool = False,
                 jsonl_path: Optional[str] = None, config: Optional[dict] = None):
        self.history: list[dict] = []
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._wandb = None
        if enable_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=run_name, config=config or {})
            except ImportError:
                log.warning("wandb requested but not installed; logging locally only")

    def log(self, metrics: dict, round_idx: Optional[int] = None):
        rec = dict(metrics)
        if round_idx is not None:
            rec["round"] = round_idx
        self.history.append(rec)
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._wandb:
            self._wandb.log(rec)
        log.info("metrics %s", rec)

    def last(self, key: str):
        for rec in reversed(self.history):
            if key in rec:
                return rec[key]
        return None

    def series(self, key: str) -> list:
        return [r[key] for r in self.history if key in r]

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._wandb:
            self._wandb.finish()
            self._wandb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def notify_sweep_complete(pipe_path: Optional[str] = None) -> bool:
    """Tell a sweep orchestrator this run finished (reference
    fedavg/utils.py:19-26): write 'training is finished!' to the FIFO named
    by ``pipe_path`` or ``FEDML_SWEEP_PIPE``. A no-op when neither is set or
    the FIFO has no reader; never blocks. Returns whether it wrote."""
    import errno
    import os

    path = pipe_path or os.environ.get("FEDML_SWEEP_PIPE")
    if not path:
        return False
    try:
        fd = os.open(path, os.O_WRONLY | os.O_NONBLOCK)
    except OSError as e:
        if e.errno != errno.ENXIO:       # ENXIO: the FIFO exists, no reader
            log.debug("sweep pipe %s unavailable: %s", path, e)
        return False
    try:
        os.write(fd, b"training is finished!\n")
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """A ``torch.profiler`` trace of the region (CPU, and CUDA when present)
    written to ``logdir`` as a Chrome trace (``trace.json``). No-op when
    ``logdir`` is falsy."""
    if not logdir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def wire_stats(comm) -> dict:
    """The counters of a wire middleware stack, walked down its ``.inner``
    chain: each layer with a ``stats`` dict and a ``stats_prefix`` (the
    reliable layer's ``wire``, the chaos layer's ``chaos``) adds
    ``<prefix>/<counter>``. A bare transport gives {}; the reliable and
    chaos layers are ROADMAP §1 item 11b, so the edge run's summary holds
    the server's own ``wire/stale_uploads`` alone."""
    out: dict = {}
    node = comm
    while node is not None:
        prefix = getattr(node, "stats_prefix", None)
        if prefix is not None:
            for k, v in getattr(node, "stats", {}).items():
                key = f"{prefix}/{k}"
                out[key] = out.get(key, 0) + v
        node = getattr(node, "inner", None)
    return out


def merge_wire_stats(comms) -> dict:
    """Sum ``wire_stats`` over a federation's transports (one a rank)."""
    total: dict = {}
    for c in comms:
        for k, v in wire_stats(c).items():
            total[k] = total.get(k, 0) + v
    return total
