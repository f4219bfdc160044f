"""The host round pipeline (counterpart of the round-granular half of
``fedml_tpu/data/pipeline.py``).

Cross-device rounds materialize their sampled cohort on the host every
round (the client stack is virtual, ``data/crossdevice.py``), and a round's
plan is a pure function of (seed, round index), so future rounds' cohorts
are known before the current round ends. :class:`CohortPrefetcher` keeps a
bounded number of rounds (or streamed chunks) in flight on background
threads: materialization (fanned out over the cohort's clients), the host
bf16 cast and the copy to the device overlap the current round's compute,
and the consumer pops the same inputs the serial path would build, in round
order.

The device leg is :func:`ship` and :func:`receive`. :func:`ship` copies
each host array into a pinned buffer and from there to the device on a side
CUDA stream, records an event after the copies and waits for it (the copy's
time is the stage's ``h2d_ms``). Its CUDA calls (pinned allocation, the
copies, the event) run under ``parallel/capture.CAPTURE_LOCK``, which a
step capture holds: a background thread's CUDA calls never fall inside a
capture window. :func:`receive`, on the consuming thread, makes the current
stream wait for the copy's event and records each tensor as used on that
stream, so the caching allocator keeps its block until the consumer's work
on it is done. On the CPU both are plain hand-offs.

The batch-granular half is :func:`device_stream`: it takes batches from a
``HostPipeline`` (``fedml_tpu_torch/native``, re-exported here) and ships
each through :func:`ship` on a side stream, ``prefetch`` batches ahead of
the consumer, which takes them in order through :func:`receive`; on the
CPU the batches pass through as tensors over the same memory.
"""

from __future__ import annotations

import os
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.native import HostPipeline
from fedml_tpu_torch.parallel.capture import CAPTURE_LOCK

__all__ = ["CohortPrefetcher", "HostPipeline", "Shipment", "device_stream",
           "materialize_cohort", "receive", "ship"]


def materialize_cohort(dataset, sampled: np.ndarray, pool: Optional[ThreadPoolExecutor] = None,
                       n_chunks: int = 0):
    """``dataset.client_slice(sampled)``, optionally fanned out over chunks
    of clients on ``pool``. The same arrays as the serial call: each
    client's records come from its own stream. Returns ``(x, y, mask,
    counts)`` like ``client_slice``."""
    sampled = np.asarray(sampled)
    if pool is None or n_chunks <= 1 or len(sampled) < 2:
        return dataset.client_slice(sampled)
    chunks = np.array_split(sampled, min(n_chunks, len(sampled)))
    parts = list(pool.map(dataset.client_slice, chunks))
    return tuple(np.concatenate([p[i] for p in parts]) for i in range(4))


class Shipment(NamedTuple):
    """Device tensors and the event after their copy (None on the CPU)."""
    tensors: tuple
    event: Optional[object]


def ship(arrays: Sequence, device: torch.device,
         stream: Optional["torch.cuda.Stream"] = None) -> Shipment:
    """Host arrays (numpy or CPU tensors) to ``device``: on CUDA through
    pinned buffers on ``stream`` (a side stream), then the host waits for
    the copies; see the module note."""
    host = [a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            for a in arrays]
    if device.type != "cuda":
        return Shipment(tuple(t.to(device) for t in host), None)
    with CAPTURE_LOCK:
        with torch.cuda.stream(stream):
            pinned = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
                      for t in host]
            out = tuple(t.to(device, non_blocking=True) for t in pinned)
            event = torch.cuda.Event()
            event.record()
        event.synchronize()
        del pinned      # freed here, under the lock (the host allocator records events)
    return Shipment(out, event)


def receive(shipment: Shipment) -> tuple:
    """The consumer's side of :func:`ship`: the current stream waits for
    the copies, and each tensor is recorded as used on it."""
    if shipment.event is None:
        return shipment.tensors
    current = torch.cuda.current_stream(shipment.tensors[0].device)
    current.wait_event(shipment.event)
    for t in shipment.tensors:
        t.record_stream(current)
    return shipment.tensors


class CohortPrefetcher:
    """Bounded-depth background pipeline over per-round payloads.

    ``build(round_idx, pool) -> (payload, stages)`` runs on a background
    thread and returns what the round needs plus its stage times
    (``{"materialize_ms", "h2d_ms"}``, ``utils/metrics.round_stats``);
    ``pool`` is a shared worker pool for fanning materialization out over
    the cohort's clients (:func:`materialize_cohort`).

    ``pop(round_idx)`` returns ``(payload, stages, wait_ms)`` for that round,
    after scheduling builds of the next ``depth`` rounds, so ``depth`` rounds
    stay in flight while the device computes. Rounds may be popped in any
    order: a round never scheduled is built on demand, and speculative
    rounds outside the new window ``(round, round + depth]`` are dropped. A
    build's exception is held in its future and raised by the ``pop`` that
    consumes it. Speculation stops at ``max_round`` (exclusive); a pop at or
    past it raises the bound (one pop admits that round; a second in a row
    drops the bound).

    ``prime`` schedules the first window without popping; ``close`` drains
    (in-flight builds finish, their payloads are dropped) and is
    idempotent. The prefetcher holds no round state: everything it builds
    is a pure function of the round index."""

    def __init__(self, build: Callable, depth: int, workers: int = 0,
                 max_round: Optional[int] = None, name: str = "cohort-prefetch"):
        self.depth = max(int(depth), 1)
        # auto: leave one core for the consumer, at most 8
        self.workers = (int(workers) if workers > 0
                        else min(8, max(1, (os.cpu_count() or 2) - 1)))
        self.max_round = max_round
        self._build = build
        # depth + 1 round threads: a dropped build cannot be cancelled once
        # running, so an on-demand build after a window jump needs a free one
        self._rounds = ThreadPoolExecutor(max_workers=self.depth + 1,
                                          thread_name_prefix=f"{name}-round")
        self._mat = ThreadPoolExecutor(max_workers=self.workers,
                                       thread_name_prefix=f"{name}-mat")
        self._inflight: dict[int, Future] = {}
        self._past_schedule = False
        self._closed = False

    def _ensure(self, round_idx: int) -> Future:
        fut = self._inflight.get(round_idx)
        if fut is None:
            fut = self._inflight[round_idx] = self._rounds.submit(self._build, round_idx,
                                                                  self._mat)
        return fut

    def prime(self, round_idx: int, wait: bool = False) -> None:
        """Schedule builds of rounds ``[round_idx, round_idx + depth)``
        without popping; ``wait`` blocks until they finish (their errors
        stay in their futures)."""
        if self._closed:
            raise RuntimeError("CohortPrefetcher is closed")
        for i in range(round_idx, round_idx + self.depth):
            if self.max_round is None or i < self.max_round:
                self._ensure(i)
        if wait:
            for fut in list(self._inflight.values()):
                fut.exception()

    def pop(self, round_idx: int):
        if self._closed:
            raise RuntimeError("CohortPrefetcher is closed")
        if self.max_round is not None and round_idx >= self.max_round:
            self.max_round = None if self._past_schedule else round_idx + 1
            self._past_schedule = True
        else:
            self._past_schedule = False
        fut = self._inflight.pop(round_idx, None) or self._rounds.submit(
            self._build, round_idx, self._mat)
        # top up the window before blocking, so the next rounds' builds
        # overlap this round's compute
        for i in range(round_idx + 1, round_idx + 1 + self.depth):
            if self.max_round is None or i < self.max_round:
                self._ensure(i)
        for r in [r for r in self._inflight if not round_idx < r <= round_idx + self.depth]:
            self._inflight.pop(r).cancel()
        t0 = time.perf_counter()
        payload, stages = fut.result()
        return payload, stages, (time.perf_counter() - t0) * 1e3

    def close(self) -> None:
        """Drain and shut down; idempotent."""
        if self._closed:
            return
        self._closed = True
        for fut in self._inflight.values():
            fut.cancel()
        self._inflight.clear()
        self._rounds.shutdown(wait=True)
        self._mat.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *_exc):
        self.close()


def device_stream(pipeline: HostPipeline, n_batches: Optional[int] = None, prefetch: int = 2,
                  device: Optional[Union[str, torch.device]] = None,
                  stream: Optional["torch.cuda.Stream"] = None) -> Iterator[tuple]:
    """Yield ``(x, y)`` batches of ``pipeline`` on ``device`` (``y`` None
    without labels), keeping ``prefetch`` batches shipped ahead of the
    consumer (:func:`ship` on ``stream``, :func:`receive` at the yield).
    ``n_batches`` None streams one epoch."""
    device = default_device(device)
    if n_batches is None:
        n_batches = pipeline.batches_per_epoch
    ahead: deque = deque()

    def take():
        shipment, labelled = ahead.popleft()
        t = receive(shipment)
        return t[0], t[1] if labelled else None

    for _ in range(n_batches):
        bx, by = pipeline.next_batch()
        ahead.append((ship([bx] if by is None else [bx, by], device, stream), by is not None))
        if len(ahead) > prefetch:
            yield take()
    while ahead:
        yield take()
