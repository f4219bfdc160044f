"""Streaming FedAvg: rounds for federations whose records stay on the host
(counterpart of ``fedml_tpu/algorithms/streaming_fedavg.py``).

The plain round moves its cohort to the device (``FedAvgAPI``). Here the
clients' records never go there whole: each sampled client in turn streams
its batches from a ``HostPipeline`` in explicit-order mode (native worker
threads gather the records, ``fedml_tpu_torch/native``) through
``data/pipeline.device_stream`` (side-stream copies, ``prefetch`` batches
ahead), and each batch is copied into the static inputs of the step program
that the plain round replays (``parallel/local``'s ``local_train.stream``,
one captured CUDA graph on the card). Device memory holds one client's
labels and mask and a few batches; host memory the pipeline's ring.

The round equals the plain host round bit for bit with the same orders:
each epoch streams the first ``ceil(count / batch)`` batches of the
real-first order of the client's permutation of its padded record axis
(``_round_orders``, the plain round's orders at cohort position i), and
those are the plain round's live steps; the padding steps it skips are
no-ops. A client whose weight is 0 (a failure, an exit) trains nothing and
stands in with the current globals.

``stream_aggregate="off"`` stacks the cohort's results and takes
``aggregate``, as the plain round does; any other mode folds each client
into one f32 accumulator with normalize-first weights
``counts[i] / max(total, 1e-12)`` as it finishes, so the server holds one
model-shaped sum (``stream_stats``). With ``host_pipeline_depth > 0`` a
``CohortPrefetcher`` materializes the next rounds' live clients on
background threads through the dataset's client LRU
(``client_slice_cached``).
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.data.pipeline import HostPipeline, device_stream, receive, ship
from fedml_tpu_torch.parallel.local import LocalResult, real_first

log = logging.getLogger(__name__)


class StreamingFedAvgAPI(FedAvgAPI):
    """FedAvg whose clients stream their host records batch by batch
    (module note); the cohort trains one client after another.
    ``n_threads`` and ``depth`` size each client's ``HostPipeline``."""

    def __init__(self, dataset, config, bundle=None, n_threads: int = 2, depth: int = 4, **kw):
        self.n_threads, self.depth = n_threads, depth
        super().__init__(dataset, config, bundle, **kw)

    def _maybe_place_train_data(self):
        if self.config.device_data == "on":
            log.warning("device_data='on' ignored: %s streams its clients' records from the "
                        "host; using the host-slice path", type(self).__name__)
        return None

    def build_packed_train(self):
        if self.config.pack_lanes > 0:
            log.warning("pack_lanes=%d ignored: %s trains its clients one after another on "
                        "streamed batches", self.config.pack_lanes, type(self).__name__)
        return None

    def _stream_mode(self) -> str:
        """The config's mode, or "off" (logged once) when a subclass
        overrides ``aggregate``, which the fold cannot mirror."""
        if self._stream_mode_memo is None:
            mode = self.config.stream_aggregate
            if mode != "off" and type(self).aggregate is not FedAvgAPI.aggregate:
                log.warning("stream_aggregate=%r ignored: %s overrides aggregate(), which the "
                            "streaming fold cannot mirror", mode, type(self).__name__)
                mode = "off"
            self._stream_mode_memo = mode
        return self._stream_mode_memo

    def round_counts(self, round_idx: int) -> tuple:
        """(real, executed) examples one epoch of the round processes: the
        live clients' records and the batch slots of their streamed steps."""
        sampled, live = self._round_plan(round_idx)
        counts = np.asarray(self.dataset.train_counts, np.int64)[sampled]
        if live is not None:
            counts = counts[live > 0]
        bs = self.config.batch_size
        return int(counts.sum()), int(sum(-(-int(c) // bs) * bs for c in counts))

    def _prefetch_build(self, round_idx: int, pool):
        """The round pipeline's build: the round's live clients
        materialized on the host through ``client_slice_cached`` (fanned out
        on ``pool``); the batches still stream to the device in the round.
        The cache holds the pipeline's working set, ``depth + 1`` cohorts.
        Returns ``({cohort position: (x, y, mask)}, stages)``."""
        t0 = time.perf_counter()
        sampled, live = self._round_plan(round_idx)
        keep = [int(p) for p in (range(len(sampled)) if live is None
                                 else np.flatnonzero(live > 0))]
        cap = max(64, len(sampled) * (self.config.host_pipeline_depth + 1))

        def fetch(p):
            return self.dataset.client_slice_cached(int(sampled[p]), cap=cap)

        parts = list(pool.map(fetch, keep)) if pool is not None else [fetch(p) for p in keep]
        rows = {p: (x[0], y[0], m[0]) for p, (x, y, m, _c) in zip(keep, parts)}
        return rows, {"materialize_ms": (time.perf_counter() - t0) * 1e3, "h2d_ms": 0.0}

    def _train_client_streaming(self, k: int, orders: torch.Tensor, data=None,
                                key: Optional[int] = None) -> LocalResult:
        """Client ``k``'s local run on its streamed batches; ``orders`` its
        ``[epochs, n_pad]`` permutations, ``data`` its prefetched host
        ``(x, y, mask)`` (None: ``client_arrays`` now), ``key`` its dropout
        key (``_round_keys``)."""
        bs = self.config.batch_size
        x, y, mask = data if data is not None else self.dataset.client_arrays(int(k))
        steps = -(-int(self.dataset.train_counts[k]) // bs)
        mask_t = torch.tensor(np.asarray(mask))
        order = torch.stack([real_first(o, mask_t)[:steps * bs] for o in orders])
        # the labels and mask go over on the side stream, as the batches do
        labels = receive(ship([np.array(y), np.array(mask)], self.device, self._h2d_stream))
        pipe = HostPipeline(x, None, bs, n_threads=self.n_threads, depth=self.depth,
                            orders=order.numpy())
        try:
            stream = device_stream(pipe, n_batches=order.shape[0] * steps, device=self.device,
                                   stream=self._h2d_stream)
            return self._local_train.stream(self.variables, (bx for bx, _ in stream), *labels,
                                            order.to(self.device), key)
        finally:
            pipe.close()

    def _run_round_inner(self, round_idx: int) -> "float | torch.Tensor":
        sampled, live = self._round_plan(round_idx, record=True)
        counts = np.asarray(self.dataset.train_counts, np.float32)[sampled]
        if live is not None:
            counts = counts * live
        orders = self._round_orders(round_idx, len(sampled))
        keys = self._round_keys(round_idx, len(sampled))
        pf = self._host_prefetcher()
        cohort, stages, wait_ms = pf.pop(round_idx) if pf is not None else (None, None, 0.0)
        t0 = time.perf_counter()
        if self._stream_mode() != "off":
            out = self._run_round_streamed(sampled, counts, orders, cohort, keys)
        else:
            results = []
            for i, k in enumerate(sampled):
                if counts[i] <= 0:
                    # zero weight: its result cannot enter the aggregate, so
                    # the current globals stand in for it
                    results.append(LocalResult(self.variables,
                                               torch.zeros((), device=self.device), 0.0))
                    continue
                data = None if cohort is None else cohort[i]
                results.append(self._train_client_streaming(int(k), orders[i], data, keys[i]))
            out = self._finish_clients(round_idx, results, counts)
        if stages is not None:
            self._stage_row(round_idx, stages, wait_ms, (time.perf_counter() - t0) * 1e3)
        return out

    def _run_round_streamed(self, sampled: np.ndarray, counts: np.ndarray,
                            orders: torch.Tensor, cohort: Optional[dict],
                            keys: Sequence[Optional[int]]) -> "float | torch.Tensor":
        """The client loop folding each result into one f32 accumulator
        with normalize-first weights (the round's total is known from the
        plan); a round whose total weight is 0 keeps the weights."""
        total = np.float32(counts.sum())
        w_norm = torch.as_tensor(counts / np.maximum(total, np.float32(1e-12)),
                                 device=self.device)
        w = torch.as_tensor(counts, device=self.device)
        acc = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in self.variables.items()}
        acc_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, k in enumerate(sampled):
            if counts[i] <= 0:
                continue        # zero weight: its term of the mean is 0
            data = None if cohort is None else cohort[i]
            res = self._train_client_streaming(int(k), orders[i], data, keys[i])
            for name, a in acc.items():
                a.add_(res.variables[name].to(torch.float32) * w_norm[i])
            acc_loss = acc_loss + res.train_loss * w[i]
        if total > 0:
            self.variables = {k: a.to(self.variables[k].dtype) for k, a in acc.items()}
        self.stream_stats = {
            "mode": self.config.stream_aggregate, "cohort": len(sampled),
            "chunks": len(sampled),
            "accumulator_bytes": int(sum(v.numel() * 4 for v in self.variables.values()) + 8)}
        loss = acc_loss / max(float(total), 1e-12)
        return loss if self.config.async_rounds else float(loss)
