"""FedAvg, standalone simulation (counterpart of
``fedml_tpu/algorithms/fedavg.py:FedAvgAPI``: the plain round and the
packed round).

Each round samples a cohort (``data/sched.CohortScheduler``; numpy,
bit-equal to the JAX package under every ``cohort_policy``), trains it
from the global state on the device, and takes the sample-weighted mean
of the clients' state dicts, BatchNorm running statistics included. The
stacked client dataset is placed on the device once (unless
``device_data="off"``, over the byte budget, or a virtual cross-device
dataset, ``data/crossdevice.py``), as ``_maybe_place_train_data`` does.

The host round (data not on the device) ships each round's cohort: the
sampled clients materialized on the host, their record axis cut to the
round's bucket (the live cohort's largest count rounded up to
``bucket_quantum_batches`` batches, ``_round_bucket``; each client's
per-epoch orders permute the cut axis, as the JAX package's do), cast to
bf16 on the host when training in bf16, and copied to the device
(``data/pipeline.ship``). With ``host_pipeline_depth > 0`` a
``CohortPrefetcher`` builds the next rounds on background threads while
the current one trains; the inputs are the serial path's, so the rounds
are bit-identical.

Streamed rounds (``stream_aggregate``, host rounds only): the cohort trains
in sub-cohort chunks of ``cohort_chunk`` clients, each folded into one f32
model-shaped accumulator as it finishes (``_run_streaming_round``), so the
server holds one model sum whatever the cohort's size. A plain chunk trains
its clients on the bucket-cut axis and adds ``sum_j w_j * vars_j`` with the
round's normalized weights (``counts / sum(counts)`` over the whole live
cohort, known from the plan), the batch round's own arithmetic
(``core/pytree.weighted_sum``): one chunk is the batch round bit for bit.
With ``pack_lanes > 0`` a chunk runs the packing schedule over its clients
on the full record axis and adds its unnormalized lane sums, divided by the
total weight at the end. A chunk's client at position j takes the orders of
its position in the whole cohort. Both fold modes fold the chunks in plan
order. The prefetcher's depth then counts chunks.

The plain round trains the cohort client by client. With ``pack_lanes > 0``
and the data on the device the round runs the packing schedule
(``parallel/packed.py``): the cohort is packed into up to ``pack_lanes``
lanes that train together in the model's lane-stacked twin. As in the JAX
package, ``device_data="off"`` runs the plain round whatever
``pack_lanes`` says (logged once).

The trainers (``build_local_train``, ``build_packed_train``) live as long
as the API, and with them one step program per step shape: on CUDA each
live (or packed) step of every client and round replays the step captured
once (``parallel/capture.py``), the counterpart of the JAX package's one
compiled program.

The algorithm contract is the JAX package's: a subclass changes
``_local_train_kwargs`` (FedProx), ``init_server_state`` and
``aggregate(variables, stacked_vars, counts, infos, rng, server_state) ->
(new_variables, new_server_state)`` for the plain round, and
``crosssilo_hooks`` (``client_transform`` / ``reduce_extras`` /
``server_update``) for the packed round, which ends in
``parallel/crosssilo.apply_server_and_rollback``. ``self.server_state``
threads across rounds; a round whose total weight is 0 keeps the weights and
the server state, and draws nothing. ``rng`` is the round's server
randomness, ``core/rng.server_generator(seed, round, device)`` on every
paradigm (the JAX package's ``server_key(round_key)``), or, with the API's
``noise_hook``, that hook's draws for the round (``_server_rng``).

Elastic rounds: with ``failure_prob > 0`` each sampled client fails a
round (numpy, bit-equal to the JAX package's draw) and, like a client that
``set_client_active`` has taken out, aggregates with weight 0; on the
packed rounds such a client's lane span is also frozen
(``parallel/packed.mask_plan``), so its steps run only where another lane
is live.

:class:`CrossSiloFedAvgAPI` is the cross-silo paradigm: clients over the
ranks of a ``torch.distributed`` process group (``parallel/mesh.py``), the
aggregate one all-reduce (``parallel/crosssilo.py``).

``train()`` runs the rounds with the periodic eval, checkpoints
(``save``/``restore``, ``checkpoint_dir``, ``resume_from``) and the
``RoundTimer`` record, as the JAX package's does.

The joint packed lowerings (``packed_conv`` ``"grouped"`` or
``"blockdiag"``, ``ops/packed_conv.py``) reach every packed round: the
simulation's, the streamed packed chunks and the cross-silo packed mesh;
``packed_status()`` says whether one is active. Not ported yet, and refused
with ``NotImplementedError`` at construction (``core/config.check_ported``,
``FedConfig``): every field whose feature the port lacks, among them
``packed_conv="auto"`` and the cross-silo super-step (``rounds_per_step >
1``). On data placed on the device the
simulation paradigm's bucket cut and grouped schedule are not needed:
running only each client's live steps (parallel/local.py) already skips
the padding they trim (the orders there permute the whole n_pad).
"""

from __future__ import annotations

import functools
import logging
import os
import time
from collections import deque
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.core.aggregation import fedavg_aggregate
from fedml_tpu_torch.core.config import FedConfig, check_ported
from fedml_tpu_torch.core.pytree import tree_stack, weighted_sum
from fedml_tpu_torch.core.rng import client_generator, server_generator
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.data.pipeline import CohortPrefetcher, materialize_cohort, receive, ship
from fedml_tpu_torch.data.sched import CohortScheduler
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.ops.dropout import client_key
from fedml_tpu_torch.parallel.crosssilo import (SiloWork, apply_server_and_rollback,
                                                make_crosssilo_round)
from fedml_tpu_torch.parallel.local import (LocalResult, finalize_metrics, local_train_kwargs,
                                            make_eval_fn, make_local_train_fn)
from fedml_tpu_torch.parallel.mesh import ClientMesh, client_mesh, shard_client_batch
from fedml_tpu_torch.parallel.packed import (PackedResult, PackPlan, executed_steps,
                                             make_crosssilo_packed_round,
                                             make_packed_cohort_train, mask_plan,
                                             mesh_member_active, packed_fallback_reason,
                                             plan_packing, plan_packing_mesh, rank_plan)
from fedml_tpu_torch.utils.dtypes import host_bf16_cast

log = logging.getLogger(__name__)

#: ``order_hook(round_idx, cohort_pos) -> orders``, ``orders[e]`` a
#: LongTensor permutation of n_pad for epoch e. The cross-silo grouped and
#: host-slice rounds train on a record axis cut to ``n < n_pad`` and call
#: ``order_hook(round_idx, cohort_pos, n)`` for permutations of n.
OrderHook = Callable[..., Sequence[torch.Tensor]]
#: ``noise_hook(round_idx, i, name, shape) -> tensor``: the server's normal
#: draw of leaf ``name`` (index ``i`` in the JAX package's flattened tree)
#: in round ``round_idx``, replacing the server generator's
#: (``core/aggregation.add_dp_noise``)
NoiseHook = Callable[[int, int, str, tuple], torch.Tensor]


def _chunk_buckets(sorted_maxes, G: int, q: int, n_pad: int) -> list:
    """The grouping core of the bucketed schedules (bit-equal to the JAX
    package's): split the ascending max-count sequence into at most ``G``
    contiguous chunks, give each the scan length of its largest member
    rounded up to quantum ``q`` (capped at ``n_pad``), and merge adjacent
    chunks whose scan lengths round equal. Returns ``[[a, b, scan_len],
    ...]`` half-open index chunks."""
    n = len(sorted_maxes)
    bounds = np.linspace(0, n, G + 1).round().astype(int)
    merged: list[list] = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        if a == b:
            continue
        bucket = min(int(np.ceil(max(float(sorted_maxes[b - 1]), 1.0) / q) * q), n_pad)
        if merged and merged[-1][2] == bucket:
            merged[-1][1] = b
        else:
            merged.append([a, b, bucket])
    return merged


def _tree_to(tree, device: torch.device):
    """A tree of dicts, lists and tuples over tensors, moved to ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _live_slots(counts: np.ndarray, bs: int) -> int:
    """Batch slots of the clients' live steps: ``ceil(count / bs) * bs``
    each, the padding of each client's last batch included."""
    return int(sum(-(-int(c) // bs) * bs for c in counts))


class FedAvgAPI:
    def __init__(self, dataset: FedDataset, config: FedConfig,
                 bundle: Optional[ModelBundle] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 order_hook: Optional[OrderHook] = None,
                 noise_hook: Optional[NoiseHook] = None):
        check_ported(config)
        self.device = default_device(device)
        self.dataset = dataset
        self.config = config
        self.bundle = bundle or create_model(
            config.model, dataset.class_num, input_shape=dataset.train_x.shape[2:] or None)
        self.task = get_task(dataset.task, dataset.class_num)
        self.order_hook = order_hook
        self.noise_hook = noise_hook
        #: the per-client exit mask of set_client_active; None = all active
        self._client_active: Optional[np.ndarray] = None
        self.variables = self.bundle.init(config.seed, self.device)
        self.server_state = self.init_server_state()
        self._local_train = self.build_local_train()
        self._eval = make_eval_fn(self.bundle, self.task)
        self._dev_train = self._maybe_place_train_data()
        self._n_total = min(config.client_num_in_total, dataset.num_clients)
        self._cohort = min(config.client_num_per_round, dataset.num_clients)
        #: the one owner of per-round sampling (uniform: sample_clients)
        self._cohort_sched = CohortScheduler(config.cohort_policy, config.seed, self._n_total,
                                             self._cohort)
        self._stream_mode_memo: Optional[str] = None
        #: the last streamed round's accumulator record (None before one)
        self.stream_stats: Optional[dict] = None
        #: per host round: stage times for utils/metrics.round_stats
        self._stage_rows: deque = deque(maxlen=1024)
        self._prefetcher = self._stream_pf = self._stream_packed = None
        # the host round's copies to the device run on a side stream
        self._h2d_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if self._dev_train is not None and config.stream_aggregate != "off":
            log.warning("stream_aggregate=%r (and cohort_chunk) ignored: the dataset is on the "
                        "device, so the round aggregates in one pass; streaming applies to the "
                        "host round", config.stream_aggregate)
        self._packed_train = self.build_packed_train()
        self._packed_plan_memo = None
        self._dev_test = None
        self.history: dict[str, list] = {"round": [], "Test/Acc": [], "Test/Loss": []}

    def _to_device(self, x: np.ndarray, y: np.ndarray, mask: np.ndarray, cast: bool = True):
        """Host arrays -> device tensors; ``cast`` puts float inputs in the
        training compute dtype (eval reads the f32 pool, as in JAX)."""
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        if cast and self.config.dtype == "bfloat16" and xt.is_floating_point():
            xt = xt.to(torch.bfloat16)
        return (xt, torch.from_numpy(np.ascontiguousarray(y)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(mask)).to(self.device))

    def _resident_ok(self, shard_factor: int = 1, slots_fraction: float = 1.0) -> bool:
        """Whether the stacked train set is placed on the device:
        ``device_data="on"``, or ``"auto"`` when its bytes per rank
        (``shard_factor`` ranks; ``slots_fraction`` of the record axis kept)
        fit ``device_data_max_bytes``, train_x counted in the compute dtype."""
        c, ds = self.config, self.dataset
        if getattr(ds, "virtual", False):
            # cross-device scale: the client stack does not exist; rounds
            # materialize their cohorts on the host (data/crossdevice.py)
            if c.device_data == "on":
                log.warning("device_data='on' ignored: %s is a virtual cross-device dataset "
                            "(%d clients); using the sampled host round", ds.name,
                            ds.num_clients)
            return False
        if c.device_data != "auto":
            return c.device_data == "on"
        x = ds.train_x
        x_bytes = x.size * 2 if c.dtype == "bfloat16" and x.dtype.kind == "f" else x.nbytes
        nbytes = (x_bytes + ds.train_y.nbytes + ds.train_mask.nbytes
                  + ds.train_counts.nbytes) * slots_fraction
        return nbytes / max(shard_factor, 1) <= c.device_data_max_bytes

    def _maybe_place_train_data(self):
        """The whole stacked client dataset on the device, once; None when
        it is not to be resident (each round then ships its cohort)."""
        if not self._resident_ok():
            return None
        ds = self.dataset
        return self._to_device(ds.train_x, ds.train_y, ds.train_mask)

    # -- factory methods subclasses override ---------------------------------

    def _local_train_kwargs(self) -> dict:
        """The one config -> trainer kwargs mapping (``local_train_kwargs``),
        shared by the plain and the packed trainer; subclasses add to it."""
        return local_train_kwargs(self.config)

    def build_local_train(self):
        return make_local_train_fn(self.bundle, self.task, **self._local_train_kwargs())

    def init_server_state(self) -> dict:
        """State threaded through ``aggregate`` across rounds (FedOpt's server
        optimizer state); {} = stateless."""
        return {}

    def crosssilo_hooks(self) -> Optional[dict]:
        """This algorithm's ``aggregate`` as hooks of the packed round
        (``client_transform`` / ``reduce_extras`` / ``server_update``), or
        None for the plain weighted mean."""
        return None

    def aggregate(self, variables: dict, stacked_vars: dict, counts: torch.Tensor,
                  infos: LocalResult, rng, server_state: dict) -> tuple[dict, dict]:
        """Sample-weighted average (fedavg_api.py:100-115). Subclasses change
        this. Returns (new_variables, new_server_state)."""
        return fedavg_aggregate(stacked_vars, counts), server_state

    # -- packed schedule (parallel/packed.py) --------------------------------

    def _packing_blocker(self) -> Optional[tuple[str, str]]:
        """Why the lane program cannot run this API, as (``packed_status``'s
        reason, the detail logged), or None: the model has no lane-stacked
        twin (``deeplab_lite``, ``unet``, ``transformer``; the JAX package
        vmaps any model over the lanes, so it schedules these), or this
        subclass rewires
        ``build_local_train`` or overrides ``aggregate`` without hooks."""
        name = type(self).__name__
        if getattr(self.bundle.module, "lane_stacked", None) is None:
            why = f"model {self.bundle.name!r} has no lane-stacked twin"
            return why, why
        mirror = f"{name} has no packed-lane algorithm mirror"
        if type(self).build_local_train is not FedAvgAPI.build_local_train:
            return mirror, (f"{name} rewires build_local_train, which the packed lane program "
                            "cannot mirror")
        if self.crosssilo_hooks() is None and type(self).aggregate is not FedAvgAPI.aggregate:
            return mirror, f"{name} overrides aggregate() without crosssilo hooks"
        return None

    def _packing_hooks(self) -> Optional[dict]:
        """The packed round's algorithm contract: ``{}`` for the plain
        weighted mean, the hook dict of ``crosssilo_hooks``, or None (logged
        once) when ``_packing_blocker`` names a reason."""
        blocker = self._packing_blocker()
        if blocker is None:
            hooks = self.crosssilo_hooks()
            return {} if hooks is None else hooks
        if not getattr(self, "_warned_no_pack", False):
            log.warning("pack_lanes=%d ignored: %s", self.config.pack_lanes, blocker[1])
            self._warned_no_pack = True
        return None

    def build_packed_train(self):
        """The packed cohort program, or None when the packed schedule does
        not apply (``pack_lanes == 0``, an algorithm the lane program cannot
        mirror, or the data is not on the device)."""
        c = self.config
        if c.pack_lanes <= 0:
            return None
        hooks = self._packing_hooks()
        if hooks is None:
            return None
        if self._dev_train is None:
            if not self._stream_packed_active():
                log.warning("pack_lanes=%d: the packed schedule runs on data placed on the "
                            "device, or on streamed chunks; with device_data='off' and "
                            "stream_aggregate='off' every round runs the plain schedule",
                            c.pack_lanes)
            return None
        self._server_update = hooks.get("server_update")
        return make_packed_cohort_train(
            self.bundle, self.task, int(self.dataset.train_x.shape[1]),
            client_transform=hooks.get("client_transform"),
            reduce_extras=hooks.get("reduce_extras"), packed_conv=c.packed_conv,
            **self._local_train_kwargs())

    def _packed_conv_status(self) -> dict:
        """The packed schedule applies: whether its joint lowering is active,
        and if not, the JAX package's reason (``packed_fallback_reason``)."""
        reason = packed_fallback_reason(self.bundle, self.config.packed_conv)
        return {"scheduled": True, "packed_conv_active": reason is None, "reason": reason}

    def packed_status(self) -> dict:
        """Whether the packed schedule applies, and whether a joint
        lowering is active (the JAX package's dict)."""
        if self.config.pack_lanes <= 0:
            return {"scheduled": False, "packed_conv_active": False, "reason": "pack_lanes=0"}
        blocker = self._packing_blocker()
        if blocker is not None:
            return {"scheduled": False, "packed_conv_active": False, "reason": blocker[0]}
        if self._packed_train is None and not (self._dev_train is None
                                               and self._stream_packed_active()):
            return {"scheduled": False, "packed_conv_active": False, "reason": "device_data=off"}
        return self._packed_conv_status()

    def _packed_plan(self, sampled: np.ndarray) -> Optional[PackPlan]:
        key = tuple(int(s) for s in sampled)
        if self._packed_plan_memo is not None and self._packed_plan_memo[0] == key:
            return self._packed_plan_memo[1]   # run_round and round_counts share one plan
        c = self.config
        counts = np.asarray(self.dataset.train_counts, np.float64)[sampled]
        # no t_quantum: it rounds T up with all-dead steps, which bucket the
        # JAX package's jit shapes; the port skips such steps
        plan = plan_packing(counts, c.batch_size, c.epochs, c.pack_lanes)
        self._packed_plan_memo = (key, plan)
        return plan

    def _round_orders(self, round_idx: int, positions: "int | Sequence[int]",
                      n: Optional[int] = None, group_round: Optional[int] = None
                      ) -> torch.Tensor:
        """[len(positions), epochs, n] per-epoch permutations of n (n_pad
        by default) for each cohort position (``positions``, or an int for
        ``range(positions)``): its draws from ``client_generator``, or the
        order hook's. Every round trains on these; at full participation a
        position is the client's index. ``group_round`` (hierarchical FL)
        gives each group round its own orders, and the hook is then called
        ``order_hook(round_idx, pos, n, group_round)``."""
        n_pad = int(self.dataset.train_x.shape[1])
        n = n_pad if n is None else int(n)
        if isinstance(positions, (int, np.integer)):
            positions = range(int(positions))
        out = []
        for i in (int(p) for p in positions):
            if self.order_hook is not None:
                orders = (self.order_hook(round_idx, i, n, group_round)
                          if group_round is not None
                          else self.order_hook(round_idx, i) if n == n_pad
                          else self.order_hook(round_idx, i, n))
            else:
                g = client_generator(self.config.seed, round_idx, i, group_round or 0)
                orders = [torch.randperm(n, generator=g) for _ in range(self.config.epochs)]
            out.append(torch.stack([torch.as_tensor(o, dtype=torch.int64) for o in orders]))
        return torch.stack(out)

    def _round_keys(self, round_idx: int, positions: "int | Sequence[int]",
                    group_round: Optional[int] = None) -> list:
        """The dropout keys of the cohort positions that ``_round_orders``
        takes, each ``client_key`` of (seed, round, position, group round);
        None each for a model without dropout."""
        if isinstance(positions, (int, np.integer)):
            positions = range(int(positions))
        if not self.bundle.uses_dropout:
            return [None] * len(positions)
        return [client_key(self.config.seed, round_idx, int(p), group_round or 0)
                for p in positions]

    def _server_rng(self, round_idx: int):
        """The round's server randomness (``rng`` of ``aggregate`` and of
        ``server_update``): ``server_generator(seed, round, device)``, or the
        ``noise_hook`` bound to the round, a ``(i, name, shape)`` noise
        source."""
        if self.noise_hook is not None:
            return functools.partial(self.noise_hook, round_idx)
        return server_generator(self.config.seed, round_idx, self.device)

    # -- elastic rounds ----------------------------------------------------------

    def _sample_failures(self, round_idx: int, cohort: int,
                         record: bool = True) -> Optional[np.ndarray]:
        """The round's injected failures (bit-equal to the JAX package's):
        with ``failure_prob > 0`` each of the ``cohort`` sampled clients
        fails independently; returns the {0,1} live vector, or None when
        injection is off. ``record`` logs the failures and appends their
        number to ``history["failed_clients"]``."""
        p = self.config.failure_prob
        if not p:
            return None
        rng = np.random.default_rng([self.config.seed, 0x0F41, round_idx])
        live = (rng.random(cohort) >= p).astype(np.float32)
        if record:
            n_failed = int(cohort - live.sum())
            if n_failed:
                log.info("round %d: %d/%d clients failed (injected)", round_idx, n_failed,
                         cohort)
            self.history.setdefault("failed_clients", []).append(n_failed)
        return live

    def set_client_active(self, active) -> None:
        """Per-client participation mask (``[num_clients]`` {0,1}, or None
        to clear): a client whose entry is 0 stops contributing from the
        next round, with weight 0 on every schedule and its lane span frozen
        on the packed ones."""
        a = None if active is None else np.asarray(active, np.float32)
        self._client_active = None if a is None or a.all() else a

    def _live(self, round_idx: int, clients: np.ndarray,
              record: bool = False) -> Optional[np.ndarray]:
        """The {0,1} live mask of ``clients`` (the round's cohort) this
        round, failures and exits folded, or None when every one is live."""
        live = self._sample_failures(round_idx, len(clients), record=record)
        if self._client_active is not None:
            av = self._client_active[clients]
            live = av if live is None else live * av
        return live

    def _round_plan(self, round_idx: int, record: bool = False):
        """The round's (sampled cohort, live mask or None): what run_round
        trains and round_counts reports."""
        sampled = self.sample(round_idx)
        return sampled, self._live(round_idx, sampled, record)

    def _masked_packed_plan(self, sampled: np.ndarray,
                            live: Optional[np.ndarray]) -> Optional[PackPlan]:
        """The cohort's plan, with the members that ``live`` zeroes frozen."""
        plan = self._packed_plan(sampled)
        if plan is None or live is None:
            return plan
        return mask_plan(plan, np.asarray(live, np.float32)[plan.member_pos])

    def _run_packed_round(self, sampled: np.ndarray, live: Optional[np.ndarray],
                          round_idx: int) -> Optional[PackedResult]:
        """The round under the packed schedule, or None when the cohort has
        no records to train."""
        plan = self._masked_packed_plan(sampled, live)
        if plan is None:
            return None
        counts = np.asarray(self.dataset.train_counts, np.float32)[sampled]
        if live is not None:
            counts = counts * live
        tx, ty, tm = self._dev_train
        return self._packed_train(self.variables, tx, ty, tm, sampled, counts,
                                  self._round_orders(round_idx, len(sampled)), plan,
                                  self._round_keys(round_idx, len(sampled)))

    def sample(self, round_idx: int) -> np.ndarray:
        return self._cohort_sched.sample(round_idx)

    def set_cohort_profiler(self, source) -> None:
        """Freeze the cohort scheduler's signal to ``source`` (a
        ``data/sched.ProfileSnapshot`` or an object with ``snapshot()``;
        None clears it): every plan then derives from that one snapshot,
        whatever the pipeline's depth."""
        self._cohort_sched.set_static_profile(source)

    def _round_bucket(self, sampled: np.ndarray, live: Optional[np.ndarray]) -> Optional[int]:
        """The host round's record axis (bit-equal to the JAX package's): the
        live cohort's largest count rounded up to the quantum
        ``bucket_quantum_batches * batch_size``, or None (the whole n_pad:
        bucketing off, or nothing to cut)."""
        c = self.config
        n_pad = int(self.dataset.train_x.shape[1])
        q = c.bucket_quantum_batches * c.batch_size
        if c.bucket_quantum_batches <= 0 or q >= n_pad:
            return None
        counts = np.asarray(self.dataset.train_counts, np.float64)[sampled]
        if live is not None:
            counts = counts * live
        maxc = float(counts.max()) if counts.size else 0.0
        bucket = int(np.ceil(max(maxc, 1.0) / q) * q)
        return None if bucket >= n_pad else bucket

    def round_counts(self, round_idx: int) -> tuple:
        """(real, executed) training examples one epoch of this round
        processes: the live cohort's real record counts (failed and exited
        clients excluded, as in the JAX package), and the batch slots the
        live steps execute (padding in each client's last batch included;
        a failed client still trains). Packed, and streamed packed chunks:
        every lane of every executed step of the plans, one epoch's share
        rounded to the nearest step."""
        c = self.config
        sampled, live = self._round_plan(round_idx)
        counts = np.asarray(self.dataset.train_counts, np.int64)[sampled]
        real = int(counts.sum() if live is None else (counts * live).sum())
        bs, ep = c.batch_size, max(c.epochs, 1)
        if self._packed_train is not None:
            plan = self._masked_packed_plan(sampled, live)
            if plan is not None:
                slots = plan.n_lanes * len(executed_steps(plan.live))
                return real, int(round(slots / ep) * bs)
        if self._dev_train is None and self._stream_packed_active():
            padded = 0
            for start, size in self._stream_chunk_spec(len(sampled)):
                plan = plan_packing(counts[start:start + size], bs, c.epochs, c.pack_lanes)
                if plan is not None:
                    padded += round(plan.n_lanes * len(executed_steps(plan.live)) / ep) * bs
            return real, int(padded)
        if self._dev_train is None:         # the host round's axis is cut to the bucket
            bucket = self._round_bucket(sampled, live)
            if bucket is not None:
                counts = np.minimum(counts, bucket)
        return real, _live_slots(counts, bs)

    def run_round(self, round_idx: int) -> "float | torch.Tensor":
        """Train one round; returns the count-weighted train loss — a float,
        or with ``config.async_rounds`` a 0-dim device tensor (no host sync).
        Every paradigm's round is ``_run_round_inner``; this wrapper then
        feeds the cohort scheduler's round boundary."""
        out = self._run_round_inner(round_idx)
        if self._cohort_sched.wants_notify:
            self._cohort_sched.notify_round_done(round_idx)
        return out

    def _run_round_inner(self, round_idx: int) -> "float | torch.Tensor":
        c = self.config
        if self._dev_train is None:
            if self._stream_mode() != "off":
                return self._run_streaming_round(round_idx)
            return self._run_host_round(round_idx)
        sampled, live = self._round_plan(round_idx, record=True)
        if self._packed_train is not None:
            out = self._run_packed_round(sampled, live, round_idx)
            if out is not None:
                self.variables, self.server_state = apply_server_and_rollback(
                    self.variables, out.variables, out.extras, out.total, self.server_state,
                    self._server_rng(round_idx), self._server_update)
                return out.train_loss if c.async_rounds else float(out.train_loss)
        counts = np.asarray(self.dataset.train_counts, np.int64)[sampled]
        tx, ty, tm = self._dev_train
        idx = torch.from_numpy(sampled).to(self.device)
        wn = counts.astype(np.float32) * (1.0 if live is None else live)
        return self._plain_round(round_idx, tx[idx], ty[idx], tm[idx], counts, wn)

    def _plain_round(self, round_idx: int, cx, cy, cm, counts: np.ndarray,
                     wn: np.ndarray) -> "float | torch.Tensor":
        """Train the cohort client by client on its device arrays ``cx/cy/cm``
        ``[cohort, n, ...]`` (each client's orders permute the n records),
        then ``aggregate`` with the weights ``wn`` (counts x live)."""
        results = self._train_clients(round_idx, range(len(counts)), cx, cy, cm, counts)
        return self._finish_clients(round_idx, results, wn)

    def _finish_clients(self, round_idx: int, results: Sequence[LocalResult],
                        wn: np.ndarray) -> "float | torch.Tensor":
        """The plain round's tail: ``aggregate`` of the clients' results
        with the weights ``wn``, unless their total is 0 (the round then
        keeps weights and server state), and the weighted train loss."""
        w = torch.as_tensor(wn, dtype=torch.float32, device=self.device)
        losses = torch.stack([r.train_loss for r in results])
        infos = LocalResult(tree_stack([r.variables for r in results]), losses,
                            torch.tensor([r.tau for r in results], device=self.device))
        if wn.sum() > 0:      # else the round keeps weights and server state
            self.variables, self.server_state = self.aggregate(
                self.variables, infos.variables, w, infos, self._server_rng(round_idx),
                self.server_state)
        train_loss = (losses * w).sum() / torch.clamp(w.sum(), min=1e-12)
        return train_loss if self.config.async_rounds else float(train_loss)

    def _train_clients(self, round_idx: int, positions: range, cx, cy, cm,
                       counts: np.ndarray) -> list:
        """``local_train`` of each client (cohort position ``positions[j]``,
        row j of ``cx/cy/cm``) on the round's axis ``cx.shape[1]``. A failed
        client's records past a bucket cut are gone (the bucket covers the
        live clients), so it trains the steps of the records it has."""
        n = cx.shape[1]
        orders = self._round_orders(round_idx, positions, n)
        keys = self._round_keys(round_idx, positions)
        return [self._local_train(self.variables, cx[j], cy[j], cm[j],
                                  min(int(counts[j]), n), orders=orders[j], key=keys[j])
                for j in range(len(positions))]

    # -- the host round and its pipeline (data/pipeline.py) -------------------

    def _host_round_inputs(self, round_idx: int, pool=None, n_chunks: int = 0, plan=None):
        """The host round's inputs, built the one way for the serial path and the
        prefetcher (pure in seed and round): the sampled cohort materialized
        (fanned out on ``pool``), cut to the round's bucket, cast to bf16 on
        the host when training in bf16. Returns ``((x, y, mask), meta)``,
        ``meta`` the raw ``counts`` and the weights ``wn`` (counts x live).
        ``plan`` is an already computed ``_round_plan``."""
        sampled, live = plan if plan is not None else self._round_plan(round_idx)
        bucket = self._round_bucket(sampled, live)
        cx, cy, cm, counts = materialize_cohort(self.dataset, sampled, pool, n_chunks)
        if bucket is not None:
            cx, cy, cm = cx[:, :bucket], cy[:, :bucket], cm[:, :bucket]
        counts = np.asarray(counts, np.int64)
        wn = counts.astype(np.float32) * (1.0 if live is None else live)
        return (host_bf16_cast(cx, self.config.dtype), cy, cm), {"counts": counts, "wn": wn}

    def _shipped(self, build: Callable, *args):
        """``build(*args) -> (arrays, meta)``, then the arrays copied to the
        device: ``((shipment, meta), stages)``, ``stages`` the two host
        stages' ms (``utils/metrics.round_stats``)."""
        t0 = time.perf_counter()
        arrays, meta = build(*args)
        t1 = time.perf_counter()
        shipment = ship(arrays, self.device, self._h2d_stream)
        t2 = time.perf_counter()
        return (shipment, meta), {"materialize_ms": (t1 - t0) * 1e3, "h2d_ms": (t2 - t1) * 1e3}

    def _fetch(self, pf: Optional[CohortPrefetcher], key: int, build: Callable, *args):
        """A round's (or chunk's) inputs on the device: popped from the
        prefetcher ``pf`` by ``key``, or built in line by ``build(*args)``,
        whose host stages are then exposed in full. Returns ``(tensors,
        meta, stages, wait_ms)``."""
        if pf is not None:
            (shipment, meta), stages, wait_ms = pf.pop(key)
        else:
            (shipment, meta), stages = self._shipped(build, *args)
            wait_ms = stages["materialize_ms"] + stages["h2d_ms"]
        return receive(shipment), meta, stages, wait_ms

    def _prefetch_build(self, round_idx: int, pool):
        """The pipeline's background build of one round."""
        return self._shipped(self._host_round_inputs, round_idx, pool,
                             getattr(pool, "_max_workers", 0))

    def _host_prefetcher(self) -> Optional[CohortPrefetcher]:
        """The host round's prefetcher, built at the first round that needs
        it; None when the pipeline is off or the data is on the device."""
        c = self.config
        if c.host_pipeline_depth <= 0 or self._dev_train is not None:
            return None
        if self._prefetcher is None:
            # speculate within the schedule, train()'s rounds [0, comm_round)
            self._prefetcher = CohortPrefetcher(self._prefetch_build, c.host_pipeline_depth,
                                                workers=c.host_pipeline_workers,
                                                max_round=c.comm_round)
        return self._prefetcher

    def _stage_row(self, round_idx: int, stages: dict, wait_ms: float,
                   compute_ms: float) -> None:
        self._stage_rows.append(dict(stages, wait_ms=wait_ms, round=round_idx,
                                     compute_ms=compute_ms))

    def _run_host_round(self, round_idx: int) -> "float | torch.Tensor":
        """The round on the host-shipped cohort."""
        pf = self._host_prefetcher()
        plan = None
        if pf is None:
            plan = self._round_plan(round_idx, record=True)
        else:       # the build plans the round; only the failure record runs here
            self._sample_failures(round_idx, self._cohort, record=True)
        (cx, cy, cm), meta, stages, wait_ms = self._fetch(pf, round_idx, self._host_round_inputs,
                                                          round_idx, None, 0, plan)
        t0 = time.perf_counter()
        out = self._plain_round(round_idx, cx, cy, cm, meta["counts"], meta["wn"])
        self._stage_row(round_idx, stages, wait_ms, (time.perf_counter() - t0) * 1e3)
        return out

    # -- streamed rounds -----------------------------------------------------------

    def _stream_mode(self) -> str:
        """The streaming mode that applies to this API: the config's, or
        "off" (logged once) when the streaming fold cannot mirror it: it
        rewires aggregation, carries cross-silo hooks, or rewires the local
        trainer or the round (``_run_round_inner`` or ``_plain_round``)."""
        if self._stream_mode_memo is not None:
            return self._stream_mode_memo
        mode = self.config.stream_aggregate
        cls = type(self)
        if mode != "off" and (cls.aggregate is not FedAvgAPI.aggregate
                              or self.crosssilo_hooks() is not None
                              or cls.build_local_train is not FedAvgAPI.build_local_train
                              or cls._run_round_inner is not FedAvgAPI._run_round_inner
                              or cls._plain_round is not FedAvgAPI._plain_round):
            log.warning("stream_aggregate=%r ignored: %s rewires aggregation (or carries "
                        "crosssilo hooks) or the round, which the streaming fold cannot "
                        "mirror; using the batch path", mode, cls.__name__)
            mode = "off"
        self._stream_mode_memo = mode
        return mode

    def _stream_packed_active(self) -> bool:
        """Whether streamed chunks run the packing schedule."""
        return self.config.pack_lanes > 0 and self._stream_mode() != "off"

    @property
    def _stream_chunks_per_round(self) -> int:
        chunk = self.config.cohort_chunk
        return 1 if chunk <= 0 or chunk >= self._cohort else -(-self._cohort // chunk)

    def _stream_chunk_spec(self, cohort_n: int) -> list:
        """``[(start, size)]``: the sub-cohort chunks in plan order."""
        chunk = self.config.cohort_chunk
        if chunk <= 0 or chunk >= cohort_n:
            return [(0, cohort_n)]
        return [(s, min(chunk, cohort_n - s)) for s in range(0, cohort_n, chunk)]

    def _stream_chunk_inputs(self, round_idx: int, ci: int, pool=None, n_chunks: int = 0):
        """One chunk's host inputs, pure in (seed, round, chunk): its clients
        materialized, cut to the round's bucket (plain chunks; the packing
        schedule takes the full record axis), cast on the host, and the
        weights: ``wn`` (counts x live) and ``w_norm``, normalized over the
        whole live cohort in f32 as ``tree_weighted_mean`` normalizes
        (integer-valued f32 weights, so the host sum is exact). Returns
        ``((x, y, mask), meta)``."""
        sampled, live = self._round_plan(round_idx)
        start, size = self._stream_chunk_spec(len(sampled))[ci]
        cx, cy, cm, counts = materialize_cohort(self.dataset, sampled[start:start + size],
                                                pool, n_chunks)
        bucket = None if self._stream_packed_active() else self._round_bucket(sampled, live)
        if bucket is not None:
            cx, cy, cm = cx[:, :bucket], cy[:, :bucket], cm[:, :bucket]
        counts = np.asarray(counts, np.int64)
        wn = counts.astype(np.float32)
        w_full = np.asarray(self.dataset.train_counts)[sampled].astype(np.float32)
        if live is not None:
            lv = np.asarray(live, np.float32)
            wn = wn * lv[start:start + size]
            w_full = w_full * lv
        denom = np.maximum(np.float32(w_full.sum()), np.float32(1e-12))
        meta = {"counts": counts, "wn": wn, "w_norm": (wn / denom).astype(np.float32),
                "start": start, "size": size}
        return (host_bf16_cast(cx, self.config.dtype), cy, cm), meta

    def _stream_prefetch_build(self, gidx: int, pool):
        """The background build of global chunk ``gidx`` = round x chunks a
        round + chunk, so the prefetcher holds ``depth`` chunks in flight."""
        r, ci = divmod(gidx, self._stream_chunks_per_round)
        return self._shipped(self._stream_chunk_inputs, r, ci, pool,
                             getattr(pool, "_max_workers", 0))

    def _stream_prefetcher(self) -> Optional[CohortPrefetcher]:
        c = self.config
        if c.host_pipeline_depth <= 0:
            return None
        if self._stream_pf is None:
            self._stream_pf = CohortPrefetcher(
                self._stream_prefetch_build, c.host_pipeline_depth,
                workers=c.host_pipeline_workers,
                max_round=c.comm_round * self._stream_chunks_per_round, name="stream-prefetch")
        return self._stream_pf

    def _stream_packed_chunk(self):
        """The packed cohort program of streamed chunks, built at the first
        packed chunk."""
        if self._stream_packed is None:
            self._stream_packed = make_packed_cohort_train(
                self.bundle, self.task, int(self.dataset.train_x.shape[1]),
                packed_conv=self.config.packed_conv, **self._local_train_kwargs())
        return self._stream_packed

    def _run_streaming_round(self, round_idx: int) -> "float | torch.Tensor":
        """One host round as streamed sub-cohort chunks folded into one f32
        accumulator (module note). Plain chunks add normalized sums, and the
        aggregate is the sum; packed chunks add their lane sums, and the
        aggregate is the sum over the total weight. A round whose total
        weight is 0 keeps the weights."""
        c = self.config
        sampled, live = self._round_plan(round_idx, record=True)
        spec = self._stream_chunk_spec(len(sampled))
        n_chunks = len(spec)
        packed = self._stream_packed_active()
        acc = {k: torch.zeros_like(v, dtype=torch.float32) for k, v in self.variables.items()}
        acc_w = torch.zeros((), dtype=torch.float32, device=self.device)
        acc_loss = torch.zeros((), dtype=torch.float32, device=self.device)
        total = 0.0
        pf = self._stream_prefetcher()
        mat_ms = h2d_ms = wait_ms = compute_ms = 0.0
        for ci in range(n_chunks):
            (cx, cy, cm), meta, stages, w_ms = self._fetch(
                pf, round_idx * n_chunks + ci, self._stream_chunk_inputs, round_idx, ci)
            mat_ms += stages["materialize_ms"]
            h2d_ms += stages["h2d_ms"]
            wait_ms += w_ms
            t0 = time.perf_counter()
            start, size, counts = meta["start"], meta["size"], meta["counts"]
            positions = range(start, start + size)
            if packed:
                plan = plan_packing(counts.astype(np.float64), c.batch_size, c.epochs,
                                    c.pack_lanes)
                if plan is not None:
                    sums = self._stream_packed_chunk().sums(
                        self.variables, cx, cy, cm, np.arange(size), meta["wn"],
                        self._round_orders(round_idx, positions), plan,
                        self._round_keys(round_idx, positions))
                    torch._foreach_add_(list(acc.values()), [sums.acc[k] for k in acc])
                    acc_loss = acc_loss + sums.loss_sum
                    total += sums.total
            else:
                results = self._train_clients(round_idx, positions, cx, cy, cm, counts)
                stacked = tree_stack([r.variables for r in results])
                w_norm = torch.as_tensor(meta["w_norm"], device=self.device)
                acc = {k: a + weighted_sum(stacked[k], w_norm) for k, a in acc.items()}
                w = torch.as_tensor(meta["wn"], device=self.device)
                losses = torch.stack([r.train_loss for r in results])
                acc_w = acc_w + w.sum()
                acc_loss = acc_loss + (losses * w).sum()
                total += float(meta["wn"].sum())
            compute_ms += (time.perf_counter() - t0) * 1e3
        if packed:
            denom = max(total, 1e-12)
            new = {k: (a / denom).to(self.variables[k].dtype) for k, a in acc.items()}
            train_loss = acc_loss / denom
        else:
            new = {k: a.to(self.variables[k].dtype) for k, a in acc.items()}
            train_loss = acc_loss / torch.clamp(acc_w, min=1e-12)
        if total > 0:
            self.variables = new
        self._stage_row(round_idx, {"materialize_ms": mat_ms, "h2d_ms": h2d_ms}, wait_ms,
                        compute_ms)
        # the server's round state: one f32 model-shaped accumulator and two
        # scalars, whatever the cohort's size
        self.stream_stats = {
            "mode": c.stream_aggregate, "cohort": len(sampled), "chunks": n_chunks,
            "chunk_clients": c.cohort_chunk if n_chunks > 1 else len(sampled),
            "packed_lanes": c.pack_lanes if packed else 0,
            "accumulator_bytes": int(sum(v.numel() * 4 for v in self.variables.values()) + 8)}
        return train_loss if c.async_rounds else float(train_loss)

    def close(self) -> None:
        """Drain and shut down the host round's prefetchers; idempotent. The
        API stays usable: the next host round builds a new one."""
        for name in ("_prefetcher", "_stream_pf"):
            pf = getattr(self, name)
            setattr(self, name, None)
            if pf is not None:
                pf.close()

    def eval_sums(self) -> dict:
        """The global model's metric sums over the test pool, on the host
        (scalars as numbers, a segmentation confusion matrix as an array)."""
        if self._dev_test is None:
            ds = self.dataset
            self._dev_test = self._to_device(ds.test_x, ds.test_y, ds.test_mask, cast=False)
        x, y, m = self._dev_test
        sums = self._eval(self.variables, x, y, m)
        return {k: v.item() if v.numel() == 1 else v.cpu().numpy() for k, v in sums.items()}

    def evaluate_global(self) -> dict:
        return finalize_metrics(self.eval_sums())

    def save(self, path: str, round_idx: int = 0, orbax: bool = False) -> None:
        """Checkpoint the variables and the server state with the round to
        resume from (``utils/checkpoint.py``)."""
        from fedml_tpu_torch.utils import checkpoint as ckpt

        if orbax:
            raise NotImplementedError(ckpt.ORBAX_UNPORTED)
        ckpt.save_checkpoint(path, self.variables, self.server_state, round_idx)

    def restore(self, path: str, orbax: bool = False) -> int:
        """Load a checkpoint into this API (on its device); returns the round
        to resume from. Training on from there is the uninterrupted run: every
        round's sampling, failures and orders are pure in (seed, round)."""
        from fedml_tpu_torch.utils import checkpoint as ckpt

        if orbax:
            raise NotImplementedError(ckpt.ORBAX_UNPORTED)
        state = ckpt.load_checkpoint(path)
        saved = state["variables"]
        if set(saved) != set(self.variables):
            raise ValueError(f"{path}: the checkpoint's variables do not match this model's "
                             f"({sorted(set(saved) ^ set(self.variables))[:6]} differ)")
        self.variables = {k: saved[k].to(self.device) for k in self.variables}
        self.server_state = _tree_to(state["server_state"], self.device)
        return int(state["round_idx"])

    def train(self) -> dict:
        """``comm_round`` rounds from round 0, or from ``resume_from``'s
        round, with the periodic eval, ``latest.ckpt`` in ``checkpoint_dir``
        every ``checkpoint_frequency`` rounds and after the last, and an
        optional profiler trace. The history gains ``rounds_per_sec`` (the
        rounds this call ran over its wall time) and ``timing``
        (``RoundTimer.summary``, and ``host_pipeline`` when host rounds ran)."""
        from fedml_tpu_torch.utils.metrics import (MetricsLogger, RoundTimer, profile_trace,
                                                   round_stats)

        c = self.config
        timer = RoundTimer(sync=(lambda: torch.cuda.synchronize(self.device))
                           if self.device.type == "cuda" else None)
        logger = MetricsLogger(c.run_name, c.enable_wandb, config=c.to_dict())
        start_round = 0
        if c.resume_from:
            start_round = self.restore(c.resume_from)
            log.info("resumed from %s at round %d", c.resume_from, start_round)
        try:
            with profile_trace(c.profile_dir):
                self._train_rounds(start_round, timer, logger)
        finally:
            # no prefetcher thread outlives the run
            self.close()
            logger.close()
        timing = timer.summary()
        if self._stage_rows:
            timing["host_pipeline"] = round_stats(self._stage_rows, c.host_pipeline_depth)
        if c.async_rounds:
            # the rounds returned device scalars unsynced, so 'train' timed
            # their dispatch; eval phases and the wall clock end on a sync
            timing["time/train_is_dispatch_only"] = True
        self.history["rounds_per_sec"] = timing["rounds_per_sec"]
        self.history["timing"] = timing
        self.metrics_logger = logger
        return self.history

    def _eval_at(self, r: int) -> bool:
        """Whether the periodic eval runs after round ``r``."""
        c = self.config
        return r % c.frequency_of_the_test == 0 or r == c.comm_round - 1

    def _train_rounds(self, start_round: int, timer, logger) -> None:
        c = self.config
        for r in range(start_round, c.comm_round):
            with timer.phase("train", sync=not c.async_rounds):
                loss = self.run_round(r)
            timer.tick_round()
            if self._eval_at(r):
                with timer.phase("eval"):
                    m = self.evaluate_global()
                self.history["round"].append(r)
                self.history["Test/Acc"].append(m.get("acc"))
                self.history["Test/Loss"].append(m.get("loss"))
                logger.log({"Train/Loss": float(loss), "Test/Acc": m.get("acc"),
                            "Test/Loss": m.get("loss")}, r)
            if c.checkpoint_dir and ((r + 1) % c.checkpoint_frequency == 0
                                     or r == c.comm_round - 1):
                self.save(os.path.join(c.checkpoint_dir, "latest.ckpt"), r + 1)


class OwnRoundMixin:
    """For a :class:`FedAvgAPI` subclass whose round program is its own
    (hierarchical FL, gossip, TurboAggregate; in the JAX package such a
    subclass overrides ``build_round_step``). As there, the FedAvg gather
    path does not place the data on the device, the packed schedule is not
    taken whatever ``pack_lanes`` says, and ``failure_prob`` is ignored,
    each logged once with the JAX package's warning; ``packed_status`` keeps
    the JAX package's answer, which names the packed schedule as the
    algorithm's FedAvg would."""

    def _maybe_place_train_data(self):
        if self.config.device_data == "on":
            log.warning("device_data='on' ignored: %s overrides the round program, which the "
                        "gather path cannot mirror; using the host-slice path",
                        type(self).__name__)
        return None

    def build_packed_train(self):
        if self.config.pack_lanes > 0:
            log.warning("pack_lanes=%d ignored: %s overrides the round program, which the "
                        "packed lane program cannot mirror", self.config.pack_lanes,
                        type(self).__name__)
        return None

    def packed_status(self) -> dict:
        if self.config.pack_lanes <= 0:
            return {"scheduled": False, "packed_conv_active": False, "reason": "pack_lanes=0"}
        return self._packed_conv_status()

    def _sample_failures(self, round_idx, cohort, record=True):
        if self.config.failure_prob and not getattr(self, "_warned_no_elastic", False):
            log.warning("failure_prob=%s ignored: %s rewires the round program without an "
                        "elastic (zero-weight) aggregation guard", self.config.failure_prob,
                        type(self).__name__)
            self._warned_no_elastic = True
        return None


class CrossSiloFedAvgAPI(FedAvgAPI):
    """Cross-silo paradigm (counterpart of the JAX package's
    ``CrossSiloFedAvgAPI``): the cohort split over the ranks of the client
    mesh (``parallel/mesh.client_mesh``; one rank without a process group),
    each rank training its block of clients, the aggregate one all-reduce
    (``parallel/crosssilo.mesh_finish``). The effective cohort must be a
    multiple of the world size. Every rank holds the whole host dataset and
    computes the same host plan, masks and weights.

    The schedule is chosen as the JAX package chooses it:

    - **packed mesh** (``pack_lanes > 0``, full participation, an algorithm
      the lane program mirrors): the clients dealt to ranks by
      ``plan_packing_mesh``, each rank's block resident in plan order and
      trained by the lane program over its lanes
      (``make_crosssilo_packed_round``);
    - **grouped** (``bucket_groups > 1``, full participation, something to
      trim): count-sorted clients dealt to ranks in strips, each group's
      block resident on its record axis cut to the group's scan length;
    - **resident-sharded** (full participation): each rank's block of the
      stacked clients resident;
    - **host slice** (partial participation, ``device_data="off"`` or over
      the byte budget): each round ships the rank's block of the sampled
      cohort, its record axis cut to the cohort's bucket.

    Every client's per-epoch orders are its original index's (the cohort
    position's on the host slice): a schedule changes which steps are
    padding, never which orders a client draws; the grouped and host-slice
    rounds draw permutations of their cut axis, as the JAX package does.
    Failed and exited clients train with weight 0 (frozen lane spans on
    the packed mesh); a round whose total weight is 0 keeps the weights and
    the server state. The super-step (``rounds_per_step > 1``) is refused;
    ``cohort_vmap_width`` and ``stream_aggregate`` are ignored (logged), as in
    the JAX package.
    """

    def __init__(self, dataset: FedDataset, config: FedConfig,
                 bundle: Optional[ModelBundle] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 order_hook: Optional[OrderHook] = None,
                 mesh: Optional[ClientMesh] = None, **kw):
        self.mesh = mesh or client_mesh(device=device)
        super().__init__(dataset, config, bundle, device=self.mesh.device,
                         order_hook=order_hook, **kw)
        D = self.mesh.world_size
        cohort = self._cohort
        if cohort % D:
            raise ValueError(f"effective cohort size ({cohort}) must be a multiple of the mesh "
                             f"'clients' axis ({D})")
        if config.cohort_vmap_width > 0:
            log.warning("cohort_vmap_width=%d ignored: the cross-silo mesh round trains "
                        "each rank's client block whole", config.cohort_vmap_width)
        self._stream_mode()     # logs that the mesh round does not stream
        self._round = make_crosssilo_round(self._local_train, self.mesh,
                                           **self._crosssilo_hooks_checked())
        self._dev_sharded = self._dev_groups = self._group_plan = self._packed_mesh = None
        if config.pack_lanes > 0:
            self._packed_mesh = self._mesh_packed_setup(cohort)
        if self._packed_mesh is None:
            plan = self._mesh_group_plan(cohort)
            if plan is not None:
                self._dev_groups = self._place_grouped(plan)
                if self._dev_groups is not None:
                    self._group_plan = plan
            if self._dev_groups is None:
                self._dev_sharded = self._maybe_place_sharded(cohort)

    # the mesh schedules place their own blocks; the simulation paradigm's
    # whole-federation placement and packed program do not apply
    def _maybe_place_train_data(self):
        return None

    def build_packed_train(self):
        return None

    def _crosssilo_hooks_checked(self) -> dict:
        hooks = self.crosssilo_hooks()
        if hooks is None:
            if type(self).aggregate is not FedAvgAPI.aggregate:
                raise NotImplementedError(
                    f"{type(self).__name__} overrides aggregate(), which the mesh round cannot "
                    "honor; implement crosssilo_hooks() or use the simulation paradigm "
                    "(FedAvgAPI)")
            hooks = {}
        return hooks

    def packed_status(self) -> dict:
        """As the simulation paradigm's, for the packed mesh schedule."""
        if self.config.pack_lanes <= 0 or self._packing_hooks() is None:
            return super().packed_status()
        if self._packed_mesh is None:
            return {"scheduled": False, "packed_conv_active": False,
                    "reason": "partial participation, or the data is not resident"}
        return self._packed_conv_status()

    def _place_rows(self, rows: np.ndarray, n: Optional[int] = None) -> tuple:
        """The stacked train arrays of ``rows`` (their record axis cut to
        ``n``) on the rank's device, x in the compute dtype."""
        ds = self.dataset
        cut = slice(None) if n is None else slice(0, n)
        return self._to_device(ds.train_x[rows, cut], ds.train_y[rows, cut],
                               ds.train_mask[rows, cut])

    def _mesh_packed_setup(self, cohort: int) -> Optional[dict]:
        """The packed mesh schedule: the plan, this rank's block of the
        clients in plan order on its device, and the round program; None
        when packing does not apply."""
        c, ds = self.config, self.dataset
        hooks = self._packing_hooks()
        if hooks is None:
            return None
        if cohort != ds.num_clients:
            log.warning("pack_lanes=%d ignored on the mesh path: the packed schedule is "
                        "resident-sharded and needs full participation (cohort %d != clients "
                        "%d)", c.pack_lanes, cohort, ds.num_clients)
            return None
        D = self.mesh.world_size
        lanes_dev = max(1, -(-c.pack_lanes // D))
        # full participation: one static plan, no quantum on its length
        out = plan_packing_mesh(np.asarray(ds.train_counts), c.batch_size, c.epochs, D,
                                lanes_dev, t_quantum=1)
        if out is None or not self._resident_ok(D):
            return None
        perm, plan = out
        rows = perm[self.mesh.block(len(perm))]
        round_fn = make_crosssilo_packed_round(
            self.bundle, self.task, int(ds.train_x.shape[1]), self.mesh, **hooks,
            packed_conv=c.packed_conv, **self._local_train_kwargs())
        return dict(perm=perm, plan=plan, rows=rows, data=self._place_rows(rows),
                    round_fn=round_fn)

    def _maybe_place_sharded(self, cohort: int) -> Optional[tuple]:
        """Full participation keeps each rank's block of the stacked
        clients resident on its device; partial participation ships the
        round's host slice instead."""
        c, ds = self.config, self.dataset
        if c.device_data == "off":
            return None
        if cohort != ds.num_clients:
            if c.device_data == "on":
                log.warning("device_data='on' ignored for cross-silo partial participation "
                            "(%d/%d clients); resident sharding needs full participation",
                            cohort, ds.num_clients)
            return None
        if not self._resident_ok(self.mesh.world_size):
            return None
        rows = np.arange(ds.num_clients)[self.mesh.block(ds.num_clients)]
        return (rows,) + self._place_rows(rows)

    def _mesh_group_plan(self, cohort: int):
        """The grouped schedule (bit-equal to the JAX package's): clients
        sorted by count and dealt to ranks in strips (strip s = the s-th
        ``D`` clients, one a rank), consecutive strips chunked into at most
        ``bucket_groups`` groups whose scan length is the chunk's largest
        count rounded up to the quantum. None when it is off or trims
        nothing, else a tuple of ``(idx_g, scan_len_g)``, ``idx_g`` the
        group's clients rank-major (rank d's block = its strip slots)."""
        c, ds = self.config, self.dataset
        if c.device_data == "off" or cohort != ds.num_clients:
            return None
        D = self.mesh.world_size
        L = ds.num_clients // D
        if c.bucket_groups <= 1 or L < 2:
            return None
        n_pad = int(ds.train_x.shape[1])
        q = c.bucket_quantum_batches * c.batch_size
        if c.bucket_quantum_batches <= 0 or q >= n_pad:
            return None
        counts = np.asarray(ds.train_counts, np.float64)
        strips = np.argsort(counts, kind="stable").reshape(L, D)
        strip_max = counts[strips].max(axis=1)
        merged = _chunk_buckets(strip_max, min(c.bucket_groups, L), q, n_pad)
        if len(merged) == 1 and merged[0][2] >= n_pad:
            return None
        return tuple((strips[a:b].T.reshape(-1), bucket) for a, b, bucket in merged)

    def _place_grouped(self, plan) -> Optional[list]:
        """Each group's block of this rank on its device, the record axis
        cut to the group's scan length (one cut copy per group); None when
        the cut federation is not to be resident."""
        ds = self.dataset
        kept = sum(len(idx_g) * bucket for idx_g, bucket in plan)
        if not self._resident_ok(self.mesh.world_size,
                                 kept / max(ds.num_clients * int(ds.train_x.shape[1]), 1)):
            return None
        groups = []
        for idx_g, bucket in plan:
            rows = idx_g[self.mesh.block(len(idx_g))]
            groups.append((rows, bucket) + self._place_rows(rows, bucket))
        return groups

    def _work(self, round_idx: int, rows: np.ndarray, x, y, m, weights: np.ndarray,
              positions: Optional[np.ndarray] = None) -> list:
        """One SiloWork per row of a rank's placed block: ``weights`` and
        the orders (of the block's record axis) by row, or by
        ``positions`` in the cohort."""
        pos = rows if positions is None else positions
        orders = self._round_orders(round_idx, pos, x.shape[1])
        keys = self._round_keys(round_idx, pos)
        counts = self.dataset.train_counts
        return [SiloWork(x[i], y[i], m[i], int(counts[r]), float(weights[p]), orders[i], keys[i])
                for i, (r, p) in enumerate(zip(rows, pos))]

    def _run_round_inner(self, round_idx: int) -> "float | torch.Tensor":
        c, ds = self.config, self.dataset
        if self._packed_mesh is None and self._dev_groups is None and self._dev_sharded is None:
            return self._run_host_slice_round(round_idx)
        clients = np.arange(ds.num_clients)
        live = self._live(round_idx, clients, record=True)
        w = np.asarray(ds.train_counts, np.float32) * (1.0 if live is None else live)
        total = float(w.astype(np.float64).sum())
        if self._packed_mesh is not None:
            pm = self._packed_mesh
            plan = pm["plan"]
            if live is not None:
                plan = mask_plan(plan, mesh_member_active(plan, self.mesh.world_size,
                                                          live[pm["perm"]]))
            rows = pm["rows"]
            tx, ty, tm = pm["data"]
            out = pm["round_fn"](self.variables, self.server_state, tx, ty, tm, w[rows],
                                 self._round_orders(round_idx, rows),
                                 rank_plan(plan, self.mesh.world_size, self.mesh.rank), total,
                                 self._server_rng(round_idx), self._round_keys(round_idx, rows))
        else:
            blocks = self._dev_groups or [self._dev_sharded]
            work = [wk for rows, *rest in blocks
                    for wk in self._work(round_idx, rows, *rest[-3:], w)]
            out = self._round(self.variables, self.server_state, work, total,
                              self._server_rng(round_idx))
        self.variables, self.server_state, loss = out
        return loss if c.async_rounds else float(loss)

    def _run_host_slice_round(self, round_idx: int) -> "float | torch.Tensor":
        """Partial participation: this rank's block of the sampled cohort,
        shipped from the host, its record axis cut to the round's bucket
        (``_round_bucket``); orders by cohort position."""
        c, ds = self.config, self.dataset
        sampled, live = self._round_plan(round_idx, record=True)
        w = np.asarray(ds.train_counts, np.float32)[sampled] * (1.0 if live is None else live)
        bucket = self._round_bucket(sampled, live)
        cx, cy, cm, _ = ds.client_slice(sampled)
        if bucket is not None:
            cx, cy, cm = cx[:, :bucket], cy[:, :bucket], cm[:, :bucket]
        x, y, m = shard_client_batch(self.mesh, (cx, cy, cm),
                                     torch.bfloat16 if c.dtype == "bfloat16" else None)
        pos = np.arange(len(sampled))[self.mesh.block(len(sampled))]
        work = self._work(round_idx, sampled[pos], x, y, m, w, positions=pos)
        self.variables, self.server_state, loss = self._round(
            self.variables, self.server_state, work, float(w.astype(np.float64).sum()),
            self._server_rng(round_idx))
        return loss if c.async_rounds else float(loss)

    def round_counts(self, round_idx: int) -> tuple:
        """(real, executed) examples one epoch of the round processes: the
        live clients' real records (as the JAX package's), and on the
        packed mesh the plan's ``executed_slots * bs / epochs`` (the JAX
        package's, the plans being bit-equal); on the grouped, resident and
        host-slice rounds the port's own count, the batch slots of every
        client's live steps (a group's cut axis runs the same live steps)."""
        ds, bs = self.dataset, self.config.batch_size
        if self._packed_mesh is None and self._dev_groups is None and self._dev_sharded is None:
            sampled, live = self._round_plan(round_idx)
        else:
            sampled = np.arange(ds.num_clients)
            live = self._live(round_idx, sampled)
        counts = np.asarray(ds.train_counts, np.int64)[sampled]
        real = int(counts.sum() if live is None else (counts * live).sum())
        if self._packed_mesh is not None:
            plan = self._packed_mesh["plan"]
            return real, int(plan.executed_slots * bs // max(self.config.epochs, 1))
        return real, _live_slots(counts, bs)
