"""FedAvg, standalone simulation (counterpart of
``fedml_tpu/algorithms/fedavg.py:FedAvgAPI``: the plain round and the
packed round).

Each round samples a cohort (numpy, bit-equal to the JAX package), trains
it from the global state on the device, and takes the sample-weighted mean
of the clients' state dicts, BatchNorm running statistics included. The
stacked client dataset is placed on the device once (unless
``device_data="off"``), as ``_maybe_place_train_data`` does.

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
the server state. ``rng`` is None: no ported algorithm draws on the server.

Not ported yet, and refused with ``NotImplementedError``: the joint packed
lowerings (``packed_conv`` other than ``"off"``), injected failures
(``failure_prob > 0``) and streaming aggregation. The bucketed and grouped
schedules of the JAX package are not needed: running only each client's
live steps (parallel/local.py) already skips the padding they trim. The
cross-silo paradigm is a later port.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.core.aggregation import fedavg_aggregate
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.pytree import tree_stack
from fedml_tpu_torch.core.rng import client_generator, sample_clients
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.parallel.crosssilo import apply_server_and_rollback
from fedml_tpu_torch.parallel.local import (LocalResult, finalize_metrics, local_train_kwargs,
                                            make_eval_fn, make_local_train_fn)
from fedml_tpu_torch.parallel.packed import (PackedResult, PackPlan, executed_steps,
                                             make_packed_cohort_train, plan_packing)

log = logging.getLogger(__name__)

#: ``order_hook(round_idx, cohort_pos) -> orders``, ``orders[e]`` a
#: LongTensor permutation of n_pad for epoch e
OrderHook = Callable[[int, int], Sequence[torch.Tensor]]


class FedAvgAPI:
    def __init__(self, dataset: FedDataset, config: FedConfig,
                 bundle: Optional[ModelBundle] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 order_hook: Optional[OrderHook] = None):
        if config.packed_conv != "off":
            raise NotImplementedError(f"packed_conv={config.packed_conv!r}: the joint packed "
                                      "lowerings are not ported yet (packed_conv='off' is)")
        if config.failure_prob > 0:
            raise NotImplementedError("failure_prob > 0: elastic rounds are not ported yet")
        if config.stream_aggregate != "off":
            raise NotImplementedError("stream_aggregate: streaming rounds are not ported yet")
        self.device = default_device(device)
        self.dataset = dataset
        self.config = config
        self.bundle = bundle or create_model(
            config.model, dataset.class_num, input_shape=dataset.train_x.shape[2:] or None)
        self.task = get_task(dataset.task, dataset.class_num)
        self.order_hook = order_hook
        self.variables = self.bundle.init(config.seed, self.device)
        self.server_state = self.init_server_state()
        self._local_train = self.build_local_train()
        self._eval = make_eval_fn(self.bundle, self.task)
        self._dev_train = self._maybe_place_train_data()
        self._packed_train = self.build_packed_train()
        self._packed_plan_memo = None
        self._dev_test = None
        self._n_total = min(config.client_num_in_total, dataset.num_clients)
        self._cohort = min(config.client_num_per_round, dataset.num_clients)
        self.history: dict[str, list] = {"round": [], "Test/Acc": [], "Test/Loss": []}

    def _to_device(self, x: np.ndarray, y: np.ndarray, mask: np.ndarray, cast: bool = True):
        """Host arrays -> device tensors; ``cast`` puts float inputs in the
        training compute dtype (eval reads the f32 pool, as in JAX)."""
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
        if cast and self.config.dtype == "bfloat16" and xt.is_floating_point():
            xt = xt.to(torch.bfloat16)
        return (xt, torch.from_numpy(np.ascontiguousarray(y)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(mask)).to(self.device))

    def _maybe_place_train_data(self):
        """The whole stacked client dataset on the device, once; None with
        ``device_data="off"`` (each round then ships its cohort)."""
        if self.config.device_data == "off":
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

    def _packing_hooks(self) -> Optional[dict]:
        """The packed round's algorithm contract: ``{}`` for the plain
        weighted mean, the hook dict of ``crosssilo_hooks``, or None (logged
        once) when the lane program cannot mirror this subclass: it rewires
        ``build_local_train``, or overrides ``aggregate`` without hooks."""
        name = type(self).__name__
        if type(self).build_local_train is not FedAvgAPI.build_local_train:
            why = f"{name} rewires build_local_train, which the packed lane program cannot mirror"
        else:
            hooks = self.crosssilo_hooks()
            if hooks is not None:
                return hooks
            if type(self).aggregate is FedAvgAPI.aggregate:
                return {}
            why = f"{name} overrides aggregate() without crosssilo hooks"
        if not getattr(self, "_warned_no_pack", False):
            log.warning("pack_lanes=%d ignored: %s", self.config.pack_lanes, why)
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
            log.warning("pack_lanes=%d: the packed schedule runs on data placed on the device; "
                        "with device_data='off' every round runs the plain schedule",
                        c.pack_lanes)
            return None
        self._server_update = hooks.get("server_update")
        return make_packed_cohort_train(
            self.bundle, self.task, int(self.dataset.train_x.shape[1]),
            client_transform=hooks.get("client_transform"),
            reduce_extras=hooks.get("reduce_extras"), **self._local_train_kwargs())

    def packed_status(self) -> dict:
        """Whether the packed schedule applies, and whether a joint
        lowering is active (never: only ``packed_conv="off"`` is ported)."""
        if self.config.pack_lanes <= 0:
            return {"scheduled": False, "packed_conv_active": False, "reason": "pack_lanes=0"}
        if self._packing_hooks() is None:
            return {"scheduled": False, "packed_conv_active": False,
                    "reason": f"{type(self).__name__} has no packed-lane algorithm mirror"}
        if self._packed_train is None:
            return {"scheduled": False, "packed_conv_active": False, "reason": "device_data=off"}
        return {"scheduled": True, "packed_conv_active": False, "reason": "packed_conv=off"}

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

    def _round_orders(self, round_idx: int, cohort: int) -> torch.Tensor:
        """[cohort, epochs, n_pad] per-epoch permutations of every cohort
        position, which the plain and the packed round both train on: each
        position's draws from ``client_generator``, or the order hook's."""
        n_pad = int(self.dataset.train_x.shape[1])
        out = []
        for i in range(cohort):
            if self.order_hook is not None:
                orders = self.order_hook(round_idx, i)
            else:
                g = client_generator(self.config.seed, round_idx, i)
                orders = [torch.randperm(n_pad, generator=g) for _ in range(self.config.epochs)]
            out.append(torch.stack([torch.as_tensor(o, dtype=torch.int64) for o in orders]))
        return torch.stack(out)

    def _run_packed_round(self, sampled: np.ndarray, round_idx: int) -> Optional[PackedResult]:
        """The round under the packed schedule, or None when the cohort has
        no records to train."""
        plan = self._packed_plan(sampled)
        if plan is None:
            return None
        counts = np.asarray(self.dataset.train_counts, np.float32)[sampled]
        tx, ty, tm = self._dev_train
        return self._packed_train(self.variables, tx, ty, tm, sampled, counts,
                                  self._round_orders(round_idx, len(sampled)), plan)

    def sample(self, round_idx: int) -> np.ndarray:
        return sample_clients(round_idx, self._n_total, self._cohort, self.config.seed)

    def round_counts(self, round_idx: int) -> tuple:
        """(real, executed) training examples one epoch of this round
        processes: the cohort's real record counts, and the batch slots the
        live steps execute (padding in each client's last batch included).
        Packed: every lane of every executed plan step, one epoch's share
        rounded to the nearest step."""
        sampled = self.sample(round_idx)
        counts = np.asarray(self.dataset.train_counts, np.int64)[sampled]
        bs = self.config.batch_size
        if self._packed_train is not None:
            plan = self._packed_plan(sampled)
            if plan is not None:
                slots = plan.n_lanes * len(executed_steps(plan.live))
                return int(counts.sum()), int(round(slots / max(self.config.epochs, 1)) * bs)
        return int(counts.sum()), int(sum(-(-int(c) // bs) * bs for c in counts))

    def run_round(self, round_idx: int) -> "float | torch.Tensor":
        """Train one round; returns the count-weighted train loss — a float,
        or with ``config.async_rounds`` a 0-dim device tensor (no host sync)."""
        c = self.config
        sampled = self.sample(round_idx)
        if self._packed_train is not None:
            out = self._run_packed_round(sampled, round_idx)
            if out is not None:
                self.variables, self.server_state = apply_server_and_rollback(
                    self.variables, out.variables, out.extras, out.total, self.server_state,
                    None, self._server_update)
                return out.train_loss if c.async_rounds else float(out.train_loss)
        counts = np.asarray(self.dataset.train_counts, np.int64)[sampled]
        if self._dev_train is not None:
            tx, ty, tm = self._dev_train
            idx = torch.from_numpy(sampled).to(self.device)
            cx, cy, cm = tx[idx], ty[idx], tm[idx]
        else:
            cx, cy, cm, _ = self.dataset.client_slice(sampled)
            cx, cy, cm = self._to_device(cx, cy, cm)
        orders = self._round_orders(round_idx, len(sampled))
        results = [self._local_train(self.variables, cx[i], cy[i], cm[i], int(counts[i]),
                                     orders=orders[i])
                   for i in range(len(sampled))]
        w = torch.as_tensor(counts, dtype=torch.float32, device=self.device)
        losses = torch.stack([r.train_loss for r in results])
        infos = LocalResult(tree_stack([r.variables for r in results]), losses,
                            torch.tensor([r.tau for r in results], device=self.device))
        if counts.sum() > 0:      # else the round keeps weights and server state
            self.variables, self.server_state = self.aggregate(
                self.variables, infos.variables, w, infos, None, self.server_state)
        train_loss = (losses * w).sum() / torch.clamp(w.sum(), min=1e-12)
        return train_loss if c.async_rounds else float(train_loss)

    def evaluate_global(self) -> dict:
        if self._dev_test is None:
            ds = self.dataset
            self._dev_test = self._to_device(ds.test_x, ds.test_y, ds.test_mask, cast=False)
        x, y, m = self._dev_test
        sums = self._eval(self.variables, x, y, m)
        return finalize_metrics({k: v.item() for k, v in sums.items()})

    def train(self) -> dict:
        c = self.config
        t0 = time.perf_counter()
        for r in range(c.comm_round):
            loss = self.run_round(r)
            if r % c.frequency_of_the_test == 0 or r == c.comm_round - 1:
                m = self.evaluate_global()
                self.history["round"].append(r)
                self.history["Test/Acc"].append(m.get("acc"))
                self.history["Test/Loss"].append(m.get("loss"))
                log.info("round %d: train loss %.4f, test acc %.4f",
                         r, float(loss), m.get("acc", float("nan")))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.history["rounds_per_sec"] = c.comm_round / max(time.perf_counter() - t0, 1e-12)
        return self.history
