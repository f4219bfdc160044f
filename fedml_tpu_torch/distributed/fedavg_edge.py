"""Message-driven FedAvg for the network edge (counterpart of
``fedml_tpu/distributed/fedavg_edge.py``; the reference's
fedml_api/distributed/fedavg: FedAvgServerManager.py:18-95,
FedAvgClientManager.py:18-75, FedAVGAggregator.py:13-163,
message_define.py:1-30).

One server (rank 0) and N workers in a star, model weights in messages. A
worker trains the logical clients the server deals it each round (the
reference's re-binding of a worker to sampled clients) through the port's
local-train program (``parallel/local.make_local_train_fn``: on CUDA each
live step a replay of one captured graph, through K1/K2 on a kernel-BN
model) and uploads their sample-weighted mean and total count, so the
server's weighted mean over workers is the weighted mean over the sampled
clients. Beyond the reference protocol, as in the JAX package: a straggler
deadline with dead workers, re-dealt clients, rejoins and stale-upload
drops; a server checkpoint and bit-identical resume (``FTCKPT1``);
error-feedback delta uploads under a lossy wire codec (``wire_delta``);
and a streaming O(1)-memory aggregator (``stream_aggregate``).

**Messages carry host numpy.** The weights on the wire, in the server's
aggregator and in its checkpoint are flat state dicts of numpy arrays; a
worker copies them to its device, trains, and copies the result back.

**Device work runs on one thread.** Rank threads of one process share the
card and, in the in-process launcher, one bundle, whose ``nn.Module`` a
worker loads and trains in place and the server evaluates
(``module.eval()``). A capture also runs in CUDA's global mode, which
another thread's allocation or synchronization invalidates
(``parallel/capture.py``). So every device call of this module (a worker's
local training with its copies in and out, the server's aggregate and
evaluation) is handed to one device thread (:data:`device_call`) and the
caller waits for its result: the calls are serialized as under a lock,
every CUDA call and capture comes from one thread, and on the CPU one
OpenMP team serves them all (a team per rank thread oversubscribes the
cores). The workers sharing a bundle share one local-train program (one
captured graph per step shape, :func:`edge_local_train`) instead of each
capturing its own. A handler waits on the device thread only for its own
call, never for a message, and the device thread never waits on a rank, so
no rank can block another's receive loop. Giving each rank its own module
instead would multiply the captures and their memory by the worker count
and would still need one thread (or a lock) for the global-mode captures.

**Keys.** A worker draws client ``ci``'s orders in round ``r`` from
``core/rng.client_generator(seed, r, ci)`` (and a dropout model's key from
``ops/dropout.client_key``), the port's derivation; the JAX package's
``fold_in(round_key(root, r), ci)`` threefry stream is not reproduced.

**The wire.** ``wire_reliable`` and the ``chaos_*`` fields stack the
reliable and chaos layers over every rank's transport
(``comm/reliable.wire_wrap_factory``); delivery faults then change arrival
order only, and the aggregate does not depend on it, so a run under chaos
equals its run without, bit for bit.

Not ported: the hooks of ROADMAP §1 item 12 (fedlens, the registry, the
tracer, the pulse plane, the flight recorder) and item 11b's gateway; the
wire lane's one counter, ``stale_uploads``, is a plain dict on the server
manager.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.comm import ClientManager, Message, ServerManager
from fedml_tpu_torch.comm.local import run_ranks
from fedml_tpu_torch.comm.message import (MSG_ARG_KEY_CLIENT_INDEX, MSG_ARG_KEY_MODEL_PARAMS,
                                          MSG_ARG_KEY_NUM_SAMPLES)
from fedml_tpu_torch.core.config import check_ported
from fedml_tpu_torch.core.pytree import tree_stack, tree_weighted_mean
from fedml_tpu_torch.core.rng import client_generator, sample_clients
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.distributed.base_framework import (MAX_EMPTY_DEADLINES,
                                                        MSG_TYPE_LOCAL_ROUND_DEADLINE,
                                                        RoundDeadlineTimer, require_injectable)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.ops.dropout import client_key
from fedml_tpu_torch.parallel.local import (finalize_metrics, local_train_kwargs, make_eval_fn,
                                            make_local_train_fn)

log = logging.getLogger(__name__)

# message_define.py:1-30
MSG_TYPE_S2C_INIT_CONFIG = 1
MSG_TYPE_S2C_SYNC_MODEL = 2
MSG_TYPE_C2S_SEND_MODEL = 3
MSG_TYPE_S2C_FINISH = 4
# beyond the reference: a worker announces itself, so a restarted or
# reconnected process re-enters a running federation
MSG_TYPE_C2S_JOIN = 5
#: the server's round index on syncs, echoed by uploads: a stale upload of a
#: worker that fell behind is dropped
MSG_ARG_KEY_ROUND = "round_idx"
#: broadcast generation, bumped by every broadcast and echoed by uploads: a
#: round re-broadcast after an all-fail deadline re-deals its clients, and
#: an upload of the first broadcast must not join the re-dealt copies
MSG_ARG_KEY_GEN = "bcast_gen"
#: with ``wire_delta`` a worker uploads (its mean - the global) plus its
#: error-feedback residual under this key, in place of full weights
MSG_ARG_KEY_MODEL_DELTA = "model_delta"


class _DeviceThread:
    """``device_call(fn, *args, **kw)``: run ``fn`` on the one device thread
    and return its result (or raise its error) in the caller; a call from
    the device thread itself runs in place. The CPU's OpenMP team size is a
    per-thread setting that a thread takes from the process's
    (``torch.set_num_threads``) once, at its first parallel op, so each
    call first brings the device thread's team to the process's current
    size: it follows a later change of the setting as the caller's own
    thread does."""

    def __init__(self):
        self._pool: Optional[ThreadPoolExecutor] = None
        self._ident: Optional[int] = None
        self._lock = threading.Lock()
        self._team = 0

    def __call__(self, fn, *args, **kwargs):
        if threading.get_ident() == self._ident:
            return fn(*args, **kwargs)
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(1, thread_name_prefix="edge-device")
                self._ident = self._pool.submit(threading.get_ident).result()
        return self._pool.submit(self._run, torch.get_num_threads(), fn, args, kwargs).result()

    def _run(self, team: int, fn, args, kwargs):
        if team != self._team:
            torch.set_num_threads(team)
            self._team = team
        return fn(*args, **kwargs)


#: every device call of the edge runtime goes through it (module note)
device_call = _DeviceThread()
_PROGRAMS_LOCK = threading.Lock()

Tree = dict   # a flat state dict of numpy arrays


def host_tree(tree: dict) -> Tree:
    """A state dict of tensors or arrays as numpy arrays (a tensor copied to
    the host; an array as it is)."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in tree.items()}


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array on the host."""
    return t.detach().cpu().numpy()


def device_tensor(a, device: torch.device) -> torch.Tensor:
    """A message's array as a tensor on ``device`` (copied: a received
    array may be read-only)."""
    return torch.from_numpy(np.array(a)).to(device)


def _device_tree(tree: Tree, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in tree.items()}


def _tree_add(a: Tree, b: Tree) -> Tree:
    return {k: np.asarray(a[k]) + np.asarray(b[k]) for k in a}


def _tree_sub(a: Tree, b: Tree) -> Tree:
    return {k: np.asarray(a[k]) - np.asarray(b[k]) for k in a}


def _tensor_addresses(module: torch.nn.Module) -> tuple:
    """Where the module's parameters and buffers live."""
    return tuple(t.data_ptr() for t in module.state_dict(keep_vars=True).values())


def edge_local_train(bundle, dataset, config):
    """The local-train program of ``bundle`` for ``dataset``'s task under
    ``config``'s local training settings, made once and shared by every
    worker of the process that trains this bundle (module note). A captured
    step replays the addresses its capture saw, and ``ModelBundle.init``
    moves the module to the CPU and back (a run's server init does), so a
    program is reused only while the module's tensors stay where they were
    when it was made; otherwise a new one is made in its place."""
    kwargs = local_train_kwargs(config)
    key = (dataset.task, dataset.class_num, *sorted((k, repr(v)) for k, v in kwargs.items()))
    with _PROGRAMS_LOCK:
        programs = bundle.__dict__.setdefault("_edge_local_train", {})
        where = _tensor_addresses(bundle.module)
        if key not in programs or programs[key][0] != where:
            programs[key] = (where, make_local_train_fn(
                bundle, get_task(dataset.task, dataset.class_num), **kwargs))
        return programs[key][1]


class ServerEval:
    """The server's evaluation of a host state dict through ``make_eval_fn``
    on its device: the test set copied there once, the call made on the
    device thread; returns the finalized metrics."""

    def __init__(self, bundle, dataset, device: torch.device):
        self.dataset = dataset
        self.device = device
        self._fn = make_eval_fn(bundle, get_task(dataset.task, dataset.class_num))
        self._test = None

    def __call__(self, variables: Tree) -> dict:
        return finalize_metrics(device_call(self._sums, variables))

    def _sums(self, variables: Tree) -> dict:
        ds = self.dataset
        if self._test is None:
            self._test = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                               for a in (ds.test_x, ds.test_y, ds.test_mask))
        sums = self._fn(_device_tree(variables, self.device), *self._test)
        return {k: v.item() if v.numel() == 1 else v.cpu().numpy() for k, v in sums.items()}


class FedAVGAggregator:
    """Server-side state: collect the workers' results, take their weighted
    mean, sample the cohort (the reference's FedAVGAggregator.py:13-163).
    The aggregate is ``core/pytree.tree_weighted_mean`` on the server's
    device, the simulation's own arithmetic."""

    def __init__(self, variables, worker_num: int, config, dataset=None, bundle=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = default_device(device)
        self.variables: Tree = host_tree(variables)
        self.worker_num = worker_num
        self.config = config
        self.dataset = dataset
        self.model_dict: dict[int, Optional[Tree]] = {}
        self.sample_num_dict: dict[int, float] = {}
        self.flag_client_model_uploaded_dict = {i: False for i in range(worker_num)}
        self.test_history: list[dict] = []
        #: every accepted upload (full participation: rounds x workers)
        self.uploads_accepted = 0
        self._eval = (ServerEval(bundle, dataset, self.device)
                      if bundle is not None and dataset is not None else None)
        if getattr(config, "cohort_policy", "uniform") != "uniform":
            log.warning("cohort_policy=%r ignored on the edge paradigm: the server samples "
                        "uniformly (client_sampling)", config.cohort_policy)

    def get_global_model_params(self) -> Tree:
        return self.variables

    def add_local_trained_result(self, index: int, model_params: Tree, sample_num) -> None:
        self.model_dict[index] = model_params
        self.sample_num_dict[index] = float(sample_num)
        self.flag_client_model_uploaded_dict[index] = True
        self.uploads_accepted += 1

    def check_whether_all_receive(self) -> bool:
        if not all(self.flag_client_model_uploaded_dict.values()):
            return False
        for i in self.flag_client_model_uploaded_dict:
            self.flag_client_model_uploaded_dict[i] = False
        return True

    def aggregate(self) -> Tree:
        order = sorted(self.model_dict)
        counts = [self.sample_num_dict[i] for i in order]
        if not order or float(np.sum(np.asarray(counts, np.float32))) <= 0.0:
            # a zero-weight round (only rejoin catch-ups after an all-fail
            # round) keeps the model, as the simulation's all-fail round does
            self.model_dict.clear()
            return self.variables
        self.variables = device_call(self._weighted_mean, [self.model_dict[i] for i in order],
                                     counts)
        self.model_dict.clear()
        return self.variables

    def _weighted_mean(self, trees: list, counts: list) -> Tree:
        stacked = tree_stack([_device_tree(t, self.device) for t in trees])
        w = torch.as_tensor(counts, dtype=torch.float32, device=self.device)
        return host_tree(tree_weighted_mean(stacked, w))

    def client_sampling(self, round_idx: int, client_num_in_total: int,
                        client_num_per_round: int) -> np.ndarray:
        return sample_clients(round_idx, client_num_in_total, client_num_per_round,
                              seed=self.config.seed)

    def test_on_server_for_all_clients(self, round_idx: int) -> Optional[dict]:
        if self._eval is None:
            return None
        m = self._eval(self.variables)
        m["round"] = round_idx
        self.test_history.append(m)
        return m


class StreamingFedAVGAggregator(FedAVGAggregator):
    """O(1)-memory server aggregation (``core/streaming.StreamAccumulator``):
    each accepted upload folds into one float64 running sum on the host as
    it arrives, and ``model_dict`` keeps index -> None markers, so the
    deadline's received set and the upload count work as for the batch
    aggregator. ``stream_aggregate``: ``deterministic`` folds in worker
    order (the aggregate is independent of arrival order), ``arrival`` at
    once. A second upload of one worker in a round is dropped and counted
    (a fold cannot be undone); stale uploads never reach it."""

    def __init__(self, variables, worker_num: int, config, dataset=None, bundle=None,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(variables, worker_num, config, dataset=dataset, bundle=bundle,
                         device=device)
        from fedml_tpu_torch.core.streaming import StreamAccumulator

        mode = "arrival" if getattr(config, "stream_aggregate", "") == "arrival" \
            else "deterministic"
        self._stream_cls = lambda: StreamAccumulator(mode)
        self._stream = self._stream_cls()
        #: same-round duplicate uploads dropped (first wins)
        self.duplicate_uploads = 0
        #: most out-of-order uploads held at once (deterministic mode)
        self.stream_peak_held = 0

    @property
    def stream_nbytes(self) -> int:
        return self._stream.nbytes

    def add_local_trained_result(self, index: int, model_params: Tree, sample_num) -> None:
        if index in self.model_dict:
            self.duplicate_uploads += 1
            return
        self._stream.add(index, model_params, float(sample_num))
        self.stream_peak_held = max(self.stream_peak_held, self._stream.peak_held)
        self.model_dict[index] = None
        self.sample_num_dict[index] = float(sample_num)
        self.flag_client_model_uploaded_dict[index] = True
        self.uploads_accepted += 1

    def aggregate(self) -> Tree:
        out = self._stream.finalize(self.variables)
        self._stream = self._stream_cls()
        self.model_dict.clear()
        if out is not None:      # None: a zero-weight round keeps the model
            self.variables = out
        return self.variables


def make_aggregator(variables, worker_num: int, config, dataset=None, bundle=None,
                    device: Optional[Union[str, torch.device]] = None) -> FedAVGAggregator:
    """The batch or the streaming aggregator, by ``config.stream_aggregate``."""
    cls = (StreamingFedAVGAggregator if getattr(config, "stream_aggregate", "off") != "off"
           else FedAVGAggregator)
    return cls(variables, worker_num, config, dataset=dataset, bundle=bundle, device=device)


class FedAvgEdgeServerManager(ServerManager):
    """The reference's FedAvgServerManager.py:18-95, with fault-tolerant
    rounds: with ``straggler_deadline_sec`` a round aggregates the uploads
    in by its deadline, a missing worker is marked dead (no more sends to
    it), its logical clients are dealt to the survivors next round, and a
    worker that sends JOIN (or an upload) re-enters."""

    _MAX_EMPTY_DEADLINES = MAX_EMPTY_DEADLINES

    def __init__(self, args, comm, rank, size, aggregator: FedAVGAggregator):
        super().__init__(args, comm, rank, size)
        self.aggregator = aggregator
        self.round_num = int(args.comm_round)
        self.round_idx = 0
        # the image of the downlink the workers train from this round
        # (decoded once at broadcast); delta uploads rebuild against it
        self._downlink_image: Optional[Tree] = None
        cfg = aggregator.config
        self._deadline = getattr(cfg, "straggler_deadline_sec", None)
        self._deadline_timer = None
        if self._deadline is not None:
            require_injectable(comm)
            self._deadline_timer = RoundDeadlineTimer(comm, self._deadline, rank,
                                                      MSG_ARG_KEY_ROUND)
        self._alive = {w: True for w in range(size - 1)}
        #: the wire lane: uploads dropped as stale (a wrong round tag or a
        #: pre-re-deal generation)
        self._wire_lane = {"stale_uploads": 0}
        self._lost_clients: list[int] = []
        self._assignment_map: dict[int, list[int]] = {}
        self._expected: set[int] = set(range(size - 1))
        self._bcast_gen = 0
        # checkpoint and resume: sampling and orders are pure in (seed,
        # round), so the model, the round and the history are the server
        self._ckpt_path = None
        if getattr(cfg, "checkpoint_dir", None):
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)
            self._ckpt_path = os.path.join(cfg.checkpoint_dir, "edge_server.ckpt")
        self._ckpt_freq = int(getattr(cfg, "checkpoint_frequency", 10) or 10)
        if getattr(cfg, "resume_from", None):
            from fedml_tpu_torch.utils.checkpoint import load_checkpoint

            state = load_checkpoint(cfg.resume_from)
            aggregator.variables = host_tree(state["variables"])
            self.round_idx = int(state["round_idx"])
            aggregator.test_history.extend(state["extra"].get("test_history", []))
            log.info("resumed edge federation at round %d from %s", self.round_idx,
                     cfg.resume_from)
        # consecutive deadlines with no upload and no live worker
        self._empty_deadlines = 0

    @property
    def stale_uploads(self) -> int:
        return self._wire_lane["stale_uploads"]

    def run(self):
        self.register_message_receive_handlers()
        if self.round_idx >= self.round_num:      # resumed a finished run
            self._teardown()
            return
        self.send_init_msg()
        self.com_manager.handle_receive_message()

    def _maybe_checkpoint(self):
        if self._ckpt_path is None:
            return
        if self.round_idx % self._ckpt_freq == 0 or self.round_idx >= self.round_num:
            from fedml_tpu_torch.utils.checkpoint import save_checkpoint

            hist = [{k: (float(v) if hasattr(v, "item") else v) for k, v in h.items()}
                    for h in self.aggregator.test_history]
            save_checkpoint(self._ckpt_path, self.aggregator.get_global_model_params(),
                            round_idx=self.round_idx, extra={"test_history": hist})

    def _assignments(self, round_idx: int) -> dict[int, list[int]]:
        """Sample the round's logical clients and deal them round-robin to
        the live workers (clients lost with a dead worker first)."""
        cohort = min(self.args.client_num_per_round, self.args.client_num_in_total)
        sampled = [int(c) for c in self.aggregator.client_sampling(
            round_idx, self.args.client_num_in_total, cohort)]
        if self._lost_clients:
            sampled = [c for c in self._lost_clients if c not in sampled] + sampled
            self._lost_clients = []
        out: dict[int, list[int]] = {w: [] for w in range(self.size - 1)}
        targets = [w for w in out if self._alive[w]]
        if not targets:
            self._lost_clients = sampled     # nobody to run them: carried over
            return out
        for i, c in enumerate(sampled):
            out[targets[i % len(targets)]].append(c)
        return out

    def _mark_dead(self, w: int) -> None:
        if self._alive.get(w, False):
            self._alive[w] = False
            lost = self._assignment_map.get(w, [])
            self._lost_clients.extend(c for c in lost if c not in self._lost_clients)
            log.warning("worker %d marked dead; re-dealing clients %s", w, lost)
        self._expected.discard(w)

    def _arm_timer(self) -> None:
        if self._deadline_timer is not None:
            self._deadline_timer.arm(self.round_idx)

    def _cancel_timer(self) -> None:
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()

    def handle_round_deadline(self, msg: Message) -> None:
        if self._deadline is None or int(msg.get(MSG_ARG_KEY_ROUND)) != self.round_idx:
            return       # a stale timer of a round that completed in time
        received = set(self.aggregator.model_dict)
        for w in sorted(self._expected - received):
            log.warning("round %d: worker %d missed the %.1fs deadline", self.round_idx, w,
                        self._deadline)
            self._mark_dead(w)
        if received:
            self._empty_deadlines = 0
            self._complete_round()
        elif any(self._alive.values()):
            # nobody reported but someone is alive: re-deal and re-sync the
            # same round with the model unchanged
            self._empty_deadlines = 0
            self._assignment_map = self._assignments(self.round_idx)
            self._broadcast_model(MSG_TYPE_S2C_SYNC_MODEL,
                                  self.aggregator.get_global_model_params(),
                                  self._assignment_map)
        else:
            # every worker is dead: wait for a rejoin, a bounded number of times
            self._empty_deadlines += 1
            if self._empty_deadlines >= self._MAX_EMPTY_DEADLINES:
                log.error("round %d: all workers dead for %d consecutive deadlines; tearing "
                          "the federation down with %d/%d rounds done", self.round_idx,
                          self._empty_deadlines, self.round_idx, self.round_num)
                self._teardown()
            else:
                self._arm_timer()

    def _downlink_codec(self) -> Optional[str]:
        """topk compresses uploads (deltas); a sparsified full-weight
        downlink would destroy the model, so syncs then ride raw. q8
        downlinks are fine (delta rebuilds account for them)."""
        return "raw" if getattr(self.aggregator.config, "wire_codec", "raw").startswith("topk") \
            else None

    def _broadcast_model(self, msg_type: int, global_params: Tree, assignments):
        """Send the model to every live worker and cache the decoded image
        they train from."""
        override = self._downlink_codec()
        effective = override or getattr(self.aggregator.config, "wire_codec", "raw")
        if effective != "raw":
            from fedml_tpu_torch.core.compression import decode_tree, encode_tree

            self._downlink_image = decode_tree(encode_tree(global_params, effective))
        else:
            self._downlink_image = global_params
        self._expected = set()
        self._bcast_gen += 1
        msgs = []
        for w in sorted(assignments):
            if not self._alive[w]:
                continue
            m = Message(msg_type, self.rank, w + 1)
            m.codec = override
            m.add_params(MSG_ARG_KEY_MODEL_PARAMS, global_params)
            m.add_params(MSG_ARG_KEY_CLIENT_INDEX, assignments[w])
            m.add_params(MSG_ARG_KEY_ROUND, self.round_idx)
            m.add_params(MSG_ARG_KEY_GEN, self._bcast_gen)
            msgs.append((w, m))
        if self._deadline is not None and len(msgs) > 1:
            # concurrent sends, one thread each: a send to an unreachable
            # peer can block up to the deadline, and W of them in a row
            # would stall the broadcast W deadlines
            with ThreadPoolExecutor(max_workers=len(msgs)) as ex:
                futs = [(w, ex.submit(self.send_message, m)) for w, m in msgs]
                results = [(w, f.exception()) for w, f in futs]
            for w, err in results:
                if err is None:
                    self._expected.add(w)
                else:
                    log.warning("send to worker %d failed (%s)", w, err)
                    self._mark_dead(w)
        else:
            for w, m in msgs:
                try:
                    self.send_message(m)
                except Exception as e:
                    if self._deadline is None:
                        raise
                    log.warning("send to worker %d failed (%s)", w, e)
                    self._mark_dead(w)
                    continue
                self._expected.add(w)
        self._arm_timer()

    def send_init_msg(self):
        # the init carries the round tag: 0 fresh, R on a resume
        self._assignment_map = self._assignments(self.round_idx)
        self._broadcast_model(MSG_TYPE_S2C_INIT_CONFIG, self.aggregator.get_global_model_params(),
                              self._assignment_map)

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_C2S_SEND_MODEL,
                                              self.handle_message_receive_model_from_client)
        self.register_message_receive_handler(MSG_TYPE_C2S_JOIN, self.handle_message_join)
        self.register_message_receive_handler(MSG_TYPE_LOCAL_ROUND_DEADLINE,
                                              self.handle_round_deadline)

    def handle_message_join(self, msg: Message) -> None:
        """A (re)connecting worker. A live worker's JOIN (each sends one at
        start-up in fault-tolerant mode) is ignored; a dead one is revived
        and sent the current model with no clients, to catch up and take
        real work from the next round."""
        if self._deadline is None:
            return
        self._empty_deadlines = 0
        w = msg.get_sender_id() - 1
        if self._alive.get(w, False):
            return
        log.info("worker %d rejoined at round %d", w, self.round_idx)
        self._alive[w] = True
        m = Message(MSG_TYPE_S2C_SYNC_MODEL, self.rank, w + 1)
        m.codec = self._downlink_codec()
        m.add_params(MSG_ARG_KEY_MODEL_PARAMS, self.aggregator.get_global_model_params())
        m.add_params(MSG_ARG_KEY_CLIENT_INDEX, [])
        m.add_params(MSG_ARG_KEY_ROUND, self.round_idx)
        # the current generation, not a bump: the round's uploads stay valid
        m.add_params(MSG_ARG_KEY_GEN, self._bcast_gen)
        try:
            self.send_message(m)
        except Exception as e:
            log.warning("catch-up send to rejoined worker %d failed (%s)", w, e)
            self._alive[w] = False

    def handle_message_receive_model_from_client(self, msg: Message):
        sender = msg.get_sender_id()
        if self._deadline is not None:
            self._empty_deadlines = 0
            w = sender - 1
            if not self._alive.get(w, False):
                # an upload from a worker presumed dead: back from next round
                log.info("worker %d rejoined via upload at round %d", w, self.round_idx)
                self._alive[w] = True
            tag = msg.get(MSG_ARG_KEY_ROUND)
            gen = msg.get(MSG_ARG_KEY_GEN)
            if ((tag is not None and int(tag) != self.round_idx)
                    or (gen is not None and int(gen) != self._bcast_gen)):
                # a late upload of a closed round, or of the broadcast before
                # a re-deal: stale, never aggregated
                self._wire_lane["stale_uploads"] += 1
                return
        payload = msg.get(MSG_ARG_KEY_MODEL_PARAMS)
        if payload is None:
            # a delta upload, rebuilt against the image of the downlink the
            # workers trained from (under a lossy codec it carries the
            # downlink's error, which the worker's residual never sees)
            payload = _tree_add(self._downlink_image, msg.get(MSG_ARG_KEY_MODEL_DELTA))
        self.aggregator.add_local_trained_result(sender - 1, host_tree(payload),
                                                 msg.get(MSG_ARG_KEY_NUM_SAMPLES))
        if self._deadline is not None:
            if not self._expected <= set(self.aggregator.model_dict):
                return
        elif not self.aggregator.check_whether_all_receive():
            return
        self._complete_round()

    def _complete_round(self):
        self._cancel_timer()
        global_params = self.aggregator.aggregate()
        if self._deadline is not None:
            for i in self.aggregator.flag_client_model_uploaded_dict:
                self.aggregator.flag_client_model_uploaded_dict[i] = False
        if self.round_idx % self.args.frequency_of_the_test == 0 \
                or self.round_idx == self.round_num - 1:
            self.aggregator.test_on_server_for_all_clients(self.round_idx)
        self.round_idx += 1
        self._maybe_checkpoint()
        if self.round_idx >= self.round_num:
            self._teardown()
            return
        self._assignment_map = self._assignments(self.round_idx)
        self._broadcast_model(MSG_TYPE_S2C_SYNC_MODEL, global_params, self._assignment_map)

    def _teardown(self):
        """FINISH to every worker, dead-marked ones too: a slow worker that
        was dropped from the rounds must still stop (a send to a truly dead
        peer fails within its timeout and is logged in fault-tolerant
        mode)."""
        self._cancel_timer()
        for rank in range(1, self.size):
            try:
                self.send_message(Message(MSG_TYPE_S2C_FINISH, self.rank, rank))
            except Exception as e:
                if self._deadline is None:
                    raise
                log.warning("FINISH to worker %d failed (%s)", rank - 1, e)
        self.finish()


class FedAVGTrainer:
    """Worker-side trainer (the reference's FedAVGTrainer.py:4-52): the
    shared local-train program (:func:`edge_local_train`) and the logical
    clients the server dealt this round."""

    def __init__(self, dataset, bundle, config,
                 device: Optional[Union[str, torch.device]] = None):
        self.dataset = dataset
        self.bundle = bundle
        self.config = config
        self.device = default_device(device)
        device_call(bundle.module.to, self.device)
        self.local_train = edge_local_train(bundle, dataset, config)
        self.client_indices: list[int] = []

    def update_dataset(self, client_indices) -> None:
        self.client_indices = [int(c) for c in client_indices]

    def train(self, variables: Tree, round_idx: int) -> tuple[Tree, float]:
        """Train each dealt client from the same global weights; returns the
        sample-weighted mean of their results and their total count (the
        worker's partial aggregate)."""
        if not self.client_indices:
            return host_tree(variables), 0.0
        return device_call(self._train, variables, round_idx, list(self.client_indices))

    def _train(self, variables: Tree, round_idx: int, clients: list) -> tuple[Tree, float]:
        c, ds = self.config, self.dataset
        n_pad = int(ds.train_x.shape[1])
        gvars = _device_tree(variables, self.device)
        counts, results = [], []
        for ci in clients:
            x, y, m = (torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                       for a in ds.client_arrays(ci))
            count = int(ds.train_counts[ci])
            g = client_generator(c.seed, round_idx, ci)
            orders = [torch.randperm(n_pad, generator=g) for _ in range(c.epochs)]
            key = client_key(c.seed, round_idx, ci) if self.bundle.uses_dropout else None
            results.append(self.local_train(gvars, x, y, m, count, orders=orders,
                                            key=key).variables)
            counts.append(float(count))
        w = torch.as_tensor(counts, dtype=torch.float32, device=self.device)
        return host_tree(tree_weighted_mean(tree_stack(results), w)), float(sum(counts))


class FedAvgEdgeClientManager(ClientManager):
    """The reference's FedAvgClientManager.py:18-75."""

    def __init__(self, args, comm, rank, size, trainer: FedAVGTrainer):
        super().__init__(args, comm, rank, size)
        self.trainer = trainer
        self.round_idx = 0
        # the error-feedback residual of delta uploads (per worker, as in
        # DGC: the compressed stream is this worker's uploads)
        self._residual: Optional[Tree] = None
        self._residual_round: Optional[int] = None
        # fault-tolerant mode: announce at start-up, so a restarted worker
        # re-enters a running federation
        self._ft = getattr(trainer.config, "straggler_deadline_sec", None) is not None
        self._bcast_gen = None
        # the residual is worker state the protocol never ships: kept beside
        # the server's checkpoint, so a resumed run is bit-identical
        cfg = trainer.config
        self._res_path = None
        if getattr(cfg, "checkpoint_dir", None) and getattr(cfg, "wire_delta", False):
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)
            self._res_path = os.path.join(cfg.checkpoint_dir, f"edge_worker_{rank}.residual")
            if getattr(cfg, "resume_from", None) and os.path.exists(self._res_path):
                from fedml_tpu_torch.core.serialization import tree_from_bytes

                with open(self._res_path, "rb") as f:
                    state = tree_from_bytes(f.read())
                self._residual = state["residual"]
                # the round it feeds; a server resumed from an older
                # checkpoint makes the tag a future one, discarded at sync
                self._residual_round = int(np.asarray(state["round"]).item())
                log.info("rank %d resumed error-feedback residual for round %d", rank,
                         self._residual_round)

    def run(self):
        self.register_message_receive_handlers()
        if self._ft:
            # best effort: the server ignores a live worker's JOIN, and its
            # init waits for this rank anyway
            try:
                self.send_message(Message(MSG_TYPE_C2S_JOIN, self.rank, 0))
            except Exception as e:
                log.warning("startup JOIN failed (%s); waiting for init", e)
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init)
        self.register_message_receive_handler(MSG_TYPE_S2C_SYNC_MODEL,
                                              self.handle_message_receive_model_from_server)
        self.register_message_receive_handler(MSG_TYPE_S2C_FINISH, self.handle_message_finish)

    def handle_message_init(self, msg: Message):
        self.round_idx = 0
        self._train_and_send(msg)

    def handle_message_receive_model_from_server(self, msg: Message):
        self.round_idx += 1
        self._train_and_send(msg)

    def handle_message_finish(self, msg: Message):
        self.finish()

    def _train_and_send(self, msg: Message):
        # the server's round tag drives the orders (the local counter in a
        # healthy run; the right round after a missed one or a rejoin)
        tag = msg.get(MSG_ARG_KEY_ROUND)
        if tag is not None:
            self.round_idx = int(tag)
        self._bcast_gen = msg.get(MSG_ARG_KEY_GEN)
        self.trainer.update_dataset(msg.get(MSG_ARG_KEY_CLIENT_INDEX))
        variables = host_tree(msg.get(MSG_ARG_KEY_MODEL_PARAMS))
        new_vars, n = self.trainer.train(variables, self.round_idx)
        out = Message(MSG_TYPE_C2S_SEND_MODEL, self.rank, 0)
        out.add_params(MSG_ARG_KEY_ROUND, self.round_idx)
        if self._bcast_gen is not None:
            out.add_params(MSG_ARG_KEY_GEN, self._bcast_gen)
        cfg = self.trainer.config
        if getattr(cfg, "wire_delta", False) and n > 0:
            out.add_params(MSG_ARG_KEY_MODEL_DELTA, self._delta(new_vars, variables))
        else:
            # full weights; a zero-weight upload (a rejoin's catch-up, no
            # clients) leaves the residual for the next real round
            out.add_params(MSG_ARG_KEY_MODEL_PARAMS, new_vars)
        out.add_params(MSG_ARG_KEY_NUM_SAMPLES, n)
        self.send_message(out)

    def _delta(self, new_vars: Tree, variables: Tree) -> Tree:
        """(new - received) plus the error-feedback residual; under a lossy
        codec the residual becomes what the codec will drop of it."""
        d = _tree_sub(new_vars, variables)
        if self._residual_round is not None:
            # only a future tag is discarded (the server resumed from an
            # older checkpoint); a past one is normal after zero-weight
            # uploads held the residual back
            if self._residual_round > self.round_idx:
                log.warning("rank %d: resumed residual targets future round %d but the "
                            "federation is at round %d; discarding it", self.rank,
                            self._residual_round, self.round_idx)
                self._residual = None
            self._residual_round = None
        if self._residual is not None:
            d = _tree_add(d, self._residual)
        codec = getattr(self.trainer.config, "wire_codec", "raw")
        if codec != "raw":
            from fedml_tpu_torch.core.compression import decode_tree, encode_tree

            self._residual = _tree_sub(d, decode_tree(encode_tree(d, codec)))
            if self._res_path is not None:
                from fedml_tpu_torch.core.serialization import tree_to_bytes

                tmp = self._res_path + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(tree_to_bytes({"residual": self._residual,
                                           "round": np.int64(self.round_idx + 1)}))
                os.replace(tmp, self._res_path)
        return d


def _edge_args(config, dataset):
    """The small arg bag the managers read (the reference passes its
    argparse namespace)."""

    class Args:
        pass

    args = Args()
    args.comm_round = config.comm_round
    args.client_num_in_total = min(config.client_num_in_total, dataset.num_clients)
    args.client_num_per_round = min(config.client_num_per_round, args.client_num_in_total)
    args.frequency_of_the_test = config.frequency_of_the_test
    return args


def _bundle(dataset, config):
    return create_model(config.model, dataset.class_num,
                        input_shape=dataset.train_x.shape[2:] or None)


def build_edge_rank(dataset, config, rank: int, world_size: int, comm, bundle=None,
                    aggregator: Optional[FedAVGAggregator] = None,
                    device: Optional[Union[str, torch.device]] = None):
    """One rank's manager. The model's initial weights and every draw of
    the federation derive from ``config.seed``, so separate processes build
    the same state (the reference's every-rank-builds-everything pattern).
    ``bundle`` and ``aggregator`` let ranks of one process share them; a
    per-process caller leaves them out."""
    bundle = bundle or _bundle(dataset, config)
    args = _edge_args(config, dataset)
    if rank == 0:
        if aggregator is None:
            aggregator = make_aggregator(bundle.init(config.seed, device), world_size - 1,
                                         config, dataset=dataset, bundle=bundle, device=device)
        return FedAvgEdgeServerManager(args, comm, 0, world_size, aggregator)
    trainer = FedAVGTrainer(dataset, bundle, config, device=device)
    return FedAvgEdgeClientManager(args, comm, rank, world_size, trainer)


#: wire counters whose nonzero value is worth a log line at the end of a run
WIRE_ANOMALIES = ("wire/retransmits", "wire/retransmit_errors", "wire/gave_up",
                  "wire/dup_dropped", "wire/stale_uploads")


def log_wire_anomalies(stats: dict) -> None:
    if any(stats.get(k, 0) for k in WIRE_ANOMALIES) or any(
            k.startswith("chaos/") and v for k, v in stats.items()):
        log.info("wire stats: %s", stats)


def release_wire(comms) -> None:
    """Stop every rank's wire stack once the federation is over, and wait
    for each reliable layer's drain: a rank whose receive loop ended
    without its ``finish()`` (a chaos crash-stop) still holds a reliable
    layer whose retransmit thread only a stop ends, and no thread of a
    layer outlives the run. A rank that finished is stopped already, and a
    second stop is a no-op or a refusal logged here."""
    from fedml_tpu_torch.comm.base import find_layer
    from fedml_tpu_torch.comm.reliable import ReliableCommManager

    for c in comms:
        try:
            c.stop_receive_message()
        except Exception as e:   # a transport already torn down
            log.debug("stopping a finished rank's transport: %s", e)
    for c in comms:
        layer = find_layer(c, ReliableCommManager)
        if layer is not None and not layer.join(timeout=layer.drain_timeout_s + 1.0):
            log.warning("rank %d: the wire's retransmit thread outlived its drain", layer.rank)


def _summary_wire_stats(aggregator, comms, server) -> None:
    """``aggregator.wire_stats``: the wire stacks' counters and the server's
    wire lane (``wire/stale_uploads``)."""
    from fedml_tpu_torch.utils.metrics import merge_wire_stats

    stats = merge_wire_stats(comms)
    for k, v in server._wire_lane.items():
        stats[f"wire/{k}"] = stats.get(f"wire/{k}", 0) + v
    aggregator.wire_stats = stats
    log_wire_anomalies(stats)


def run_fedavg_edge(dataset, config, worker_num: int, wire_roundtrip: bool = True,
                    comm_factory=None, timeout: float = 300.0, bundle=None,
                    device: Optional[Union[str, torch.device]] = None) -> FedAVGAggregator:
    """In-process launch: the server and ``worker_num`` workers on threads
    over the local transport (the reference's mpirun path) or another
    (``comm_factory``, e.g. gRPC loopback or MQTT). ``bundle`` defaults to
    ``config.model``'s. Runs on the GPU unless ``device`` says otherwise.
    Returns the server's aggregator: the final global weights (numpy) and
    the test history."""
    check_ported(config)
    dev = default_device(device)
    bundle = bundle or _bundle(dataset, config)
    size = worker_num + 1
    aggregator = make_aggregator(bundle.init(config.seed, dev), worker_num, config,
                                 dataset=dataset, bundle=bundle, device=dev)

    def make(rank, comm):
        return build_edge_rank(dataset, config, rank, size, comm, bundle=bundle,
                               aggregator=aggregator, device=dev)

    from fedml_tpu_torch.comm.reliable import wire_wrap_factory

    wrap = wire_wrap_factory(config)
    managers = run_ranks(make, size, wire_roundtrip=wire_roundtrip, comm_factory=comm_factory,
                         timeout=timeout, codec=config.wire_codec, wrap=wrap,
                         inbox_cap=config.wire_inbox_cap)
    comms = [m.com_manager for m in managers]
    if wrap is not None:
        release_wire(comms)
    _summary_wire_stats(aggregator, comms, managers[0])
    return aggregator


def run_fedavg_edge_rank(dataset, config, device: Optional[Union[str, torch.device]] = None
                         ) -> Optional[FedAVGAggregator]:
    """Run this process as one rank of a multi-process gRPC federation (the
    reference's per-process launch, ``mpirun -np N python main_fedavg.py``),
    rank -> IP from ``config.grpc_ipconfig_path`` (the reference's
    grpc_ipconfig.csv). Blocks until the federation ends; returns the
    aggregator on rank 0, None on a worker."""
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

    check_ported(config)
    if config.rank is None or config.world_size is None:
        raise ValueError("per-rank deployment needs config.rank and config.world_size")
    if config.backend.lower() not in ("grpc", "mesh"):
        raise ValueError(f"per-rank deployment runs over gRPC; got backend={config.backend!r}")
    dev = default_device(device)
    deadline = config.straggler_deadline_sec
    comm = GRPCCommManager(
        config.rank, config.world_size, ip_config_path=config.grpc_ipconfig_path,
        base_port=config.grpc_base_port, codec=config.wire_codec,
        # a fault-tolerant server fails a send it cannot deliver within the
        # deadline, so the round marks the worker dead; workers keep the
        # long default (their sends go to the server; start order is free)
        send_timeout=deadline if deadline is not None and config.rank == 0 else 120.0,
        inbox_cap=config.wire_inbox_cap)
    from fedml_tpu_torch.comm.reliable import wire_wrap_factory

    wrap = wire_wrap_factory(config)
    if wrap is not None:
        comm = wrap(config.rank, comm)
    manager = build_edge_rank(dataset, config, config.rank, config.world_size, comm,
                              device=dev)
    log.info("rank %d/%d entering run loop (grpc base port %d)", config.rank,
             config.world_size, config.grpc_base_port)
    manager.run()
    if wrap is not None:
        release_wire([comm])
    if config.rank != 0:
        # each process sees only its own wire stack, so every rank reports
        # its counters (an uplink's loss shows in the worker's log)
        from fedml_tpu_torch.utils.metrics import wire_stats

        stats = wire_stats(comm)
        if stats:
            log.info("rank %d wire stats: %s", config.rank, stats)
        return None
    _summary_wire_stats(manager.aggregator, [comm], manager)
    return manager.aggregator
