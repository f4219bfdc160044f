"""Message-driven FedBuff: asynchronous buffered aggregation at the edge
(counterpart of ``fedml_tpu/distributed/fedbuff_edge.py``).

The synchronous edge (``distributed/fedavg_edge.py``) broadcasts a model a
round and waits on a barrier or a straggler deadline. Here there are no
rounds on the wire:

- the server answers each accepted upload at once (``buffer_mode=arrival``)
  with the current model version and the worker's next assignment, so a
  fast worker loops at its own pace and a slow one contributes later with a
  staleness-decayed weight (``algorithms/fedbuff.py``);
- a version is emitted every ``buffer_k`` folds, and the per-version
  evaluation hangs off the emission. A BN running variance that a stale
  delta carries below 0 (where the JAX package's emission evaluates NaN)
  takes the weighted mean of the uploads' own variances instead
  (:meth:`FedBuffAggregator.emit`);
- a crash-stopped worker is ejected when the reliable layer gives up on it
  (``on_gave_up``, re-entered as a local ``PEER_GAVE_UP`` event on the
  server's own receive loop), never by discarding its contributions; a
  revived worker re-enters by JOIN or by its own retransmitted upload and
  folds with the staleness its lag earned;
- ``buffer_mode=deterministic`` folds through the canonical ``(train tag,
  worker)`` frontier instead, and replies flush when the buffer emits, so
  the whole schedule (fold order, version membership, staleness, weights)
  is a function of ``(seed, chaos_seed)`` and replays bit for bit under
  drop, dup, delay and crash-stop chaos. With ``buffer_k`` equal to the
  worker count it is synchronous FedAvg (the sync-equivalence pin). A
  stalled frontier re-sends the blocking worker's assignment on a probe
  timer, so a crash that left nothing unacked still reaches the gave-up
  oracle and emission never waits on a dead worker.

Assignments come from ``data/sched.CohortScheduler``: the sweep tag is the
scheduler's round, and worker ``w`` takes ``cohort[w::workers]`` of the
tag's cohort, a function of ``(seed, tag, w)`` and not of who is alive.

Device work is the FedAvg edge's: a worker trains its assignment through
``fedavg_edge.FedAVGTrainer.train(variables, round_idx=tag)`` (the shared
local-train program: on CUDA a captured step, through K1/K2 on a kernel-BN
model) and uploads the update delta; the server evaluates each version on
its device. Every device call goes through ``fedavg_edge.device_call``, and
messages carry host numpy state dicts.

Not ported: the pulse plane, fedlens and the flight recorder of ROADMAP §1
item 12 (the JAX manager's per-fold pulse and lens feeds, the per-version
pulse snapshot and the flight-dump handler); their fields stay refused by
``FedConfig``, so they are off.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.algorithms.fedbuff import DeterministicFrontier, FedBuffBuffer
from fedml_tpu_torch.comm import ClientManager, Message, ServerManager
from fedml_tpu_torch.comm.base import find_layer
from fedml_tpu_torch.comm.chaos import find_chaos
from fedml_tpu_torch.comm.local import run_ranks
from fedml_tpu_torch.comm.message import (MSG_ARG_KEY_CLIENT_INDEX, MSG_ARG_KEY_MODEL_PARAMS,
                                          MSG_ARG_KEY_NUM_SAMPLES)
from fedml_tpu_torch.comm.reliable import ReliableCommManager, retry_budget_s, wire_wrap_factory
from fedml_tpu_torch.core.config import check_ported
from fedml_tpu_torch.core.streaming import StreamAccumulator
from fedml_tpu_torch.data.sched import CohortScheduler
from fedml_tpu_torch.distributed.base_framework import require_injectable
from fedml_tpu_torch.distributed.fedavg_edge import (MSG_ARG_KEY_MODEL_DELTA, FedAVGTrainer,
                                                     ServerEval, Tree, _bundle, _edge_args,
                                                     host_tree, log_wire_anomalies, release_wire)
from fedml_tpu_torch.models.norm import running_variance_names

log = logging.getLogger(__name__)

# the protocol: fedavg_edge's numbering and the asynchronous additions
MSG_TYPE_S2C_INIT_CONFIG = 1
MSG_TYPE_S2C_SYNC_MODEL = 2
MSG_TYPE_C2S_SEND_MODEL = 3
MSG_TYPE_S2C_FINISH = 4
MSG_TYPE_C2S_JOIN = 5
# local control events, put into the server's own receive queue (they never
# cross the wire, and are handled in turn with the messages)
MSG_TYPE_LOCAL_PEER_GAVE_UP = 98
MSG_TYPE_LOCAL_STALL_PROBE = 97

#: the model version an assignment carries and its upload echoes as the one
#: it trained from: the server's version minus it is the staleness
MSG_ARG_KEY_VERSION = "model_version"
#: the worker's assignment tag: the client orders' round, the frontier's
#: canonical order, and the exactly-once guard of uploads
MSG_ARG_KEY_TRAIN_TAG = "train_tag"
#: the rank a local control event is about
MSG_ARG_KEY_PEER = "peer_rank"

#: the stall probe's cadence without ``straggler_deadline_sec`` (with it,
#: the deadline is the cadence); either is floored above the wire's retry
#: budget, so a probe never re-sends what the original could still deliver
DEFAULT_PROBE_SEC = 3.0


def _probe_interval(config) -> float:
    base = float(getattr(config, "straggler_deadline_sec", None) or DEFAULT_PROBE_SEC)
    if getattr(config, "wire_reliable", False):
        return max(base, 1.25 * retry_budget_s(config))
    return base


class FedBuffAggregator:
    """The server's state: the versioned buffer and the evaluation, with
    the attributes of ``fedavg_edge.FedAVGAggregator`` that launchers read
    (``variables``, ``test_history``, ``wire_stats``)."""

    def __init__(self, variables, worker_num: int, config, dataset=None, bundle=None,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = default_device(device)
        self.variables: Tree = host_tree(variables)
        self.worker_num = worker_num
        self.config = config
        self.dataset = dataset
        self.buffer = FedBuffBuffer(int(getattr(config, "buffer_k", 4)),
                                    float(getattr(config, "buffer_staleness_alpha", 0.5)))
        self.mode = getattr(config, "buffer_mode", "arrival")
        self.test_history: list[dict] = []
        #: uploads the (worker, tag) guard dropped: a retransmit across a
        #: version, a copy from before a rejoin; never folded twice
        self.duplicate_uploads = 0
        #: ejected workers that came back (JOIN or upload)
        self.rejoins = 0
        self._eval = (ServerEval(bundle, dataset, self.device)
                      if bundle is not None and dataset is not None else None)
        #: the model's BN running variances, kept ``>= 0`` (:meth:`emit`)
        self.variance_leaves = running_variance_names(bundle.module) if bundle is not None else []
        #: variance floats an emission took from the folded values (:meth:`emit`)
        self.variances_from_values = 0
        self._values = StreamAccumulator("arrival")
        #: version -> its running variances, for the versions an upload can
        #: still have trained from (:meth:`forget_versions`)
        self._variances_at = {0: self._variances(self.variables)}

    def _variances(self, tree: Tree) -> Tree:
        return {k: tree[k] for k in self.variance_leaves}

    def fold(self, delta: Tree, n: float, trained_version: int) -> dict:
        """Fold one upload (``FedBuffBuffer.fold``) and return its record;
        beside it, the upload's BN running variances by value (the trained
        version's plus the delta) with the same weight, for :meth:`emit`."""
        rec = self.buffer.fold(delta, n, trained_version)
        if self.variance_leaves:
            base = self._variances_at.get(int(trained_version))
            if base is None:   # not kept: the current variances stand in
                log.warning("no running variances kept for version %d; folding the current "
                            "ones", trained_version)
                values = self._variances(self.variables)
            else:
                values = {k: base[k] + delta[k] for k in self.variance_leaves}
            self._values.add(self.buffer.folds - 1, values, rec["weight"])
        return rec

    def emit(self) -> dict:
        """Close the pending buffer into the next version
        (``FedBuffBuffer.emit``: the old weights plus the weighted mean
        delta) and return its record. A stale delta of a BN running
        variance, added to a version whose variance has since shrunk, can
        carry it below 0, where the evaluation's ``rsqrt(var + eps)`` is
        NaN (the JAX package's emission does so; ROADMAP §3). Each such
        float takes the weighted mean of the folded variances instead (each
        upload's own, a variance); every other float is the emission's."""
        params, rec = self.buffer.emit(self.variables)
        if self.variance_leaves:
            values = self._values.finalize(self._variances(params))
            self._values = StreamAccumulator("arrival")
            for k in self.variance_leaves:
                neg = params[k] < 0
                if values is not None and neg.any():
                    self.variances_from_values += int(neg.sum())
                    params[k] = np.where(neg, values[k], params[k])
            self._variances_at[self.buffer.version] = self._variances(params)
        self.variables = params
        return rec

    def forget_versions(self, live) -> None:
        """Drop the variances of versions no upload can have trained from
        any more (``live``: the versions of the assignments out, and the
        current one)."""
        for v in [v for v in self._variances_at if v not in live]:
            del self._variances_at[v]

    @property
    def uploads_folded(self) -> int:
        return self.buffer.folds

    @property
    def versions_emitted(self) -> int:
        return self.buffer.versions_emitted

    def test_on_server(self, version_idx: int) -> Optional[dict]:
        if self._eval is None:
            return None
        m = self._eval(self.variables)
        m["round"] = version_idx
        self.test_history.append(m)
        return m


class FedBuffEdgeServerManager(ServerManager):
    """The asynchronous server (module note): a version every K folds,
    replies per upload (arrival) or at emission (deterministic)."""

    def __init__(self, args, comm, rank, size, aggregator: FedBuffAggregator):
        super().__init__(args, comm, rank, size)
        self.aggregator = aggregator
        self.buffer = aggregator.buffer
        self.versions_total = int(args.comm_round)
        self.workers = size - 1
        cfg = aggregator.config
        self.deterministic = aggregator.mode == "deterministic"
        cohort = min(args.client_num_per_round, args.client_num_in_total)
        self.scheduler = CohortScheduler(getattr(cfg, "cohort_policy", "uniform"), cfg.seed,
                                         args.client_num_in_total, cohort)
        self._alive = {w: True for w in range(self.workers)}
        self._finished = False
        #: arrival mode: the tag expected next of each worker (the
        #: exactly-once guard); deterministic mode reads the frontier's
        self._expected = {w: 0 for w in range(self.workers)}
        self.frontier = DeterministicFrontier(range(self.workers)) if self.deterministic else None
        #: each worker's last assignment sent: (tag, version, params). A
        #: resend repeats it, or a resend racing its original could hand the
        #: worker a newer model and make the folded delta depend on arrival
        self._last_sent: dict[int, tuple] = {}
        #: deterministic mode: the workers whose folds are in the pending
        #: buffer; their replies flush when it emits (the one canonical
        #: point; at buffer_k == workers, the synchronous broadcast)
        self._pending_replies: list[int] = []
        if self.deterministic and self.buffer.k > self.workers:
            raise ValueError(f"buffer_mode=deterministic needs buffer_k <= workers "
                             f"({self.buffer.k} > {self.workers}): replies flush at emission, "
                             "so a buffer needing more folds than there are workers never fills")
        self._probe_sec = _probe_interval(cfg)
        self._probe_timer: Optional[threading.Timer] = None
        if self.deterministic:
            require_injectable(comm, feature="buffer_mode=deterministic")
        # the ejection oracle: the reliable layer names the peer it gave up
        # on, and the event re-enters on this server's own loop
        reliable = find_layer(comm, ReliableCommManager)
        if reliable is not None:
            reliable.on_gave_up = self._on_gave_up

    # -- lifecycle -------------------------------------------------------
    def run(self):
        self.register_message_receive_handlers()
        for w in range(self.workers):
            self._send_assignment(w, 0, msg_type=MSG_TYPE_S2C_INIT_CONFIG)
        self._arm_probe()
        try:
            self.com_manager.handle_receive_message()
        finally:
            # every exit drops the probe timer, whose closure would keep
            # this manager alive
            self._finished = True
            self._cancel_probe()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_C2S_SEND_MODEL, self.handle_upload)
        self.register_message_receive_handler(MSG_TYPE_C2S_JOIN, self.handle_join)
        self.register_message_receive_handler(MSG_TYPE_LOCAL_PEER_GAVE_UP,
                                              self.handle_peer_gave_up)
        self.register_message_receive_handler(MSG_TYPE_LOCAL_STALL_PROBE,
                                              self.handle_stall_probe)

    def _teardown(self):
        self._finished = True
        self._cancel_probe()
        for rank in range(1, self.size):
            try:
                self.send_message(Message(MSG_TYPE_S2C_FINISH, self.rank, rank))
            except Exception as e:   # a dead worker must not block teardown
                log.warning("FINISH to worker %d failed (%s)", rank - 1, e)
        self.finish()

    # -- assignments -----------------------------------------------------
    def _assignment(self, worker: int, tag: int) -> list[int]:
        """Worker ``worker``'s slice of the tag's cohort, whoever is alive
        (with every worker alive, fedavg_edge's round-robin deal)."""
        cohort = self.scheduler.sample(int(tag))
        return [int(c) for c in cohort[worker::self.workers]]

    def _send_assignment(self, worker: int, tag: int, msg_type: int = MSG_TYPE_S2C_SYNC_MODEL,
                         resend: bool = False) -> None:
        """Send a worker its (model, version, tag, clients). ``resend`` (the
        stall probe, an alive worker's JOIN) repeats the last content sent
        for that tag as it was."""
        cached = self._last_sent.get(worker)
        if resend and cached is not None and cached[0] == int(tag):
            _tag, version, params = cached
        else:
            version, params = self.buffer.version, self.aggregator.variables
        ids = self._assignment(worker, tag)
        m = Message(msg_type, self.rank, worker + 1)
        m.add_params(MSG_ARG_KEY_MODEL_PARAMS, params)
        m.add_params(MSG_ARG_KEY_CLIENT_INDEX, ids)
        m.add_params(MSG_ARG_KEY_VERSION, version)
        m.add_params(MSG_ARG_KEY_TRAIN_TAG, int(tag))
        try:
            self.send_message(m)
        except Exception as e:
            # the transport declared the peer gone: eject it through the
            # injected event, after the handler that runs now
            log.warning("assignment to worker %d failed (%s)", worker, e)
            self._on_gave_up(worker + 1, m)
            return
        self._last_sent[worker] = (int(tag), version, params)

    # -- uploads ---------------------------------------------------------
    def handle_upload(self, msg: Message) -> None:
        if self._finished:
            return
        w = msg.get_sender_id() - 1
        tag = int(msg.get(MSG_ARG_KEY_TRAIN_TAG))
        item = (msg.get(MSG_ARG_KEY_MODEL_DELTA), float(msg.get(MSG_ARG_KEY_NUM_SAMPLES)),
                int(msg.get(MSG_ARG_KEY_VERSION)))
        if not self._alive.get(w, False):
            # an upload of a worker taken for dead is its rejoin, and it is
            # used: staleness weighting exists so that late work counts
            log.info("worker %d rejoined via upload (tag %d)", w, tag)
            self._alive[w] = True
            self.aggregator.rejoins += 1
            if self.deterministic and self.frontier.next_tag(w) is None:
                self.frontier.admit(w, tag)
        if self.deterministic:
            if not self.frontier.offer(w, tag, item):
                self.aggregator.duplicate_uploads += 1
                return
            self._advance()
        else:
            if tag != self._expected.get(w):
                self.aggregator.duplicate_uploads += 1
                return
            self._expected[w] = tag + 1
            self._fold(w, item)
            if not self._finished:
                self._send_assignment(w, tag + 1)

    def _fold(self, worker: int, item) -> None:
        delta, n, trained_v = item
        self.aggregator.fold(host_tree(delta), n, trained_v)
        if self.deterministic:
            self._pending_replies.append(worker)
        if self.buffer.ready:
            self._emit()

    def _advance(self) -> None:
        """Deterministic mode: fold the frontier in canonical order; the
        replies flush in :meth:`_emit`."""
        for w, _tag, item in self.frontier.drain():
            self._fold(w, item)
            if self._finished:
                return
        self._arm_probe()

    # -- emission --------------------------------------------------------
    def _emit(self) -> None:
        self.aggregator.emit()
        self.aggregator.forget_versions({self.buffer.version}
                                        | {v for _t, v, _p in self._last_sent.values()})
        v_idx = self.buffer.versions_emitted - 1   # 0-based, as rounds
        if v_idx % self.args.frequency_of_the_test == 0 or v_idx == self.versions_total - 1:
            self.aggregator.test_on_server(v_idx)
        self.scheduler.notify_round_done(v_idx)
        if self.buffer.versions_emitted >= self.versions_total:
            self._teardown()
            return
        if self.deterministic:
            # release the emitted buffer's workers (an ejected one is skipped)
            released, self._pending_replies = self._pending_replies, []
            for w in released:
                if self._alive.get(w, False):
                    self._send_assignment(w, self.frontier.next_tag(w))

    # -- ejection and liveness -------------------------------------------
    def _on_gave_up(self, receiver: int, msg: Message) -> None:
        """The reliable layer's hook (on its retransmit thread): re-enter as
        a local event, so the ejection runs in turn with the handlers."""
        if self._finished or receiver == 0:
            return
        m = Message(MSG_TYPE_LOCAL_PEER_GAVE_UP, self.rank, self.rank)
        m.add_params(MSG_ARG_KEY_PEER, int(receiver))
        try:
            self.com_manager.inject_local(m)
        except Exception as e:   # the loop is torn down already
            log.debug("gave-up injection failed (%s)", e)

    def handle_peer_gave_up(self, msg: Message) -> None:
        if not self._finished:
            self._eject(int(msg.get(MSG_ARG_KEY_PEER)) - 1)

    def _eject(self, worker: int) -> None:
        if not self._alive.get(worker, False):
            return
        log.warning("worker %d ejected (gave-up/unreachable); its pending slots stop gating "
                    "version emission", worker)
        self._alive[worker] = False
        if self.deterministic:
            self.frontier.eject(worker)
            # drop a reply the pending buffer owes it: a JOIN's assignment
            # must be the only one for its tag
            self._pending_replies = [w for w in self._pending_replies if w != worker]
        if not any(self._alive.values()):
            log.error("every worker is dead; tearing down with %d/%d versions emitted",
                      self.buffer.versions_emitted, self.versions_total)
            self._teardown()
            return
        if self.deterministic:
            if len(self.frontier.admitted) < self.buffer.k:
                # fewer admitted workers than a buffer needs folds: it can
                # never fill
                log.error("admitted workers (%d) dropped below buffer_k (%d); tearing down "
                          "with %d/%d versions emitted", len(self.frontier.admitted),
                          self.buffer.k, self.buffer.versions_emitted, self.versions_total)
                self._teardown()
                return
            self._advance()   # the dead worker may have held the head

    def handle_join(self, msg: Message) -> None:
        """A (re)connecting worker. An ejected one is re-admitted at the
        current sweep with a fresh assignment (its pre-crash upload, if it
        lands, meets the exactly-once guard). An alive worker's JOIN means
        it starved (it JOINs only after long silence or a revival): arrival
        mode re-sends its pending assignment; deterministic mode does not
        answer at a time set by arrival, and its stall probe re-sends the
        head's assignment instead."""
        w = msg.get_sender_id() - 1
        if self._finished:
            return
        if self._alive.get(w, False):
            if not self.deterministic:
                log.info("alive worker %d JOINed (starved/revived); re-sending its pending "
                         "assignment tag %d", w, self._expected[w])
                self._send_assignment(w, self._expected[w], resend=True)
            return
        self._alive[w] = True
        self.aggregator.rejoins += 1
        if self.deterministic:
            tag = max([self.frontier.next_tag(x) for x in self.frontier.admitted] or [0])
            self.frontier.admit(w, tag)
        else:
            tag = self._expected[w]
        log.info("worker %d rejoined via JOIN; re-admitted at tag %d", w, tag)
        self._send_assignment(w, tag)

    # -- the frontier's stall probe --------------------------------------
    def _arm_probe(self) -> None:
        """Deterministic mode: while the frontier waits on a slot, re-send
        its owner's assignment on a timer. A live worker's duplicate upload
        meets the exactly-once guard; to a dead one the resend's retries run
        out and the gave-up path ejects it."""
        if not self.deterministic or self._finished:
            return
        self._cancel_probe()
        head = self.frontier.head()
        if head is None:
            return
        m = Message(MSG_TYPE_LOCAL_STALL_PROBE, self.rank, self.rank)
        m.add_params(MSG_ARG_KEY_PEER, head[1] + 1)
        m.add_params(MSG_ARG_KEY_TRAIN_TAG, head[0])

        def fire():
            try:
                self.com_manager.inject_local(m)
            except Exception as e:
                log.debug("stall-probe injection failed (%s)", e)

        t = threading.Timer(self._probe_sec, fire)
        t.daemon = True
        t.start()
        self._probe_timer = t

    def _cancel_probe(self) -> None:
        if self._probe_timer is not None:
            self._probe_timer.cancel()
            self._probe_timer = None

    def handle_stall_probe(self, msg: Message) -> None:
        if self._finished or not self.deterministic:
            return
        head = self.frontier.head()
        probed = (int(msg.get(MSG_ARG_KEY_TRAIN_TAG)), int(msg.get(MSG_ARG_KEY_PEER)) - 1)
        if head == probed and self._alive.get(probed[1], False):
            log.info("frontier stalled on worker %d (tag %d) for %.1fs; re-sending its "
                     "assignment", probed[1], probed[0], self._probe_sec)
            self._send_assignment(probed[1], probed[0], resend=True)
        self._arm_probe()


class FedBuffEdgeClientManager(ClientManager):
    """The asynchronous worker: trains each assignment through the
    synchronous edge's ``FedAVGTrainer`` (the tag is its round, so the
    client orders are fedavg_edge's and sync-equivalence is exact) and
    uploads the delta from the version it trained. A keepalive JOINs after
    long silence, and a chaos crash-restart's revival JOINs at once."""

    def __init__(self, args, comm, rank, size, trainer: FedAVGTrainer):
        super().__init__(args, comm, rank, size)
        self.trainer = trainer
        #: the silence before a JOIN: a multiple of the server's probe
        #: cadence, so healthy waits do not JOIN
        self._keepalive_s = max(2.0 * _probe_interval(trainer.config), 3.0)
        self._keepalive: Optional[threading.Timer] = None
        #: arm and cancel race the firing timer's own re-arm
        self._ka_lock = threading.Lock()
        self._done = False

    def run(self):
        self.register_message_receive_handlers()
        chaos = find_chaos(self.com_manager)
        if chaos is not None:
            chaos.on_restart = self._send_join
        self._arm_keepalive()
        try:
            self.com_manager.handle_receive_message()
        finally:
            # the loop can end without a FINISH (a crash-stop ends it): the
            # keepalive dies with it, or it JOINs a dead federation for ever
            self._done = True
            self._cancel_keepalive()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_S2C_INIT_CONFIG, self.handle_assignment)
        self.register_message_receive_handler(MSG_TYPE_S2C_SYNC_MODEL, self.handle_assignment)
        self.register_message_receive_handler(MSG_TYPE_S2C_FINISH, self.handle_finish)

    def _send_join(self) -> None:
        if self._done:
            return
        try:
            self.send_message(Message(MSG_TYPE_C2S_JOIN, self.rank, 0))
        except Exception as e:   # best effort: the next timer tries again
            log.debug("rank %d JOIN failed (%s)", self.rank, e)

    def _arm_keepalive(self) -> None:
        def fire():
            self._send_join()
            self._arm_keepalive()

        with self._ka_lock:
            if self._keepalive is not None:
                self._keepalive.cancel()
                self._keepalive = None
            if self._done:
                return
            t = threading.Timer(self._keepalive_s, fire)
            t.daemon = True
            t.start()
            self._keepalive = t

    def _cancel_keepalive(self) -> None:
        with self._ka_lock:
            if self._keepalive is not None:
                self._keepalive.cancel()
                self._keepalive = None

    def handle_finish(self, msg: Message) -> None:
        self._done = True
        self._cancel_keepalive()
        self.finish()

    def handle_assignment(self, msg: Message) -> None:
        # the keepalive measures the server's silence while this worker is
        # idle, not its training: off while it trains, re-armed after the
        # upload
        self._cancel_keepalive()
        tag = int(msg.get(MSG_ARG_KEY_TRAIN_TAG))
        version = int(msg.get(MSG_ARG_KEY_VERSION))
        variables = host_tree(msg.get(MSG_ARG_KEY_MODEL_PARAMS))
        self.trainer.update_dataset(msg.get(MSG_ARG_KEY_CLIENT_INDEX))
        new_vars, n = self.trainer.train(variables, round_idx=tag)
        out = Message(MSG_TYPE_C2S_SEND_MODEL, self.rank, 0)
        out.add_params(MSG_ARG_KEY_MODEL_DELTA, {k: new_vars[k] - variables[k] for k in variables})
        out.add_params(MSG_ARG_KEY_NUM_SAMPLES, n)
        out.add_params(MSG_ARG_KEY_TRAIN_TAG, tag)
        out.add_params(MSG_ARG_KEY_VERSION, version)
        self.send_message(out)
        self._arm_keepalive()


def build_fedbuff_rank(dataset, config, rank: int, world_size: int, comm, bundle=None,
                       aggregator: Optional[FedBuffAggregator] = None,
                       device: Optional[Union[str, torch.device]] = None):
    """One rank's manager (as ``fedavg_edge.build_edge_rank``: the initial
    weights and every draw derive from ``config.seed``, so separate
    processes build the same state; ``bundle`` and ``aggregator`` let the
    ranks of one process share them)."""
    bundle = bundle or _bundle(dataset, config)
    args = _edge_args(config, dataset)
    if rank == 0:
        if aggregator is None:
            aggregator = FedBuffAggregator(bundle.init(config.seed, device), world_size - 1,
                                           config, dataset=dataset, bundle=bundle, device=device)
        return FedBuffEdgeServerManager(args, comm, 0, world_size, aggregator)
    trainer = FedAVGTrainer(dataset, bundle, config, device=device)
    return FedBuffEdgeClientManager(args, comm, rank, world_size, trainer)


def run_fedbuff_edge(dataset, config, worker_num: int, wire_roundtrip: bool = True,
                     comm_factory=None, timeout: float = 300.0, profile_snapshot=None,
                     bundle=None, device: Optional[Union[str, torch.device]] = None
                     ) -> FedBuffAggregator:
    """In-process launch: the server and ``worker_num`` workers on threads
    over the local transport, or another (``comm_factory``), under the wire
    stack ``config`` asks for. ``config.comm_round`` is the number of
    versions to emit; ``profile_snapshot`` freezes the scheduler's signal
    (``set_static_profile``) for the speed and fair policies. ``bundle``
    defaults to ``config.model``'s; runs on the GPU unless ``device`` says
    otherwise. Returns the server's aggregator: the final weights (numpy),
    the per-version test history, the fold accounting and the wire
    counters."""
    check_ported(config)
    dev = default_device(device)
    bundle = bundle or _bundle(dataset, config)
    size = worker_num + 1
    aggregator = FedBuffAggregator(bundle.init(config.seed, dev), worker_num, config,
                                   dataset=dataset, bundle=bundle, device=dev)

    def make(rank, comm):
        mgr = build_fedbuff_rank(dataset, config, rank, size, comm, bundle=bundle,
                                 aggregator=aggregator, device=dev)
        if rank == 0 and profile_snapshot is not None:
            mgr.scheduler.set_static_profile(profile_snapshot)
        return mgr

    managers = run_ranks(make, size, wire_roundtrip=wire_roundtrip, comm_factory=comm_factory,
                         timeout=timeout, codec=config.wire_codec,
                         wrap=wire_wrap_factory(config), inbox_cap=config.wire_inbox_cap)
    comms = [m.com_manager for m in managers]
    # a crash-stopped rank's loop ended without its finish(): stop every
    # rank's stack, so no retransmit thread outlives the federation
    release_wire(comms)
    from fedml_tpu_torch.utils.metrics import merge_wire_stats

    aggregator.wire_stats = merge_wire_stats(comms)
    log_wire_anomalies(aggregator.wire_stats)
    return aggregator
