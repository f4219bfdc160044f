"""Message-driven TurboAggregate: secure aggregation over the edge
transport (counterpart of ``fedml_tpu/distributed/turboaggregate_edge.py``;
the reference's fedml_api/distributed/turboaggregate/:
TA_decentralized_worker_manager.py and TA_fedavg.py).

Workers hold additive shares of their group-mates' masked updates, group
leaders relay the running field total along the group ring, and only the
final total reaches the server. The field arithmetic is
``algorithms/turboaggregate.py``'s (the JAX package's numpy: int64 over p =
2^31 - 1, ``frac_bits`` fractional bits), so the recovered aggregate equals
``secure_weighted_sum``'s on the same updates bit for bit: the additive
masks cancel in the field whatever generator drew them.

Per round, with C clients in G = max(1, C // group_size) round-robin groups
(group g = clients {g, g + G, ...}, ``secure_weighted_sum``'s grouping)::

  server --SYNC(model, weight)--> every client
  client: local training, q = quantize(flat_update * w), q split into
          |group| additive shares, one --SHARE--> to each group-mate
  client: the sum of its received shares --PARTIAL--> its group leader
  leader: its partials + the relay in --RELAY--> the next group's leader
  last leader --TOTAL--> server (dequantized: the next round's model)

No hop sees a client's update in the clear. The loss and count sums and
the hosts' MPC milliseconds ride the relay as non-secret metrics.

**Local training** is the port's local-train program, shared by every
worker of the process through ``fedavg_edge.edge_local_train`` (on CUDA each
live step a replay of one captured graph, through K1/K2 on a kernel-BN
model; the program follows the bundle's tensors), and every device call
runs on the edge runtime's one device thread (``fedavg_edge.device_call``).
Client ``ci`` draws its orders in round ``r`` from
``core/rng.client_generator(seed, r, ci)`` over its padded record axis, as
``TurboAggregateAPI``'s host round does at full participation when its
record bucket does not cut that axis; the flat update is the state dict in
the JAX package's leaf order (``models/convert.flax_leaf_order``), in f64.

**Wrapped floats.** A float whose weighted total leaves the field comes
back wrapped, as in the JAX package's edge. The server sees only the field
total, so it cannot tell which floats wrapped; ``TurboAggregateAPI``, which
holds the exact total, names them (``mpc_stats``, ``wrapped``).

**Fault tolerance.** With ``straggler_deadline_sec`` the federation runs
the BGW threshold protocol instead (``bgw_encode`` / ``bgw_decode``; the
reference's mpc_function.py:62-108): every client deals degree-T shares of
its update to every client, then reports DEALT; the server names the
dealer set D, each client returns the sum of its shares from D, and any
T + 1 of those evaluations reconstruct the sum, so clients may die between
the phases. Checkpoint and resume (``checkpoint_dir``, ``resume_from``)
keep the model, the round and the history; the masks need no saving.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.algorithms.turboaggregate import (P_DEFAULT, additive_shares, bgw_decode,
                                                       bgw_encode, dequantize, quantize)
from fedml_tpu_torch.comm import ClientManager, Message, ServerManager
from fedml_tpu_torch.comm.local import run_ranks
from fedml_tpu_torch.comm.message import MSG_ARG_KEY_MODEL_PARAMS
from fedml_tpu_torch.core.config import check_ported
from fedml_tpu_torch.core.rng import client_generator
from fedml_tpu_torch.distributed.base_framework import (MAX_EMPTY_DEADLINES,
                                                        MSG_TYPE_LOCAL_ROUND_DEADLINE,
                                                        RoundDeadlineTimer, require_injectable)
from fedml_tpu_torch.distributed.fedavg_edge import (ServerEval, _bundle, _device_tree,
                                                     device_call, edge_local_train, host_tree,
                                                     release_wire)
from fedml_tpu_torch.models.convert import flax_leaf_order
from fedml_tpu_torch.ops.dropout import client_key

log = logging.getLogger(__name__)

MSG_TYPE_S2C_SYNC = "ta_sync"        # server -> clients: model + round + weight
MSG_TYPE_C2C_SHARE = "ta_share"      # additive share to a group-mate
MSG_TYPE_C2L_PARTIAL = "ta_partial"  # masked partial sum to the group leader
MSG_TYPE_L2L_RELAY = "ta_relay"      # running field total along the group ring
MSG_TYPE_L2S_TOTAL = "ta_total"      # final field total to the server
MSG_TYPE_S2C_FINISH = "ta_finish"

KEY_ROUND = "round"
KEY_WEIGHT = "weight"
KEY_FIELD = "field"          # int64 field vector
KEY_LOSS_SUM = "loss_sum"    # non-secret metrics riding the relay
KEY_COUNT_SUM = "count_sum"
KEY_MPC_MS = "mpc_ms"

Tree = dict


def _groups(num_clients: int, group_size: int) -> list[list[int]]:
    """Round-robin grouping, ``secure_weighted_sum``'s ``range(g, C,
    n_groups)``."""
    n_groups = max(1, num_clients // group_size)
    return [list(range(g, num_clients, n_groups)) for g in range(n_groups)]


class _Flat:
    """The field vector <-> state dict mapping: the field holds the leaves
    in the JAX package's leaf order (``names``), each with its shape and
    dtype; a state dict keeps its own key order."""

    def __init__(self, variables: dict):
        self.keys = list(variables)                 # the state dict's own order
        self.names = flax_leaf_order({k: torch.as_tensor(v) for k, v in variables.items()})
        host = host_tree(variables)
        self.shapes = [host[k].shape for k in self.names]
        self.dtypes = [host[k].dtype for k in self.names]

    def flatten(self, tree: Tree) -> np.ndarray:
        return np.concatenate([np.ravel(tree[k]).astype(np.float64) for k in self.names])

    def unflatten(self, flat: np.ndarray) -> Tree:
        out, off = {}, 0
        for k, shape, dtype in zip(self.names, self.shapes, self.dtypes):
            n = int(np.prod(shape, dtype=np.int64))
            out[k] = flat[off:off + n].reshape(shape).astype(dtype)
            off += n
        return {k: out[k] for k in self.keys}


def _ckpt_setup(server, cfg, fname: str) -> None:
    """Checkpoint and resume of either server: the model, the round and the
    history (the additive and BGW masks cancel in the field, so a resumed
    run's aggregates equal the uninterrupted run's whatever masks the
    restarted clients draw)."""
    server._ckpt_path = None
    if getattr(cfg, "checkpoint_dir", None):
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        server._ckpt_path = os.path.join(cfg.checkpoint_dir, fname)
    server._ckpt_freq = int(getattr(cfg, "checkpoint_frequency", 10) or 10)
    resume = getattr(cfg, "resume_from", None)
    if resume:
        from fedml_tpu_torch.utils.checkpoint import load_checkpoint

        state = load_checkpoint(resume)
        server.variables = host_tree(state["variables"])
        server.round_idx = int(state["round_idx"])
        for k, v in state["extra"].get("history", {}).items():
            server.history[k] = list(v)


def _ckpt_maybe(server) -> None:
    if server._ckpt_path is None:
        return
    if server.round_idx % server._ckpt_freq == 0 or server.round_idx >= server.round_num:
        from fedml_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(server._ckpt_path, server.variables, round_idx=server.round_idx,
                        extra={"history": server.history})


class _TAServer(ServerManager):
    """What both servers share: the model, the weights, the evaluation,
    the history and the per-round host MPC time."""

    def __init__(self, args, comm, rank, size, variables, dataset, bundle, frac_bits: int,
                 p=P_DEFAULT, device: Optional[Union[str, torch.device]] = None):
        super().__init__(args, comm, rank, size)
        self.variables: Tree = host_tree(variables)
        self.dataset = dataset
        self.frac_bits = frac_bits
        self.p = p
        self.round_idx = 0
        self.round_num = int(args.comm_round)
        self.num_clients = size - 1
        self.history: dict[str, list] = {"round": [], "Test/Acc": [], "Test/Loss": [],
                                         "Train/Loss": []}
        self._eval = ServerEval(bundle, dataset, default_device(device))
        self._flat = _Flat(self.variables)
        counts = np.asarray(dataset.train_counts, np.float64)[: self.num_clients]
        self._weights = counts / counts.sum()
        #: every round's host MPC milliseconds, summed over the ranks
        self.mpc_ms: list[float] = []
        #: the last round's MPC figures (``TurboAggregateAPI.mpc_stats``' keys)
        self.mpc_stats: Optional[dict] = None
        #: ``time.perf_counter()`` when the first round went out, and at each
        #: round's close: the rounds' walls
        self.t_start: Optional[float] = None
        self.round_closes: list[float] = []

    def _close_round(self, flat: np.ndarray, train_loss: float, mpc_ms: float) -> None:
        self.round_closes.append(time.perf_counter())
        self.variables = self._flat.unflatten(flat)
        self.mpc_ms.append(mpc_ms)
        scale = float(1 << self.frac_bits)
        self.mpc_stats = {"mpc_ms": mpc_ms, "field_limit": (int(P_DEFAULT) - 1) / 2 / scale,
                          "floats": int(flat.shape[0]), "clients": self.num_clients}
        if (self.round_idx % self.args.frequency_of_the_test == 0
                or self.round_idx == self.round_num - 1):
            m = self._eval(self.variables)
            self.history["round"].append(self.round_idx)
            self.history["Test/Acc"].append(m.get("acc"))
            self.history["Test/Loss"].append(m.get("loss"))
            self.history["Train/Loss"].append(train_loss)
        self.round_idx += 1
        _ckpt_maybe(self)


class TAEdgeServerManager(_TAServer):
    """The rounds' owner and unmasker (the reference's TA_fedavg aggregator):
    sends the model out, receives one field total a round, dequantizes."""

    def __init__(self, args, comm, rank, size, variables, dataset, bundle, frac_bits: int,
                 p=P_DEFAULT, device: Optional[Union[str, torch.device]] = None):
        super().__init__(args, comm, rank, size, variables, dataset, bundle, frac_bits, p,
                         device)
        _ckpt_setup(self, args, "ta_server.ckpt")

    def run(self):
        self.register_message_receive_handlers()
        if self.round_idx >= self.round_num:          # resumed a finished run
            self._finish_all()
            return
        self.t_start = time.perf_counter()
        self._send_sync()
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_L2S_TOTAL, self._on_total)

    def _send_sync(self):
        for rank in range(1, self.size):
            m = Message(MSG_TYPE_S2C_SYNC, self.rank, rank)
            m.add_params(MSG_ARG_KEY_MODEL_PARAMS, self.variables)
            m.add_params(KEY_ROUND, self.round_idx)
            m.add_params(KEY_WEIGHT, float(self._weights[rank - 1]))
            self.send_message(m)

    def _finish_all(self):
        for rank in range(1, self.size):
            self.send_message(Message(MSG_TYPE_S2C_FINISH, self.rank, rank))
        self.finish()

    def _on_total(self, msg: Message):
        # a wire-protocol invariant, never an assert (stripped under -O)
        if int(msg.get(KEY_ROUND)) != self.round_idx:
            raise RuntimeError(f"TurboAggregate total for round {msg.get(KEY_ROUND)} arrived "
                               f"at the server in round {self.round_idx}")
        t0 = time.perf_counter()
        flat = dequantize(np.asarray(msg.get(KEY_FIELD), np.int64), self.frac_bits, self.p)
        mpc_ms = float(msg.get(KEY_MPC_MS)) + (time.perf_counter() - t0) * 1e3
        train_loss = float(msg.get(KEY_LOSS_SUM)) / max(float(msg.get(KEY_COUNT_SUM)), 1e-12)
        self._close_round(flat, train_loss, mpc_ms)
        if self.round_idx >= self.round_num:
            self._finish_all()
            return
        self._send_sync()


class _TAWorker(ClientManager):
    """What both workers share: the local training of client ``rank - 1``
    through the bundle's shared program, on the device thread."""

    def __init__(self, args, comm, rank, size, dataset, bundle, config,
                 device: Optional[Union[str, torch.device]] = None):
        super().__init__(args, comm, rank, size)
        self.dataset = dataset
        self.bundle = bundle
        self.config = config
        self.device = default_device(device)
        self.client_idx = rank - 1
        self.num_clients = size - 1
        device_call(bundle.module.to, self.device)
        self.local_train = edge_local_train(bundle, dataset, config)
        self._data = None
        self._flat: Optional[_Flat] = None

    def train(self, variables: Tree, round_idx: int) -> tuple:
        """(the flat f64 update, the train loss, the record count)."""
        return device_call(self._train, variables, round_idx)

    def _train(self, variables: Tree, round_idx: int) -> tuple:
        c, ds, ci = self.config, self.dataset, self.client_idx
        if self._data is None:
            self._data = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                               for a in ds.client_arrays(ci))
        x, y, m = self._data
        count = int(ds.train_counts[ci])
        g = client_generator(c.seed, round_idx, ci)
        orders = [torch.randperm(int(x.shape[0]), generator=g) for _ in range(c.epochs)]
        key = client_key(c.seed, round_idx, ci) if self.bundle.uses_dropout else None
        res = self.local_train(_device_tree(variables, self.device), x, y, m, count,
                               orders=orders, key=key)
        new = host_tree(res.variables)
        if self._flat is None:
            self._flat = _Flat(new)
        return self._flat.flatten(new), float(res.train_loss), float(count)


class TAEdgeClientManager(_TAWorker):
    """A worker: local training and the share, partial and relay legs (the
    reference's TA_decentralized_worker_manager.py roles, one rank a
    client)."""

    def __init__(self, args, comm, rank, size, dataset, bundle, config, group_size: int,
                 frac_bits: int, p=P_DEFAULT, device: Optional[Union[str, torch.device]] = None):
        super().__init__(args, comm, rank, size, dataset, bundle, config, device)
        self.frac_bits = frac_bits
        self.p = p
        groups = _groups(self.num_clients, group_size)
        self._groups_list = groups
        self.gid = self.client_idx % len(groups)
        self.members = groups[self.gid]
        self.leader = self.members[0]
        self.n_groups = len(groups)
        self.is_leader = self.client_idx == self.leader
        self.last_group = self.gid == self.n_groups - 1
        self._rng = np.random.default_rng([config.seed, 0x7A, self.client_idx])
        self.round_idx = -1
        # a fast group-mate's legs of round r + 1 may arrive before our own
        # SYNC(r + 1): they wait here and are handled right after it
        self._ahead: list[tuple] = []
        self._reset_round()

    def _reset_round(self):
        self._share_sum = None
        self._n_shares = 0
        self._partial_sum = None
        self._n_partials = 0
        self._relay_in = None
        self._loss_sum = self._count_sum = self._mpc_ms = 0.0

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_S2C_SYNC, self._on_sync)
        self.register_message_receive_handler(MSG_TYPE_C2C_SHARE, self._on_share)
        self.register_message_receive_handler(MSG_TYPE_C2L_PARTIAL, self._on_partial)
        self.register_message_receive_handler(MSG_TYPE_L2L_RELAY, self._on_relay)
        self.register_message_receive_handler(MSG_TYPE_S2C_FINISH, lambda m: self.finish())

    def _ahead_of_round(self, msg: Message, handler) -> bool:
        r = int(msg.get(KEY_ROUND))
        if r == self.round_idx:
            return False
        if r < self.round_idx:        # the relay's gating makes a past round impossible
            raise RuntimeError(f"client {self.client_idx}: stale round {r} message (at round "
                               f"{self.round_idx}): {msg}")
        self._ahead.append((handler, msg))
        return True

    def _on_sync(self, msg: Message):
        self._reset_round()
        self.round_idx = int(msg.get(KEY_ROUND))
        if self.gid == 0 and self.is_leader:
            self._relay_in = np.zeros(1, np.int64)        # the ring's head starts at 0
        flat, loss, count = self.train(host_tree(msg.get(MSG_ARG_KEY_MODEL_PARAMS)),
                                       self.round_idx)
        self._loss_own, self._count_own = loss * count, count
        t0 = time.perf_counter()
        xw = flat * float(msg.get(KEY_WEIGHT))
        shares = additive_shares(quantize(xw, self.frac_bits, self.p), len(self.members),
                                 self.p, self._rng)
        self._mpc_own = (time.perf_counter() - t0) * 1e3
        for slot, member in enumerate(self.members):
            out = Message(MSG_TYPE_C2C_SHARE, self.rank, member + 1)
            out.add_params(KEY_ROUND, self.round_idx)
            out.add_params(KEY_FIELD, shares[slot])
            self.send_message(out)
        pending, self._ahead = self._ahead, []
        for handler, m in pending:
            handler(m)

    def _on_share(self, msg: Message):
        if self._ahead_of_round(msg, self._on_share):
            return
        t0 = time.perf_counter()
        share = np.asarray(msg.get(KEY_FIELD), np.int64)
        self._share_sum = (share if self._share_sum is None
                           else np.mod(self._share_sum + share, self.p))
        self._mpc_own += (time.perf_counter() - t0) * 1e3
        self._n_shares += 1
        if self._n_shares == len(self.members):
            out = Message(MSG_TYPE_C2L_PARTIAL, self.rank, self.leader + 1)
            out.add_params(KEY_ROUND, self.round_idx)
            out.add_params(KEY_FIELD, self._share_sum)
            out.add_params(KEY_LOSS_SUM, self._loss_own)
            out.add_params(KEY_COUNT_SUM, self._count_own)
            out.add_params(KEY_MPC_MS, self._mpc_own)
            self.send_message(out)

    def _on_partial(self, msg: Message):
        if not self.is_leader:
            raise RuntimeError(f"rank {self.rank}: partial-sum message routed to a non-leader")
        if self._ahead_of_round(msg, self._on_partial):
            return
        t0 = time.perf_counter()
        part = np.asarray(msg.get(KEY_FIELD), np.int64)
        self._partial_sum = (part if self._partial_sum is None
                             else np.mod(self._partial_sum + part, self.p))
        self._mpc_ms += (time.perf_counter() - t0) * 1e3 + float(msg.get(KEY_MPC_MS))
        self._n_partials += 1
        self._loss_sum += float(msg.get(KEY_LOSS_SUM))
        self._count_sum += float(msg.get(KEY_COUNT_SUM))
        self._maybe_relay()

    def _on_relay(self, msg: Message):
        if not self.is_leader:
            raise RuntimeError(f"rank {self.rank}: relay message routed to a non-leader")
        if self._ahead_of_round(msg, self._on_relay):
            return
        self._relay_in = np.asarray(msg.get(KEY_FIELD), np.int64)
        self._loss_sum += float(msg.get(KEY_LOSS_SUM))
        self._count_sum += float(msg.get(KEY_COUNT_SUM))
        self._mpc_ms += float(msg.get(KEY_MPC_MS))
        self._maybe_relay()

    def _maybe_relay(self):
        if self._relay_in is None or self._n_partials != len(self.members):
            return
        t0 = time.perf_counter()
        total = np.mod(self._relay_in + self._partial_sum, self.p)
        mpc_ms = self._mpc_ms + (time.perf_counter() - t0) * 1e3
        if self.last_group:
            out = Message(MSG_TYPE_L2S_TOTAL, self.rank, 0)
        else:
            out = Message(MSG_TYPE_L2L_RELAY, self.rank, self._groups_list[self.gid + 1][0] + 1)
        out.add_params(KEY_ROUND, self.round_idx)
        out.add_params(KEY_FIELD, total)
        out.add_params(KEY_LOSS_SUM, self._loss_sum)
        out.add_params(KEY_COUNT_SUM, self._count_sum)
        out.add_params(KEY_MPC_MS, mpc_ms)
        self.send_message(out)


# -------------------------------------------------- the threshold (fault-tolerant) protocol
#
#   server --SYNC(model, w_j)--> live clients
#   client j: train; q_j = quantize(flat_j * w_j); deal the BGW shares of
#             q_j (degree T, evaluated at alpha_i = i + 1) one to each peer,
#             THEN --DEALT(count, loss)--> server (sends are synchronous: a
#             DEALT that arrived means every share before it arrived)
#   server:   on every live DEALT or the deadline, D = the dealers that
#             reported; --REVEAL(D)--> live clients
#   client i: S_i = sum over j in D of share_{j->i} mod p --EVAL(S_i)--> server
#   server:   the S_i are evaluations of a degree-T polynomial whose value
#             at 0 is sum q_j: any T + 1 of them reconstruct it, so up to
#             live - (T + 1) clients may die between the phases

MSG_TYPE_C2C_TSHARE = "ta_tshare"    # dealer -> peer: BGW share
MSG_TYPE_C2S_DEALT = "ta_dealt"      # dealer -> server: shares all delivered
MSG_TYPE_S2C_REVEAL = "ta_reveal"    # server -> clients: dealer set D
MSG_TYPE_C2S_EVAL = "ta_eval"        # client -> server: S_i evaluation

KEY_DEALER = "dealer"
KEY_CLIENT = "client"
KEY_DEALERS = "dealers"
KEY_COUNT = "count"
KEY_LOSS = "loss"
KEY_GEN = "gen"   # the attempt: a re-run round re-deals fresh polynomials


class TAThresholdServerManager(_TAServer):
    """The fault-tolerant server: two deadline-guarded phases (deal,
    evaluate) a round; the sum from any T + 1 evaluations."""

    def __init__(self, args, comm, rank, size, variables, dataset, bundle, frac_bits: int,
                 threshold_t: int, deadline: float, p=P_DEFAULT,
                 device: Optional[Union[str, torch.device]] = None):
        require_injectable(comm)
        super().__init__(args, comm, rank, size, variables, dataset, bundle, frac_bits, p,
                         device)
        self.T = int(threshold_t)
        if self.num_clients < self.T + 1:
            raise ValueError(f"threshold T={self.T} needs at least T+1={self.T + 1} clients; "
                             f"got {self.num_clients}")
        self._alive = {i: True for i in range(self.num_clients)}
        self._phase = "deal"
        self._dealt: dict[int, tuple] = {}
        self._evals: dict[int, np.ndarray] = {}
        self._dealers: list[int] = []
        self._empty = 0
        self._gen = 0
        self._timer = RoundDeadlineTimer(comm, deadline, rank, KEY_ROUND)
        _ckpt_setup(self, args, "ta_server.ckpt")

    def run(self):
        self.register_message_receive_handlers()
        if self.round_idx >= self.round_num:          # resumed a finished run
            self._teardown()
            return
        self.t_start = time.perf_counter()
        self._send_sync()
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_C2S_DEALT, self._on_dealt)
        self.register_message_receive_handler(MSG_TYPE_C2S_EVAL, self._on_eval)
        self.register_message_receive_handler(MSG_TYPE_LOCAL_ROUND_DEADLINE, self._on_deadline)

    def _live(self):
        return [i for i, a in self._alive.items() if a]

    def _mark_dead(self, cid: int):
        if self._alive.get(cid):
            log.warning("TA threshold: client %d marked dead (round %d, phase %s)", cid,
                        self.round_idx, self._phase)
            self._alive[cid] = False

    def _send_sync(self):
        self._phase = "deal"
        self._dealt, self._evals = {}, {}
        self._gen += 1
        for cid in self._live():
            m = Message(MSG_TYPE_S2C_SYNC, self.rank, cid + 1)
            m.add_params(MSG_ARG_KEY_MODEL_PARAMS, self.variables)
            m.add_params(KEY_ROUND, self.round_idx)
            m.add_params(KEY_GEN, self._gen)
            m.add_params(KEY_WEIGHT, float(self._weights[cid]))
            try:
                self.send_message(m)
            except Exception:
                self._mark_dead(cid)
        if not self._live():
            self._teardown()
            return
        # the tag gen * 2 + phase is unique per (attempt, phase), so a timer
        # that fired just before its cancel is always recognisably stale
        self._timer.arm(self._gen * 2)

    def _on_dealt(self, msg: Message):
        if int(msg.get(KEY_GEN)) != self._gen or self._phase != "deal":
            return       # a late report of a dead-marked client or an old attempt
        self._dealt[int(msg.get(KEY_CLIENT))] = (float(msg.get(KEY_COUNT)),
                                                 float(msg.get(KEY_LOSS)),
                                                 float(msg.get(KEY_MPC_MS)))
        if set(self._dealt) >= set(self._live()):
            self._start_reveal()

    def _start_reveal(self):
        self._timer.cancel()
        self._empty = 0                  # progress: the budget counts consecutive stalls
        self._dealers = sorted(self._dealt)
        self._phase = "eval"
        for cid in self._live():
            m = Message(MSG_TYPE_S2C_REVEAL, self.rank, cid + 1)
            m.add_params(KEY_ROUND, self.round_idx)
            m.add_params(KEY_GEN, self._gen)
            m.add_params(KEY_DEALERS, np.asarray(self._dealers, np.int64))
            try:
                self.send_message(m)
            except Exception:
                self._mark_dead(cid)
        self._timer.arm(self._gen * 2 + 1)

    def _on_eval(self, msg: Message):
        if int(msg.get(KEY_GEN)) != self._gen or self._phase != "eval":
            return       # an old attempt's: its shares were dealt again since
        cid = int(msg.get(KEY_CLIENT))
        self._evals[cid] = (np.asarray(msg.get(KEY_FIELD), np.int64), float(msg.get(KEY_MPC_MS)))
        if set(self._evals) >= set(self._live()):
            self._finish_round()

    def _on_deadline(self, msg: Message):
        tag = self._gen * 2 + (0 if self._phase == "deal" else 1)
        if int(msg.get(KEY_ROUND)) != tag:
            return       # a stale timer of a closed phase or attempt
        if self._phase == "deal":
            if not self._dealt:
                # an empty window looks like everyone still starting up:
                # liveness stays, the round is sent again, and the
                # federation ends after MAX_EMPTY_DEADLINES such windows
                self._empty += 1
                if self._empty >= MAX_EMPTY_DEADLINES:
                    self._teardown()
                    return
                self._send_sync()
                return
            self._empty = 0
            for cid in self._live():        # some progress: the silent ones are dead
                if cid not in self._dealt:
                    self._mark_dead(cid)
            self._start_reveal()
            return
        # the evaluation phase: any T + 1 evaluations close the round
        if len(self._evals) >= self.T + 1:
            for cid in self._live():
                if cid not in self._evals:
                    self._mark_dead(cid)
            self._finish_round()
            return
        # under the threshold the silent ones may all be slow: the round runs
        # again, bounded by the same counter
        self._empty += 1
        if self._empty >= MAX_EMPTY_DEADLINES:
            log.error("TA threshold: %d evaluations < T+1=%d after %d windows; cannot "
                      "reconstruct, tearing down", len(self._evals), self.T + 1, self._empty)
            self._teardown()
            return
        self._send_sync()

    def _finish_round(self):
        self._timer.cancel()
        self._empty = 0
        t0 = time.perf_counter()
        ids = sorted(self._evals)
        field_sum = bgw_decode(np.stack([self._evals[i][0] for i in ids]), ids, self.p)
        w_d = float(sum(self._weights[d] for d in self._dealers))
        flat = dequantize(field_sum, self.frac_bits, self.p) / max(w_d, 1e-12)
        mpc_ms = ((time.perf_counter() - t0) * 1e3 + sum(v[2] for v in self._dealt.values())
                  + sum(v[1] for v in self._evals.values()))
        loss_sum = sum(v[1] for v in self._dealt.values())
        count_sum = sum(v[0] for v in self._dealt.values())
        self._close_round(flat, loss_sum / max(count_sum, 1e-12), mpc_ms)
        if self.round_idx >= self.round_num:
            self._teardown()
            return
        self._send_sync()

    def _teardown(self):
        self._timer.cancel()
        # FINISH to every rank, the dead-marked too: over the local transport
        # a "dead" client is a live thread that must still end
        for cid in range(self.num_clients):
            try:
                self.send_message(Message(MSG_TYPE_S2C_FINISH, self.rank, cid + 1))
            except Exception as e:
                log.debug("FINISH to client %d failed (%s)", cid, e)
        self.finish()


class TAThresholdClientManager(_TAWorker):
    """The fault-tolerant worker: deals its BGW shares, then reveals the sum
    of its shares over the server's dealer set."""

    def __init__(self, args, comm, rank, size, dataset, bundle, config, threshold_t: int,
                 frac_bits: int, p=P_DEFAULT, device: Optional[Union[str, torch.device]] = None):
        super().__init__(args, comm, rank, size, dataset, bundle, config, device)
        self.frac_bits = frac_bits
        self.T = int(threshold_t)
        self.p = p
        self._rng = np.random.default_rng([config.seed, 0x7B, self.client_idx])
        self.round_idx = -1
        self._gen = 0
        self._shares: dict[int, np.ndarray] = {}
        self._ahead: list[tuple] = []

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_S2C_SYNC, self._on_sync)
        self.register_message_receive_handler(MSG_TYPE_C2C_TSHARE, self._on_tshare)
        self.register_message_receive_handler(MSG_TYPE_S2C_REVEAL, self._on_reveal)
        self.register_message_receive_handler(MSG_TYPE_S2C_FINISH, lambda m: self.finish())

    def _ahead_of_round(self, msg: Message, handler) -> bool:
        r = int(msg.get(KEY_ROUND))
        if r == self.round_idx:
            return False
        if r < self.round_idx:
            return True           # leftovers of a round that ran again: dropped
        self._ahead.append((handler, msg))
        return True

    def _on_sync(self, msg: Message):
        self.round_idx = int(msg.get(KEY_ROUND))
        self._gen = int(msg.get(KEY_GEN))
        self._shares = {}
        flat, loss, count = self.train(host_tree(msg.get(MSG_ARG_KEY_MODEL_PARAMS)),
                                       self.round_idx)
        t0 = time.perf_counter()
        q = quantize(flat * float(msg.get(KEY_WEIGHT)), self.frac_bits, self.p)
        shares = bgw_encode(q, self.num_clients, self.T, self.p, self._rng)
        mpc_ms = (time.perf_counter() - t0) * 1e3
        for peer in range(self.num_clients):
            if peer == self.client_idx:
                self._shares[self.client_idx] = shares[peer]
                continue
            out = Message(MSG_TYPE_C2C_TSHARE, self.rank, peer + 1)
            out.add_params(KEY_ROUND, self.round_idx)
            out.add_params(KEY_GEN, self._gen)
            out.add_params(KEY_DEALER, self.client_idx)
            out.add_params(KEY_FIELD, shares[peer])
            try:
                self.send_message(out)
            except Exception as e:         # a dead peer: its share is lost
                log.debug("share to client %d failed (%s)", peer, e)
        done = Message(MSG_TYPE_C2S_DEALT, self.rank, 0)
        done.add_params(KEY_ROUND, self.round_idx)
        done.add_params(KEY_GEN, self._gen)
        done.add_params(KEY_CLIENT, self.client_idx)
        done.add_params(KEY_COUNT, count)
        done.add_params(KEY_LOSS, loss * count)
        done.add_params(KEY_MPC_MS, mpc_ms)
        self.send_message(done)
        # snapshot and swap: a replayed handler may buffer a message that is
        # still ahead again
        pending, self._ahead = self._ahead, []
        for handler, m in pending:
            handler(m)

    def _on_tshare(self, msg: Message):
        if self._ahead_of_round(msg, self._on_tshare):
            return
        g = int(msg.get(KEY_GEN))
        if g > self._gen:
            # a faster peer already started the re-run attempt: replayed
            # after our own re-SYNC
            self._ahead.append((self._on_tshare, msg))
            return
        if g < self._gen:
            return                 # a share of a superseded attempt
        self._shares[int(msg.get(KEY_DEALER))] = np.asarray(msg.get(KEY_FIELD), np.int64)

    def _on_reveal(self, msg: Message):
        if self._ahead_of_round(msg, self._on_reveal):
            return
        g = int(msg.get(KEY_GEN))
        if g > self._gen:
            self._ahead.append((self._on_reveal, msg))
            return
        if g < self._gen:
            return                 # the reveal of a superseded attempt
        dealers = [int(d) for d in np.asarray(msg.get(KEY_DEALERS), np.int64)]
        missing = [d for d in dealers if d not in self._shares]
        if missing:
            # the DEALT-after-shares ordering was violated
            raise RuntimeError(f"client {self.client_idx}: REVEAL names dealers {missing} "
                               f"whose shares never arrived (round {self.round_idx})")
        t0 = time.perf_counter()
        s = np.zeros_like(self._shares[dealers[0]])
        for d in dealers:
            s = np.mod(s + self._shares[d], self.p)
        out = Message(MSG_TYPE_C2S_EVAL, self.rank, 0)
        out.add_params(KEY_ROUND, self.round_idx)
        out.add_params(KEY_GEN, self._gen)
        out.add_params(KEY_CLIENT, self.client_idx)
        out.add_params(KEY_FIELD, s)
        out.add_params(KEY_MPC_MS, (time.perf_counter() - t0) * 1e3)
        self.send_message(out)


def run_turboaggregate_edge(dataset, config, group_size: int = 2, frac_bits: int = 20,
                            wire_roundtrip: bool = True, comm_factory=None,
                            threshold_t: int = 1, bundle=None,
                            device: Optional[Union[str, torch.device]] = None) -> _TAServer:
    """The server and ``min(client_num_in_total, num_clients)`` workers on
    threads over the local transport (or ``comm_factory``'s), the whole
    secure-relay federation; returns the server manager (the final
    ``variables`` as numpy, ``history``, ``mpc_ms``, ``mpc_stats``).
    ``config.straggler_deadline_sec`` runs the BGW threshold protocol (up to
    live - (T + 1) clients may die mid-round). ``bundle`` defaults to
    ``config.model``'s. The reliable and chaos layers
    ``config`` asks for stack over every rank's transport. Runs on the GPU
    unless ``device`` says otherwise."""
    from fedml_tpu_torch.comm.reliable import wire_wrap_factory

    check_ported(config)
    deadline = getattr(config, "straggler_deadline_sec", None)
    dev = default_device(device)
    C = min(config.client_num_in_total, dataset.num_clients)
    bundle = bundle or _bundle(dataset, config)
    variables0 = device_call(bundle.init, config.seed, dev)
    size = C + 1

    def make(rank, comm):
        if deadline is not None:
            if rank == 0:
                return TAThresholdServerManager(config, comm, rank, size, variables0, dataset,
                                                bundle, frac_bits, threshold_t, float(deadline),
                                                device=dev)
            return TAThresholdClientManager(config, comm, rank, size, dataset, bundle, config,
                                            threshold_t, frac_bits, device=dev)
        if rank == 0:
            return TAEdgeServerManager(config, comm, rank, size, variables0, dataset, bundle,
                                       frac_bits, device=dev)
        return TAEdgeClientManager(config, comm, rank, size, dataset, bundle, config,
                                   group_size, frac_bits, device=dev)

    wrap = wire_wrap_factory(config)
    managers = run_ranks(make, size, wire_roundtrip=wire_roundtrip, comm_factory=comm_factory,
                         wrap=wrap, inbox_cap=config.wire_inbox_cap)
    if wrap is not None:
        release_wire([m.com_manager for m in managers])
    return managers[0]
