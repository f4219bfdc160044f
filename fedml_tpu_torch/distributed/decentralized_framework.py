"""Peer-to-peer message-driven template over a topology, with no server
(counterpart of ``fedml_tpu/distributed/decentralized_framework.py``; the
reference's fedml_api/distributed/decentralized_framework/
decentralized_worker_manager.py:8-56).

Each worker trains, sends its result to its out-neighbours (:41-46) and
advances its round once every in-neighbour's result of that round has
arrived (:29-39), mixing with its row of the topology's matrix. The gossip
arithmetic of the in-mesh paradigm is ``algorithms/decentralized.py``'s;
this module is the edge-transport variant for workers that are separate
processes. It runs no model and no kernel: the state is a host numpy
vector, and the module is the gossip transport's smoke test.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np

from fedml_tpu_torch.comm import ClientManager, Message
from fedml_tpu_torch.comm.local import run_ranks
from fedml_tpu_torch.distributed.topology import SymmetricTopologyManager

log = logging.getLogger(__name__)

MSG_TYPE_SEND_MSG_TO_NEIGHBOR = 7
MSG_ARG_KEY_PARAMS = "params"


class DecentralizedWorkerManager(ClientManager):
    """One gossip worker (the reference's decentralized_worker_manager.py:
    8-56)."""

    def __init__(self, args, comm, rank, size, topology_manager,
                 local_fn: Optional[Callable] = None):
        super().__init__(args, comm, rank, size)
        self.topology_manager = topology_manager
        self.comm_round = int(args.comm_round)
        self.round_idx = 0
        # the local "training": (round_idx, mixed_state) -> new local state
        self.local_fn = local_fn or (lambda r, s: s)
        self.local_state = np.asarray([float(rank)], np.float32)
        # round -> {sender -> state}: a fast neighbour may be a round ahead;
        # buffering per round keeps the barrier exact (the reference is in
        # lockstep through MPI)
        self.neighbor_results: dict[int, dict[int, object]] = {}
        self.history: list[np.ndarray] = []

    @property
    def in_neighbors(self) -> list[int]:
        w = self.topology_manager.get_in_neighbor_weights(self.rank)
        return [j for j, wt in enumerate(w) if wt > 0 and j != self.rank]

    @property
    def out_neighbors(self) -> list[int]:
        w = self.topology_manager.get_out_neighbor_weights(self.rank)
        return [j for j, wt in enumerate(w) if wt > 0 and j != self.rank]

    def run(self):
        self.register_message_receive_handlers()
        self.start_training()
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_SEND_MSG_TO_NEIGHBOR,
                                              self.handle_msg_from_neighbor)

    def start_training(self):
        self.local_state = self.local_fn(self.round_idx, self.local_state)
        self._send_to_neighbors()

    def _send_to_neighbors(self):
        for j in self.out_neighbors:
            m = Message(MSG_TYPE_SEND_MSG_TO_NEIGHBOR, self.rank, j)
            m.add_params(MSG_ARG_KEY_PARAMS, self.local_state)
            m.add_params("round", self.round_idx)
            self.send_message(m)
        # a worker with no in-neighbour completes its round at once
        self._maybe_finish_round()

    def handle_msg_from_neighbor(self, msg: Message):
        r = int(msg.get("round"))
        self.neighbor_results.setdefault(r, {})[msg.get_sender_id()] = msg.get(MSG_ARG_KEY_PARAMS)
        self._maybe_finish_round()

    def _maybe_finish_round(self):
        current = self.neighbor_results.setdefault(self.round_idx, {})
        if len(current) < len(self.in_neighbors):
            return
        # x_i <- sum_j W[i, j] x_j over the row of the mixing matrix,
        # renormalized over the senders present: a no-op for a symmetric
        # topology, and for an asymmetric one it keeps the mass at 1
        # (unbiased asymmetric gossip is PushSum, algorithms/decentralized.py)
        weights = np.asarray(self.topology_manager.topology[self.rank], np.float32)
        mass = weights[self.rank] + sum(weights[j] for j in current)
        mixed = (weights[self.rank] / mass) * np.asarray(self.local_state, np.float32)
        # the senders in rank order: the sum does not depend on arrival order
        for j in sorted(current):
            mixed = mixed + (weights[j] / mass) * np.asarray(current[j], np.float32)
        del self.neighbor_results[self.round_idx]
        self.history.append(mixed)
        self.round_idx += 1
        if self.round_idx >= self.comm_round:
            self.finish()
            return
        self.local_state = self.local_fn(self.round_idx, mixed)
        self._send_to_neighbors()


def run_decentralized_framework(worker_num: int, comm_round: int = 3, neighbor_num: int = 2,
                                wire_roundtrip: bool = True, config=None,
                                comm_factory=None) -> list:
    """In-process gossip launch; returns each worker's mixed history. Over a
    doubly stochastic symmetric topology the values contract toward the
    global mean. ``config`` (a FedConfig) sets the transport's codec and
    inbox cap and stacks the reliable and chaos layers it asks for
    (``comm/reliable.wire_wrap_factory``): a worker's round advances by
    counting in-neighbour messages, so one dropped message would hang the
    mesh. ``comm_factory`` builds another transport, as in
    ``comm.local.run_ranks``."""
    from fedml_tpu_torch.comm.reliable import wire_wrap_factory
    from fedml_tpu_torch.core.config import check_ported
    from fedml_tpu_torch.distributed.fedavg_edge import release_wire

    class Args:
        pass

    args = Args()
    args.comm_round = comm_round
    topo = SymmetricTopologyManager(worker_num, neighbor_num=neighbor_num, seed=0)
    topo.generate_topology()
    kw, wrap = {}, None
    if config is not None:
        check_ported(config)
        wrap = wire_wrap_factory(config)
        kw = dict(codec=config.wire_codec, inbox_cap=config.wire_inbox_cap, wrap=wrap)

    def make(rank, comm):
        return DecentralizedWorkerManager(args, comm, rank, worker_num, topo)

    managers = run_ranks(make, worker_num, wire_roundtrip=wire_roundtrip,
                         comm_factory=comm_factory, **kw)
    if wrap is not None:
        release_wire([m.com_manager for m in managers])
    return [m.history for m in managers]
