"""Minimal message-driven algorithm template and the straggler-deadline
machinery (counterpart of ``fedml_tpu/distributed/base_framework.py``; the
reference's distributed/base_framework/algorithm_api.py:16-38).

The server broadcasts an init signal, each client computes a numeric "local
result", the server averages and broadcasts the global result, for
``comm_round`` rounds: the template every message-driven algorithm copies
and the transport's smoke test (the reference's CI-script-framework.sh:
16-24 launches exactly this).

The JAX package's flight-dump broadcast and the strict-barrier warning of
the other edge protocols belong to ROADMAP §1 items 12 and 11c.
"""

from __future__ import annotations

import logging
import threading
from typing import List

import numpy as np

from fedml_tpu_torch.comm import ClientManager, Message, ServerManager
from fedml_tpu_torch.comm.local import run_ranks

log = logging.getLogger(__name__)

#: the control event injected into the server's own receive queue when the
#: straggler deadline fires; it never crosses the wire and is handled in
#: turn with real messages on the receive loop
MSG_TYPE_LOCAL_ROUND_DEADLINE = 99
#: consecutive all-dead deadlines before a federation tears itself down
MAX_EMPTY_DEADLINES = 10


def require_injectable(comm, feature: str = "straggler_deadline_sec") -> None:
    if not comm.supports_local_injection():
        raise ValueError(f"{feature} needs a transport with local event injection "
                         f"(local/grpc); {type(comm).__name__} has none")


class RoundDeadlineTimer:
    """A daemon ``threading.Timer`` that injects a round-tagged
    ``MSG_TYPE_LOCAL_ROUND_DEADLINE`` into ``comm``'s own queue."""

    def __init__(self, comm, deadline: float, rank: int, round_key: str):
        self.comm = comm
        self.deadline = float(deadline)
        self.rank = int(rank)
        self.round_key = round_key
        self._timer = None

    def arm(self, round_idx: int) -> None:
        self.cancel()
        m = Message(MSG_TYPE_LOCAL_ROUND_DEADLINE, self.rank, self.rank)
        m.add_params(self.round_key, int(round_idx))

        def fire():
            try:
                self.comm.inject_local(m)
            except Exception as e:   # the receive loop already torn down
                log.warning("deadline timer injection failed: %s", e)

        t = threading.Timer(self.deadline, fire)
        t.daemon = True
        t.start()
        self._timer = t

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None


MSG_TYPE_S2C_INIT = 1
MSG_TYPE_C2S_RESULT = 2
MSG_TYPE_S2C_SYNC = 3
MSG_TYPE_S2C_FINISH = 4

MSG_ARG_KEY_RESULT = "local_result"
MSG_ARG_KEY_GLOBAL = "global_result"


class BaseServerManager(ServerManager):
    def __init__(self, args, comm, rank, size):
        super().__init__(args, comm, rank, size)
        self.round_idx = 0
        self.comm_round = int(getattr(args, "comm_round", 1))
        self.results: dict[int, float] = {}
        self.global_history: List[float] = []

    def run(self):
        self.register_message_receive_handlers()
        for client in range(1, self.size):
            self.send_message(Message(MSG_TYPE_S2C_INIT, self.rank, client))
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_C2S_RESULT, self.handle_result)

    def handle_result(self, msg: Message):
        self.results[msg.get_sender_id()] = float(msg.get(MSG_ARG_KEY_RESULT))
        if len(self.results) == self.size - 1:          # the barrier: a message count
            global_result = float(np.mean(list(self.results.values())))
            self.global_history.append(global_result)
            self.results.clear()
            self.round_idx += 1
            done = self.round_idx >= self.comm_round
            for client in range(1, self.size):
                m = Message(MSG_TYPE_S2C_FINISH if done else MSG_TYPE_S2C_SYNC, self.rank, client)
                m.add_params(MSG_ARG_KEY_GLOBAL, global_result)
                self.send_message(m)
            if done:
                self.finish()


class BaseClientManager(ClientManager):
    def __init__(self, args, comm, rank, size, local_fn=None):
        super().__init__(args, comm, rank, size)
        # the local "training": any callable (round_idx, global_result) -> float
        self.local_fn = local_fn or (lambda r, g: float(self.rank) + (g or 0.0))
        self.round_idx = 0

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_S2C_INIT, self.handle_init)
        self.register_message_receive_handler(MSG_TYPE_S2C_SYNC, self.handle_sync)
        self.register_message_receive_handler(MSG_TYPE_S2C_FINISH, self.handle_finish)

    def _train_and_send(self, global_result):
        result = self.local_fn(self.round_idx, global_result)
        m = Message(MSG_TYPE_C2S_RESULT, self.rank, 0)
        m.add_params(MSG_ARG_KEY_RESULT, float(result))
        self.send_message(m)
        self.round_idx += 1

    def handle_init(self, msg: Message):
        self._train_and_send(None)

    def handle_sync(self, msg: Message):
        self._train_and_send(msg.get(MSG_ARG_KEY_GLOBAL))

    def handle_finish(self, msg: Message):
        self.finish()


def run_base_framework(client_num: int, comm_round: int = 3, wire_roundtrip: bool = True,
                       config=None, comm_factory=None) -> List[float]:
    """In-process launch of the server and ``client_num`` clients (the
    reference's ``mpirun -np N``); returns the server's global history.
    ``config`` (a FedConfig) sets the transport's codec and inbox cap and is
    held to the port's features (``core/config.check_ported``: the reliable
    and chaos layers are ROADMAP item 11b); ``comm_factory`` builds another
    transport, as in ``comm.local.run_ranks``."""
    from fedml_tpu_torch.core.config import check_ported

    class Args:
        pass

    args = Args()
    args.comm_round = comm_round
    size = client_num + 1
    kw = {}
    if config is not None:
        check_ported(config)
        kw = dict(codec=config.wire_codec, inbox_cap=config.wire_inbox_cap)

    def make(rank, comm):
        if rank == 0:
            return BaseServerManager(args, comm, rank, size)
        return BaseClientManager(args, comm, rank, size)

    managers = run_ranks(make, size, wire_roundtrip=wire_roundtrip, comm_factory=comm_factory,
                         **kw)
    return managers[0].global_history
