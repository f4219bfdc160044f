"""Minimal message-driven algorithm template and the straggler-deadline
machinery (counterpart of ``fedml_tpu/distributed/base_framework.py``; the
reference's distributed/base_framework/algorithm_api.py:16-38).

The server broadcasts an init signal, each client computes a numeric "local
result", the server averages and broadcasts the global result, for
``comm_round`` rounds: the template every message-driven algorithm copies
and the transport's smoke test (the reference's CI-script-framework.sh:
16-24 launches exactly this).

:func:`warn_strict_barrier` is the warning of the edge protocols that keep
the strict all-participants barrier, :class:`OrderedStream` the in-order
handling of the protocols whose messages form strict sequences. The JAX package's flight-dump
broadcast (``broadcast_flight_dump``) belongs to ROADMAP §1 item 12.
"""

from __future__ import annotations

import logging
import threading
import uuid
from typing import List

import numpy as np

from fedml_tpu_torch.comm import ClientManager, Message, ServerManager
from fedml_tpu_torch.comm.local import run_ranks

log = logging.getLogger(__name__)


def warn_strict_barrier(config, proto: str) -> None:
    """Log that ``straggler_deadline_sec`` has no effect for ``proto``:
    unlike the FedAvg edge, this protocol keeps the strict all-participants
    barrier and cannot drop a participant."""
    if getattr(config, "straggler_deadline_sec", None) is not None:
        logging.getLogger(proto).warning(
            "straggler_deadline_sec ignored: %s keeps the strict all-participants barrier "
            "(this protocol cannot drop participants)", proto)


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


#: a stream message's place in its sender's stream to its receiver, and the
#: stream's incarnation
MSG_ARG_KEY_ORDER = "stream_seq"
MSG_ARG_KEY_ORDER_INC = "stream_inc"


class OrderedStream:
    """Per-sender in-order handling over a wire that may reorder (the
    reliable layer resends a dropped message late, behind later ones, and
    the chaos layer delays and reorders): a sender stamps each message to a
    receiver with its place in that stream and the stream's incarnation
    (:meth:`stamp`), and the receiver handles each (sender, incarnation)'s
    stamped messages in stamp order (:meth:`wrap` a handler), holding the
    early ones. An unstamped message (a local control event) is handled at
    once; a place already handled (a duplicate) is dropped; a restarted
    sender's new stream (a new incarnation, places back at 0) is not taken
    for its predecessor's duplicates. For the protocols whose messages form
    strict sequences (VFL's guest, SplitNN's clients), where a reordered
    pair would change what is computed.

    The reliable layer's own sequence numbers cannot serve: they exist only
    when ``wire_reliable`` is on, and that layer hands messages on in
    arrival order on purpose. The protocols that count their messages
    (FedAvg, FedBuff's arrival mode, TurboAggregate, FedGKT, the gossip
    mix) would otherwise wait behind every retransmit, and a send whose
    retries run out would stall its sender's later messages for good,
    where these protocols' deadlines expect to lose only that message."""

    def __init__(self):
        self._inc = uuid.uuid4().hex[:12]
        self._sent: dict[int, int] = {}
        self._next: dict[tuple, int] = {}
        self._held: dict[tuple, dict] = {}

    def stamp(self, msg: Message) -> Message:
        dest = msg.get_receiver_id()
        n = self._sent.get(dest, 0)
        self._sent[dest] = n + 1
        msg.add_params(MSG_ARG_KEY_ORDER, n)
        msg.add_params(MSG_ARG_KEY_ORDER_INC, self._inc)
        return msg

    def wrap(self, handler):
        return lambda msg: self.deliver(msg, handler)

    def deliver(self, msg: Message, handler) -> None:
        seq = msg.get(MSG_ARG_KEY_ORDER)
        if seq is None:
            handler(msg)
            return
        stream = (msg.get_sender_id(), msg.get(MSG_ARG_KEY_ORDER_INC))
        if int(seq) < self._next.get(stream, 0):
            return
        held = self._held.setdefault(stream, {})
        held[int(seq)] = (handler, msg)
        while self._next.get(stream, 0) in held:
            h, m = held.pop(self._next.get(stream, 0))
            self._next[stream] = self._next.get(stream, 0) + 1
            h(m)


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
    ``config`` (a FedConfig) sets the transport's codec and inbox cap,
    stacks the reliable and chaos layers it asks for over each rank's
    transport (``comm/reliable.wire_wrap_factory``), and is held to the
    port's features (``core/config.check_ported``); ``comm_factory`` builds
    another transport, as in ``comm.local.run_ranks``."""
    from fedml_tpu_torch.comm.reliable import wire_wrap_factory
    from fedml_tpu_torch.core.config import check_ported

    class Args:
        pass

    args = Args()
    args.comm_round = comm_round
    size = client_num + 1
    kw = {}
    if config is not None:
        check_ported(config)
        kw = dict(codec=config.wire_codec, inbox_cap=config.wire_inbox_cap,
                  wrap=wire_wrap_factory(config))

    def make(rank, comm):
        if rank == 0:
            return BaseServerManager(args, comm, rank, size)
        return BaseClientManager(args, comm, rank, size)

    managers = run_ranks(make, size, wire_roundtrip=wire_roundtrip, comm_factory=comm_factory,
                         **kw)
    return managers[0].global_history
