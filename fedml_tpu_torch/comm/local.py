"""In-process multi-rank transport (counterpart of ``fedml_tpu/comm/local.py``).

N logical ranks in one process, each on its own thread, exchange Messages
through one blocking ``queue.Queue`` per rank (the reference MPI backend's
0.3 s receive poll and ctypes thread kill are not kept); shutdown is a
sentinel. :func:`run_ranks` launches a federation this way, over this
transport or any other (``comm_factory``).

Rank threads of one process share the card and, in the edge federation,
one model module: the protocols serialize their device work themselves
(``distributed/fedavg_edge.device_call``), never inside the transport.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

from fedml_tpu_torch.comm.base import BaseCommunicationManager, put_control
from fedml_tpu_torch.comm.message import Message

_STOP = object()


class LocalRouter:
    """One mailbox per rank of a launch. ``cap`` bounds every mailbox (0 =
    unbounded): a sender to a full mailbox blocks until the receiver drains
    it (``--wire_inbox_cap``; the in-process analogue of TCP flow control)."""

    def __init__(self, size: int, cap: int = 0):
        self.size = size
        self.cap = int(cap)
        self._queues: Dict[int, "queue.Queue"] = {r: queue.Queue(maxsize=self.cap)
                                                   for r in range(size)}

    def post(self, rank: int, item) -> None:
        self._queues[int(rank)].put(item)

    def post_control(self, rank: int, item) -> None:
        """Teardown-priority post (``put_control``)."""
        put_control(self._queues[int(rank)], item)

    def take(self, rank: int, timeout: Optional[float] = None):
        return self._queues[int(rank)].get(timeout=timeout)


class LocalCommunicationManager(BaseCommunicationManager):
    def __init__(self, router: LocalRouter, rank: int, wire_roundtrip: bool = False,
                 codec: str = "raw"):
        super().__init__(codec=codec)
        self.router = router
        self.rank = int(rank)
        self._running = False
        # every message serialized and parsed in transit: the bytes a gRPC
        # hop would carry; a lossy codec forces it, so it really applies
        self.wire_roundtrip = wire_roundtrip or codec != "raw"

    def send_message(self, msg: Message) -> None:
        payload = (Message.from_bytes(msg.to_bytes(msg.codec or self.codec))
                   if self.wire_roundtrip else msg)
        self.router.post(msg.get_receiver_id(), payload)

    def inject_local(self, msg: Message) -> None:
        self.router.post(self.rank, msg)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            item = self.router.take(self.rank)
            if item is _STOP:
                break
            self._notify(item)

    def stop_receive_message(self) -> None:
        self._running = False
        self.router.post_control(self.rank, _STOP)


def run_ranks(make_manager, size: int, wire_roundtrip: bool = False, timeout: float = 300.0,
              comm_factory=None, codec: str = "raw", inbox_cap: int = 0):
    """Launch ``size`` ranks on threads; rank r runs ``make_manager(r,
    comm).run()``. Returns the managers once every thread has joined (the
    reference's ``mpirun -np N`` and rank branch, FedAvgAPI.py:20-28).

    ``comm_factory(rank)`` builds another transport (gRPC loopback, MQTT)
    in place of ``LocalCommunicationManager``s over one ``LocalRouter``,
    whose mailboxes ``inbox_cap`` bounds and whose sends ``codec``
    compresses (a ``comm_factory`` configures its own). A rank that raises
    stops every rank's receive loop, and the first error is raised here."""
    router = None if comm_factory else LocalRouter(size, cap=inbox_cap)
    comms: list[BaseCommunicationManager] = []
    try:
        for r in range(size):
            comms.append(comm_factory(r) if comm_factory else LocalCommunicationManager(
                router, r, wire_roundtrip=wire_roundtrip, codec=codec))
        managers = [make_manager(r, comms[r]) for r in range(size)]
    except BaseException:
        # a partial set-up (a port already bound) releases what it made
        for c in comms:
            c.stop_receive_message()
        raise

    errors: Dict[int, BaseException] = {}

    def _run(rank: int, m) -> None:
        try:
            m.run()
        except BaseException as e:   # propagate to the caller, unblock the peers
            errors[rank] = e
            for c in comms:
                c.stop_receive_message()

    threads = [threading.Thread(target=_run, args=(r, m), daemon=True, name=f"rank{r}")
               for r, m in enumerate(managers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        if t.is_alive() and not errors:
            raise TimeoutError(f"rank thread {t.name} did not finish within {timeout}s")
    if errors:
        rank, err = sorted(errors.items())[0]
        raise RuntimeError(f"rank {rank} raised during run_ranks") from err
    return managers
