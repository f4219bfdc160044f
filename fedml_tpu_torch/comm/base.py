"""Comm-manager and observer interfaces (counterpart of
``fedml_tpu/comm/base.py``; the reference's base_com_manager.py:7-27 and
observer.py:4-7). Backends deliver through blocking queues (no polling) and
stop gracefully (no ``MPI.COMM_WORLD.Abort()``)."""

from __future__ import annotations

import abc
import queue
from typing import List

from fedml_tpu_torch.comm.message import Message


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type, msg_params: Message) -> None:
        ...


class BaseCommunicationManager(abc.ABC):
    #: wire codec of a send's blobs (``core/compression.py``: raw | q8 |
    #: topk:<ratio>); receivers decode any codec, so a link's two ends may
    #: differ
    codec: str = "raw"

    def __init__(self, codec: str = "raw") -> None:
        self._observers: List[Observer] = []
        self.codec = codec

    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Block, dispatching incoming messages to observers, until stopped."""

    @abc.abstractmethod
    def stop_receive_message(self) -> None:
        ...

    def inject_local(self, msg: Message) -> None:
        """Enqueue a message into this node's own delivery queue (it never
        touches the wire), so a control event (the straggler deadline)
        serializes with message handling on the receive loop."""
        raise NotImplementedError(f"{type(self).__name__} has no local injection")

    def supports_local_injection(self) -> bool:
        """Whether ``inject_local`` reaches a real delivery queue."""
        return type(self).inject_local is not BaseCommunicationManager.inject_local

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        self._observers.remove(observer)

    def _notify(self, msg: Message) -> None:
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)


def put_control(q, item) -> None:
    """Teardown-priority put into a (possibly bounded) queue: never blocks
    for good on a full queue; it drops the oldest item to make room (the
    receiver is being stopped)."""
    while True:
        try:
            q.put(item, timeout=0.05)
            return
        except queue.Full:
            try:
                q.get_nowait()
            except queue.Empty:
                pass


def find_layer(comm, cls):
    """The first layer of type ``cls`` down a wire stack's ``.inner`` chain
    (reliable over chaos over a bare transport), or None: how a protocol
    reaches one layer's hooks (FedBuff's gave-up ejection, the chaos
    layer's ``on_restart``)."""
    node = comm
    while node is not None:
        if isinstance(node, cls):
            return node
        node = getattr(node, "inner", None)
    return None
