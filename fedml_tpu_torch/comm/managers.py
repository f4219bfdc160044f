"""Node runtime: handler-registry managers (counterpart of
``fedml_tpu/comm/managers.py``; the reference's client_manager.py:13-73 and
server_manager.py:13-68). Both are Observers; ``run()`` registers the
message handlers, then blocks in the transport's receive loop, which
dispatches ``message_handler_dict[msg_type]``. ``finish()`` stops that loop
gracefully, where the reference aborts ``MPI.COMM_WORLD``.

The JAX package's send and receive spans (its tracer) and the gateway's
tenant stamp are not ported (ROADMAP §1 item 12 and item 11b's gateway)."""

from __future__ import annotations

import logging
from typing import Callable, Dict

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.message import Message

log = logging.getLogger(__name__)


class _ManagerBase(Observer):
    def __init__(self, args, comm: BaseCommunicationManager, rank: int = 0, size: int = 0):
        self.args = args
        self.com_manager = comm
        self.rank = int(rank)
        self.size = int(size)
        self.com_manager.add_observer(self)
        self.message_handler_dict: Dict[object, Callable[[Message], None]] = {}

    def register_comm_manager(self, comm: BaseCommunicationManager) -> None:
        self.com_manager = comm

    def run(self) -> None:
        self.register_message_receive_handlers()
        self.com_manager.handle_receive_message()
        log.debug("rank %d run loop exited", self.rank)

    def register_message_receive_handlers(self) -> None:
        raise NotImplementedError

    def register_message_receive_handler(self, msg_type,
                                         handler: Callable[[Message], None]) -> None:
        self.message_handler_dict[msg_type] = handler

    def receive_message(self, msg_type, msg_params: Message) -> None:
        handler = self.message_handler_dict.get(msg_type)
        if handler is None:
            log.warning("rank %d: no handler for msg_type=%r", self.rank, msg_type)
            return
        handler(msg_params)

    def send_message(self, message: Message) -> None:
        self.com_manager.send_message(message)

    def finish(self) -> None:
        """Graceful stop of the receive loop."""
        self.com_manager.stop_receive_message()


class ClientManager(_ManagerBase):
    """Per-client runtime (reference client/client_manager.py:13-73)."""


class ServerManager(_ManagerBase):
    """Rank-0 runtime (reference server/server_manager.py:13-68)."""
