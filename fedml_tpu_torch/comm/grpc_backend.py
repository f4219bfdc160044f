"""gRPC edge transport (counterpart of ``fedml_tpu/comm/grpc_backend.py``;
the reference's grpc_comm_manager.py:20-106).

Each rank serves one generic bytes RPC on ``base_port + rank`` (no
protoc-generated stubs); a send is a unary call on a channel to the
receiver's address (``build_ip_table``: the reference's rank->IP csv),
cached per receiver; the servicer enqueues the parsed Message and the
receive loop drains that queue. ``grpc`` is imported when this module is
(lazily, by ``comm.create_comm_manager``), so the rest of the port needs no
grpc installed.
"""

from __future__ import annotations

import csv
import logging
import queue
import threading
from concurrent import futures
from typing import Dict, Optional

import grpc

from fedml_tpu_torch.comm.base import BaseCommunicationManager, put_control
from fedml_tpu_torch.comm.message import Message

log = logging.getLogger(__name__)

_SERVICE = "fedml_tpu.Comm"
_METHOD = "SendMessage"
_FULL_METHOD = f"/{_SERVICE}/{_METHOD}"
# the reference caps messages at 100 MB (grpc_comm_manager.py:35-36); 2 GB
# less some slack here
_MAX_MSG = 2 * 1024 * 1024 * 1024 - 1024
_OPTS = [("grpc.max_send_message_length", _MAX_MSG),
         ("grpc.max_receive_message_length", _MAX_MSG)]

_STOP = object()


def build_ip_table(path: str) -> Dict[int, str]:
    """rank -> IP from a csv of ``receiver_id,ip`` rows under a header row
    (the reference's ip_config_utils.build_ip_table)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return {int(row[0]): row[1].strip() for row in rows[1:] if len(row) >= 2 and row[0].strip()}


class GRPCCommManager(BaseCommunicationManager):
    BASE_PORT = 50000   # the reference's port 50000 + rank (grpc_comm_manager.py:27)

    def __init__(self, rank: int, size: int, ip_table: Optional[Dict[int, str]] = None,
                 ip_config_path: Optional[str] = None, base_port: int = BASE_PORT,
                 host: str = "0.0.0.0", codec: str = "raw", send_timeout: float = 120.0,
                 inbox_cap: int = 0):
        super().__init__(codec=codec)
        self.rank = int(rank)
        self.size = int(size)
        self.base_port = int(base_port)
        # ranks of a multi-process deployment start in any order, so a send
        # waits for the receiver's server (wait_for_ready) up to this long
        self.send_timeout = float(send_timeout)
        if ip_table is None:
            ip_table = (build_ip_table(ip_config_path) if ip_config_path
                        else {r: "127.0.0.1" for r in range(size)})
        self.ip_table = ip_table
        # a bounded inbox (--wire_inbox_cap) blocks the servicer thread,
        # which holds the sender's call: gRPC's flow control pushes back
        self._inbox: "queue.Queue" = queue.Queue(maxsize=int(inbox_cap))
        self._channels: Dict[int, grpc.Channel] = {}
        self._stubs: Dict[int, grpc.UnaryUnaryMultiCallable] = {}
        self._lock = threading.Lock()
        self._running = False
        self._looped = False
        handler = grpc.method_handlers_generic_handler(_SERVICE, {
            _METHOD: grpc.unary_unary_rpc_method_handler(
                self._servicer, request_deserializer=None, response_serializer=None)})
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8), options=_OPTS)
        self._server.add_generic_rpc_handlers((handler,))
        self._port = self._server.add_insecure_port(f"{host}:{self.base_port + self.rank}")
        if self._port == 0:
            raise OSError(f"grpc comm manager rank {self.rank}: failed to bind "
                          f"{host}:{self.base_port + self.rank} (port in use?)")
        self._server.start()
        log.info("grpc comm manager rank %d listening on :%d", self.rank, self._port)

    def _servicer(self, request: bytes, context) -> bytes:
        self._inbox.put(Message.from_bytes(request))
        return b"ok"

    def _stub_for(self, receiver: int):
        with self._lock:
            if receiver not in self._stubs:
                chan = grpc.insecure_channel(
                    f"{self.ip_table[receiver]}:{self.base_port + receiver}", options=_OPTS)
                self._channels[receiver] = chan
                self._stubs[receiver] = chan.unary_unary(
                    _FULL_METHOD, request_serializer=None, response_deserializer=None)
            return self._stubs[receiver]

    def send_message(self, msg: Message) -> None:
        self._stub_for(int(msg.get_receiver_id()))(
            msg.to_bytes(msg.codec or self.codec), wait_for_ready=True,
            timeout=self.send_timeout)

    def inject_local(self, msg: Message) -> None:
        self._inbox.put(msg)

    def handle_receive_message(self) -> None:
        self._running = self._looped = True
        while self._running:
            item = self._inbox.get()
            if item is _STOP:
                break
            self._notify(item)
        self._shutdown()

    def stop_receive_message(self) -> None:
        self._running = False
        put_control(self._inbox, _STOP)
        if not self._looped:
            # a rank whose loop never ran (a failed set-up of the launch)
            # releases its port here
            self._shutdown()

    def _shutdown(self) -> None:
        with self._lock:
            for chan in self._channels.values():
                chan.close()
            self._channels.clear()
            self._stubs.clear()
        self._server.stop(grace=1.0)
