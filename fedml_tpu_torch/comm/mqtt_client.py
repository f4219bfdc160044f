"""Minimal MQTT 3.1.1 client over TCP, with paho's surface (counterpart of
``fedml_tpu/comm/mqtt_client.py``).

Exactly what ``MqttCommManager`` calls: ``Client(client_id, protocol)``,
``connect``, ``loop_start``, ``subscribe``, ``publish``, ``loop_stop``,
``disconnect`` and the ``on_connect`` / ``on_subscribe`` / ``on_message``
callbacks, so the backend runs over a real socket (against
``mqtt_broker.MqttBroker`` or any standard broker) where paho-mqtt is not
installed. If the connection drops
while the loop runs, the reader reconnects after a short backoff and fires
``on_connect`` again, where the backend subscribes again: a broker restart
loses at most the QoS-0 messages in flight, as with paho at QoS 0.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time

from fedml_tpu_torch.comm.mqtt_broker import (CONNACK, CONNECT, DISCONNECT, PUBLISH, SUBACK,
                                              SUBSCRIBE, encode_varlen, hard_close, mqtt_str,
                                              publish_packet, read_varlen, recv_exact)

log = logging.getLogger(__name__)

MQTTv311 = 4


class _Msg:
    def __init__(self, topic: str, payload: bytes):
        self.topic = topic
        self.payload = payload


class Client:
    def __init__(self, client_id: str = "", protocol: int = MQTTv311,
                 reconnect_backoff: float = 0.2):
        self._id = client_id or f"fedml-{id(self)}"
        self.on_connect = None
        self.on_subscribe = None
        self.on_message = None
        self._host = self._port = None
        self._sock: "socket.socket | None" = None
        self._wlock = threading.Lock()
        self._running = False
        self._thread = None
        self._pid = 0
        self._backoff = reconnect_backoff

    def connect(self, host: str, port: int = 1883, keepalive: int = 60):
        self._host, self._port = host, int(port)
        self._dial()

    def loop_start(self):
        self._running = True
        self._thread = threading.Thread(target=self._reader, daemon=True,
                                        name=f"mqtt-client-{self._id}")
        self._thread.start()

    def subscribe(self, topic: str, qos: int = 0):
        self._pid = (self._pid % 0xFFFF) + 1
        body = struct.pack(">H", self._pid) + mqtt_str(topic) + bytes([0])
        # SUBSCRIBE's fixed-header flags must be 0b0010 (§3.8.1)
        self._send(bytes([(SUBSCRIBE << 4) | 0x2]) + encode_varlen(len(body)) + body)

    def publish(self, topic: str, payload: bytes = b"", qos: int = 0):
        self._send(publish_packet(topic, bytes(payload)))

    def loop_stop(self):
        self._running = False

    def disconnect(self):
        self._running = False
        try:
            self._send(bytes([DISCONNECT << 4, 0]))
        except OSError:
            pass
        if self._sock is not None:
            hard_close(self._sock)

    def _dial(self):
        sock = socket.create_connection((self._host, self._port), timeout=10)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(None)
        body = (mqtt_str("MQTT") + bytes([MQTTv311]) + bytes([0x02])   # clean session
                + struct.pack(">H", 60) + mqtt_str(self._id))           # keepalive, id
        sock.sendall(bytes([CONNECT << 4]) + encode_varlen(len(body)) + body)
        self._sock = sock

    def _send(self, pkt: bytes):
        with self._wlock:
            if self._sock is None:
                raise OSError("not connected")
            self._sock.sendall(pkt)

    def _recv_exact(self, n: int) -> bytes:
        return recv_exact(self._sock, n)

    def _reader(self):
        while self._running:
            try:
                ptype = self._recv_exact(1)[0] >> 4
                length = read_varlen(self._recv_exact)
                body = self._recv_exact(length) if length else b""
                if ptype == CONNACK and self.on_connect:
                    self.on_connect(self, None, None, body[1])
                elif ptype == SUBACK and self.on_subscribe:
                    self.on_subscribe(self, None, struct.unpack(">H", body[:2])[0],
                                      tuple(body[2:]))
                elif ptype == PUBLISH and self.on_message:
                    tlen = struct.unpack(">H", body[:2])[0]
                    self.on_message(self, None, _Msg(body[2:2 + tlen].decode(), body[2 + tlen:]))
            except (ConnectionError, OSError, IndexError):
                if not self._running:
                    return
                log.warning("mqtt client %s: connection lost, reconnecting", self._id)
                if self._sock is not None:
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                while self._running:
                    try:
                        time.sleep(self._backoff)
                        self._dial()
                        break
                    except OSError:
                        continue
