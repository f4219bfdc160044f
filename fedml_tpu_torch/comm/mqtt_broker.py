"""Minimal MQTT 3.1.1 broker over TCP sockets (counterpart of
``fedml_tpu/comm/mqtt_broker.py``).

The slice of MQTT 3.1.1 the federation's transport needs: CONNECT/CONNACK,
SUBSCRIBE/SUBACK, UNSUBSCRIBE/UNSUBACK, PUBLISH at QoS 0, PINGREQ/PINGRESP
and DISCONNECT, so the backend's per-pair topics and binary Message frames
run over real sockets (framing, partial reads, concurrent publishers)
without an external broker. Out of scope: wildcard topic filters (the
federation's topics never use them), QoS above 0 (the reference publishes
at QoS 0), retained messages, wills and authentication.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading

log = logging.getLogger(__name__)

# control packet types (MQTT 3.1.1 §2.2.1)
CONNECT, CONNACK = 0x1, 0x2
PUBLISH = 0x3
SUBSCRIBE, SUBACK = 0x8, 0x9
UNSUBSCRIBE, UNSUBACK = 0xA, 0xB
PINGREQ, PINGRESP = 0xC, 0xD
DISCONNECT = 0xE


def hard_close(sock: socket.socket) -> None:
    """``shutdown`` before ``close``: a bare close of a socket another
    thread is blocked on in ``recv`` or ``accept`` neither wakes that thread
    nor ends the TCP stream."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Exactly ``n`` bytes from ``sock`` (into one buffer, so a large
    payload costs one copy); ``ConnectionError`` when the peer closes."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if not k:
            raise ConnectionError("peer closed")
        got += k
    return bytes(buf)


def encode_varlen(n: int) -> bytes:
    """The remaining-length varint (§2.2.3)."""
    out = bytearray()
    while True:
        d, n = n & 0x7F, n >> 7
        out.append(d | (0x80 if n else 0))
        if not n:
            return bytes(out)


def read_varlen(recv) -> int:
    mult, val = 1, 0
    for _ in range(4):
        b = recv(1)[0]
        val += (b & 0x7F) * mult
        if not b & 0x80:
            return val
        mult *= 128
    raise ValueError("malformed remaining length")


def mqtt_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack(">H", len(b)) + b


def publish_packet(topic: str, payload: bytes) -> bytes:
    body = mqtt_str(topic) + payload
    return bytes([PUBLISH << 4]) + encode_varlen(len(body)) + body


class _Conn:
    def __init__(self, broker: "MqttBroker", sock: socket.socket, addr):
        self.broker = broker
        self.sock = sock
        self.addr = addr
        self.client_id = ""
        self.topics: set[str] = set()
        self._wlock = threading.Lock()

    def _recv_exact(self, n: int) -> bytes:
        return recv_exact(self.sock, n)

    def send_packet(self, pkt: bytes) -> None:
        with self._wlock:
            self.sock.sendall(pkt)

    def _topics(self, body: bytes, qos_byte: bool):
        off = 2
        while off < len(body):
            tlen = struct.unpack(">H", body[off:off + 2])[0]
            yield body[off + 2:off + 2 + tlen].decode()
            off += 2 + tlen + (1 if qos_byte else 0)

    def serve(self) -> None:
        try:
            while True:
                hdr = self._recv_exact(1)[0]
                ptype, flags = hdr >> 4, hdr & 0xF
                length = read_varlen(self._recv_exact)
                body = self._recv_exact(length) if length else b""
                if ptype == CONNECT:
                    off = 2 + body[1] + 4      # protocol name, level, flags, keepalive
                    cid_len = struct.unpack(">H", body[off:off + 2])[0]
                    self.client_id = body[off + 2:off + 2 + cid_len].decode()
                    self.send_packet(bytes([CONNACK << 4, 2, 0, 0]))
                elif ptype == SUBSCRIBE:
                    granted = bytearray()
                    for topic in self._topics(body, qos_byte=True):
                        self.topics.add(topic)
                        self.broker.subscribe(topic, self)
                        granted.append(0)      # QoS 0
                    self.send_packet(bytes([SUBACK << 4]) + encode_varlen(2 + len(granted))
                                     + body[:2] + bytes(granted))
                elif ptype == UNSUBSCRIBE:
                    for topic in self._topics(body, qos_byte=False):
                        self.topics.discard(topic)
                        self.broker.unsubscribe(topic, self)
                    self.send_packet(bytes([UNSUBACK << 4, 2]) + body[:2])
                elif ptype == PUBLISH:
                    qos = (flags >> 1) & 0x3
                    tlen = struct.unpack(">H", body[:2])[0]
                    topic = body[2:2 + tlen].decode()
                    self.broker.route(topic, body[2 + tlen + (2 if qos else 0):])
                elif ptype == PINGREQ:
                    self.send_packet(bytes([PINGRESP << 4, 0]))
                elif ptype == DISCONNECT:
                    return
        except (ConnectionError, OSError):
            pass
        finally:
            self.broker.drop(self)


class MqttBroker:
    """``with MqttBroker(port) as b:`` serves until ``close()``; port 0
    binds a free port (``b.port``)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._subs: dict[str, list[_Conn]] = {}
        self._lock = threading.Lock()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self.port = self._srv.getsockname()[1]
        self._srv.listen(64)
        self._conns: set[_Conn] = set()
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, name="mqtt-broker",
                                        daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while self._running:
            try:
                sock, addr = self._srv.accept()
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(self, sock, addr)
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=conn.serve, daemon=True, name=f"mqtt-conn-{addr[1]}").start()

    def subscribe(self, topic: str, conn: _Conn):
        with self._lock:
            subs = self._subs.setdefault(topic, [])
            if conn not in subs:
                subs.append(conn)

    def unsubscribe(self, topic: str, conn: _Conn):
        with self._lock:
            if conn in self._subs.get(topic, []):
                self._subs[topic].remove(conn)

    def route(self, topic: str, payload: bytes):
        pkt = publish_packet(topic, payload)
        with self._lock:
            subs = list(self._subs.get(topic, []))
        for conn in subs:
            try:
                conn.send_packet(pkt)
            except OSError:
                self.drop(conn)

    def drop(self, conn: _Conn):
        with self._lock:
            self._conns.discard(conn)
            for subs in self._subs.values():
                if conn in subs:
                    subs.remove(conn)
        hard_close(conn.sock)

    def close(self):
        self._running = False
        # shutdown wakes the accept thread; a bare close would leave a
        # listener that steals a restarted broker's connections
        hard_close(self._srv)
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            hard_close(c.sock)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
