"""MQTT pub/sub transport over a broker socket (counterpart of
``fedml_tpu/comm/mqtt_backend.py``; the reference's mqtt_comm_manager.py:
14-126).

The reference's per-pair topics: the server publishes to client c on
``<topic>0_<c>`` and listens on ``<topic><c>`` for every client
(mqtt_comm_manager.py:47-70, :99-120). Payloads are the Message wire frames
as raw bytes (MQTT payloads are binary-safe). The client stack is
paho-mqtt where installed, else the in-repo socket client
(``comm/mqtt_client.py``), against ``comm/mqtt_broker.MqttBroker`` or any
standard broker.

Unlike the JAX package's manager, the constructor returns only once the
broker has acknowledged this node's subscriptions (SUBACK): a QoS-0 message
published to a topic nobody has subscribed yet is dropped, so a federation
whose server starts sending at once would otherwise race its clients'
subscriptions.
"""

from __future__ import annotations

import queue
import threading

from fedml_tpu_torch.comm.base import BaseCommunicationManager, put_control
from fedml_tpu_torch.comm.message import Message

try:
    import paho.mqtt.client as _mqtt

    HAS_PAHO = True
except ImportError:   # no paho: the socket client takes over
    from fedml_tpu_torch.comm import mqtt_client as _mqtt

    HAS_PAHO = False

_STOP = object()

#: seconds to wait for the broker to acknowledge the subscriptions
SUBSCRIBE_TIMEOUT_S = 30.0


class MqttCommManager(BaseCommunicationManager):
    def __init__(self, host: str, port: int, client_id: int, client_num: int,
                 topic: str = "fedml", codec: str = "raw", inbox_cap: int = 0):
        super().__init__(codec=codec)
        self.client_id = int(client_id)
        self.client_num = int(client_num)
        self.topic = topic
        # a bounded inbox (--wire_inbox_cap) blocks the network loop, so TCP
        # flow control throttles the broker's stream to this node
        self._inbox: "queue.Queue" = queue.Queue(maxsize=int(inbox_cap))
        self._running = False
        self._pending_subs = 0
        self._subscribed = threading.Event()
        self._client = _mqtt.Client(client_id=f"{topic}_node{client_id}", protocol=_mqtt.MQTTv311)
        self._client.on_connect = self._on_connect
        self._client.on_subscribe = self._on_subscribe
        self._client.on_message = self._on_message
        self._client.connect(host, port)
        self._client.loop_start()
        if not self._subscribed.wait(SUBSCRIBE_TIMEOUT_S):
            self._client.disconnect()
            raise TimeoutError(f"mqtt node {client_id}: the broker at {host}:{port} did not "
                               f"acknowledge its subscriptions within {SUBSCRIBE_TIMEOUT_S} s")

    def _topics(self) -> list[str]:
        """The server (id 0) listens on <topic><c> for every client c; a
        client on <topic>0_<own id>."""
        if self.client_id == 0:
            return [f"{self.topic}{cid}" for cid in range(1, self.client_num + 1)]
        return [f"{self.topic}0_{self.client_id}"]

    def _on_connect(self, client, userdata, flags, rc, *rest):
        topics = self._topics()
        self._pending_subs = len(topics)
        for t in topics:
            client.subscribe(t)

    def _on_subscribe(self, client, userdata, mid, granted, *rest):
        self._pending_subs -= 1
        if self._pending_subs <= 0:
            self._subscribed.set()

    def _on_message(self, client, userdata, msg):
        self._inbox.put(Message.from_bytes(msg.payload))

    def send_message(self, msg: Message) -> None:
        receiver = int(msg.get_receiver_id())
        if self.client_id == 0:
            topic = f"{self.topic}0_{receiver}"           # server -> client
        elif receiver == 0:
            topic = f"{self.topic}{self.client_id}"       # client -> server
        else:
            # the per-pair topics are a star (as the reference's are)
            raise NotImplementedError("MQTT backend supports star (client<->server) routing "
                                      "only; peer-to-peer algorithms need the local or gRPC "
                                      "backend")
        self._client.publish(topic, payload=msg.to_bytes(msg.codec or self.codec))

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            item = self._inbox.get()
            if item is _STOP:
                break
            self._notify(item)
        self._client.loop_stop()
        self._client.disconnect()

    def stop_receive_message(self) -> None:
        self._running = False
        put_control(self._inbox, _STOP)
