"""Edge transports (counterpart of ``fedml_tpu/comm``; the reference's
fedml_core/distributed/communication).

In-process federation (simulation, cross-silo) never uses this package:
there the aggregate is a weighted sum on the card or an all-reduce
(``parallel/crosssilo.py``). It serves participants behind a real wire:
the ``Message`` envelope (message.py), the ``Observer`` callback and
``BaseCommunicationManager`` (base.py), the handler-registry managers
(managers.py) and the transports :func:`create_comm_manager` builds by name:
the in-process router (local.py), gRPC (grpc_backend.py, imported on use)
and MQTT (mqtt_backend.py, with an in-repo broker and socket client). Over
any of them, the wire middleware: seeded chaos injection (chaos.py) under
ACK / retransmit and dedup (reliable.py), stacked by
``reliable.wire_wrap_factory``. The gateway's bounded tenant lanes
(``comm/flow.py``) come with the gateway (ROADMAP §1, "11b's gateway").
"""

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.local import LocalCommunicationManager, LocalRouter
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.message import Message


def create_comm_manager(backend: str, **kwargs):
    """A transport by name (the reference's client_manager.py:20-32 switch):
    ``local`` (or ``MPI``: the in-process router plays its role), ``grpc``
    or ``mqtt``, built from ``kwargs``."""
    if backend in ("LOCAL", "local", "MPI"):
        return LocalCommunicationManager(**kwargs)
    if backend in ("GRPC", "grpc"):
        from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

        return GRPCCommManager(**kwargs)
    if backend in ("MQTT", "mqtt"):
        from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager

        return MqttCommManager(**kwargs)
    raise ValueError(f"unknown comm backend: {backend!r}")


__all__ = ["Message", "Observer", "BaseCommunicationManager", "LocalCommunicationManager",
           "LocalRouter", "ClientManager", "ServerManager", "create_comm_manager"]
