"""Distributed building blocks (counterpart of ``fedml_tpu/distributed``):
communication topologies (``topology.py``), the message-driven algorithm
template and straggler deadline (``base_framework.py``), the edge FedAvg
federation (``fedavg_edge.py``) and asynchronous FedBuff
(``fedbuff_edge.py``). The other edge protocols (split NN, FedGKT, VFL,
TurboAggregate, the decentralized framework) are ROADMAP §1 item 11c; the
gateway is item 11b's, after item 12."""
