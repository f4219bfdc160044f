"""Distributed building blocks (counterpart of ``fedml_tpu/distributed``):
communication topologies (``topology.py``), the message-driven algorithm
template, the straggler deadline and the in-order stream
(``base_framework.py``), and the edge protocols: FedAvg
(``fedavg_edge.py``), asynchronous FedBuff (``fedbuff_edge.py``), FedGKT
(``fedgkt_edge.py``), TurboAggregate (``turboaggregate_edge.py``), SplitNN
(``split_nn_edge.py``), vertical FL (``vfl_edge.py``) and the peer-to-peer
gossip template (``decentralized_framework.py``). The gateway is ROADMAP
§1 item 11b's, after item 12."""
