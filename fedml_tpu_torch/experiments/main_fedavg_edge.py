"""Thin alias of the unified launcher: equivalent to ``--algorithm
fedavg_edge``, the message-driven FedAvg deployment over the in-process
router, gRPC loopback (``--backend grpc``), or as one rank of a
multi-process gRPC federation (``--rank R --world_size N``;
``experiments/launch_edge.py`` starts every rank on one host)."""

import sys

from fedml_tpu_torch.experiments.run import main

if __name__ == "__main__":
    main(sys.argv[1:], default_algorithm="fedavg_edge")
