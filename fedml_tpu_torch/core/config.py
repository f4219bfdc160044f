"""Typed configuration (counterpart of ``fedml_tpu/core/config.py``).

Only the fields the ported path reads, with the JAX package's names,
defaults and checks. ``packed_conv`` values other than ``"off"`` and
``rounds_per_step > 1`` exist so that a launch line asking for an unported
schedule fails loudly (``FedAvgAPI`` or ``CrossSiloFedAvgAPI`` raises
``NotImplementedError``) instead of being ignored. The JAX package's
``donate`` (XLA's buffer donation) has no counterpart. Optimizer names are checked where they are built, as in
the JAX package: ``parallel/local.make_optimizer`` and
``algorithms/fedopt.make_server_optimizer`` raise ``ValueError`` for an
unknown name, so an API given one fails when it is constructed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional


@dataclass
class FedConfig:
    model: str = "lr"
    dataset: str = "mnist"

    client_num_in_total: int = 10
    client_num_per_round: int = 10
    comm_round: int = 10

    batch_size: int = 32
    client_optimizer: str = "sgd"    # sgd | adam (amsgrad) | adamw | adagrad | yogi
    lr: float = 0.03
    wd: float = 0.0
    momentum: float = 0.0
    epochs: int = 1
    grad_clip: Optional[float] = None

    # server optimizer (FedOpt): sgd (FedAvgM with server_momentum > 0) |
    # adam | adagrad | yogi
    server_optimizer: str = "sgd"
    server_lr: float = 1.0
    server_momentum: float = 0.0

    # FedProx: each local step adds (mu / 2) ||w - w_global||^2 to the loss
    fedprox_mu: float = 0.1

    frequency_of_the_test: int = 5
    seed: int = 0
    dtype: str = "float32"           # compute dtype: float32 | bfloat16
    # return each round's loss as a 0-dim device tensor (no host sync)
    async_rounds: bool = False
    # "off" ships each round's cohort from host memory; otherwise the whole
    # stacked client dataset is placed on the device once ("auto": when its
    # bytes per rank fit device_data_max_bytes)
    device_data: str = "auto"
    device_data_max_bytes: int = 6_000_000_000
    # the cross-silo grouped schedule (CrossSiloFedAvgAPI): count-sorted
    # clients in up to bucket_groups groups, each trained on its record axis
    # cut to its largest count rounded up to bucket_quantum_batches batches;
    # the host-slice mesh round cuts the cohort's axis the same way (0 = off)
    bucket_quantum_batches: int = 8
    bucket_groups: int = 1

    # client packing (parallel/packed.py): the cohort runs in up to
    # pack_lanes lanes, each lane's clients back to back. Only
    # packed_conv="off" (the per-lane form) is ported.
    pack_lanes: int = 0
    packed_conv: str = "off"

    # elastic rounds: each sampled client fails a round with this
    # probability and aggregates with weight 0
    failure_prob: float = 0.0
    # the cross-silo super-step (rounds folded into one program) is not
    # ported: CrossSiloFedAvgAPI refuses rounds_per_step > 1
    rounds_per_step: int = 1
    # the simulation paradigm's chunked vmap; the mesh rounds ignore it (and
    # log so), and the port's plain round trains client by client anyway
    cohort_vmap_width: int = 0
    # streamed host rounds (device_data off): the cohort trains in
    # sub-cohort chunks of cohort_chunk clients (0 = one chunk), each folded
    # into one f32 model-shaped accumulator as it finishes; "deterministic"
    # and "arrival" fold the same chunk order on this path
    stream_aggregate: str = "off"
    cohort_chunk: int = 0
    # the host round pipeline (data/pipeline.CohortPrefetcher): this many
    # future rounds (streamed: chunks) materialized, cast and copied to the
    # device on background threads (0 = serial); workers fan materialization
    # out over a cohort's clients (0 = auto)
    host_pipeline_depth: int = 0
    host_pipeline_workers: int = 0
    # cohort selection (data/sched.py): uniform | speed | fair
    cohort_policy: str = "uniform"

    def __post_init__(self):
        if self.client_num_per_round > self.client_num_in_total:
            raise ValueError(
                f"client_num_per_round ({self.client_num_per_round}) > "
                f"client_num_in_total ({self.client_num_in_total})")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32|bfloat16, got {self.dtype!r}")
        if self.device_data not in ("auto", "on", "off"):
            raise ValueError(f"device_data must be auto|on|off, got {self.device_data!r}")
        if self.bucket_groups < 1:
            raise ValueError(f"bucket_groups must be >= 1, got {self.bucket_groups}")
        if self.pack_lanes < 0:
            raise ValueError(f"pack_lanes must be >= 0, got {self.pack_lanes}")
        if self.packed_conv not in ("off", "blockdiag", "grouped", "auto"):
            raise ValueError(f"packed_conv must be off|blockdiag|grouped|auto, got "
                             f"{self.packed_conv!r}")
        if self.stream_aggregate not in ("off", "deterministic", "arrival"):
            raise ValueError(f"stream_aggregate must be off|deterministic|arrival, got "
                             f"{self.stream_aggregate!r}")
        if self.cohort_policy not in ("uniform", "speed", "fair"):
            raise ValueError(f"cohort_policy must be uniform|speed|fair, got "
                             f"{self.cohort_policy!r}")
        if self.cohort_chunk < 0:
            raise ValueError(f"cohort_chunk must be >= 0, got {self.cohort_chunk}")
        if self.cohort_chunk > 0 and self.stream_aggregate == "off":
            raise ValueError("cohort_chunk > 0 needs stream_aggregate: sub-cohort chunks only "
                             "exist to be folded into the streaming accumulator; set "
                             "stream_aggregate='deterministic' (or 'arrival')")
        if self.host_pipeline_depth < 0:
            raise ValueError(f"host_pipeline_depth must be >= 0, got "
                             f"{self.host_pipeline_depth}")
        if self.host_pipeline_workers < 0:
            raise ValueError(f"host_pipeline_workers must be >= 0, got "
                             f"{self.host_pipeline_workers}")
        if self.rounds_per_step < 1:
            raise ValueError(f"rounds_per_step must be >= 1, got {self.rounds_per_step}")
        if not 0.0 <= self.failure_prob < 1.0:
            raise ValueError(f"failure_prob must be in [0, 1), got {self.failure_prob}")

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
