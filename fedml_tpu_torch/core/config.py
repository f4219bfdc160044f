"""Typed configuration (counterpart of ``fedml_tpu/core/config.py``).

Only the fields the ported path reads, with the JAX package's names and
defaults. ``pack_lanes``, ``failure_prob`` and ``stream_aggregate`` exist so
that a launch line asking for an unported schedule fails loudly
(``FedAvgAPI`` raises ``NotImplementedError``) instead of being ignored.
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
    client_optimizer: str = "sgd"
    lr: float = 0.03
    wd: float = 0.0
    momentum: float = 0.0
    epochs: int = 1
    grad_clip: Optional[float] = None

    frequency_of_the_test: int = 5
    seed: int = 0
    dtype: str = "float32"           # compute dtype: float32 | bfloat16
    # return each round's loss as a 0-dim device tensor (no host sync)
    async_rounds: bool = False
    # "off" ships each round's cohort from host memory; otherwise the whole
    # stacked client dataset is placed on the device once
    device_data: str = "auto"

    # schedules of the JAX package that are not ported yet
    pack_lanes: int = 0
    failure_prob: float = 0.0
    stream_aggregate: str = "off"

    def __post_init__(self):
        if self.client_num_per_round > self.client_num_in_total:
            raise ValueError(
                f"client_num_per_round ({self.client_num_per_round}) > "
                f"client_num_in_total ({self.client_num_in_total})")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32|bfloat16, got {self.dtype!r}")
        if self.device_data not in ("auto", "on", "off"):
            raise ValueError(f"device_data must be auto|on|off, got {self.device_data!r}")
        if self.pack_lanes < 0:
            raise ValueError(f"pack_lanes must be >= 0, got {self.pack_lanes}")
        if not 0.0 <= self.failure_prob < 1.0:
            raise ValueError(f"failure_prob must be in [0, 1), got {self.failure_prob}")

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)
