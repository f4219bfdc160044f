"""Federated data layer (counterpart of ``fedml_tpu/data/__init__.py``).

:class:`FedDataset` keeps every client's records padded to one shape and
stacked along a leading client axis, with a mask marking real records.
Arrays are host numpy; ``FedAvgAPI`` moves them to the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class FedDataset:
    train_x: np.ndarray             # [num_clients, n_pad, ...]
    train_y: np.ndarray
    train_mask: np.ndarray          # [num_clients, n_pad] {0,1}
    train_counts: np.ndarray        # [num_clients] real record counts
    test_x: np.ndarray              # global test pool, padded
    test_y: np.ndarray
    test_mask: np.ndarray
    class_num: int
    task: str = "classification"
    name: str = ""

    @property
    def num_clients(self) -> int:
        return int(self.train_x.shape[0])

    def client_slice(self, idx: np.ndarray):
        """The sampled clients' stacked (x, y, mask, counts)."""
        return (self.train_x[idx], self.train_y[idx], self.train_mask[idx],
                self.train_counts[idx])
