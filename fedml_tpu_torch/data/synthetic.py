"""Synthetic federated classification data (counterpart of
``fedml_tpu/data/synthetic.py:make_synthetic_classification``).

The stand-in for CIFAR-10 when the files are absent: class-conditional
gaussian blobs with the real dataset's shapes, partitioned with the
Dirichlet machinery. Same draws in the same order as the JAX package, so
the arrays are bit-equal.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.core.partition import partition as partition_fn
from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.data.batching import pad_and_stack_clients, pad_eval_pool


def make_synthetic_classification(
    name: str,
    input_shape: tuple,
    classes: int,
    num_clients: int,
    records_per_client: int = 64,
    test_records: int = 512,
    partition_method: str = "hetero",
    partition_alpha: float = 0.5,
    batch_size: int = 32,
    seed: int = 0,
    dtype=np.float32,
    separation: float = 1.0,
    label_noise: float = 0.0,
) -> FedDataset:
    rng = np.random.default_rng(seed)
    n_total = num_clients * records_per_client + test_records
    y = rng.integers(0, classes, n_total).astype(np.int32)
    dim = int(np.prod(input_shape))
    means = rng.normal(0, 1.0, (classes, dim)) * separation
    x = (means[y] + rng.normal(0, 1.0, (n_total, dim))).astype(dtype)
    x = x.reshape((n_total,) + tuple(input_shape))
    if label_noise > 0.0:
        # features stay conditional on the clean label; a label_noise
        # fraction of observed labels is resampled uniformly
        flip = rng.random(n_total) < label_noise
        y = np.where(flip, rng.integers(0, classes, n_total), y).astype(np.int32)
    train_x, train_y = x[:-test_records], y[:-test_records]
    test_x, test_y = x[-test_records:], y[-test_records:]
    idx_map = partition_fn(partition_method, train_y, num_clients, classes,
                           partition_alpha, seed=seed)
    xs = [train_x[idx_map[i]] for i in range(num_clients)]
    ys = [train_y[idx_map[i]] for i in range(num_clients)]
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(test_x, test_y, 256)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=classes, name=name,
    )
