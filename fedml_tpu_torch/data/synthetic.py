"""Synthetic federated datasets (counterpart of ``fedml_tpu/data/synthetic.py``).

1. ``synthetic_1_1``, ``synthetic_0_0``, ``synthetic_0.5_0.5``: the LEAF
   synthetic(alpha, beta) logistic-regression task with power-law client
   sizes (:func:`make_synthetic_lr`).
2. :func:`make_synthetic_classification`: the stand-in every image loader
   falls back to when its files are absent: class-conditional gaussian blobs
   with the real dataset's shapes, partitioned with the Dirichlet machinery.

Numpy only, the same draws in the same order as the JAX package, so the
arrays are bit-equal.
"""

from __future__ import annotations

import os

import numpy as np

from fedml_tpu_torch.core.partition import partition as partition_fn
from fedml_tpu_torch.data import FedDataset, register_dataset
from fedml_tpu_torch.data.batching import pad_and_stack_clients, pad_eval_pool


def _power_law_sizes(num_clients: int, rng: np.random.Generator, min_size: int = 10,
                     mean: float = 40.0):
    sizes = (rng.lognormal(np.log(mean), 1.0, num_clients)).astype(int)
    return np.clip(sizes, min_size, None)


def make_synthetic_lr(alpha: float = 1.0, beta: float = 1.0, num_clients: int = 30,
                      dim: int = 60, classes: int = 10, batch_size: int = 10,
                      seed: int = 0) -> FedDataset:
    """Client k: model W_k ~ N(u_k, 1), u_k ~ N(0, alpha); features
    x ~ N(v_k, Sigma), v_k ~ N(B_k, 1), B_k ~ N(0, beta), Sigma diagonal
    j^-1.2; labels argmax(W_k x + b_k). Each client's last 8 records go to
    the test pool."""
    rng = np.random.default_rng(seed)
    sizes = _power_law_sizes(num_clients, rng)
    diag = np.array([(j + 1) ** -1.2 for j in range(dim)])
    xs, ys, test_xs, test_ys = [], [], [], []
    for k in range(num_clients):
        u_k = rng.normal(0, alpha)
        W = rng.normal(u_k, 1, (dim, classes))
        b = rng.normal(u_k, 1, classes)
        B_k = rng.normal(0, beta)
        v_k = rng.normal(B_k, 1, dim)
        n = int(sizes[k]) + 8
        # the covariance scales the noise only
        x = v_k + rng.normal(0, 1, (n, dim)) * np.sqrt(diag)
        y = np.argmax(x @ W + b, axis=1)
        xs.append(x[:-8].astype(np.float32))
        ys.append(y[:-8].astype(np.int32))
        test_xs.append(x[-8:].astype(np.float32))
        test_ys.append(y[-8:].astype(np.int32))
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(np.concatenate(test_xs), np.concatenate(test_ys), 256)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=classes,
        name=f"synthetic_{alpha}_{beta}",
    )


@register_dataset("synthetic_1_1")
def _syn11(num_clients: int = 30, batch_size: int = 10, seed: int = 0, **_):
    return make_synthetic_lr(1.0, 1.0, num_clients, batch_size=batch_size, seed=seed)


@register_dataset("synthetic_0_0")
def _syn00(num_clients: int = 30, batch_size: int = 10, seed: int = 0, **_):
    return make_synthetic_lr(0.0, 0.0, num_clients, batch_size=batch_size, seed=seed)


@register_dataset("synthetic_0.5_0.5")
def _syn55(num_clients: int = 30, batch_size: int = 10, seed: int = 0, **_):
    return make_synthetic_lr(0.5, 0.5, num_clients, batch_size=batch_size, seed=seed)


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
    data_dir: str = "./data",
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
    # hetero-fix: synthetic labels depend on the seed, so the fixed map is
    # keyed on alpha and seed (the JAX package's file name)
    idx_map = partition_fn(partition_method, train_y, num_clients, classes,
                           partition_alpha, seed=seed,
                           map_path=os.path.join(data_dir, f"{name}_partition_{num_clients}"
                                                 f"_a{partition_alpha}_s{seed}.npz"))
    xs = [train_x[idx_map[i]] for i in range(num_clients)]
    ys = [train_y[idx_map[i]] for i in range(num_clients)]
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(test_x, test_y, 256)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=classes, name=name,
    )
