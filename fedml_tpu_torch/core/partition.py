"""Federated data partitioners (counterpart of ``fedml_tpu/core/partition.py``).

Plain numpy, with the same draws in the same order as the JAX package, so
the index maps are bit-equal. Returns ``dict[client_idx -> indices]``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def partition_class_samples_with_dirichlet_distribution(
    N: int,
    alpha: float,
    client_num: int,
    idx_batch: list[list[int]],
    idx_k: np.ndarray,
    rng: np.random.Generator,
) -> tuple[list[list[int]], int]:
    """Distribute one class's sample indices over clients by a Dirichlet
    draw, zeroing clients already at N/client_num samples
    (reference noniid_partition.py:76-91)."""
    rng.shuffle(idx_k)
    proportions = rng.dirichlet(np.repeat(alpha, client_num))
    proportions = np.array(
        [p * (len(idx_j) < N / client_num) for p, idx_j in zip(proportions, idx_batch)]
    )
    total = proportions.sum()
    if total <= 0:
        proportions = np.full(client_num, 1.0 / client_num)
    else:
        proportions = proportions / total
    proportions = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
    idx_batch = [idx_j + idx.tolist() for idx_j, idx in zip(idx_batch, np.split(idx_k, proportions))]
    min_size = min(len(idx_j) for idx_j in idx_batch)
    return idx_batch, min_size


def non_iid_partition_with_dirichlet_distribution(
    label_list: np.ndarray,
    client_num: int,
    classes: int,
    alpha: float,
    seed: int = 0,
    min_size_floor: int = 10,
) -> dict[int, np.ndarray]:
    """Dirichlet label partition with the reference's minimum-size retry
    loop (noniid_partition.py:6-73), classification labels only."""
    rng = np.random.default_rng(seed)
    min_size = 0
    N = len(label_list)
    min_size_floor = max(1, min(min_size_floor, N // (client_num * 10)))
    attempts = 0
    while min_size < min_size_floor:
        attempts += 1
        if attempts > 1000:
            raise RuntimeError(
                f"Dirichlet partition failed to reach min size {min_size_floor} "
                f"after 1000 attempts (N={N}, clients={client_num}, alpha={alpha})")
        idx_batch: list[list[int]] = [[] for _ in range(client_num)]
        for k in range(classes):
            idx_k = np.where(label_list == k)[0]
            if len(idx_k) == 0:
                continue
            idx_batch, min_size = partition_class_samples_with_dirichlet_distribution(
                N, alpha, client_num, idx_batch, idx_k, rng)
    out = {}
    for i in range(client_num):
        rng.shuffle(idx_batch[i])
        out[i] = np.asarray(idx_batch[i], dtype=np.int64)
    return out


def homo_partition(n_records: int, client_num: int, seed: int = 0) -> dict[int, np.ndarray]:
    """Random equal split (reference cifar10/data_loader.py:119-123)."""
    rng = np.random.default_rng(seed)
    idxs = rng.permutation(n_records)
    return {i: np.sort(part).astype(np.int64)
            for i, part in enumerate(np.array_split(idxs, client_num))}


def hetero_partition(labels: np.ndarray, client_num: int, classes: int,
                     alpha: float, seed: int = 0) -> dict[int, np.ndarray]:
    """'hetero': Dirichlet over labels (reference cifar10/data_loader.py:125-148)."""
    return non_iid_partition_with_dirichlet_distribution(
        labels, client_num, classes, alpha, seed=seed)


def partition(method: str, labels: np.ndarray, client_num: int, classes: int,
              alpha: Optional[float] = None, seed: int = 0) -> dict[int, np.ndarray]:
    """Dispatch on --partition_method (homo | hetero). The JAX package's
    hetero-fix (a precomputed map file) is not ported and raises."""
    if method == "hetero-fix":
        raise ValueError("partition_method='hetero-fix' (a precomputed map file) is not "
                         "ported yet (ROADMAP §1 item 6)")
    if method == "homo":
        return homo_partition(len(labels), client_num, seed=seed)
    if method == "hetero":
        if alpha is None:
            raise ValueError("hetero partition requires alpha (--partition_alpha)")
        return hetero_partition(labels, client_num, classes, alpha, seed=seed)
    raise ValueError(f"unknown or unported partition method: {method!r}")
