"""Federated data partitioners (counterpart of ``fedml_tpu/core/partition.py``).

Plain numpy, with the same draws in the same order as the JAX package, so
the index maps are bit-equal. Returns ``dict[client_idx -> indices]``.
"""

from __future__ import annotations

import os
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


def hetero_fix_partition(labels: np.ndarray, client_num: int, classes: int, alpha: float,
                         map_path: str, seed: int = 0) -> dict[int, np.ndarray]:
    """'hetero-fix': a precomputed partition map, so every run and every
    rank sees the same non-IID split (reference cifar10/data_loader.py:
    150-158 reads the map files shipped with it). The map is the JAX
    package's ``.npz`` of ``client_<i>`` index arrays. A missing file is
    made once with the Dirichlet split and saved (atomically), so the first
    run fixes the split for the later ones. A map for another client count,
    or one that does not cover exactly this dataset's records (a stale map
    of another snapshot), raises."""
    if os.path.exists(map_path):
        with np.load(map_path) as z:
            m = {int(k.split("_", 1)[1]): z[k] for k in z.files}
        if len(m) != client_num:
            raise ValueError(f"partition map {map_path!r} has {len(m)} clients, expected "
                             f"{client_num}; delete it to regenerate")
        allidx = np.concatenate([m[i] for i in range(client_num)])
        if len(allidx) != len(labels) or (len(allidx) and int(allidx.max()) >= len(labels)):
            raise ValueError(
                f"partition map {map_path!r} covers {len(allidx)} records (max index "
                f"{int(allidx.max()) if len(allidx) else -1}) but the dataset has "
                f"{len(labels)}; delete it to regenerate")
        return {i: m[i].astype(np.int64) for i in range(client_num)}
    m = hetero_partition(labels, client_num, classes, alpha, seed=seed)
    os.makedirs(os.path.dirname(map_path) or ".", exist_ok=True)
    tmp = map_path + ".tmp.npz"
    np.savez(tmp, **{f"client_{i}": v for i, v in m.items()})
    os.replace(tmp, map_path)
    return m


def partition(method: str, labels: np.ndarray, client_num: int, classes: int,
              alpha: Optional[float] = None, seed: int = 0,
              map_path: Optional[str] = None) -> dict[int, np.ndarray]:
    """Dispatch on --partition_method (homo | hetero | hetero-fix)."""
    if method == "homo":
        return homo_partition(len(labels), client_num, seed=seed)
    if method == "hetero":
        if alpha is None:
            raise ValueError("hetero partition requires alpha (--partition_alpha)")
        return hetero_partition(labels, client_num, classes, alpha, seed=seed)
    if method == "hetero-fix":
        if alpha is None:
            raise ValueError("hetero-fix partition requires alpha for first-run generation")
        if map_path is None:
            raise ValueError("hetero-fix partition requires a map_path")
        return hetero_fix_partition(labels, client_num, classes, alpha, map_path, seed=seed)
    raise ValueError(f"unknown partition method: {method!r}")
