"""Federated data layer (counterpart of ``fedml_tpu/data/__init__.py``).

:class:`FedDataset` keeps every client's records padded to one shape and
stacked along a leading client axis, with a mask marking real records.
Arrays are host numpy; ``FedAvgAPI`` moves them to the device.

Loaders register under the reference's ``--dataset`` names
(:func:`register_dataset`) and :func:`load_dataset` dispatches on them. A
name the JAX package knows but the port does not load yet raises
``NotImplementedError`` with its ROADMAP item.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable

import numpy as np

_LOADERS: dict[str, Callable[..., "FedDataset"]] = {}

def register_dataset(*names: str):
    def deco(fn):
        for n in names:
            _LOADERS[n] = fn
        return fn
    return deco


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

    @property
    def train_data_num(self) -> int:
        return int(self.train_counts.sum())

    @property
    def test_data_num(self) -> int:
        return int(self.test_mask.sum())

    def client_slice(self, idx: np.ndarray):
        """The sampled clients' stacked (x, y, mask, counts)."""
        return (self.train_x[idx], self.train_y[idx], self.train_mask[idx],
                self.train_counts[idx])

    def client_arrays(self, k: int):
        """One client's padded ``(x, y, mask)``, the streaming round's
        accessor (views of the stack; a virtual dataset materializes it)."""
        return self.train_x[k], self.train_y[k], self.train_mask[k]

    def client_slice_cached(self, k: int, cap: int = 64):
        """``client_slice([k])`` behind a small LRU of ``cap`` clients
        (the JAX package's). Repeated requests for a client (every epoch,
        every round it is sampled) are served from the cache, so a virtual
        dataset's ``materialized_rows`` counts each client once while it
        stays cached. Thread-safe and single-flight: concurrent misses for
        one client materialize it once and share the result. The arrays are
        shared, so they are made read-only."""
        k = int(k)
        lock = self.__dict__.setdefault("_client_lru_lock", threading.Lock())
        cache = self.__dict__.setdefault("_client_lru", {})
        pending = self.__dict__.setdefault("_client_lru_pending", {})
        with lock:
            hit = cache.get(k)
            if hit is not None:
                cache[k] = cache.pop(k)       # dict order is recency
                return hit
            fut = pending.get(k)
            owner = fut is None
            if owner:
                fut = pending[k] = Future()
        if not owner:
            return fut.result()
        try:
            out = self.client_slice(np.asarray([k]))
            for a in out:
                if isinstance(a, np.ndarray):
                    a.flags.writeable = False
        except BaseException as e:
            with lock:
                pending.pop(k, None)          # the next request retries
            fut.set_exception(e)
            raise
        with lock:
            cache[k] = out
            while len(cache) > cap:
                cache.pop(next(iter(cache)))
            pending.pop(k, None)
        fut.set_result(out)
        return out


def _register_all() -> None:
    from fedml_tpu_torch.data import (cifar, crossdevice, femnist, imagenet,  # noqa: F401
                                      mnist, segmentation, shakespeare, stackoverflow,
                                      synthetic)


def load_dataset(name: str, **kw) -> FedDataset:
    """Dispatch on the reference's ``--dataset`` values (synthetic_1_1,
    mnist, femnist, fed_cifar100, cifar10, cifar100, cinic10, shakespeare,
    fed_shakespeare, stackoverflow_lr, stackoverflow_nwp, stackoverflow_lr_full,
    ILSVRC2012, gld23k, pascal_voc, ...). Loaders ignore keyword
    arguments they do not take."""
    _register_all()
    if name not in _LOADERS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_LOADERS)}")
    return _LOADERS[name](**kw)


def known_datasets() -> list[str]:
    _register_all()
    return sorted(_LOADERS)
