"""MNIST in the LEAF JSON format, one client per LEAF user (counterpart of
``fedml_tpu/data/mnist.py``; reference MNIST/data_loader.py:8-120).

Layout: ``{data_dir}/train/*.json`` and ``{data_dir}/test/*.json``, each
``{"users": [...], "user_data": {user: {"x": [[784] ...], "y": [...]}}}``.
When either directory holds no JSON file, the loader returns the JAX
package's synthetic stand-in of the same shapes. Numpy only, bit-equal to
the JAX package.
"""

from __future__ import annotations

import json
import os
from glob import glob

import numpy as np

from fedml_tpu_torch.data import FedDataset, register_dataset
from fedml_tpu_torch.data.batching import pad_and_stack_clients, pad_eval_pool
from fedml_tpu_torch.data.synthetic import make_synthetic_classification


def _read_leaf_dir(d: str) -> dict[str, dict]:
    users: dict[str, dict] = {}
    for path in sorted(glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            blob = json.load(f)
        for u in blob["users"]:
            users[u] = blob["user_data"][u]
    return users


@register_dataset("mnist")
def load_mnist(data_dir: str = "./data/MNIST", client_num_in_total: int = 1000,
               batch_size: int = 10, seed: int = 0, **_) -> FedDataset:
    train_dir, test_dir = os.path.join(data_dir, "train"), os.path.join(data_dir, "test")
    if not (glob(os.path.join(train_dir, "*.json")) and glob(os.path.join(test_dir, "*.json"))):
        return make_synthetic_classification(
            "mnist(synthetic)", (784,), 10, client_num_in_total,
            records_per_client=30, batch_size=batch_size, seed=seed)
    train_users = _read_leaf_dir(train_dir)
    test_users = _read_leaf_dir(test_dir)
    names = sorted(train_users)[:client_num_in_total]
    xs = [np.asarray(train_users[u]["x"], np.float32) for u in names]
    ys = [np.asarray(train_users[u]["y"], np.int32) for u in names]
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex = np.concatenate([np.asarray(test_users[u]["x"], np.float32)
                         for u in names if u in test_users])
    ey = np.concatenate([np.asarray(test_users[u]["y"], np.int32)
                         for u in names if u in test_users])
    ex, ey, em = pad_eval_pool(ex, ey, 256)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=10, name="mnist",
    )
