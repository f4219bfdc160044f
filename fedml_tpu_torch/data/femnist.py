"""Federated EMNIST and fed_cifar100 in the TFF h5 format, one client per
h5 group (counterpart of ``fedml_tpu/data/femnist.py``; reference
FederatedEMNIST/data_loader.py:26-151, fed_cifar100/data_loader.py).

Layout: ``examples/<client_id>/pixels|image`` and ``label``. When the files
are absent, the loaders return the JAX package's synthetic stand-ins (400 /
200 clients at most). ``h5py`` is imported only when the files exist: with
the files present and no ``h5py``, the loader raises instead of falling
back. Numpy only, bit-equal to the JAX package.
"""

from __future__ import annotations

import os

import numpy as np

from fedml_tpu_torch.data import FedDataset, register_dataset
from fedml_tpu_torch.data.batching import pad_and_stack_clients, pad_eval_pool
from fedml_tpu_torch.data.synthetic import make_synthetic_classification


def _h5_clients(path: str, x_key: str, y_key: str, limit: int):
    import h5py

    xs, ys = [], []
    with h5py.File(path, "r") as f:
        ex = f["examples"]
        for cid in list(ex.keys())[:limit]:
            xs.append(np.asarray(ex[cid][x_key]))
            ys.append(np.asarray(ex[cid][y_key], np.int32))
    return xs, ys


@register_dataset("femnist")
def load_femnist(data_dir: str = "./data/FederatedEMNIST/datasets",
                 client_num_in_total: int = 3400, batch_size: int = 20, seed: int = 0,
                 **_) -> FedDataset:
    train_h5 = os.path.join(data_dir, "fed_emnist_train.h5")
    test_h5 = os.path.join(data_dir, "fed_emnist_test.h5")
    if not (os.path.exists(train_h5) and os.path.exists(test_h5)):
        return make_synthetic_classification(
            "femnist(synthetic)", (28, 28, 1), 62, min(client_num_in_total, 400),
            records_per_client=30, batch_size=batch_size, seed=seed)
    xs, ys = _h5_clients(train_h5, "pixels", "label", client_num_in_total)
    xs = [x.reshape(len(x), 28, 28, 1).astype(np.float32) for x in xs]
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    txs, tys = _h5_clients(test_h5, "pixels", "label", client_num_in_total)
    ex = np.concatenate([x.reshape(len(x), 28, 28, 1).astype(np.float32) for x in txs])
    ey = np.concatenate(tys)
    ex, ey, em = pad_eval_pool(ex, ey, 256)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=62, name="femnist",
    )


_FC100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
_FC100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)


@register_dataset("fed_cifar100")
def load_fed_cifar100(data_dir: str = "./data/fed_cifar100/datasets",
                      client_num_in_total: int = 500, batch_size: int = 20, crop: int = 24,
                      seed: int = 0, **_) -> FedDataset:
    train_h5 = os.path.join(data_dir, "fed_cifar100_train.h5")
    test_h5 = os.path.join(data_dir, "fed_cifar100_test.h5")
    if not (os.path.exists(train_h5) and os.path.exists(test_h5)):
        return make_synthetic_classification(
            "fed_cifar100(synthetic)", (crop, crop, 3), 100, min(client_num_in_total, 200),
            records_per_client=100, batch_size=batch_size, seed=seed)
    xs, ys = _h5_clients(train_h5, "image", "label", client_num_in_total)
    off = (32 - crop) // 2

    def prep(x):
        x = ((x.astype(np.float32) / 255.0) - _FC100_MEAN) / _FC100_STD
        return x[:, off: off + crop, off: off + crop, :]

    xs = [prep(x) for x in xs]
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    txs, tys = _h5_clients(test_h5, "image", "label", client_num_in_total)
    ex, ey, em = pad_eval_pool(np.concatenate([prep(x) for x in txs]), np.concatenate(tys), 256)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=100, name="fed_cifar100",
    )
