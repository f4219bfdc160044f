"""CIFAR-10/100 and CINIC-10 with the homo/hetero partitions (counterpart
of ``fedml_tpu/data/cifar.py``; reference {cifar10,cifar100,cinic10}/
data_loader.py:101-269).

The files: torchvision's pickled batches (``cifar-10-batches-py``,
``cifar-100-python``) or CINIC-10's ImageFolder tree (``train/<class>/*.png``,
``test/<class>/*.png``; PIL is imported only to read one) under
``data_dir``. Images are normalized with the reference's per-channel mean and
std and split over the clients by ``core/partition.py`` (``hetero-fix``
keeps its map file in ``data_dir``). When the files are absent, the loaders return the JAX
package's synthetic stand-in: 32x32x3 class blobs, 160 records a client,
under the same partition. Numpy only, bit-equal to the JAX package.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from fedml_tpu_torch.core.partition import partition as partition_fn
from fedml_tpu_torch.data import FedDataset, register_dataset
from fedml_tpu_torch.data.batching import pad_and_stack_clients, pad_eval_pool
from fedml_tpu_torch.data.synthetic import make_synthetic_classification

_CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
_CIFAR_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
# reference cinic10/data_loader.py:118-119
_CINIC_MEAN = np.array([0.47889522, 0.47227842, 0.43047404], np.float32)
_CINIC_STD = np.array([0.24205776, 0.23828046, 0.25874835], np.float32)


def _load_cifar10_files(root: str):
    d = os.path.join(root, "cifar-10-batches-py")
    if not os.path.isdir(d):
        return None
    xs, ys = [], []
    for name in [f"data_batch_{i}" for i in range(1, 6)]:
        with open(os.path.join(d, name), "rb") as f:
            b = pickle.load(f, encoding="bytes")
        xs.append(b[b"data"])
        ys.extend(b[b"labels"])
    with open(os.path.join(d, "test_batch"), "rb") as f:
        b = pickle.load(f, encoding="bytes")
    test_x, test_y = b[b"data"], np.asarray(b[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    tx = np.asarray(test_x).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.asarray(ys), tx, test_y


def _load_cifar100_files(root: str):
    d = os.path.join(root, "cifar-100-python")
    if not os.path.isdir(d):
        return None
    with open(os.path.join(d, "train"), "rb") as f:
        b = pickle.load(f, encoding="bytes")
    x = b[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.asarray(b[b"fine_labels"])
    with open(os.path.join(d, "test"), "rb") as f:
        b = pickle.load(f, encoding="bytes")
    tx = b[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    ty = np.asarray(b[b"fine_labels"])
    return x, y, tx, ty


def _load_cinic10_files(root: str):
    """CINIC-10's ImageFolder tree: the class index is the alphabetical
    order of the class directories (torchvision's ImageFolder); the two
    splits must have the same 10. The decoded arrays are cached next to the
    tree (``cinic10_decoded.npz``, keyed by each class's image counts)."""
    train_dir, test_dir = os.path.join(root, "train"), os.path.join(root, "test")
    if not (os.path.isdir(train_dir) and os.path.isdir(test_dir)):
        return None
    from PIL import Image

    def class_dirs(d):
        return sorted(e for e in os.listdir(d) if os.path.isdir(os.path.join(d, e)))

    def image_files(cdir):
        return [fn for fn in sorted(os.listdir(cdir))
                if fn.lower().endswith((".png", ".jpg", ".jpeg"))]

    classes = class_dirs(train_dir)
    if classes != class_dirs(test_dir):
        raise ValueError(f"CINIC-10 train/test class dirs differ under {root}: "
                         f"{classes} vs {class_dirs(test_dir)}")
    if len(classes) != 10:
        raise ValueError(f"CINIC-10 tree under {root} has {len(classes)} class dirs "
                         f"({classes}); expected exactly 10")
    fingerprint = np.asarray([len(image_files(os.path.join(d, c)))
                              for d in (train_dir, test_dir) for c in classes], np.int64)
    cache = os.path.join(root, "cinic10_decoded.npz")
    if os.path.isfile(cache):
        try:
            z = np.load(cache)
            if np.array_equal(z["fingerprint"], fingerprint):
                return z["x"], z["y"], z["tx"], z["ty"]
        except Exception:  # a truncated or stale cache is rebuilt
            pass

    def load_split(d):
        xs, ys = [], []
        for ci, cls in enumerate(classes):
            cdir = os.path.join(d, cls)
            for fn in image_files(cdir):
                with Image.open(os.path.join(cdir, fn)) as im:
                    xs.append(np.asarray(im.convert("RGB"), np.uint8))
                ys.append(ci)
        if not xs:
            raise ValueError(f"CINIC-10 split {d} contains no images")
        return np.stack(xs), np.asarray(ys)

    x, y = load_split(train_dir)
    tx, ty = load_split(test_dir)
    tmp = cache + ".tmp.npz"
    try:
        np.savez_compressed(tmp, x=x, y=y, tx=tx, ty=ty, fingerprint=fingerprint)
        os.replace(tmp, cache)
    except OSError:  # a read-only data dir: no cache
        if os.path.exists(tmp):
            os.unlink(tmp)
    return x, y, tx, ty


def _normalize(u8: np.ndarray, mean=_CIFAR_MEAN, std=_CIFAR_STD) -> np.ndarray:
    return ((u8.astype(np.float32) / 255.0) - mean) / std


def _build(name: str, loaded, classes: int, client_num_in_total: int, partition_method: str,
           partition_alpha: float, batch_size: int, seed: int, mean=_CIFAR_MEAN,
           std=_CIFAR_STD, data_dir: str = "./data") -> FedDataset:
    if loaded is None:
        return make_synthetic_classification(
            f"{name}(synthetic)", (32, 32, 3), classes, client_num_in_total,
            records_per_client=160, partition_method=partition_method,
            partition_alpha=partition_alpha, batch_size=batch_size, seed=seed,
            data_dir=data_dir)
    x, y, test_x, test_y = loaded
    x, test_x = _normalize(x, mean, std), _normalize(test_x, mean, std)
    # hetero-fix: the map lives next to the data, keyed on the client count
    # and alpha (the JAX package's file name)
    idx_map = partition_fn(partition_method, y, client_num_in_total, classes, partition_alpha,
                           seed=seed, map_path=os.path.join(
                               data_dir, f"{name}_partition_{client_num_in_total}"
                               f"_a{partition_alpha}.npz"))
    xs = [x[idx_map[i]] for i in range(client_num_in_total)]
    ys = [y[idx_map[i]].astype(np.int32) for i in range(client_num_in_total)]
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(test_x, test_y.astype(np.int32), 256)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=classes, name=name,
    )


@register_dataset("cifar10")
def load_cifar10(data_dir: str = "./data/cifar10", client_num_in_total: int = 10,
                 partition_method: str = "hetero", partition_alpha: float = 0.5,
                 batch_size: int = 64, seed: int = 0, **_) -> FedDataset:
    return _build("cifar10", _load_cifar10_files(data_dir), 10, client_num_in_total,
                  partition_method, partition_alpha, batch_size, seed, data_dir=data_dir)


@register_dataset("cifar100")
def load_cifar100(data_dir: str = "./data/cifar100", client_num_in_total: int = 10,
                  partition_method: str = "hetero", partition_alpha: float = 0.5,
                  batch_size: int = 64, seed: int = 0, **_) -> FedDataset:
    return _build("cifar100", _load_cifar100_files(data_dir), 100, client_num_in_total,
                  partition_method, partition_alpha, batch_size, seed, data_dir=data_dir)


@register_dataset("cinic10")
def load_cinic10(data_dir: str = "./data/cinic10", client_num_in_total: int = 10,
                 partition_method: str = "hetero", partition_alpha: float = 0.5,
                 batch_size: int = 64, seed: int = 0, **_) -> FedDataset:
    return _build("cinic10", _load_cinic10_files(data_dir), 10, client_num_in_total,
                  partition_method, partition_alpha, batch_size, seed,
                  mean=_CINIC_MEAN, std=_CINIC_STD, data_dir=data_dir)
