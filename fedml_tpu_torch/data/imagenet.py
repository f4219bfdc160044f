"""ImageNet (ILSVRC2012) and Google Landmarks federated loaders
(counterpart of ``fedml_tpu/data/imagenet.py``; reference
fedml_api/data_preprocessing/ImageNet/data_loader.py, a folder per class
split equally over the clients, and Landmarks/data_loader.py, a csv of
(user_id, image_id, class) rows over an image folder: the natural
233 / 1,262-client federation of gld23k / gld160k).

The loaders read files only when they exist, and import ``PIL`` only then
(the card's machine has none); otherwise they return the JAX package's
synthetic stand-in of the same shape contract ([H, W, 3] float32, int
labels). Numpy only, bit-equal to the JAX package.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from fedml_tpu_torch.data import FedDataset, register_dataset
from fedml_tpu_torch.data.batching import pad_and_stack_clients, pad_eval_pool
from fedml_tpu_torch.data.synthetic import make_synthetic_classification


def _read_image(path: str, size: int) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert("RGB").resize((size, size))
    return np.asarray(im, np.float32) / 255.0


@register_dataset("ILSVRC2012", "imagenet")
def load_imagenet(data_dir: str = "./data", num_clients: int = 10, batch_size: int = 32,
                  image_size: int = 64, max_per_class: int = 50, seed: int = 0,
                  **_) -> FedDataset:
    """``{data_dir}/ILSVRC2012/train/<wnid>/*.JPEG``; the clients get an
    equal random split and a tenth of the records is the test pool."""
    root = os.path.join(data_dir, "ILSVRC2012", "train")
    if not os.path.isdir(root):
        return make_synthetic_classification(
            "imagenet", (image_size, image_size, 3), 100, num_clients, records_per_client=32,
            partition_method="homo", batch_size=batch_size, seed=seed)
    classes = sorted(os.listdir(root))
    xs_all, ys_all = [], []
    for ci, wnid in enumerate(classes):
        for f in sorted(os.listdir(os.path.join(root, wnid)))[:max_per_class]:
            xs_all.append(_read_image(os.path.join(root, wnid, f), image_size))
            ys_all.append(ci)
    x = np.stack(xs_all)
    y = np.asarray(ys_all, np.int32)
    order = np.random.default_rng(seed).permutation(len(x))
    n_test = max(len(x) // 10, 1)
    te, tr = order[:n_test], order[n_test:]
    splits = np.array_split(tr, num_clients)
    tx, ty, tm, tc = pad_and_stack_clients([x[s] for s in splits], [y[s] for s in splits],
                                           batch_size)
    ex, ey, em = pad_eval_pool(x[te], y[te], 64)
    return FedDataset(train_x=tx, train_y=ty, train_mask=tm, train_counts=tc, test_x=ex,
                      test_y=ey, test_mask=em, class_num=len(classes), name="ILSVRC2012")


def load_landmarks(data_dir: str = "./data", num_clients: int = 16, batch_size: int = 16,
                   image_size: int = 64, seed: int = 0, variant: str = "gld23k",
                   **_) -> FedDataset:
    """``{data_dir}/landmarks/{variant}_train.csv`` (user_id, image_id,
    class) over ``landmarks/images/<image_id>.jpg``: the user_id column is
    the federation, the first ``num_clients`` users in sorted order, each
    holding out a tenth of its records for the test pool."""
    csv_path = os.path.join(data_dir, "landmarks", f"{variant}_train.csv")
    img_root = os.path.join(data_dir, "landmarks", "images")
    if not (os.path.exists(csv_path) and os.path.isdir(img_root)):
        return make_synthetic_classification(
            variant, (image_size, image_size, 3), 40, num_clients, records_per_client=24,
            partition_method="hetero", batch_size=batch_size, seed=seed)
    by_user: dict[str, list] = {}
    classes: set = set()
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            by_user.setdefault(row["user_id"], []).append((row["image_id"], int(row["class"])))
            classes.add(int(row["class"]))
    xs, ys, test_x, test_y = [], [], [], []
    for u in sorted(by_user)[:num_clients]:
        recs = by_user[u]
        imgs = np.stack([_read_image(os.path.join(img_root, f"{iid}.jpg"), image_size)
                         for iid, _ in recs])
        labels = np.asarray([c for _, c in recs], np.int32)
        n_hold = max(len(recs) // 10, 1)
        xs.append(imgs[n_hold:])
        ys.append(labels[n_hold:])
        test_x.append(imgs[:n_hold])
        test_y.append(labels[:n_hold])
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(np.concatenate(test_x), np.concatenate(test_y), 64)
    return FedDataset(train_x=tx, train_y=ty, train_mask=tm, train_counts=tc, test_x=ex,
                      test_y=ey, test_mask=em, class_num=max(classes) + 1, name=variant)


@register_dataset("gld23k")
def _gld23k(**kw) -> FedDataset:
    kw.pop("variant", None)
    return load_landmarks(variant="gld23k", **kw)


@register_dataset("gld160k")
def _gld160k(**kw) -> FedDataset:
    kw.pop("variant", None)
    return load_landmarks(variant="gld160k", **kw)
