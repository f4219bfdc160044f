"""Federated segmentation datasets for FedSeg (counterpart of
``fedml_tpu/data/segmentation.py``; numpy only, bit-equal to the JAX
package).

``pascal_voc`` and ``coco_seg`` read preprocessed shards
``{data_dir}/pascal_voc/client_*.npz`` (x ``[n, H, W, 3]`` float, y
``[n, H, W]`` uint8 with 255 = ignore) and ``test.npz``; when there are
none they return the synthetic blob task, which has the same contract:
images ``[*, H, W, 3]``, integer masks ``[*, H, W]``, 255 = ignore.
"""

from __future__ import annotations

import os

import numpy as np

from fedml_tpu_torch.data import FedDataset, register_dataset
from fedml_tpu_torch.data.batching import pad_and_stack_clients, pad_eval_pool


def make_synthetic_segmentation(num_clients: int = 4, records_per_client: int = 8,
                                image_size: int = 32, num_classes: int = 4,
                                batch_size: int = 4, seed: int = 0,
                                ignore_frac: float = 0.02) -> FedDataset:
    """Blob task: class-0 background and coloured rectangles whose fill
    colour follows their class, with ``ignore_frac`` of the pixels set to
    255. Draws from ``default_rng(seed)`` in the JAX package's order."""
    rng = np.random.default_rng(seed)
    H = image_size

    def sample(n):
        xs = np.zeros((n, H, H, 3), np.float32)
        ys = np.zeros((n, H, H), np.int32)
        for i in range(n):
            xs[i] = rng.normal(0, 0.05, (H, H, 3))
            for _ in range(rng.integers(1, 4)):
                c = int(rng.integers(1, num_classes))
                h0, w0 = rng.integers(0, H // 2, 2)
                h1 = h0 + int(rng.integers(4, H // 2))
                w1 = w0 + int(rng.integers(4, H // 2))
                color = np.array([c / num_classes, 1 - c / num_classes, 0.5])
                xs[i, h0:h1, w0:w1] = color + rng.normal(0, 0.05, 3)
                ys[i, h0:h1, w0:w1] = c
            ys[i][rng.random((H, H)) < ignore_frac] = 255
        return xs, ys

    xs, ys = [], []
    for _ in range(num_clients):
        x, y = sample(records_per_client)
        xs.append(x)
        ys.append(y)
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(*sample(max(2 * records_per_client, 16)), 16)
    return FedDataset(train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
                      test_x=ex, test_y=ey, test_mask=em, class_num=num_classes,
                      task="segmentation", name="synthetic_seg")


@register_dataset("pascal_voc", "coco_seg")
def _load_seg(data_dir: str = "./data", num_clients: int = 4, batch_size: int = 4,
              image_size: int = 32, seed: int = 0, **_) -> FedDataset:
    """The first ``num_clients`` shards and the test shard; the class count
    spans every shard and the test set, so a class absent from the loaded
    clients keeps its place in the label space."""
    root = os.path.join(data_dir, "pascal_voc")
    shards = sorted(os.path.join(root, f) for f in (os.listdir(root) if os.path.isdir(root)
                                                    else [])
                    if f.startswith("client_") and f.endswith(".npz"))
    if not shards:
        return make_synthetic_segmentation(num_clients=num_clients, batch_size=batch_size,
                                           image_size=image_size, seed=seed)

    def classes_in(y) -> int:
        return int(y[y != 255].max()) + 1 if np.any(y != 255) else 0

    classes = max(classes_in(np.load(s)["y"].astype(np.int32)) for s in shards)
    xs, ys = [], []
    for s in shards[:num_clients]:
        blob = np.load(s)
        xs.append(blob["x"].astype(np.float32))
        ys.append(blob["y"].astype(np.int32))
    test = np.load(os.path.join(root, "test.npz"))
    test_y = test["y"].astype(np.int32)
    classes = max(classes, classes_in(test_y))
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(test["x"].astype(np.float32), test_y, 16)
    return FedDataset(train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
                      test_x=ex, test_y=ey, test_mask=em, class_num=classes,
                      task="segmentation", name="pascal_voc")
