"""Static-shape batching (counterpart of ``fedml_tpu/data/batching.py``).

Ragged per-client datasets are padded to a common ``n_pad`` (a multiple of
the batch size) and stacked with {0,1} masks. Numpy only, bit-equal to the
JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def pad_to_multiple(n: int, multiple: int) -> int:
    return int(np.ceil(max(n, 1) / multiple) * multiple)


def pad_and_stack_clients(
    xs: Sequence[np.ndarray],
    ys: Sequence[np.ndarray],
    batch_size: int,
    n_pad: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """[per-client ragged arrays] -> (x [C,n_pad,...], y [C,n_pad,...],
    mask [C,n_pad], counts [C]). Padding records repeat the client's own
    records; mask 0 removes them from loss and metrics."""
    counts = np.array([len(x) for x in xs], dtype=np.int64)
    if n_pad is None:
        n_pad = pad_to_multiple(int(counts.max()), batch_size)
    C = len(xs)
    x0, y0 = np.asarray(xs[0]), np.asarray(ys[0])
    out_x = np.zeros((C, n_pad) + x0.shape[1:], dtype=x0.dtype)
    out_y = np.zeros((C, n_pad) + y0.shape[1:], dtype=y0.dtype)
    mask = np.zeros((C, n_pad), dtype=np.float32)
    for i, (x, y) in enumerate(zip(xs, ys)):
        n = len(x)
        if n == 0:
            continue
        reps = int(np.ceil(n_pad / n))
        out_x[i] = np.concatenate([np.asarray(x)] * reps, axis=0)[:n_pad]
        out_y[i] = np.concatenate([np.asarray(y)] * reps, axis=0)[:n_pad]
        mask[i, :n] = 1.0
    return out_x, out_y, mask, counts


def pad_eval_pool(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad a flat eval set to a batch multiple; returns (x, y, mask)."""
    n = len(x)
    n_pad = pad_to_multiple(n, batch_size)
    if n_pad == n:
        return np.asarray(x), np.asarray(y), np.ones(n, np.float32)
    pad = n_pad - n
    xp = np.concatenate([x, np.repeat(np.asarray(x[:1]), pad, axis=0)], axis=0)
    yp = np.concatenate([y, np.repeat(np.asarray(y[:1]), pad, axis=0)], axis=0)
    m = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return xp, yp, m
