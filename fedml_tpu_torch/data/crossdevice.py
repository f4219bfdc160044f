"""Cross-device scale: datasets of 10^5-10^6 logical clients (counterpart
of ``fedml_tpu/data/crossdevice.py``; numpy only, every array bit-equal to
the JAX package's).

The stacked :class:`~fedml_tpu_torch.data.FedDataset` holds every client's
padded records, which is impossible at cross-device scale (stackoverflow:
342,477 clients, 50 a round). :class:`CrossDeviceDataset` holds only the
per-client record counts and the test pool: ``train_x/y/mask`` are
:class:`VirtualArray` stubs that carry shape and dtype for the planners and
raise on any data access. ``client_slice(sampled)`` materializes just the
round's cohort ``[cohort, n_pad, ...]``, so memory is O(client count) for
the counts plus O(cohort) a round. Each synthetic client's records derive
from its own ``SeedSequence(entropy=seed, spawn_key=(id,))`` stream, so any
cohort is reproducible without generating the other clients.
"""

from __future__ import annotations

import threading
from typing import Callable

import numpy as np

from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.data.batching import pad_eval_pool

#: the stackoverflow LR task's widths (``fedml_tpu/data/stackoverflow.py``):
#: a 10k-word bag of words in, 500 multilabel tags out
WORD_DIM = 10000
TAG_DIM = 500


class VirtualArray:
    """Shape and dtype of a stacked client array that is never
    materialized. Planners read ``shape``, ``dtype``, ``size`` and
    ``nbytes`` (so a residency check sees the virtual byte count and
    declines); reading data raises."""

    def __init__(self, shape: tuple, dtype):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __len__(self) -> int:
        return self.shape[0]

    def _refuse(self, *_a, **_k):
        raise RuntimeError(
            "this dataset is cross-device scale (virtual client stack of shape "
            f"{self.shape}); materialize cohorts through client_slice() instead of "
            "touching train_x/train_y/train_mask")

    __getitem__ = _refuse
    __array__ = _refuse
    astype = _refuse


class CrossDeviceDataset(FedDataset):
    """A :class:`FedDataset` whose client stack is materialized a cohort at a
    time: ``materialize(ids) -> (x, y, mask)`` returns the stacked padded
    arrays of exactly those clients. ``materialized_rows`` counts every
    padded record row produced (thread-safe: the host round pipeline
    materializes from several threads)."""

    virtual = True

    def __init__(self, *, materialize: Callable, counts: np.ndarray, n_pad: int,
                 sample_shape: tuple, x_dtype, y_shape: tuple, y_dtype, test_x, test_y,
                 test_mask, class_num: int, task: str = "classification", name: str = ""):
        counts = np.asarray(counts)
        n_clients = int(counts.shape[0])
        super().__init__(
            train_x=VirtualArray((n_clients, n_pad) + tuple(sample_shape), x_dtype),
            train_y=VirtualArray((n_clients, n_pad) + tuple(y_shape), y_dtype),
            train_mask=VirtualArray((n_clients, n_pad), np.float32),
            train_counts=counts, test_x=test_x, test_y=test_y, test_mask=test_mask,
            class_num=class_num, task=task, name=name)
        self._materialize = materialize
        self.materialized_rows = 0
        self._rows_lock = threading.Lock()

    def _count_rows(self, x: np.ndarray) -> None:
        with self._rows_lock:
            self.materialized_rows += int(np.prod(x.shape[:2]))

    def client_slice(self, idx: np.ndarray):
        idx = np.asarray(idx)
        x, y, m = self._materialize(idx)
        self._count_rows(x)
        return x, y, m, self.train_counts[idx]

    def client_arrays(self, k: int):
        """One client's padded ``(x, y, mask)``."""
        x, y, m, _ = self.client_slice(np.asarray([k]))
        return x[0], y[0], m[0]


def _client_rng(seed: int, client_id: int) -> np.random.Generator:
    """A client's own stream, independent of every other client's."""
    return np.random.default_rng(np.random.SeedSequence(entropy=seed,
                                                        spawn_key=(int(client_id),)))


def make_synthetic_crossdevice(name: str, input_dim: int, classes: int, num_clients: int, *,
                               batch_size: int = 10, mean_records: float = 20.0,
                               max_records: int = 64, test_records: int = 512,
                               label_alpha: float = 0.3, separation: float = 1.0,
                               multilabel: bool = False, seed: int = 0) -> CrossDeviceDataset:
    """A cross-device classification (or multilabel tag) task at any client
    count. Record counts are lognormal, clipped to ``max_records``; each
    client draws a Dirichlet(``label_alpha``) label preference from its own
    stream, and features are class-mean gaussians. The counts of all clients
    are one vectorized draw; records exist only for materialized cohorts.

    Multilabel draw order, per client: dirichlet (preference) -> poisson
    (tags a record) -> gumbel ``[n, classes]`` (a weighted sample without
    replacement by Gumbel top-k) -> standard normal feature noise."""
    gl = np.random.default_rng(seed)
    counts = np.clip(gl.lognormal(np.log(mean_records), 0.8, num_clients), 1,
                     max_records).astype(np.int64)
    n_pad = int(-(-max_records // batch_size) * batch_size)
    means = gl.standard_normal((classes, input_dim)).astype(np.float32) * separation

    def _gen(rng: np.random.Generator, n: int):
        if multilabel:
            pref = rng.dirichlet(np.full(classes, label_alpha))
            k_tags = 1 + rng.poisson(1.0, n).clip(max=4)
            with np.errstate(divide="ignore"):   # pref underflow: never picked
                scores = np.log(pref)[None, :] + rng.gumbel(size=(n, classes))
            order = np.argsort(-scores, axis=1, kind="stable")[:, :int(k_tags.max())]
            sel = np.arange(order.shape[1])[None, :] < k_tags[:, None]
            y = np.zeros((n, classes), np.float32)
            y[np.arange(n)[:, None], order] = sel.astype(np.float32)
            # the mean of the selected tags' class means, term by term
            w = (sel / k_tags[:, None]).astype(np.float32)
            x = means[order[:, 0]] * w[:, 0:1]
            for j in range(1, order.shape[1]):
                x += means[order[:, j]] * w[:, j:j + 1]
            x += rng.standard_normal((n, input_dim)).astype(np.float32)
            return x, y
        pref = rng.dirichlet(np.full(classes, label_alpha))
        y = rng.choice(classes, size=n, p=pref).astype(np.int32)
        x = means[y] + rng.standard_normal((n, input_dim)).astype(np.float32)
        return x.astype(np.float32), y

    y_shape = (classes,) if multilabel else ()
    y_dtype = np.float32 if multilabel else np.int32

    def materialize(ids: np.ndarray):
        m = len(ids)
        x = np.zeros((m, n_pad, input_dim), np.float32)
        y = np.zeros((m, n_pad) + y_shape, y_dtype)
        mask = np.zeros((m, n_pad), np.float32)
        for j, cid in enumerate(ids):
            n = int(counts[cid])
            cx, cy = _gen(_client_rng(seed, int(cid)), n)
            x[j, :n] = cx
            y[j, :n] = cy
            mask[j, :n] = 1.0
        return x, y, mask

    # the test pool: held-out pseudo-clients (ids from num_clients on)
    tx_parts, ty_parts = [], []
    rows, cid = 0, num_clients
    while rows < test_records:
        cx, cy = _gen(_client_rng(seed, cid), int(min(max_records, test_records - rows)))
        tx_parts.append(cx)
        ty_parts.append(cy)
        rows += cx.shape[0]
        cid += 1
    ex, ey, em = pad_eval_pool(np.concatenate(tx_parts), np.concatenate(ty_parts), 256)
    return CrossDeviceDataset(
        materialize=materialize, counts=counts, n_pad=n_pad, sample_shape=(input_dim,),
        x_dtype=np.float32, y_shape=y_shape, y_dtype=y_dtype, test_x=ex, test_y=ey,
        test_mask=em, class_num=classes,
        task="tag_prediction" if multilabel else "classification", name=name)


def load_stackoverflow_lr_full(client_num_in_total: int = 342_477, batch_size: int = 10,
                               seed: int = 0, **_) -> CrossDeviceDataset:
    """The stackoverflow LR task at its real scale, 342,477 clients, with
    synthetic records: 10k-dim bag-of-words-shaped features, 500 multilabel
    tags, lognormal client sizes, a Dirichlet tag preference per client."""
    return make_synthetic_crossdevice(
        "stackoverflow_lr_full", WORD_DIM, TAG_DIM, client_num_in_total,
        batch_size=batch_size, mean_records=20.0, max_records=64, multilabel=True, seed=seed)
