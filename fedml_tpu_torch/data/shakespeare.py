"""Shakespeare next-char datasets (counterpart of
``fedml_tpu/data/shakespeare.py``).

- ``shakespeare``: LEAF json, role-per-client, char sequences of length 80
  (80-symbol printable vocab + pad).
- ``fed_shakespeare``: TFF h5 ``snippets`` per client (vocab 90 = 86 chars
  + pad/bos/eos/oov, sequence length 80).

Records are (x[T], y[T]) with y the one-step-shifted sequence; they pair
with the ``nwp`` task. When the files are absent both fall back to
synthetic token streams, bit-equal to the JAX package's.
"""

from __future__ import annotations

import json
import os
from glob import glob

import numpy as np

from fedml_tpu_torch.data import FedDataset, register_dataset
from fedml_tpu_torch.data.batching import pad_and_stack_clients, pad_eval_pool

SEQ_LEN = 80
# LEAF printable character vocabulary (80 symbols + pad), language_utils.py.
ALL_LETTERS = "\n !\"&'(),-.0123456789:;>?ABCDEFGHIJKLMNOPQRSTUVWXYZ[]abcdefghijklmnopqrstuvwxyz}"
VOCAB_SIZE = len(ALL_LETTERS) + 1  # +1 pad/oov -> 81
_CHAR2IDX = {c: i + 1 for i, c in enumerate(ALL_LETTERS)}


def text_to_ids(s: str) -> np.ndarray:
    return np.asarray([_CHAR2IDX.get(c, 0) for c in s], np.int32)


def _sequences_from_text(ids: np.ndarray, seq_len: int) -> tuple[np.ndarray, np.ndarray]:
    """Chop a char-id stream into (x, y) next-char pairs of fixed length."""
    n = (len(ids) - 1) // seq_len
    if n <= 0:
        return np.zeros((0, seq_len), np.int32), np.zeros((0, seq_len), np.int32)
    x = ids[: n * seq_len].reshape(n, seq_len)
    y = ids[1: n * seq_len + 1].reshape(n, seq_len)
    return x, y


def _synthetic_nwp(name: str, num_clients: int, vocab: int, seq_len: int, batch_size: int,
                   seed: int) -> FedDataset:
    """Markov-ish token streams (a stride walk with 0/1 noise) that a model
    can learn, 6-13 sequences per client."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    for _ in range(num_clients):
        stride = rng.integers(1, 7)
        start = rng.integers(0, vocab)
        n_seq = int(rng.integers(6, 14))
        stream = (start + stride * np.arange(n_seq * seq_len + 1)
                  + rng.integers(0, 2, n_seq * seq_len + 1)) % vocab
        x, y = _sequences_from_text(stream.astype(np.int32), seq_len)
        xs.append(x)
        ys.append(y)
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(np.concatenate(xs), np.concatenate(ys), 64)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=vocab, task="nwp", name=name,
    )


@register_dataset("shakespeare")
def load_shakespeare(data_dir: str = "./data/shakespeare", client_num_in_total: int = 715,
                     batch_size: int = 4, seed: int = 0, **_) -> FedDataset:
    train_dir = os.path.join(data_dir, "train")
    if not glob(os.path.join(train_dir, "*.json")):
        return _synthetic_nwp("shakespeare(synthetic)", min(client_num_in_total, 100),
                              VOCAB_SIZE, SEQ_LEN, batch_size, seed)
    xs, ys, exs, eys = [], [], [], []
    for split, accx, accy in ((os.path.join(data_dir, "train"), xs, ys),
                              (os.path.join(data_dir, "test"), exs, eys)):
        for path in sorted(glob(os.path.join(split, "*.json"))):
            with open(path) as f:
                blob = json.load(f)
            for u in blob["users"][: client_num_in_total]:
                ud = blob["user_data"][u]
                sx = np.stack([text_to_ids(s.ljust(SEQ_LEN)[:SEQ_LEN]) for s in ud["x"]])
                sy_last = [text_to_ids(t)[0] for t in ud["y"]]
                # LEAF stores y as the single next char; rebuild the full shift
                sy = np.concatenate([sx[:, 1:], np.asarray(sy_last, np.int32)[:, None]], axis=1)
                accx.append(sx)
                accy.append(sy)
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(np.concatenate(exs), np.concatenate(eys), 64)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=VOCAB_SIZE, task="nwp",
        name="shakespeare",
    )


@register_dataset("fed_shakespeare")
def load_fed_shakespeare(data_dir: str = "./data/fed_shakespeare/datasets",
                         client_num_in_total: int = 715, batch_size: int = 4, seed: int = 0,
                         **_) -> FedDataset:
    train_h5 = os.path.join(data_dir, "shakespeare_train.h5")
    test_h5 = os.path.join(data_dir, "shakespeare_test.h5")
    vocab = 90  # 86 chars + pad + bos + eos + oov (TFF convention)
    if not (os.path.exists(train_h5) and os.path.exists(test_h5)):
        return _synthetic_nwp("fed_shakespeare(synthetic)", min(client_num_in_total, 100),
                              vocab, SEQ_LEN, batch_size, seed)
    import h5py

    def read(path, limit):
        xs, ys = [], []
        with h5py.File(path, "r") as f:
            ex = f["examples"]
            for cid in list(ex.keys())[:limit]:
                snippets = [s.decode("utf-8") for s in np.asarray(ex[cid]["snippets"])]
                x, y = _sequences_from_text(text_to_ids("".join(snippets)), SEQ_LEN)
                if len(x):
                    xs.append(x)
                    ys.append(y)
        return xs, ys

    xs, ys = read(train_h5, client_num_in_total)
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    exs, eys = read(test_h5, client_num_in_total)
    ex, ey, em = pad_eval_pool(np.concatenate(exs), np.concatenate(eys), 64)
    return FedDataset(
        train_x=tx, train_y=ty, train_mask=tm, train_counts=tc,
        test_x=ex, test_y=ey, test_mask=em, class_num=vocab, task="nwp",
        name="fed_shakespeare",
    )
