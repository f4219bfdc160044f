"""StackOverflow: logistic-regression tag prediction and next-word
prediction (counterpart of ``fedml_tpu/data/stackoverflow.py``; reference
fedml_api/data_preprocessing/stackoverflow_lr/data_loader.py:25-130 and
stackoverflow_nwp/, TFF h5, 342,477 clients).

Files under ``data_dir``: ``stackoverflow_train.h5`` (and
``stackoverflow_test.h5``), layout ``examples/<client_id>/tokens|title|tags``,
with the vocab tables ``stackoverflow.word_count`` (one ``word count`` a
line, the top 10,000 words) and ``stackoverflow.tag_count`` (json, the top
500 tags). ``h5py`` is imported only when the files exist. The loaders take
``client_num_in_total`` as a cap. Without the files they return the JAX
package's synthetic stand-ins of the same shape contract: LR, a 10,000-dim
bag of words -> 500 multilabel tags; NWP, sequences of 20 tokens over 10,004
ids; LR past 4,096 clients the cross-device
``stackoverflow_lr_full`` dataset. Numpy only, bit-equal to the JAX package.
"""

from __future__ import annotations

import json
import os

import numpy as np

from fedml_tpu_torch.data import FedDataset, register_dataset
from fedml_tpu_torch.data.batching import pad_and_stack_clients, pad_eval_pool

WORD_DIM = 10000
TAG_DIM = 500
NWP_SEQ = 20
NWP_VOCAB = 10004  # pad + 10k words + bos + eos + 1 oov bucket

WORD_COUNT_FILE = "stackoverflow.word_count"
TAG_COUNT_FILE = "stackoverflow.tag_count"


def _word_vocab(data_dir: str, vocab_size: int) -> dict[str, int]:
    """Top-``vocab_size`` words, one per ``word count`` line (reference
    stackoverflow_lr/utils.py:32-52)."""
    vocab: dict[str, int] = {}
    with open(os.path.join(data_dir, WORD_COUNT_FILE)) as f:
        for line in f:
            if len(vocab) >= vocab_size:
                break
            w = line.split()[0]
            if w not in vocab:
                vocab[w] = len(vocab)
    return vocab


def _tag_vocab(data_dir: str, tag_size: int) -> dict[str, int]:
    """Top-``tag_size`` tags from the json count table (reference
    stackoverflow_lr/utils.py:39-62)."""
    with open(os.path.join(data_dir, TAG_COUNT_FILE)) as f:
        counts = json.load(f)
    return {t: i for i, t in enumerate(list(counts)[:tag_size])}


def _h5_client_examples(h5_path: str, limit: int):
    """Yield (tokens, title, tags) string lists for the first ``limit``
    clients of a TFF stackoverflow h5 (reference
    stackoverflow_lr/dataset.py:21-60)."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        ex = f["examples"]
        for cid in list(ex.keys())[:limit]:
            g = ex[cid]
            toks = [b.decode("utf8") for b in g["tokens"][()]]
            titles = ([b.decode("utf8") for b in g["title"][()]] if "title" in g
                      else [""] * len(toks))
            tags = [b.decode("utf8") for b in g["tags"][()]]
            yield toks, titles, tags


def _bag_of_words(sentence: str, vocab: dict[str, int]) -> np.ndarray:
    """Mean multi-hot over the vocab; out-of-vocab tokens count in the
    length only (reference stackoverflow_lr/utils.py:65-84)."""
    out = np.zeros(len(vocab), np.float32)
    toks = sentence.split(" ")
    for t in toks:
        i = vocab.get(t)
        if i is not None:
            out[i] += 1.0
    if toks:
        out /= len(toks)
    return out


def _multi_hot_tags(tag: str, tags: dict[str, int]) -> np.ndarray:
    out = np.zeros(len(tags), np.float32)
    for t in tag.split("|"):
        i = tags.get(t)
        if i is not None:
            out[i] = 1.0
    return out


def _lr_client(toks, titles, tg, vocab, tags):
    x = np.stack([_bag_of_words(" ".join(p for p in (a, b) if p), vocab)
                  for a, b in zip(toks, titles)])
    return x, np.stack([_multi_hot_tags(t, tags) for t in tg])


def _load_so_lr_h5(data_dir: str, client_num: int, batch_size: int) -> FedDataset:
    vocab = _word_vocab(data_dir, WORD_DIM)
    tags = _tag_vocab(data_dir, TAG_DIM)
    xs, ys = [], []
    for ex in _h5_client_examples(os.path.join(data_dir, "stackoverflow_train.h5"), client_num):
        x, y = _lr_client(*ex, vocab, tags)
        xs.append(x)
        ys.append(y)
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    test_h5 = os.path.join(data_dir, "stackoverflow_test.h5")
    if os.path.exists(test_h5):
        pairs = [_lr_client(*ex, vocab, tags) for ex in _h5_client_examples(test_h5, client_num)]
        pool_x = np.concatenate([p[0] for p in pairs])
        pool_y = np.concatenate([p[1] for p in pairs])
    else:
        pool_x, pool_y = np.concatenate(xs), np.concatenate(ys)
    ex, ey, em = pad_eval_pool(pool_x, pool_y, max(batch_size, 32))
    return FedDataset(train_x=tx, train_y=ty, train_mask=tm, train_counts=tc, test_x=ex,
                      test_y=ey, test_mask=em, class_num=len(tags), task="tag_prediction",
                      name="stackoverflow_lr")


def _nwp_ids(sentence: str, vocab: dict[str, int]) -> np.ndarray:
    """bos + truncated token ids (+ eos if short) padded to NWP_SEQ + 1 ids
    (reference stackoverflow_nwp/utils.py:56-84: pad 0, words 1..V, bos
    V + 1, eos V + 2, one out-of-vocab bucket V + 3)."""
    V = len(vocab)
    pad, bos, eos, oov = 0, V + 1, V + 2, V + 3
    toks = sentence.split(" ")[:NWP_SEQ]
    ids = [vocab[t] + 1 if t in vocab else oov for t in toks]
    if len(ids) < NWP_SEQ:
        ids.append(eos)
    ids = [bos] + ids
    ids += [pad] * (NWP_SEQ + 1 - len(ids))
    return np.asarray(ids[: NWP_SEQ + 1], np.int32)


def _load_so_nwp_h5(data_dir: str, client_num: int, batch_size: int) -> FedDataset:
    vocab = _word_vocab(data_dir, WORD_DIM)

    def read(path, limit):
        xs, ys = [], []
        for toks, _titles, _tags in _h5_client_examples(path, limit):
            seq = np.stack([_nwp_ids(s, vocab) for s in toks])
            xs.append(seq[:, :-1])
            ys.append(seq[:, 1:])
        return xs, ys

    xs, ys = read(os.path.join(data_dir, "stackoverflow_train.h5"), client_num)
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    test_h5 = os.path.join(data_dir, "stackoverflow_test.h5")
    if os.path.exists(test_h5):
        exs, eys = read(test_h5, client_num)
        pool_x, pool_y = np.concatenate(exs), np.concatenate(eys)
    else:
        pool_x, pool_y = np.concatenate(xs), np.concatenate(ys)
    ex, ey, em = pad_eval_pool(pool_x, pool_y, max(batch_size, 32))
    return FedDataset(train_x=tx, train_y=ty, train_mask=tm, train_counts=tc, test_x=ex,
                      test_y=ey, test_mask=em, class_num=len(vocab) + 4, task="nwp",
                      name="stackoverflow_nwp")


def _synthetic_so_lr(num_clients: int, batch_size: int, seed: int) -> FedDataset:
    rng = np.random.default_rng(seed)
    # low-rank word -> tag structure, so the linear model learns
    proj = rng.normal(0, 1, (WORD_DIM, TAG_DIM)).astype(np.float32)
    xs, ys = [], []
    for _ in range(num_clients):
        n = int(rng.integers(8, 40))
        x = (rng.random((n, WORD_DIM)) < 0.002).astype(np.float32)
        scores = x @ proj
        y = (scores > np.quantile(scores, 0.99, axis=1, keepdims=True)).astype(np.float32)
        xs.append(x)
        ys.append(y)
    tx, ty, tm, tc = pad_and_stack_clients(xs, ys, batch_size)
    ex, ey, em = pad_eval_pool(np.concatenate(xs)[:512], np.concatenate(ys)[:512], 128)
    return FedDataset(train_x=tx, train_y=ty, train_mask=tm, train_counts=tc, test_x=ex,
                      test_y=ey, test_mask=em, class_num=TAG_DIM, task="tag_prediction",
                      name="stackoverflow_lr(synthetic)")


def _missing_tables(data_dir: str, names) -> None:
    missing = [f for f in names if not os.path.exists(os.path.join(data_dir, f))]
    if missing:
        raise FileNotFoundError(
            f"stackoverflow_train.h5 is mounted but the vocab tables {missing} are missing "
            f"from {data_dir}; refusing to fall back to synthetic data silently")


@register_dataset("stackoverflow_lr")
def load_stackoverflow_lr(data_dir: str = "./data/stackoverflow", client_num_in_total: int = 100,
                          batch_size: int = 10, seed: int = 0, **_) -> FedDataset:
    if not os.path.exists(os.path.join(data_dir, "stackoverflow_train.h5")):
        if client_num_in_total > 4096:
            # the reference's operating point (342,477 clients): the stacked
            # stand-in cannot hold that, so serve the cross-device dataset
            from fedml_tpu_torch.data.crossdevice import load_stackoverflow_lr_full

            return load_stackoverflow_lr_full(client_num_in_total=client_num_in_total,
                                              batch_size=batch_size, seed=seed)
        return _synthetic_so_lr(min(client_num_in_total, 100), batch_size, seed)
    _missing_tables(data_dir, (WORD_COUNT_FILE, TAG_COUNT_FILE))
    return _load_so_lr_h5(data_dir, client_num_in_total, batch_size)


@register_dataset("stackoverflow_nwp")
def load_stackoverflow_nwp(data_dir: str = "./data/stackoverflow", client_num_in_total: int = 100,
                           batch_size: int = 16, seed: int = 0, **_) -> FedDataset:
    if not os.path.exists(os.path.join(data_dir, "stackoverflow_train.h5")):
        from fedml_tpu_torch.data.shakespeare import _synthetic_nwp

        return _synthetic_nwp("stackoverflow_nwp(synthetic)", min(client_num_in_total, 100),
                              NWP_VOCAB, NWP_SEQ, batch_size, seed)
    _missing_tables(data_dir, (WORD_COUNT_FILE,))
    return _load_so_nwp_h5(data_dir, client_num_in_total, batch_size)
