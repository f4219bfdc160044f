"""Vertical (feature-partitioned) datasets for classical VFL (counterpart of
``fedml_tpu/data/vertical.py``, whose numpy it keeps line for line, so
both packages build the same tables from the same seed).

Counterpart of the reference's vertical-FL loaders, which split ONE table's
feature columns across parties:

- lending_club: party A = qualification+loan features, party B =
  debt+repayment(+multi_acc+mal_behavior) — lending_club_dataset.py:141-190,
- NUS_WIDE: party A = low-level image features, party B = tag features —
  NUS_WIDE/nus_wide_dataset.py:23-230,
- UCI credit default — UCI/.

All reference loaders reduce to the same contract: ``(Xa, y)`` for the
label-holding guest and ``Xb[, Xc]`` for the hosts, already row-aligned.
:class:`VerticalDataset` captures that contract; the real-file loaders are
gated on the files existing on disk (zero-egress environment) and otherwise
fall back to a synthetic table with the same party feature-widths, so every
algorithm and test path exercises identical code.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class VerticalDataset:
    """Row-aligned feature-partitioned dataset; party 0 is the guest
    (holds the binary labels), parties 1.. are hosts."""

    train_parts: list[np.ndarray]     # per-party [n_train, d_p] float32
    train_y: np.ndarray               # [n_train] {0,1} float32
    test_parts: list[np.ndarray]
    test_y: np.ndarray
    name: str = ""

    @property
    def num_parties(self) -> int:
        return len(self.train_parts)

    @property
    def party_dims(self) -> list[int]:
        return [int(p.shape[1]) for p in self.train_parts]


def make_synthetic_vertical(
    party_dims: Sequence[int] = (12, 10),
    n_train: int = 512,
    n_test: int = 128,
    seed: int = 0,
    name: str = "synthetic_vertical",
) -> VerticalDataset:
    """Learnable two/three-party binary task: the label depends on ALL
    parties' features, so a guest-only model underperforms the federation —
    the property VFL exists to demonstrate."""
    rng = np.random.default_rng(seed)
    n = n_train + n_test
    parts = [rng.normal(0, 1, (n, d)).astype(np.float32) for d in party_dims]
    ws = [rng.normal(0, 1, (d,)) for d in party_dims]
    score = sum(p @ w for p, w in zip(parts, ws)) + 0.3 * rng.normal(0, 1, n)
    y = (score > np.median(score)).astype(np.float32)
    return VerticalDataset(
        train_parts=[p[:n_train] for p in parts],
        train_y=y[:n_train],
        test_parts=[p[n_train:] for p in parts],
        test_y=y[n_train:],
        name=name,
    )


def _standardize(x: np.ndarray) -> np.ndarray:
    mu, sd = x.mean(0, keepdims=True), x.std(0, keepdims=True)
    return ((x - mu) / np.maximum(sd, 1e-6)).astype(np.float32)


def load_lending_club(
    data_dir: str, party_num: int = 2, test_frac: float = 0.2, seed: int = 0
) -> VerticalDataset:
    """Lending-club loan VFL split (lending_club_dataset.py:141-190). Expects
    a preprocessed ``loan_processed.npz`` with arrays X (features ordered as
    qualification|loan|debt|repayment|multi_acc|mal_behavior), y, and
    ``party_cuts`` giving the column index where each party's slice starts.
    Falls back to a synthetic table with the reference's party widths."""
    path = os.path.join(data_dir, "lending_club", "loan_processed.npz")
    if not os.path.exists(path):
        dims = (17, 25) if party_num == 2 else (17, 15, 10)
        return make_synthetic_vertical(dims, seed=seed, name="lending_club_synth")
    blob = np.load(path)
    X, y = blob["X"], blob["y"].astype(np.float32)
    cuts = list(blob["party_cuts"])[: party_num - 1]
    cols = np.split(np.arange(X.shape[1]), cuts)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(X))
    n_test = int(len(X) * test_frac)
    tr, te = order[n_test:], order[:n_test]
    parts = [_standardize(X[:, c]) for c in cols]
    return VerticalDataset(
        train_parts=[p[tr] for p in parts], train_y=y[tr],
        test_parts=[p[te] for p in parts], test_y=y[te],
        name="lending_club",
    )


def load_uci_credit(
    data_dir: str, test_frac: float = 0.2, seed: int = 0
) -> VerticalDataset:
    """UCI default-of-credit-card-clients two-party split (reference
    UCI/ loader): party A = demographic columns, party B = bill/payment
    history. Expects ``uci_credit.npz`` with X [n, 23], y; synthetic
    fallback keeps those widths (A=5 demographics, B=18 history)."""
    path = os.path.join(data_dir, "UCI", "uci_credit.npz")
    if not os.path.exists(path):
        return make_synthetic_vertical((5, 18), seed=seed, name="uci_credit_synth")
    blob = np.load(path)
    X, y = _standardize(blob["X"]), blob["y"].astype(np.float32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(y))
    n_test = int(len(y) * test_frac)
    tr, te = order[n_test:], order[:n_test]
    parts = [X[:, :5], X[:, 5:]]
    return VerticalDataset(
        train_parts=[p[tr] for p in parts], train_y=y[tr],
        test_parts=[p[te] for p in parts], test_y=y[te],
        name="uci_credit",
    )


def load_nus_wide(
    data_dir: str, selected_label: str = "sky", test_frac: float = 0.2, seed: int = 0
) -> VerticalDataset:
    """NUS-WIDE two-party split: guest = 634-d low-level image features,
    host = 1000-d tag features (nus_wide_dataset.py:23-230). Expects
    ``nus_wide_processed.npz`` with XA, XB, y; synthetic fallback keeps the
    reference widths (downscaled 4x to stay CI-sized)."""
    path = os.path.join(data_dir, "NUS_WIDE", "nus_wide_processed.npz")
    if not os.path.exists(path):
        return make_synthetic_vertical((158, 250), seed=seed, name="nus_wide_synth")
    blob = np.load(path)
    # standardize once over the full matrix (train stats leak into test
    # scaling either way; matching lending_club keeps both splits on the
    # same affine transform)
    XA, XB = _standardize(blob["XA"]), _standardize(blob["XB"])
    y = blob["y"].astype(np.float32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(y))
    n_test = int(len(y) * test_frac)
    tr, te = order[n_test:], order[:n_test]
    return VerticalDataset(
        train_parts=[XA[tr], XB[tr]], train_y=y[tr],
        test_parts=[XA[te], XB[te]], test_y=y[te],
        name="nus_wide",
    )


#: the launcher's ``--dataset`` names for VFL; any other name takes the
#: synthetic table
VERTICAL_LOADERS = {
    "lending_club": load_lending_club,
    "nus_wide": load_nus_wide,
    "uci_credit": load_uci_credit,
}


def load_vertical(name: str, data_dir: str, seed: int = 0) -> VerticalDataset:
    """The VFL launcher's dataset choice (the JAX package's): a named
    loader, or ``make_synthetic_vertical(seed=seed)`` for any other name."""
    loader = VERTICAL_LOADERS.get(name)
    if loader is None:
        return make_synthetic_vertical(seed=seed)
    return loader(data_dir, seed=seed)
