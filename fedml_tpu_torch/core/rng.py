"""Deterministic RNG plumbing (counterpart of ``fedml_tpu/core/rng.py``).

Client sampling is numpy and bit-equal to the JAX package. Per-client
shuffles use an explicit ``torch.Generator`` derived from
(seed, round, cohort position); it does not reproduce JAX's threefry
stream, so parity tests inject the reference's permutations instead
(``parallel/local.make_local_train_fn``'s ``orders``).
"""

from __future__ import annotations

import numpy as np
import torch


def sample_clients(round_idx: int, client_num_in_total: int,
                   client_num_per_round: int, seed: int = 0) -> np.ndarray:
    """Round-deterministic client sampling without replacement
    (reference _client_sampling, fedavg_api.py:83-91)."""
    if client_num_in_total == client_num_per_round:
        return np.arange(client_num_in_total, dtype=np.int64)
    rng = np.random.default_rng(seed * 1_000_003 + round_idx)
    return np.sort(rng.choice(client_num_in_total, client_num_per_round,
                              replace=False)).astype(np.int64)


def client_generator(seed: int, round_idx: int, client_pos: int) -> torch.Generator:
    """A CPU generator for one client's shuffles in one round, a pure
    function of (seed, round, cohort position)."""
    state = np.random.SeedSequence([seed, round_idx, client_pos]).generate_state(2)
    g = torch.Generator()
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g
