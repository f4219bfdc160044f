"""Deterministic RNG plumbing (counterpart of ``fedml_tpu/core/rng.py``).

Client sampling is numpy and bit-equal to the JAX package. Per-client
shuffles use an explicit ``torch.Generator`` derived from
(seed, round, cohort position); it does not reproduce JAX's threefry
stream, so parity tests inject the reference's permutations instead
(``parallel/local.make_local_train_fn``'s ``orders``). Server-side draws
(the DP noise of robust aggregation) take :func:`server_generator`, the
counterpart of ``server_key(round_key(root, r))``.
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


def _seeded(entropy: list, device=None) -> torch.Generator:
    state = np.random.SeedSequence(entropy).generate_state(2)
    g = torch.Generator() if device is None else torch.Generator(device=device)
    g.manual_seed(int(state[0]) << 32 | int(state[1]))
    return g


def client_generator(seed: int, round_idx: int, client_pos: int,
                     group_round: int = 0) -> torch.Generator:
    """A CPU generator for one client's shuffles in one round, a pure
    function of (seed, round, cohort position) and, for the group rounds of
    hierarchical FL after the first, the group round's index (group round 0
    draws the flat round's orders)."""
    return _seeded([seed, round_idx, client_pos] + ([group_round] if group_round else []))


def server_generator(seed: int, round_idx: int, device=None) -> torch.Generator:
    """The generator of a round's server-side draws, a pure function of
    (seed, round), on ``device`` (the aggregate's: the card draws on the
    card). Every paradigm derives it the same way, so the simulation and
    every rank of the mesh draw the same noise."""
    return _seeded([seed, round_idx, 0x5E87], device)


def init_generator(seed: int, *stream: int) -> torch.Generator:
    """A CPU generator for initial weights, a pure function of the seed and
    the ``stream`` path (FedGKT: ``(1, client)`` for each client's edge net,
    ``(2,)`` for the server net)."""
    return _seeded([seed, 0x1417, *stream])
