"""The JAX package's random draws, in the port's layout, for the parity tests
of the robust, hierarchical and silo slices (tests/test_torch_robust.py,
test_torch_hierarchical.py, test_torch_silo.py): per-client per-epoch
orders, the server's DP noise, and a leafwise comparison of a port state
dict with flax variables."""

from __future__ import annotations

import functools

import jax
import numpy as np
import torch

from fedml_tpu.core.rng import server_key
from fedml_tpu_torch.models.convert import torch_to_flax


def _perms(client_key, epochs: int, n: int) -> np.ndarray:
    return np.stack([np.asarray(jax.random.permutation(ek, n)).astype(np.int64)
                     for ek in jax.random.split(client_key, epochs)])


@functools.lru_cache(maxsize=None)
def jax_orders_np(seed: int, epochs: int, round_idx: int, cohort: int, n: int,
                  group_rounds: int = 0, group_round: int = 0) -> tuple:
    """``[cohort]`` arrays ``[epochs, n]``: the permutations the JAX API's
    clients draw in a round, from ``split(fold_in(key(seed), r), cohort)``
    (``group_rounds > 0``: hierarchical FL's
    ``split(split(rk, group_rounds)[group_round], cohort)``)."""
    rk = jax.random.fold_in(jax.random.key(seed), round_idx)
    if group_rounds:
        rk = jax.random.split(rk, group_rounds)[group_round]
    return tuple(_perms(ck, epochs, n) for ck in jax.random.split(rk, cohort))


def order_hook(seed: int, epochs: int, cohort: int, n_pad: int, group_rounds: int = 0):
    """An ``order_hook`` for the port's API that returns the JAX API's
    orders (cohort position ``i``, the record axis ``n``, and the group
    round for hierarchical FL)."""
    def hook(r, i, n=n_pad, group_round=None):
        arr = jax_orders_np(seed, epochs, r, cohort, n, group_rounds, group_round or 0)[i]
        return [torch.from_numpy(o) for o in arr]
    return hook


def flax_shape(name: str, shape: tuple) -> tuple:
    if name.endswith("weight") and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    if name.endswith("weight") and len(shape) == 2:
        return (shape[1], shape[0])
    return tuple(shape)


def to_port_layout(name: str, a: np.ndarray) -> np.ndarray:
    if name.endswith("weight") and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if name.endswith("weight") and a.ndim == 2:
        return a.T
    return a


def jax_normal(key, i: int, name: str, shape: tuple) -> torch.Tensor:
    """``normal(fold_in(key, i))`` of the flax leaf ``i`` (``add_dp_noise``'s
    draw), in the port's layout of leaf ``name``."""
    a = np.asarray(jax.random.normal(jax.random.fold_in(key, i), flax_shape(name, shape)))
    return torch.from_numpy(np.array(to_port_layout(name, a), order="C"))


def noise_hook(seed: int):
    """A ``noise_hook`` for the port's API that returns the JAX API's DP
    noise: ``normal(fold_in(server_key(fold_in(key(seed), r)), i))``."""
    def hook(r, i, name, shape):
        sk = server_key(jax.random.fold_in(jax.random.key(seed), r))
        return jax_normal(sk, i, name, shape)
    return hook


def assert_vars_close(got: dict, want_flax: dict, rtol: float, atol: float, msg: str = "",
                      bn_name=None) -> None:
    """Every leaf of the port's state dict against the flax variables."""
    got = torch_to_flax(got, bn_name=bn_name)
    want = jax.tree.map(np.asarray, want_flax)
    la, ta = jax.tree_util.tree_flatten_with_path(want)
    lb, tb = jax.tree_util.tree_flatten_with_path(got)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=f"{msg} {path}")
