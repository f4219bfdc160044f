"""Explicit-key dropout (counterpart of ``seed_dropout`` / ``lane_dropout``
in ``fedml_tpu/ops/packed_conv.py`` and of flax ``nn.Dropout``).

One derivation for every dropout of the port: a mask is a pure function of
the step's key, the call site's static index and the element's index.

- The key is an int64 tensor on the activations' device: 0-dim for one
  client, ``[L]`` for the lane-stacked twin (lane l's own key). Inside a
  captured step (``parallel/capture.py``) it is one of the step's static
  inputs, which the trainer rewrites before every replay, so replay k draws
  the masks the eager step k draws under the same key.
- The bits are a counter hash (two rounds of a 32-bit multiply-xorshift
  mix) of the element's flat index in the per-client tensor, seeded by the
  key and ``DROPOUT_KEY_SALT + site``. Every product stays below 2^63, so
  the int64 arithmetic never overflows and gives the same bits on the CPU
  and on the card. Lane l's mask under a ``[L]`` key vector is the
  per-client mask under key l, bit for bit (:func:`lane_dropout`), and a
  recomputed block (``torch.utils.checkpoint``) draws the same mask again.
- An element is kept when its 32 bits fall below ``round((1 - rate) *
  2^32)``; a kept element is scaled by ``1 / (1 - rate)``, as JAX's
  ``jnp.where(keep, x / (1 - rate), 0)``.

The port does not reproduce threefry, so its masks differ from the JAX
package's. Parity tests hand in the reference's masks instead
(:func:`injected_masks`), as they hand in its permutations.

A train-mode call with ``rate > 0`` and no key raises, as the JAX
package's does.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Mapping, Optional

import numpy as np
import torch

#: salt added to the call site's index (the JAX package's constant)
DROPOUT_KEY_SALT = 0xD120

_M32 = 0xFFFFFFFF
_MUL = (0x7FEB352D, 0x5BD1E995)   # odd, below 2^31: products of 32-bit values fit in int64

#: site -> the reference's keep mask, while :func:`injected_masks` is open
_INJECTED: Optional[Mapping[int, torch.Tensor]] = None


def _mix32(h):
    """A 32-bit multiply-xorshift mix of ``h`` (an int64 tensor or a Python
    int, values in [0, 2^32))."""
    for m in _MUL:
        h = h ^ (h >> 16)
        h = (h * m) & _M32
    return h ^ (h >> 15)


@contextlib.contextmanager
def injected_masks(masks: Mapping[int, torch.Tensor]) -> Iterator[None]:
    """Within the block, call site ``s`` drops with ``masks[s]`` (a bool or
    {0, 1} keep mask of the per-client shape, or ``[L, ...]`` for the
    lane-stacked twin) instead of drawing one; a site without an entry
    draws as usual. The hook parity tests use to hand in the JAX
    package's masks."""
    global _INJECTED
    before, _INJECTED = _INJECTED, dict(masks)
    try:
        yield
    finally:
        _INJECTED = before


def keep_mask(key: torch.Tensor, site: int, shape: tuple, rate: float) -> torch.Tensor:
    """The bool keep mask ``[*key.shape, *shape]`` of call site ``site``
    under ``key`` (an int64 tensor, 0-dim or ``[L]``)."""
    key = key.to(torch.int64)
    lo, hi = key & _M32, (key >> 32) & _M32
    seed = _mix32(lo ^ _mix32(hi ^ _mix32(DROPOUT_KEY_SALT + site)))
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    seed = seed.reshape(*key.shape, 1)
    bits = _mix32(_mix32(idx ^ seed) ^ _mix32(seed ^ 0x9E3779B9))
    threshold = int(round((1.0 - rate) * 2.0 ** 32))
    return (bits < threshold).reshape(*key.shape, *shape)


def _apply(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    keep = keep.to(device=x.device, dtype=torch.bool)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _check_key(key, what: str) -> None:
    if key is None:
        raise ValueError(f"{what}: train-mode apply without a dropout key; pass dropout_key "
                         "(ModelBundle.apply_train and the trainers thread the step's key)")


def seed_dropout(x: torch.Tensor, key: Optional[torch.Tensor], rate: float, site: int,
                 deterministic: bool, shape: Optional[tuple] = None) -> torch.Tensor:
    """Dropout of ``x`` at call site ``site`` under the step's 0-dim
    ``key``. ``shape`` (default ``x.shape``) is the mask's shape, which
    broadcasts against ``x``: ``(N, 1, 1, 1)`` drops whole samples
    (EfficientNet's stochastic depth). Identity when ``deterministic`` or
    ``rate <= 0``."""
    if deterministic or rate <= 0.0:
        return x
    shape = tuple(x.shape) if shape is None else tuple(shape)
    if _INJECTED is not None and site in _INJECTED:
        return _apply(x, _INJECTED[site].reshape(shape), rate)
    _check_key(key, "seed_dropout")
    return _apply(x, keep_mask(key, site, shape, rate), rate)


def lane_dropout(xs: torch.Tensor, keys: Optional[torch.Tensor], rate: float, site: int,
                 deterministic: bool) -> torch.Tensor:
    """The lane-stacked form: ``xs`` ``[L, N, ...]``, ``keys`` the ``[L]``
    lane keys; lane l's mask is ``seed_dropout``'s under ``keys[l]``."""
    if deterministic or rate <= 0.0:
        return xs
    if _INJECTED is not None and site in _INJECTED:
        return _apply(xs, _INJECTED[site].reshape(xs.shape), rate)
    _check_key(keys, "lane_dropout")
    return _apply(xs, keep_mask(keys, site, tuple(xs.shape[1:]), rate), rate)


def mix_key(*parts):
    """A 63-bit key (int64) hashed from non-negative ints or int64 arrays
    (broadcast together) with the masks' own mix, :func:`_mix32`: each
    part's low and high 32 bits fold into two 32-bit states, which make the
    key's low 32 and high 31 bits."""
    lo, hi = 0x243F6A88, 0x13198A2E
    for p in parts:
        p = np.asarray(p, np.int64) if isinstance(p, np.ndarray) else int(p)
        for half in (p & _M32, (p >> 32) & _M32):
            lo = _mix32(lo ^ half)
            hi = _mix32(hi ^ half ^ lo)
    return ((hi >> 1) << 32) | lo


def client_key(seed: int, round_idx: int, pos: int, group_round: int = 0) -> int:
    """A client's dropout key in a round: a hash of (seed, round, cohort
    position, group round), the tuple its orders are drawn from
    (``core/rng.client_generator``). Every schedule (plain, packed, host,
    streamed, mesh) knows it, so each keys a client alike."""
    return int(mix_key(seed, round_idx, pos, group_round))


def step_keys(client_keys, epochs, steps):
    """The keys of local steps (int64, broadcast over the arguments): a
    hash of the client's key, the epoch and the step in the epoch. The plain
    and the packed trainers derive them alike, so a packed lane replays its
    client's masks."""
    return mix_key(client_keys, epochs, steps)
