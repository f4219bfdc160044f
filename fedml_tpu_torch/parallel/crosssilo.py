"""The cross-silo paradigm's shared round tail (counterpart of
``fedml_tpu/parallel/crosssilo.py``; only :func:`apply_server_and_rollback`
is ported: the packed round ends in it, as the JAX package's does. The
mesh rounds are a later port)."""

from __future__ import annotations

from typing import Callable, Optional


def apply_server_and_rollback(variables0: dict, agg: dict, extras: Optional[dict],
                              total: float, server_state: dict, rng,
                              server_update: Optional[Callable]) -> tuple[dict, dict]:
    """The post-aggregation tail: the server hook
    ``server_update(variables0, agg, extras, total, server_state, rng)`` on
    the aggregate, then the all-failed rollback: a round whose total weight
    is 0 keeps the weights AND the server state (a server optimizer would
    otherwise absorb the zero aggregate as a pseudo-gradient). ``total`` is
    known on the host, so such a round skips the hook instead of undoing
    it: the server optimizers update their state in place."""
    if not total > 0:
        return variables0, server_state
    if server_update is None:
        return agg, server_state
    return server_update(variables0, agg, extras, total, server_state, rng)
