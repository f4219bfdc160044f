"""Why tests/test_torch_packed_conv.py runs its two-round parity at
``E2E_SEED``: for each seed given, two packed rounds of its end-to-end
configuration (resnet20, 8 clients in 4 lanes, lr 0.005) under off,
blockdiag and grouped, in the JAX package and in the port (JAX's initial
weights and orders injected), and the port's off and blockdiag rounds again
from initial weights perturbed by 1e-7 (relative; four draws each, or
``--draws=N``). Prints, as the largest share of the end-to-end bound (2 x
W_RTOL / 4 x W_ATOL) over every tensor, after round 1 and after round 2
(``[r1, r2]``): each port round against
JAX's same lowering, JAX's blockdiag against its off, the port's blockdiag
against its off, and each perturbed round against the unperturbed one of
its lowering; for each lowering, the port's tensor farthest from JAX's
after each round, and the port's round 2 started from JAX's round-1
weights against JAX's round 2 (its farthest tensor).

    env JAX_PLATFORMS=cpu python tests/torch_packed_conv_seeds.py 0 1 2 3 4
    env JAX_PLATFORMS=cpu python tests/torch_packed_conv_seeds.py 0 --draws=16

CPU only, a few minutes a seed.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import test_torch_packed_conv as t  # noqa: E402
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI  # noqa: E402
from fedml_tpu.core.config import FedConfig as JaxFedConfig  # noqa: E402
from fedml_tpu_torch.models.convert import flax_to_torch  # noqa: E402

IMPLS = ("off", "blockdiag", "grouped")


def shares(a: dict, b: dict) -> dict:
    return {k: float(((a[k] - b[k]).abs() / (4 * t.W_ATOL + 2 * t.W_RTOL * b[k].abs())).max())
            for k in b}


def share(a: dict, b: dict) -> float:
    return max(shares(a, b).values())


def worst(a: dict, b: dict) -> tuple:
    """The tensor farthest from ``b`` and its share."""
    k, v = max(shares(a, b).items(), key=lambda kv: kv[1])
    return k, round(v, 3)


def main(seeds, draws: int = 4) -> None:
    torch.set_num_threads(1)
    jds, ds = t._data(t.jax_synthetic), t._data(t.make_synthetic_classification)
    for seed in seeds:
        jax_vars, jax_states = {}, {}
        for impl in IMPLS:
            bundle = t.jax_create_model("resnet20", jds.class_num,
                                        input_shape=jds.train_x.shape[2:])
            japi = JaxFedAvgAPI(jds, JaxFedConfig(**t._run_cfg(packed_conv=impl, seed=seed)),
                                bundle)
            init = jax.tree.map(np.asarray, japi.variables)
            jax_vars[impl], jax_states[impl] = [], [init]
            for r in range(2):
                japi.run_round(r)
                jax_vars[impl].append(flax_to_torch(jax.tree.map(np.asarray, japi.variables)))
                jax_states[impl].append(jax.tree.map(np.asarray, japi.variables))

        def port(impl, eps=0.0, draw=0):
            api = t._port_api(ds, t._run_cfg(packed_conv=impl, seed=seed), init)
            if eps:
                g = torch.Generator().manual_seed(draw)
                api.variables = {k: v * (1 + eps * torch.randn(v.shape, generator=g))
                                 if v.is_floating_point() else v
                                 for k, v in api.variables.items()}
            after = []
            for r in range(2):
                api.run_round(r)
                after.append({k: v.clone() for k, v in api.variables.items()})
            return after

        def both(a, b):
            # [after round 1, after round 2]
            return [round(share(x, y), 3) for x, y in zip(a, b)]

        ports = {impl: port(impl) for impl in IMPLS}
        out = {f"port {impl} vs JAX {impl}": both(ports[impl], jax_vars[impl]) for impl in IMPLS}
        out["JAX blockdiag vs JAX off"] = both(jax_vars["blockdiag"], jax_vars["off"])
        out["port blockdiag vs port off"] = both(ports["blockdiag"], ports["off"])
        for impl in IMPLS:
            # where the gap lies, and round 2 from JAX's round-1 weights
            out[f"port {impl} vs JAX {impl}: farthest tensor"] = [
                worst(a, b) for a, b in zip(ports[impl], jax_vars[impl])]
            api = t._port_api(ds, t._run_cfg(packed_conv=impl, seed=seed), jax_states[impl][1])
            api.run_round(1)
            out[f"port {impl} round 2 from JAX's round-1 weights vs JAX {impl}"] = worst(
                api.variables, jax_vars[impl][1])
        for impl in ("off", "blockdiag"):
            out[f"port {impl} perturbed 1e-7 vs port {impl}"] = [
                both(port(impl, 1e-7, d), ports[impl]) for d in range(draws)]
        print(f"seed {seed}: {out}", flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--draws=")]
    n = [int(a.split("=")[1]) for a in sys.argv[1:] if a.startswith("--draws=")]
    main([int(a) for a in args] or [0, 1, 2, 3, 4], *n)
