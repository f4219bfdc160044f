"""Why the FedGKT and FedSeg parity tests and the chip gate run where they
run: prints the evidence that their rounds are chaotic elsewhere, on the CPU.

1. FedSeg rounds (tests/test_torch_fedseg.py's configuration, JAX's
   weights and orders injected): the largest relative difference of a leaf
   (its max abs difference over its max abs) between the port's round and
   JAX's, and between JAX's round and JAX's round from weights perturbed by
   1e-7 (relative; three draws), for ``deeplab_lite`` at batch 4 and 8 and
   ``unet`` at batch 8.
2. One batch-8 gradient of ``deeplab_lite``'s segmentation loss per client
   from JAX's init, the port's against JAX's (the same measure).
3. ``deeplab_lite``'s gradient at 4 x 32 x 32, the port's against JAX's,
   with the encoder in f32 and in float64 (JAX in x64 mode).
4. ``chip_smoke.py``'s GKT kernel gate configuration (CI depth, 4 clients,
   32 x 32) on the CPU, where ``bn_impl="pallas"`` takes K1/K2's plain
   version: the round's client features and server logits against the
   ``"xla"`` round (relative norm) at lr 0.1 and 0.01 and 1, 4 and 8
   torch threads: two plain BNs that differ only in op order. Parts 1-3
   run on one torch thread.

    env JAX_PLATFORMS=cpu python tests/torch_gkt_seg_chaos.py

CPU only, a few minutes.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]

import test_torch_fedseg as seg  # noqa: E402
from fedml_tpu.core.tasks import make_segmentation_task as jax_seg_task  # noqa: E402
from fedml_tpu.models import create_model as jax_create_model  # noqa: E402
from fedml_tpu_torch.core.tasks import get_task  # noqa: E402
from fedml_tpu_torch.data.segmentation import make_synthetic_segmentation  # noqa: E402
from fedml_tpu_torch.models import create_model  # noqa: E402
from fedml_tpu_torch.models.convert import flax_to_torch  # noqa: E402


def worst(got: dict, want: dict) -> tuple:
    return max((float(np.abs(got[k].numpy() - v.numpy()).max()
                      / (np.abs(v.numpy()).max() + 1e-30)), k) for k, v in want.items())


def seg_rounds() -> None:
    for model, bs in (("deeplab_lite", 4), ("deeplab_lite", 8), ("unet", 8)):
        japi, api = seg._round_apis(model, batch_size=bs)
        japi.run_round(0)
        api.run_round(0)
        want = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
        selfd = []
        for draw in range(3):
            jp, _ = seg._round_apis(model, batch_size=bs)
            key = jax.random.key(9 + draw)
            jp.variables = jax.tree.map(
                lambda a: a * (1 + 1e-7 * jax.random.normal(key, a.shape))
                if a.dtype == jnp.float32 else a, jp.variables)
            jp.run_round(0)
            selfd.append(worst(flax_to_torch(jax.tree.map(np.asarray, jp.variables)), want)[0])
        print(f"[1] {model} batch {bs}: port vs JAX {worst(api.variables, want)}, "
              f"JAX perturbed by 1e-7 vs JAX {[f'{d:.3g}' for d in selfd]}", flush=True)


def grad(model: str, x, y, m, jdtype, tdtype) -> tuple:
    jb = jax_create_model(model, 3, input_shape=x.shape[1:], dtype=jdtype)
    jvars = jax.tree.map(lambda a: jnp.asarray(a, jdtype) if a.dtype == jnp.float32 else a,
                         jb.init(jax.random.key(0)))
    task = jax_seg_task(3)

    def loss(p):
        out, _ = jb.module.apply({**jvars, "params": p}, jnp.asarray(x, jdtype), train=True,
                                 mutable=["batch_stats"])
        return task.loss(out, jnp.asarray(y), jnp.asarray(m))

    want = flax_to_torch({"params": jax.tree.map(np.asarray, jax.grad(loss)(jvars["params"]))})
    tb = create_model(model, 3, input_shape=x.shape[1:], dtype=tdtype)
    tb.module.to(tdtype).load_state_dict(flax_to_torch(jax.tree.map(np.asarray, jvars)))
    tb.module.train()
    out = tb.module(torch.from_numpy(np.asarray(x, np.float64 if tdtype == torch.float64
                                                else np.float32)))
    get_task("segmentation", 3).loss(out, torch.from_numpy(y), torch.from_numpy(m)).backward()
    return worst({k: tb.module.get_parameter(k).grad for k in want}, want)


def seg_grads() -> None:
    ds = make_synthetic_segmentation(**{**seg.DATA, "batch_size": 8})
    for c in range(ds.num_clients):
        d = grad("deeplab_lite", ds.train_x[c], ds.train_y[c], ds.train_mask[c], jnp.float32,
                 torch.float32)
        print(f"[2] deeplab_lite batch-8 gradient, client {c}: port vs JAX {d}", flush=True)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 32, 32, 3))
    y = rng.integers(0, 3, (4, 32, 32)).astype(np.int32)
    m = np.ones(4, np.float32)
    print(f"[3] deeplab_lite at 4 x 32 x 32, f32: port vs JAX "
          f"{grad('deeplab_lite', x.astype(np.float32), y, m, jnp.float32, torch.float32)}",
          flush=True)
    with jax.enable_x64(True):
        d = grad("deeplab_lite", x, y, m, jnp.float64, torch.float64)
    print(f"[3] deeplab_lite at 4 x 32 x 32, encoder in float64: port vs JAX {d}", flush=True)


def gkt_gate() -> None:
    import chip_smoke
    import fedml_tpu_torch.algorithms.fedgkt as fedgkt
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    fedgkt.default_device = lambda device=None: torch.device("cpu")
    gds = make_synthetic_classification("gkt-gate", (32, 32, 3), 10, 4, records_per_client=64,
                                        partition_method="hetero", partition_alpha=0.5,
                                        batch_size=16, seed=0)
    for lr in (0.1, 0.01):
        for threads in (1, 4, 8):
            torch.set_num_threads(threads)
            apis = {b: chip_smoke.gkt_api(gds, bn_impl=b, blocks=(1, 1), dtype="float32",
                                          batch_size=16, lr=lr) for b in ("pallas", "xla")}
            plain = apis["xla"]
            apis["pallas"].client_vars = {k.replace("BatchNorm", "PallasBatchNorm"): v.clone()
                                          for k, v in plain.client_vars.items()}
            apis["pallas"].server_vars = {k.replace("BatchNorm", "PallasBatchNorm"): v
                                          for k, v in plain.server_vars.items()}
            for api in apis.values():
                api.run_round(0)
            d = {n: float((getattr(apis["pallas"], n).double() - getattr(plain, n).double()).norm()
                          / getattr(plain, n).double().norm())
                 for n in ("_feats", "server_logits")}
            print(f"[4] GKT gate round, lr {lr}, {threads} threads: {d}", flush=True)


if __name__ == "__main__":
    torch.set_num_threads(1)        # parts 1-3; part 4 sets its own
    seg_rounds()
    seg_grads()
    gkt_gate()
