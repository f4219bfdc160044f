"""One rank of the multi-process cross-silo cases of
``tests/test_torch_crosssilo.py``: a spawned child that imports torch and
the port only (never JAX), joins a gloo process group through a
``file://`` store, runs the rounds a spec describes and sends back its
losses and variables as numpy."""

from __future__ import annotations


def run_rank(rank: int, world: int, store: str, spec: dict, out) -> None:
    """``spec``: ``data`` (make_synthetic_classification kwargs), ``run``
    (FedConfig kwargs), ``model`` ("lr" or "cifar-small"), ``init``
    (name -> array), ``orders`` ((round, client, n) -> [epochs, n]),
    ``rounds``. Puts ``(rank, losses, variables)`` on ``out``, or
    ``(rank, error)``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI
        from fedml_tpu_torch.core.config import FedConfig
        from fedml_tpu_torch.data.synthetic import make_synthetic_classification
        from fedml_tpu_torch.models import ModelBundle, create_model
        from fedml_tpu_torch.models.resnet import CifarResNet
        from fedml_tpu_torch.parallel.mesh import client_mesh, init_multihost

        init_multihost(f"file://{store}", world, rank, device="cpu", timeout_s=60)
        ds = make_synthetic_classification(**spec["data"])
        if spec["model"] == "lr":
            bundle = create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:])
        else:
            bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16),
                                                            bn_impl="pallas"), (8, 8, 3))
        n_pad = ds.train_x.shape[1]
        orders = spec["orders"]

        def hook(r, j, n=n_pad):
            return [torch.from_numpy(o) for o in orders[(r, j, n)]]

        api = CrossSiloFedAvgAPI(ds, FedConfig(**spec["run"]), bundle, order_hook=hook,
                                 mesh=client_mesh(world, device="cpu"))
        api.variables = {k: torch.from_numpy(np.array(v)) for k, v in spec["init"].items()}
        losses = [float(api.run_round(r)) for r in range(spec["rounds"])]
        out.put((rank, losses, {k: v.numpy() for k, v in api.variables.items()}))
    except Exception as e:     # reported to the parent, which fails the test
        import traceback

        out.put((rank, f"{e!r}\n{traceback.format_exc()}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
