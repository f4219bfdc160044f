"""One rank of the multi-process cross-silo cases of
``tests/test_torch_crosssilo.py``: a spawned child that imports torch and
the port only (never JAX), joins a gloo process group through a
``file://`` store, runs the rounds a spec describes and sends back its
losses and variables as numpy."""

from __future__ import annotations


def run_rank(rank: int, world: int, store: str, spec: dict, out) -> None:
    """``spec``: ``data`` (make_synthetic_classification kwargs), ``run``
    (FedConfig kwargs), ``model`` ("lr" or "cifar-small"), ``init``
    (name -> array), ``orders`` ((round, client, n) -> [epochs, n], or
    (round, client, n, group round) -> [epochs, n] for hierarchical FL),
    ``rounds``, and ``groups`` for ``CrossSiloHierarchicalFedAvgAPI`` on a
    ``groups`` x ``world / groups`` mesh, or ``gossip`` (``{"mode", "W"}``) for
    ``MeshDecentralizedFedAPI`` over that mixing matrix, whose variables are
    then every node's (``node.<name>``) and the PushSum mass
    (``ps_weights``), or ``fednas`` (``CrossSiloFedNASAPI`` kwargs: the search
    net's size, ``unrolled``, ``bn_impl``), whose variables then include the
    alphas (``alphas.normal``, ``alphas.reduce``), or ``vfl`` (``{"lr"}``:
    party-sharded VFL steps on ``data``'s ``make_synthetic_vertical`` table,
    one a batch of row indices in ``orders``, this rank its block of the
    parties; ``init`` holds the stacked padded parameters and the variables
    are this rank's block of them). Puts ``(rank, losses, variables)`` on ``out``, or
    ``(rank, error)``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI
        from fedml_tpu_torch.algorithms.hierarchical import CrossSiloHierarchicalFedAvgAPI
        from fedml_tpu_torch.core.config import FedConfig
        from fedml_tpu_torch.data.synthetic import make_synthetic_classification
        from fedml_tpu_torch.models import ModelBundle, create_model
        from fedml_tpu_torch.models.resnet import CifarResNet
        from fedml_tpu_torch.parallel.mesh import client_mesh, hierarchical_mesh, init_multihost

        init_multihost(f"file://{store}", world, rank, device="cpu", timeout_s=60)
        if spec.get("vfl"):
            from fedml_tpu_torch.algorithms.vfl import make_sharded_vfl_step
            from fedml_tpu_torch.data.vertical import make_synthetic_vertical

            vds = make_synthetic_vertical(**spec["data"])
            mesh = client_mesh(world, device="cpu")
            block = mesh.block(vds.num_parties)
            step, tx = make_sharded_vfl_step(mesh, spec["vfl"]["lr"])
            params = {k: torch.from_numpy(np.array(v[block])) for k, v in spec["init"].items()}
            opt = tx.init(list(params.values()))
            d_max = max(vds.party_dims)
            losses = []
            for idx in spec["orders"]:
                xs = np.zeros((block.stop - block.start, len(idx), d_max), np.float32)
                for i, p in enumerate(range(block.start, block.stop)):
                    xs[i, :, :vds.party_dims[p]] = vds.train_parts[p][idx]
                losses.append(float(step(params, opt, torch.from_numpy(xs),
                                         torch.from_numpy(vds.train_y[idx]))))
            out.put((rank, losses, {k: v.numpy() for k, v in params.items()}))
            return
        ds = make_synthetic_classification(**spec["data"])
        if spec["model"] == "lr":
            bundle = create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:])
        else:
            bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16),
                                                            bn_impl="pallas"), (8, 8, 3))
        n_pad = ds.train_x.shape[1]
        orders = spec["orders"]

        def hook(r, j, n=n_pad, group_round=None):
            key = (r, j, n) if group_round is None else (r, j, n, group_round)
            return [torch.from_numpy(o) for o in orders[key]]

        groups, gossip = spec.get("groups"), spec.get("gossip")
        init = {k: torch.from_numpy(np.array(v)) for k, v in spec["init"].items()}
        if spec.get("fednas"):
            from fedml_tpu_torch.algorithms.fednas import CrossSiloFedNASAPI

            api = CrossSiloFedNASAPI(ds, FedConfig(**spec["run"]), order_hook=hook,
                                     mesh=client_mesh(world, device="cpu"), **spec["fednas"])
            api.variables = {k: v for k, v in init.items() if not k.startswith("alphas.")}
            api.alphas = {k[len("alphas."):]: v for k, v in init.items()
                          if k.startswith("alphas.")}
            losses = [float(api.run_round(r)) for r in range(spec["rounds"])]
            state = {**api.variables, **{f"alphas.{k}": v for k, v in api.alphas.items()}}
            out.put((rank, losses, {k: v.numpy() for k, v in state.items()}))
            return
        if gossip:
            from fedml_tpu_torch.algorithms.decentralized import MeshDecentralizedFedAPI
            from fedml_tpu_torch.distributed.topology import BaseTopologyManager

            topo = BaseTopologyManager()
            topo.topology = np.asarray(gossip["W"])
            api = MeshDecentralizedFedAPI(ds, FedConfig(**spec["run"]), bundle, topology=topo,
                                          mode=gossip["mode"], order_hook=hook,
                                          mesh=client_mesh(world, device="cpu"))
            api.variables = init
            api.init_nodes()
            losses = [float(api.run_round(r)) for r in range(spec["rounds"])]
            out.put((rank, losses, {**{f"node.{k}": v.numpy() for k, v in api.node_vars.items()},
                                    "ps_weights": api.ps_weights.numpy()}))
            return
        if groups:
            api = CrossSiloHierarchicalFedAvgAPI(
                ds, FedConfig(**spec["run"]), bundle, order_hook=hook,
                mesh=hierarchical_mesh(groups, world // groups, device="cpu"))
        else:
            api = CrossSiloFedAvgAPI(ds, FedConfig(**spec["run"]), bundle, order_hook=hook,
                                     mesh=client_mesh(world, device="cpu"))
        api.variables = init
        losses = [float(api.run_round(r)) for r in range(spec["rounds"])]
        out.put((rank, losses, {k: v.numpy() for k, v in api.variables.items()}))
    except Exception as e:     # reported to the parent, which fails the test
        import traceback

        out.put((rank, f"{e!r}\n{traceback.format_exc()}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
