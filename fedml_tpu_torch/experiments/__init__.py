"""Experiment entry points (counterpart of ``fedml_tpu/experiments``).

One dispatcher, :func:`run_experiment`, serves every algorithm; the
per-algorithm ``main_*`` modules are thin aliases of ``run.main``, so
``python -m fedml_tpu_torch.experiments.main_fedavg --dataset mnist --model
lr`` has the reference's invocation shape and ``python -m
fedml_tpu_torch.experiments.run --algorithm X`` is the fed_launch form.
:data:`ALGORITHMS` is the JAX package's tuple, so ``--algorithm`` takes the
same names; a name whose algorithm is not ported yet raises
``NotImplementedError`` with its ROADMAP item. Runs go to the GPU unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
from typing import Optional, Union

import torch

from fedml_tpu_torch.core.config import FedConfig, check_ported

log = logging.getLogger(__name__)

ALGORITHMS = (
    "fedavg", "crosssilo_fedavg", "fedopt", "fedprox", "fednova", "fedagc",
    "fedavg_robust", "hierarchical", "decentralized", "turboaggregate",
    "fedgkt", "fednas", "fedseg", "splitnn", "vfl", "centralized",
    "silo_fedavg", "silo_fedopt", "silo_fednova", "silo_fedagc",
    "crosssilo_fedopt", "crosssilo_fednova", "crosssilo_fedagc",
    "crosssilo_fedavg_robust", "crosssilo_fedprox", "crosssilo_decentralized",
    "crosssilo_fedseg", "crosssilo_hierarchical", "crosssilo_fednas",
    "streaming_fedavg", "fedavg_edge",
)

#: the ported algorithms (the crosssilo_* ones on the mesh of the initialised
#: process group, or one rank without one; silo_* are ``SiloRunner`` over
#: their algorithm, as in the JAX package)
PORTED = ("fedavg", "fedopt", "fedprox", "fednova", "fedagc", "centralized",
          "crosssilo_fedavg", "crosssilo_fedopt", "crosssilo_fedprox", "crosssilo_fednova",
          "crosssilo_fedagc", "fedavg_robust", "crosssilo_fedavg_robust", "hierarchical",
          "crosssilo_hierarchical", "silo_fedavg", "silo_fedopt", "silo_fednova",
          "silo_fedagc", "decentralized", "crosssilo_decentralized", "streaming_fedavg",
          "turboaggregate", "fedgkt", "fedseg", "crosssilo_fedseg", "fednas",
          "crosssilo_fednas", "splitnn", "vfl")

#: algorithm -> the ROADMAP item that ports it
UNPORTED = {"fedavg_edge": "ROADMAP §1 item 11 (edge runtimes)"}


def _bundle_for(config: FedConfig, ds):
    """The model of ``config.model`` for ``ds`` (no ``bn_impl`` or dtype: a
    launched ResNet takes the plain BatchNorm, as the JAX launcher's does)."""
    from fedml_tpu_torch.models import create_model

    if config.class_num is not None and config.class_num != ds.class_num:
        raise ValueError(f"class_num={config.class_num}, but {config.dataset!r} has "
                         f"{ds.class_num} classes")
    return create_model(config.model, ds.class_num, input_shape=ds.train_x.shape[2:] or None)


def _load(config: FedConfig):
    from fedml_tpu_torch.data import load_dataset

    # loader parameter names vary (client_num_in_total vs num_clients);
    # every loader ignores unknown kwargs, so pass both spellings
    return load_dataset(
        config.dataset, data_dir=config.data_dir,
        client_num_in_total=config.client_num_in_total,
        num_clients=config.client_num_in_total,
        partition_method=config.partition_method, partition_alpha=config.partition_alpha,
        batch_size=config.batch_size, seed=config.seed)


def run_experiment(config: FedConfig, algorithm: str,
                   device: Optional[Union[str, torch.device]] = None) -> dict:
    """Build data, model and API for ``algorithm``, train, and return the
    history (also JSON-logged). On success, signals a sweep orchestrator
    listening on ``FEDML_SWEEP_PIPE``, once per experiment."""
    from fedml_tpu_torch.utils.metrics import notify_sweep_complete

    result = _run_experiment(config, algorithm, device)
    notify_sweep_complete()
    return result


def _run_experiment(config: FedConfig, algorithm: str, device) -> dict:
    algorithm = algorithm.lower()
    if algorithm not in ALGORITHMS:
        raise KeyError(f"unknown algorithm {algorithm!r}; known: {ALGORITHMS}")
    if config.rank is not None and algorithm != "fedavg_edge":
        raise ValueError(
            "--rank/--world_size start one process of a multi-process deployment, which only "
            f"the fedavg_edge algorithm supports (got --algorithm {algorithm})")
    if algorithm in UNPORTED:
        raise NotImplementedError(f"--algorithm {algorithm} is not ported yet "
                                  f"({UNPORTED[algorithm]})")
    check_ported(config)

    from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
    from fedml_tpu_torch.algorithms.decentralized import (DecentralizedFedAPI,
                                                          MeshDecentralizedFedAPI)
    from fedml_tpu_torch.algorithms.fedagc import CrossSiloFedAGCAPI, FedAGCAPI
    from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
    from fedml_tpu_torch.algorithms.fednova import CrossSiloFedNovaAPI, FedNovaAPI
    from fedml_tpu_torch.algorithms.fedopt import CrossSiloFedOptAPI, FedOptAPI
    from fedml_tpu_torch.algorithms.fedprox import CrossSiloFedProxAPI, FedProxAPI
    from fedml_tpu_torch.algorithms.fedseg import CrossSiloFedSegAPI, FedSegAPI
    from fedml_tpu_torch.algorithms.hierarchical import (CrossSiloHierarchicalFedAvgAPI,
                                                         HierarchicalFedAvgAPI)
    from fedml_tpu_torch.algorithms.robust import CrossSiloFedAvgRobustAPI, FedAvgRobustAPI
    from fedml_tpu_torch.algorithms.silo import SiloRunner
    from fedml_tpu_torch.algorithms.streaming_fedavg import StreamingFedAvgAPI
    from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
    from fedml_tpu_torch.models.gkt import gkt_blocks_from_names
    from fedml_tpu_torch.parallel.mesh import client_mesh

    apis = {
        "fedavg": FedAvgAPI, "fedopt": FedOptAPI, "fedprox": FedProxAPI,
        "fednova": FedNovaAPI, "fedagc": FedAGCAPI, "centralized": CentralizedTrainer,
        "crosssilo_fedavg": CrossSiloFedAvgAPI, "crosssilo_fedopt": CrossSiloFedOptAPI,
        "crosssilo_fedprox": CrossSiloFedProxAPI, "crosssilo_fednova": CrossSiloFedNovaAPI,
        "crosssilo_fedagc": CrossSiloFedAGCAPI, "fedavg_robust": FedAvgRobustAPI,
        "crosssilo_fedavg_robust": CrossSiloFedAvgRobustAPI,
        "hierarchical": HierarchicalFedAvgAPI,
        "crosssilo_hierarchical": CrossSiloHierarchicalFedAvgAPI,
        "decentralized": DecentralizedFedAPI, "crosssilo_decentralized": MeshDecentralizedFedAPI,
        "streaming_fedavg": StreamingFedAvgAPI, "turboaggregate": TurboAggregateAPI,
        "fedseg": FedSegAPI, "crosssilo_fedseg": CrossSiloFedSegAPI,
    }
    silo = {"silo_fedavg": FedAvgAPI, "silo_fedopt": FedOptAPI, "silo_fednova": FedNovaAPI,
            "silo_fedagc": FedAGCAPI}
    if algorithm == "vfl":
        # the vertical loaders (their synthetic table for any other name)
        from fedml_tpu_torch.algorithms.vfl import VFLAPI
        from fedml_tpu_torch.data.vertical import load_vertical

        vds = load_vertical(config.dataset, config.data_dir, seed=config.seed)
        result = VFLAPI(vds, lr=config.lr, batch_size=config.batch_size, seed=config.seed,
                        device=device).fit(epochs=config.comm_round, seed=config.seed)
        log.info("result %s", json.dumps(result))
        return result
    ds = _load(config)
    if algorithm in ("fednas", "crosssilo_fednas"):
        from fedml_tpu_torch.algorithms.fednas import CrossSiloFedNASAPI, FedNASAPI

        size = (dict(channels=4, layers=2, steps=2, multiplier=2) if config.ci
                else dict(channels=16, layers=8, steps=4, multiplier=4))
        cls = CrossSiloFedNASAPI if algorithm == "crosssilo_fednas" else FedNASAPI
        result = cls(ds, config, **size, device=device).train()
        log.info("result %s", {k: v for k, v in result.items() if k != "genotype"})
        return result
    if algorithm == "splitnn":
        from fedml_tpu_torch.algorithms.split_nn import SplitNNAPI
        from fedml_tpu_torch.models.split import create_split_cnn, create_split_mlp

        make = create_split_cnn if ds.train_x.ndim == 5 else create_split_mlp   # [C, n, H, W, ch]
        cb, sb = make(ds.class_num, input_shape=ds.train_x.shape[2:])
        result = SplitNNAPI(ds, config, cb, sb, device=device).train()
        log.info("result %s", json.dumps({k: v[-1] for k, v in result.items() if v}))
        return result
    if algorithm == "fedgkt":
        # the JAX launcher's: the pair from --model_client/--model_server,
        # blocks (1, 2) under --ci; the model flag is not read
        blocks = (1, 2) if config.ci else gkt_blocks_from_names(config.model_client,
                                                                config.model_server)
        # several card ranks: the server phase data parallel over all of
        # them, as the JAX launcher shards it over its accelerators
        server_mesh = None
        world = client_mesh(device=device)
        if (world.world_size > 1 and ds.num_clients % world.world_size == 0
                and world.device.type == "cuda"):
            from fedml_tpu_torch.parallel.dataparallel import batch_mesh

            server_mesh = batch_mesh(world.world_size, device=device)
        result = FedGKTAPI(ds, config, client_blocks=blocks[0],
                           server_blocks_per_stage=blocks[1], server_mesh=server_mesh,
                           device=device).train()
        log.info("result %s", json.dumps(result))
        return result
    bundle = _bundle_for(config, ds)
    if algorithm in silo:
        result = SiloRunner(ds, config, api_cls=silo[algorithm], bundle=bundle,
                            device=device).train()
    else:
        result = apis[algorithm](ds, config, bundle, device=device).train()
    log.info("result %s", json.dumps({k: v for k, v in dict(result).items()
                                      if isinstance(v, (int, float, str))}))
    return result
