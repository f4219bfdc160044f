"""The command-line entry point and ``train()`` against the JAX package's.

- ``run.main(argv, device="cpu")`` runs every ported algorithm with
  ``--ci 1`` and prints the last-line JSON (FedGKT and FedSeg on image
  stand-ins); ``--result_json`` writes the full dict; each ported name
  reaches its class (the gossip, streaming and TurboAggregate names checked
  one by one), ``UNPORTED`` is empty (``fedavg_edge``, the last name, runs
  the edge federation), a name put in it raises ``NotImplementedError``
  naming its ROADMAP item, an unknown one ``KeyError``, ``--rank``
  ``ValueError`` for any algorithm but ``fedavg_edge`` (as the JAX
  launcher does); each ported algorithm has its ``main_*`` alias,
  which runs on the GPU by default and raises without one.
- ``train()``'s history (eval rounds, Test/Acc, Test/Loss) matches the JAX
  package's ``train()`` on ``lr``, with JAX's per-epoch orders injected
  through ``order_hook``: losses rtol 1e-5 (tests/test_torch_fedavg.py's).
- Full participation with one full-batch step a client equals centralized
  training on ``lr`` and ``cnn`` within relative 1e-4 (the gate of
  tests/test_fedavg.py:26 and :49).
- ``merge_clients`` gives arrays bit-equal to the JAX package's on a
  hetero dataset with padding, and ``CentralizedTrainer`` with full-batch
  steps (one batch of every record, so no shuffle order enters) matches the
  JAX package's from its initial weights on ``lr`` and ``cnn``: Test/Loss and
  Test/Acc history rtol 1e-5, variables rtol 1e-5 / atol 1e-6. A field that
  only the federated loop reads raises at its construction.
"""

import importlib
import json
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.centralized import CentralizedTrainer as JaxCentralizedTrainer
from fedml_tpu.algorithms.centralized import merge_clients as jax_merge_clients
from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.data.synthetic import make_synthetic_lr as jax_make_synthetic_lr
from fedml_tpu.experiments import ALGORITHMS as JAX_ALGORITHMS
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms.centralized import (FEDERATED_ONLY_FIELDS, CentralizedTrainer,
                                                    merge_clients)
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification, make_synthetic_lr
from fedml_tpu_torch.experiments import ALGORITHMS, PORTED, UNPORTED, run_experiment
from fedml_tpu_torch.experiments.run import main
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch

SMALL = ("--dataset synthetic_1_1 --model lr --client_num_in_total 6 --client_num_per_round 3 "
         "--batch_size 10 --lr 0.3 --ci 1").split()


def test_algorithm_names_are_jax_s():
    assert ALGORITHMS == JAX_ALGORITHMS
    assert set(PORTED) | set(UNPORTED) == set(ALGORITHMS) and not set(PORTED) & set(UNPORTED)


#: the launch lines of the algorithms that need image data: FedGKT's split
#: ResNet pair on the CIFAR-10 stand-in, FedSeg's nets on the segmentation one
IMAGE_ARGS = {
    "fedgkt": ("--dataset cifar10 --client_num_in_total 2 --client_num_per_round 2 "
               "--batch_size 32 --lr 0.05 --ci 1").split(),
    "fedseg": ("--dataset pascal_voc --model unet --client_num_in_total 2 "
               "--client_num_per_round 2 --batch_size 8 --lr 0.05 --ci 1").split(),
}
IMAGE_ARGS["crosssilo_fedseg"] = IMAGE_ARGS["fedseg"]
# FedNAS's search net at the launcher's --ci size, first-order, on the
# FEMNIST stand-in (28 x 28 x 1, 30 records a client: one step a client)
IMAGE_ARGS["fednas"] = IMAGE_ARGS["crosssilo_fednas"] = (
    "--dataset femnist --client_num_in_total 2 --client_num_per_round 2 --batch_size 32 "
    "--lr 0.05 --ci 1").split()


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the image nets' CPU convs: under the suite's
    parallel workers, a process per core each using every core slows them
    by two orders of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("algorithm", PORTED)
def test_main_runs_each_ported_algorithm(algorithm, capsys, request):
    if algorithm in IMAGE_ARGS:
        request.getfixturevalue("one_torch_thread")
    result = main(IMAGE_ARGS.get(algorithm, SMALL) + ["--algorithm", algorithm], device="cpu")
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["algorithm"] == algorithm
    if algorithm == "fedgkt":              # FedGKTAPI's last evaluation (the JAX package's keys)
        assert result["round"] == last["round"] == 1 and np.isfinite(last["Train/ServerLoss"])
        assert np.isfinite(last["Test/Loss"]) and 0.0 <= last["Test/Acc"] <= 1.0
        return
    if algorithm.endswith("fednas"):       # FedNASAPI's last evaluation, with its genotype
        assert result["round"] == last["round"] == 1 and np.isfinite(last["Train/Loss"])
        assert 0.0 <= last["Test/Acc"] <= 1.0 and len(result["genotype"].normal) == 4
        return
    if algorithm == "splitnn":             # the ring's history: 6 client epochs, 2 validations
        assert len(result["epoch_loss"]) == 2 * 6 and len(result["val_acc"]) == 2
        assert np.isfinite(last["epoch_loss"]) and 0.0 <= last["val_acc"] <= 1.0
        return
    if algorithm == "vfl":                 # the fused fit's last epoch on the synthetic table
        assert result["epoch"] == last["epoch"] == 1 and np.isfinite(last["Train/Loss"])
        assert 0.0 <= last["Test/Acc"] <= 1.0
        return
    assert result["round"] == [0, 1] and last["round"] == 1       # --ci: 2 rounds
    if algorithm == "fedavg_edge":         # the edge server's history (the JAX package's keys)
        assert np.isfinite(last["Test/Loss"]) and 0.0 <= last["Test/Acc"] <= 1.0
        return
    if algorithm.startswith("silo_"):      # SiloRunner's history (the JAX package's keys)
        assert np.isfinite(last["GLOBAL/Test/Loss"]) and 0.0 <= last["GLOBAL/Test/Acc"] <= 1.0
        assert last["best_round"] in (0, 1) and "Client.0/Train/Acc" in last
        return
    assert np.isfinite(last["Test/Loss"]) and 0.0 <= last["Test/Acc"] <= 1.0
    if algorithm != "centralized":
        assert last["rounds_per_sec"] == result["timing"]["rounds_per_sec"] > 0


def test_result_json_holds_the_full_history(tmp_path, capsys):
    path = tmp_path / "r.json"
    main(SMALL + ["--comm_round", "3", "--ci", "0", "--frequency_of_the_test", "1",
                  "--result_json", str(path)], device="cpu")
    full = json.loads(path.read_text())
    assert full["algorithm"] == "fedavg" and full["round"] == [0, 1, 2]
    assert len(full["Test/Acc"]) == 3 and "time/wall_s" in full["timing"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["Test/Acc"] == full["Test/Acc"][-1]


def test_unported_names_are_the_remaining_eight():
    assert sorted(UNPORTED) == [] and "fedavg_edge" in PORTED


@pytest.mark.parametrize("algorithm, module, cls", [
    ("decentralized", "decentralized", "DecentralizedFedAPI"),
    ("crosssilo_decentralized", "decentralized", "MeshDecentralizedFedAPI"),
    ("streaming_fedavg", "streaming_fedavg", "StreamingFedAvgAPI"),
    ("turboaggregate", "turboaggregate", "TurboAggregateAPI")])
def test_gossip_stream_turbo_dispatch_to_their_classes(algorithm, module, cls, monkeypatch):
    api_cls = getattr(importlib.import_module(f"fedml_tpu_torch.algorithms.{module}"), cls)
    seen = []
    monkeypatch.setattr(api_cls, "train", lambda self: seen.append(self) or {"round": []})
    run_experiment(FedConfig(dataset="synthetic_1_1", model="lr", client_num_in_total=4,
                             client_num_per_round=2, batch_size=10), algorithm, device="cpu")
    assert len(seen) == 1 and type(seen[0]) is api_cls
    assert seen[0].device == torch.device("cpu")


@pytest.mark.parametrize("algorithm", ["fedavg_edge"])
def test_unported_algorithm_raises(algorithm, monkeypatch):
    """No name is unported now; one put back in ``UNPORTED`` (the last one
    ported) raises naming its item before anything runs."""
    import fedml_tpu_torch.experiments as experiments

    monkeypatch.setitem(experiments.UNPORTED, algorithm, "ROADMAP §1 item 11a")
    with pytest.raises(NotImplementedError, match="ROADMAP §1 item 11a"):
        run_experiment(FedConfig(dataset="synthetic_1_1"), algorithm, device="cpu")


def _jax_perms(key, epochs: int, n: int) -> list:
    """JAX's ``permutation(split(key, epochs)[e], n)`` for each epoch."""
    return [torch.from_numpy(np.asarray(jax.random.permutation(k, n)).astype(np.int64))
            for k in jax.random.split(key, epochs)]


@pytest.mark.parametrize("algorithm", ["fedgkt", "fedseg", "crosssilo_fedseg"])
def test_gkt_and_seg_launch_like_jax(algorithm, monkeypatch, one_torch_thread):
    """One ``--ci`` round of each freed name against the JAX launcher's on
    the same flags (8 silos for the cross-silo mesh, as the JAX package's
    8 CPU devices need). Both launchers build their API themselves, so each
    side's constructor is wrapped to record it; the port's also starts from
    the JAX API's initial weights and takes its orders. FedGKT's pair is
    built at the JAX launcher's CI depth (1 client block, 2 server blocks a
    stage). Both launchers load the same data bit for bit. After the round:
    FedGKT's client nets within 1e-4 and its server net within 1e-2
    (relative norm), its losses and Test/Loss rtol 5e-3; FedSeg's pixel
    accuracy and 1 - mIoU within 1e-3 (a few pixels' worth of argmax flips).
    These are end-to-end bounds on the CIFAR-10 and blob stand-ins at 32 x
    32, where f32 noise grows: the server net trains 10 nesterov steps on
    features that already differ, and BN through FedSeg's 4 x 4 bottleneck
    is ill-conditioned on the blob images (tests/torch_gkt_seg_chaos.py
    prints such spreads). Elementwise parity at rtol 1e-4 / atol 1e-5 is
    held at small shapes by tests/test_torch_fedgkt.py and
    tests/test_torch_fedseg.py."""
    from fedml_tpu.core.config import add_args as jax_add_args
    from fedml_tpu.core.config import config_from_args as jax_config_from_args
    from fedml_tpu.core.rng import round_key
    from fedml_tpu.experiments import run_experiment as jax_run_experiment
    from fedml_tpu_torch.algorithms import fedavg, fedgkt
    from fedml_tpu_torch.core.config import add_args, config_from_args
    from torch_jax_refs import assert_vars_close

    silos = ["--client_num_in_total", "8", "--client_num_per_round", "8"]
    argv = (IMAGE_ARGS[algorithm] + (silos if algorithm == "crosssilo_fedseg" else [])
            + ["--bucket_quantum_batches", "0", "--comm_round", "1"])
    jcfg = jax_config_from_args(jax_add_args().parse_args(argv))
    cfg = config_from_args(add_args().parse_args(argv))
    made = {}

    def record(cls, side, after=None):
        init = cls.__init__

        def wrapped(self, *a, **kw):
            init(self, *a, **kw)
            made[side] = self
            # the JAX API's initial weights (its arrays are immutable)
            made[f"{side}_init"] = {k: getattr(self, k, None)
                                    for k in ("variables", "client_vars", "server_vars")}
            if after is not None:
                after(self)

        monkeypatch.setattr(cls, "__init__", wrapped)

    if algorithm == "fedgkt":
        from fedml_tpu.algorithms.fedgkt import FedGKTAPI as JaxFedGKTAPI

        def from_jax(api):
            japi, init = made["jax"], made["jax_init"]
            api.client_vars = flax_to_torch(jax.tree.map(np.asarray, init["client_vars"]),
                                            stacked=True)
            api.server_vars = flax_to_torch(jax.tree.map(np.asarray, init["server_vars"]))
            rk = lambda r, i: jax.random.fold_in(round_key(japi.root_key, r), i)  # noqa: E731
            api.order_hook = lambda r, i: _jax_perms(
                jax.random.split(rk(r, 1), japi.C)[i], cfg.epochs, japi.n_pad)
            api.server_order_hook = lambda r: _jax_perms(rk(r, 2), cfg.epochs_server,
                                                         japi.C * japi.n_pad)

        record(JaxFedGKTAPI, "jax")
        record(fedgkt.FedGKTAPI, "port", from_jax)
        keys = ("Test/Loss", "Train/ClientLoss", "Train/ServerLoss")
    else:
        from fedml_tpu.algorithms.fedavg import FedAvgAPI as JaxFedAvgAPI

        def from_jax(api):
            n_pad = api.dataset.train_x.shape[1]
            api.variables = flax_to_torch(jax.tree.map(np.asarray, made["jax_init"]["variables"]))
            api.order_hook = lambda r, i, n=n_pad: _jax_perms(
                jax.random.split(round_key(jax.random.key(cfg.seed), r),
                                 cfg.client_num_per_round)[i], cfg.epochs, n)

        record(JaxFedAvgAPI, "jax")
        record(fedavg.FedAvgAPI, "port", from_jax)
        keys = ()
    want = jax_run_experiment(jcfg, algorithm)
    got = run_experiment(cfg, algorithm, device="cpu")
    port, japi = made["port"], made["jax"]
    for name in ("train_x", "train_y", "train_mask", "test_x", "test_y"):
        assert np.array_equal(getattr(port.dataset, name), getattr(japi.dataset, name)), name
    if algorithm == "fedgkt":
        blocks = (port.pair.client.module._blocks, port.pair.server.module._blocks)
        assert tuple(map(len, blocks)) == (1, 4)
        wantv = {"client": flax_to_torch(jax.tree.map(np.asarray, japi.client_vars),
                                         stacked=True),
                 "server": flax_to_torch(jax.tree.map(np.asarray, japi.server_vars))}
        gotv = {"client": port.client_vars, "server": port.server_vars}
        dist = {h: _rel_diff(gotv[h], wantv[h]) for h in wantv}
        assert dist["client"] < 1e-4 and dist["server"] < 1e-2, dist
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=5e-3, err_msg=k)
        return
    assert type(port).__name__ == type(japi).__name__ and got["round"] == want["round"] == [0]
    np.testing.assert_allclose(got["Test/Acc"], want["Test/Acc"], atol=1e-3)
    np.testing.assert_allclose(got["Test/Loss"], want["Test/Loss"], atol=1e-3)


def test_unknown_algorithm_rank_and_class_num():
    with pytest.raises(KeyError):
        run_experiment(FedConfig(), "fedsgd", device="cpu")
    with pytest.raises(SystemExit):
        main(SMALL + ["--algorithm", "fedsgd"], device="cpu")
    with pytest.raises(ValueError, match="--rank"):
        run_experiment(FedConfig(rank=1, world_size=3), "fedavg", device="cpu")
    with pytest.raises(ValueError, match="class_num"):
        run_experiment(FedConfig(dataset="synthetic_1_1", class_num=3), "fedavg", device="cpu")
    with pytest.raises(NotImplementedError, match="rounds_per_step"):
        main(SMALL + ["--rounds_per_step", "2"], device="cpu")


@pytest.mark.parametrize("algorithm", PORTED)
def test_main_alias_defaults_to_its_algorithm_on_the_gpu(algorithm, monkeypatch):
    seen = {}
    import fedml_tpu_torch.experiments.run as run

    def fake_run(config, alg, device=None):
        seen.update(algorithm=alg, device=device)
        return run_experiment(config, alg, device=device)

    monkeypatch.setattr(run, "run_experiment", fake_run)
    monkeypatch.setattr(sys, "argv", [f"main_{algorithm}.py"] + IMAGE_ARGS.get(algorithm, SMALL))
    module = f"fedml_tpu_torch.experiments.main_{algorithm}"
    monkeypatch.delitem(sys.modules, module, raising=False)   # run it fresh, as -m does
    if torch.cuda.is_available():
        runpy.run_module(module, run_name="__main__")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            runpy.run_module(module, run_name="__main__")
    assert seen == {"algorithm": algorithm, "device": None}


def _jax_orders(seed: int, epochs: int, round_idx: int, cohort: int, n_pad: int):
    rk = jax.random.fold_in(jax.random.key(seed), round_idx)
    return [[torch.from_numpy(np.asarray(jax.random.permutation(ek, n_pad)).astype(np.int64))
             for ek in jax.random.split(ck, epochs)]
            for ck in jax.random.split(rk, cohort)]


def test_train_history_matches_jax():
    run = dict(model="lr", dataset="synthetic_1_1", client_num_in_total=8,
               client_num_per_round=3, comm_round=5, batch_size=10, epochs=2, lr=0.3,
               frequency_of_the_test=2, seed=4)
    jds = jax_make_synthetic_lr(num_clients=8, batch_size=10, seed=4)
    japi = JaxFedAvgAPI(jds, JaxFedConfig(**run, device_data="off", bucket_quantum_batches=0),
                        jax_create_model("lr", jds.class_num, input_shape=jds.train_x.shape[2:]))
    init = flax_to_torch(jax.tree.map(np.asarray, japi.variables))
    want = japi.train()
    ds = make_synthetic_lr(num_clients=8, batch_size=10, seed=4)
    n_pad = ds.train_x.shape[1]
    api = FedAvgAPI(ds, FedConfig(**run, device_data="on"), device="cpu",
                    order_hook=lambda r, i: _jax_orders(4, 2, r, 3, n_pad)[i])
    api.variables = init
    got = api.train()
    assert got["round"] == want["round"] == [0, 2, 4]
    np.testing.assert_allclose(got["Test/Loss"], want["Test/Loss"], rtol=1e-5)
    np.testing.assert_allclose(got["Test/Acc"], want["Test/Acc"], rtol=1e-5)
    assert set(got["timing"]) >= {"time/train_s", "time/eval_s", "time/wall_s", "rounds_per_sec"}


def _rel_diff(a: dict, b: dict) -> float:
    diff = torch.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
    return float(diff / torch.sqrt(sum((b[k] ** 2).sum() for k in b)).clamp(min=1e-9))


@pytest.mark.parametrize("model", ["lr", "cnn"])
def test_full_participation_equals_centralized(model):
    """One full-batch step a client, every client a round: the weighted mean
    of the clients' steps is one full-batch step of the merged data."""
    if model == "lr":
        ds = make_synthetic_classification("tiny", (12,), 3, 4, records_per_client=10,
                                           partition_method="homo", batch_size=8, seed=0)
        extra = dict(comm_round=3, lr=0.5, seed=7, frequency_of_the_test=1)
    else:
        ds = make_synthetic_classification("convq", (12, 12, 1), 3, 4, records_per_client=8,
                                           partition_method="homo", batch_size=8, seed=2)
        extra = dict(comm_round=2, lr=0.2, seed=5, frequency_of_the_test=10)
    n_pad = ds.train_x.shape[1]
    cfg = FedConfig(model=model, dataset=ds.name, client_num_in_total=4, client_num_per_round=4,
                    epochs=1, batch_size=n_pad, client_optimizer="sgd", **extra)
    fed = FedAvgAPI(ds, cfg, create_model(model, ds.class_num, input_shape=ds.train_x.shape[2:]),
                    device="cpu")
    fed.train()
    cen = CentralizedTrainer(ds, cfg.replace(batch_size=int(ds.train_counts.sum())),
                             create_model(model, ds.class_num, input_shape=ds.train_x.shape[2:]),
                             device="cpu")
    h = cen.train()
    assert h["round"][-1] == cfg.comm_round - 1
    assert _rel_diff(fed.variables, cen.variables) < 1e-4


def test_merge_clients_is_bit_equal_to_jax():
    data = dict(name="merge", input_shape=(5,), classes=3, num_clients=5, records_per_client=13,
                test_records=8, partition_method="hetero", batch_size=8, seed=3)
    ds, jds = make_synthetic_classification(**data), jax_synthetic(**data)
    assert (ds.train_mask == 0).any()                 # the clients are padded
    for got, want in zip(merge_clients(ds, 7), jax_merge_clients(jds, 7)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert merge_clients(ds, 7)[2].min() == 0         # and so is the pool


_CENTRALIZED = {
    "lr": (dict(input_shape=(12,), records_per_client=10, seed=0),
           dict(comm_round=3, lr=0.5, momentum=0.5, epochs=2, seed=7, frequency_of_the_test=1)),
    "cnn": (dict(input_shape=(12, 12, 1), records_per_client=8, seed=2),
            dict(comm_round=2, lr=0.05, momentum=0.5, epochs=2, seed=5,
                 frequency_of_the_test=1)),
}


@pytest.mark.parametrize("model", sorted(_CENTRALIZED))
def test_centralized_trainer_matches_jax(model):
    data, run = _CENTRALIZED[model]
    data = dict(name="centralized", classes=3, num_clients=4, test_records=24,
                partition_method="hetero", batch_size=8, **data)
    ds, jds = make_synthetic_classification(**data), jax_synthetic(**data)
    run = dict(model=model, dataset="centralized", client_num_in_total=4, client_num_per_round=4,
               batch_size=int(ds.train_counts.sum()), client_optimizer="sgd", **run)
    shape = ds.train_x.shape[2:]
    jtr = JaxCentralizedTrainer(jds, JaxFedConfig(**run),
                                jax_create_model(model, jds.class_num, input_shape=shape))
    init = flax_to_torch(jax.tree.map(np.asarray, jtr.variables))
    want = jtr.train()
    tr = CentralizedTrainer(ds, FedConfig(**run), create_model(model, ds.class_num,
                                                                input_shape=shape), device="cpu")
    tr.variables = init
    got = tr.train()
    assert got["round"] == want["round"] == list(range(run["comm_round"]))
    np.testing.assert_allclose(got["Test/Loss"], want["Test/Loss"], rtol=1e-5)
    np.testing.assert_allclose(got["Test/Acc"], want["Test/Acc"], rtol=1e-5)
    final = flax_to_torch(jax.tree.map(np.asarray, jtr.variables))
    assert sorted(final) == sorted(tr.variables)
    for k, v in final.items():
        np.testing.assert_allclose(tr.variables[k].numpy(), v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


_FEDERATED_ONLY = {
    "checkpoint_dir": "ckpt", "resume_from": "ckpt/latest.ckpt", "profile_dir": "prof",
    "enable_wandb": True, "pack_lanes": 2, "packed_conv": "blockdiag", "async_rounds": True,
    "stream_aggregate": "deterministic",
    "cohort_chunk": {"cohort_chunk": 2, "stream_aggregate": "deterministic"},
    "cohort_policy": "speed",
    "failure_prob": 0.25, "host_pipeline_depth": 2, "host_pipeline_workers": 2,
    "device_data": "off", "norm_bound": 1.0, "stddev": 0.1, "attack_type": "edge_case",
    "poison_frac": 0.1, "group_num": 2, "group_comm_round": 2,
}


def test_federated_only_fields_are_the_listed_ones():
    assert set(_FEDERATED_ONLY) == set(FEDERATED_ONLY_FIELDS) | {"device_data"}


@pytest.mark.parametrize("field", sorted(_FEDERATED_ONLY))
def test_centralized_refuses_a_field_it_does_not_read(field):
    value = _FEDERATED_ONLY[field]
    ds = make_synthetic_lr(num_clients=4, batch_size=10, seed=0)
    fields = value if isinstance(value, dict) else {field: value}
    cfg = FedConfig(model="lr", dataset="synthetic_1_1", client_num_in_total=4,
                    client_num_per_round=4, **fields)
    with pytest.raises(NotImplementedError, match=field):
        CentralizedTrainer(ds, cfg, device="cpu")
