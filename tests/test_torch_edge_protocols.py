"""The port's TurboAggregate, VFL and SplitNN edges and its decentralized
framework (``distributed/{turboaggregate_edge,vfl_edge,split_nn_edge,
decentralized_framework}.py``) against the JAX package's, and against the
port's own in-process forms.

- TurboAggregate: the edge equals the port's ``TurboAggregateAPI`` (both
  draw the port's orders), and the JAX edge from JAX's initial weights in
  JAX's equivalence set-up (one full batch a client, so the two packages'
  orders only permute records inside it), C = 4 and the uneven C = 5
  (groups of 3 + 2), every float within ``4 / 2^20``
  (tests/test_edge_protocols.py:51-53); the threshold protocol, healthy,
  equals the strict ring (tests/test_edge_ft_protocols.py:42-58); where
  the field wraps, the edge returns the API's wrapped values.
- VFL: the edge equals the port's in-process protocol bit for bit
  (tests/test_edge_protocols.py:93-122), and the JAX edge from JAX's party
  init at rtol 1e-5 / atol 1e-6 (tests/test_torch_vfl.py's bound).
- SplitNN: from JAX's initial weights the port's ring takes JAX's turns
  (one validation per client-epoch) with JAX's validation accuracies, and
  the stages' weights within rtol 1e-4 / atol 1e-5 (tests/test_torch_
  split_nn.py's bound: the server stage trains through every client-epoch
  with no average between); the managed ring, healthy, equals the strict
  one (tests/test_edge_ft_protocols.py:145-152).
- The decentralized framework: consensus (tests/test_comm.py:174-180) and
  JAX's histories at rtol 1e-5.
- Under the wire's chaos (drop 0.2, dup 0.1, reorder 0.1, seed 7), each
  protocol equals its run without, bit for bit (tests/test_chaos.py:
  386-416 holds JAX's decentralized run at rtol 1e-5 only because it mixes
  in arrival order; the port mixes in rank order).
"""

import logging

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.rng import seed_everything
from fedml_tpu.data import load_dataset as jax_load_dataset
from fedml_tpu.data import vertical as jvert
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.split import create_split_mlp as jax_split_mlp
from fedml_tpu_torch.algorithms.turboaggregate import TurboAggregateAPI
from fedml_tpu_torch.algorithms.vfl import build_protocol_vfl
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data import vertical as tvert
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.distributed import decentralized_framework as dfw
from fedml_tpu_torch.distributed import split_nn_edge as se
from fedml_tpu_torch.distributed import turboaggregate_edge as te
from fedml_tpu_torch.distributed import vfl_edge as ve
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.split import create_split_mlp
from torch_edge_refs import assert_tree_close, free_base, to_flax

# JAX's acceptance fault rates (tests/test_chaos.py:43-44); the retry clock
# starts at 10 ms (a drained run ends within ~1.5 s of its last lost ack)
CHAOS = dict(wire_reliable=True, chaos_drop=0.2, chaos_dup=0.1, chaos_reorder=0.1, chaos_seed=7,
             wire_retry_base_s=0.01)
FIELD_TOL = dict(rtol=0, atol=4 / (1 << 20))


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flax(tree) -> dict:
    return flax_to_torch(jax.tree.map(np.asarray, tree))


# -- TurboAggregate -----------------------------------------------------------------------


def _ta_data(clients: int) -> dict:
    return dict(name="ta-edge", input_shape=(8,), classes=3, num_clients=clients,
                records_per_client=12, partition_method="hetero", partition_alpha=0.5,
                batch_size=6, seed=2)


def _ta_run(clients: int, rounds: int = 2, **kw) -> dict:
    run = dict(model="lr", client_num_in_total=clients, client_num_per_round=clients,
               comm_round=rounds, epochs=1, batch_size=6, lr=0.3, seed=9,
               frequency_of_the_test=1, device_data="off")
    run.update(kw)
    return run


def _lr(ds):
    return create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:])


def _assert_same_vars(a: dict, b: dict, **tol):
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]), **tol, err_msg=k)


@pytest.mark.parametrize("clients", [4, 5])
def test_ta_edge_matches_the_api(clients):
    ds = make_synthetic_classification(**_ta_data(clients))
    cfg = FedConfig(**_ta_run(clients))
    host = TurboAggregateAPI(ds, cfg, _lr(ds), group_size=2, device="cpu")
    hist = host.train()
    server = te.run_turboaggregate_edge(ds, cfg, group_size=2, device="cpu")
    for k, v in host.variables.items():
        np.testing.assert_allclose(server.variables[k], v.numpy(), **FIELD_TOL, err_msg=k)
    assert server.history["round"] == hist["round"]
    np.testing.assert_allclose(server.history["Test/Acc"], hist["Test/Acc"], rtol=1e-6)
    np.testing.assert_allclose(server.history["Test/Loss"], hist["Test/Loss"], rtol=1e-5)
    assert len(server.mpc_ms) == 2 and server.mpc_stats["clients"] == clients


@pytest.mark.parametrize("clients", [4, 5])
def test_ta_edge_matches_the_jax_edge(clients):
    from fedml_tpu.distributed.turboaggregate_edge import \
        run_turboaggregate_edge as jax_run_turboaggregate_edge

    data = _ta_data(clients)
    n_pad = int(make_synthetic_classification(**data).train_x.shape[1])
    run = _ta_run(clients, batch_size=n_pad)       # one full batch a client
    want = jax_run_turboaggregate_edge(jax_synthetic(**data), JaxFedConfig(**run), group_size=2)
    ds = make_synthetic_classification(**data)
    bundle = _lr(ds)
    init = _flax(jax_create_model("lr", 3, input_shape=(8,)).init(seed_everything(run["seed"])))

    def jax_init(seed=0, device=None):
        bundle.module.load_state_dict(init)
        bundle.module.to(device)
        return {k: v.detach().clone() for k, v in bundle.module.state_dict().items()}

    bundle.init = jax_init
    got = te.run_turboaggregate_edge(ds, FedConfig(**run), group_size=2, bundle=bundle,
                                     device="cpu")
    assert_tree_close(to_flax("lr", got.variables), jax.tree.map(np.asarray, want.variables),
                      **FIELD_TOL)
    assert got.history["round"] == want.history["round"]
    np.testing.assert_allclose(got.history["Test/Acc"], want.history["Test/Acc"], rtol=1e-6)
    np.testing.assert_allclose(got.history["Test/Loss"], want.history["Test/Loss"], rtol=1e-4)


def test_ta_threshold_healthy_equals_the_ring():
    ds = make_synthetic_classification(**_ta_data(4))
    strict = te.run_turboaggregate_edge(ds, FedConfig(**_ta_run(4, 3)), group_size=2,
                                        device="cpu")
    ft = te.run_turboaggregate_edge(ds, FedConfig(**_ta_run(4, 3, straggler_deadline_sec=60.0)),
                                    threshold_t=1, device="cpu")
    _assert_same_vars(strict.variables, ft.variables, rtol=0, atol=1e-6)
    assert ft.history["Test/Acc"] == strict.history["Test/Acc"]


def test_ta_under_chaos_equals_its_run_without():
    ds = make_synthetic_classification(**_ta_data(4))
    bare = te.run_turboaggregate_edge(ds, FedConfig(**_ta_run(4)), device="cpu")
    chaos = te.run_turboaggregate_edge(ds, FedConfig(**_ta_run(4), **CHAOS), device="cpu")
    _assert_same_vars(bare.variables, chaos.variables, rtol=0, atol=0)
    assert chaos.history == bare.history


def test_ta_edge_wraps_where_the_api_wraps():
    """At 30 fractional bits the field holds |total| < 1: the trained lr
    model's larger weights wrap, and the edge returns the API's wrapped
    values (the reference's arithmetic); the API names those floats."""
    ds = make_synthetic_classification(**_ta_data(4))
    cfg = FedConfig(**_ta_run(4, 1, lr=3.0))
    host = TurboAggregateAPI(ds, cfg, _lr(ds), group_size=2, frac_bits=30, device="cpu")
    host.train()
    server = te.run_turboaggregate_edge(ds, cfg, group_size=2, frac_bits=30, device="cpu")
    assert host.mpc_stats["wrapped_floats"] > 0
    _assert_same_vars({k: v.numpy() for k, v in host.variables.items()}, server.variables,
                      **FIELD_TOL)


def test_groups_are_secure_weighted_sums_round_robin_groups():
    assert te._groups(5, 2) == [[0, 2, 4], [1, 3]]
    assert te._groups(4, 2) == [[0, 2], [1, 3]]
    assert te._groups(3, 5) == [[0, 1, 2]]


# -- VFL ----------------------------------------------------------------------------------

VFL = dict(party_dims=(6, 5, 4), n_train=96, n_test=48, seed=7)


def _protocol_fit(ds, epochs, bs, seed, lr):
    proto = build_protocol_vfl(ds, hidden_dim=8, lr=lr, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    n = len(ds.train_y)
    steps = n // bs
    for _ in range(epochs):
        order = rng.permutation(n)[: steps * bs].reshape(steps, bs)
        for idx in order:
            proto.fit(ds.train_parts[0][idx], ds.train_y[idx],
                      {p: ds.train_parts[p][idx] for p in range(1, ds.num_parties)})
    return proto


def test_vfl_edge_equals_the_in_process_protocol():
    ds = tvert.make_synthetic_vertical(**VFL)
    # on the edge's device thread, whose CPU thread count is its own
    proto = ve.device_call(_protocol_fit, ds, epochs=3, bs=32, seed=5, lr=0.05)
    guest = ve.run_vfl_edge(ds, hidden_dim=8, lr=0.05, batch_size=32, epochs=3, seed=5,
                            device="cpu")
    for k, v in proto.guest.params.items():
        assert torch.equal(guest.party.params[k], v), k
    assert set(guest.history[-1]) == {"Train/Loss", "Test/Acc", "Test/Loss"}


def test_vfl_edge_matches_the_jax_edge(monkeypatch):
    from fedml_tpu.algorithms.vfl import init_party_params as jax_init_party_params
    from fedml_tpu.distributed.vfl_edge import run_vfl_edge as jax_run_vfl_edge

    kw = dict(hidden_dim=8, lr=0.05, batch_size=32, epochs=3, seed=5)
    jds = jvert.make_synthetic_vertical(**VFL)
    want = jax_run_vfl_edge(jds, **kw)
    keys = jax.random.split(jax.random.PRNGKey(kw["seed"]), jds.num_parties)

    def jax_parties(dataset, hidden_dim, lr, seed, device):
        params = [{k: torch.from_numpy(np.array(v)).to(device) for k, v in
                   jax_init_party_params(keys[p], d, hidden_dim, guest=p == 0).items()}
                  for p, d in enumerate(dataset.party_dims)]
        return (ve.VFLGuestParty(params[0], lr),
                {p: ve.VFLHostParty(params[p], lr) for p in range(1, dataset.num_parties)})

    monkeypatch.setattr(ve, "init_parties", jax_parties)
    got = ve.run_vfl_edge(tvert.make_synthetic_vertical(**VFL), device="cpu", **kw)
    for k, v in want.party.params.items():
        np.testing.assert_allclose(got.party.params[k].numpy(), np.asarray(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    for key in ("Train/Loss", "Test/Acc", "Test/Loss"):
        np.testing.assert_allclose(got.history[-1][key], want.history[-1][key], rtol=1e-5,
                                   err_msg=key)


def test_vfl_under_chaos_equals_its_run_without():
    ds = tvert.make_synthetic_vertical((6, 5), n_train=64, n_test=32, seed=3)
    kw = dict(hidden_dim=8, lr=0.05, batch_size=32, epochs=1, seed=1, device="cpu")
    bare = ve.run_vfl_edge(ds, **kw)
    chaos = ve.run_vfl_edge(ds, config=FedConfig(**CHAOS), **kw)
    for k, v in bare.party.params.items():
        assert torch.equal(chaos.party.params[k], v), k
    assert chaos.history == bare.history


def test_vfl_keeps_the_strict_barrier_with_a_warning(caplog):
    ds = tvert.make_synthetic_vertical((4, 3), n_train=64, n_test=32, seed=0)
    with caplog.at_level(logging.WARNING):
        guest = ve.run_vfl_edge(ds, epochs=1, batch_size=16, straggler_deadline_sec=5.0,
                                device="cpu")
    assert any("strict" in r.message for r in caplog.records)
    assert np.isfinite(guest.history[-1]["Test/Loss"])


# -- SplitNN ------------------------------------------------------------------------------

SPLIT = dict(batch_size=10, lr=0.02, momentum=0.9, epochs=2, seed=0)


def _split(kw=None):
    ds = load_dataset("synthetic_1_1", num_clients=3, batch_size=10, seed=0)
    return (ds,) + create_split_mlp(ds.class_num, ds.train_x.shape[2:], cut_dim=32)


def test_split_edge_matches_the_jax_edge(monkeypatch):
    from fedml_tpu.distributed.split_nn_edge import run_splitnn_edge as jax_run_splitnn_edge

    jds = jax_load_dataset("synthetic_1_1", num_clients=3, batch_size=10, seed=0)
    jcb, jsb = jax_split_mlp(jds.class_num, jds.train_x.shape[2:], cut_dim=32)
    want = jax_run_splitnn_edge(jds, JaxFedConfig(**SPLIT), jcb, jsb)
    keys = jax.random.split(seed_everything(SPLIT["seed"]), 4)

    def jax_stages(client_bundle, server_bundle, n, seed, device):
        server = _flax(jsb.init(keys[-1]))
        server_bundle.module.load_state_dict(server)
        server_bundle.module.to(device)
        return [{k: v.to(device) for k, v in _flax(jcb.init(keys[c])).items()}
                for c in range(n)], server

    monkeypatch.setattr(se, "init_stages", jax_stages)
    ds, cb, sb = _split()
    got = se.run_splitnn_edge(ds, FedConfig(**SPLIT), cb, sb, device="cpu")
    # one validation a client-epoch: 3 clients x 2 epochs, one turn each
    assert len(got.val_history) == 6 == len(want.val_history)
    assert got.epoch == 6 and got.active_node == 1
    np.testing.assert_allclose(got.val_history, want.val_history, atol=1e-9)
    assert_tree_close(to_flax("lr", got.variables), jax.tree.map(np.asarray, want.variables),
                      rtol=1e-4, atol=1e-5)


def test_split_managed_ring_equals_the_strict_ring():
    ds, cb, sb = _split()
    strict = se.run_splitnn_edge(ds, FedConfig(**SPLIT), cb, sb, device="cpu")
    ds, cb, sb = _split()
    managed = se.run_splitnn_edge(ds, FedConfig(**SPLIT, straggler_deadline_sec=60.0), cb, sb,
                                  device="cpu")
    assert managed.val_history == strict.val_history
    assert managed.ring_alive == {1: True, 2: True, 3: True}
    _assert_same_vars(strict.variables, managed.variables, rtol=0, atol=0)


def test_split_under_chaos_equals_its_run_without():
    cfg = dict(SPLIT, epochs=1)
    ds, cb, sb = _split()
    bare = se.run_splitnn_edge(ds, FedConfig(**cfg), cb, sb, device="cpu")
    ds, cb, sb = _split()
    chaos = se.run_splitnn_edge(ds, FedConfig(**cfg, **CHAOS), cb, sb, device="cpu")
    assert chaos.val_history == bare.val_history
    _assert_same_vars(bare.variables, chaos.variables, rtol=0, atol=0)


# -- the decentralized framework ----------------------------------------------------------


def test_decentralized_consensus_matches_jax():
    from fedml_tpu.distributed.decentralized_framework import \
        run_decentralized_framework as jax_run_decentralized_framework

    hists = dfw.run_decentralized_framework(worker_num=5, comm_round=8)
    finals = np.array([h[-1][0] for h in hists])
    assert np.ptp(finals) < 0.3 * np.ptp(np.arange(5, dtype=np.float32))
    want = jax_run_decentralized_framework(worker_num=5, comm_round=8)
    assert [len(h) for h in hists] == [len(h) for h in want] == [8] * 5
    for a, b in zip(hists, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b, np.float32), rtol=1e-5)


def test_decentralized_under_chaos_equals_its_run_without():
    bare = dfw.run_decentralized_framework(worker_num=4, comm_round=3)
    chaos = dfw.run_decentralized_framework(worker_num=4, comm_round=3,
                                            config=FedConfig(**CHAOS))
    assert all(len(h) == 3 for h in chaos)
    for a, b in zip(chaos, bare):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


# -- gRPC loopback ------------------------------------------------------------------------


def _over_grpc(run, size: int):
    """``run(comm_factory)`` over gRPC loopback on a block of free ports."""
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

    for attempt in range(3):
        base = free_base(size)
        try:
            return run(lambda r: GRPCCommManager(r, size, base_port=base, host="127.0.0.1"))
        except OSError:
            if attempt == 2:
                raise


@pytest.mark.parametrize("protocol", ["turboaggregate", "vfl", "split"])
def test_grpc_loopback_equals_local(protocol):
    """The protocols over real gRPC sockets on the CPU (the card's machine
    has no gRPC) equal their in-process runs bit for bit."""
    if protocol == "turboaggregate":
        ds = make_synthetic_classification(**_ta_data(4))

        def run(factory=None):
            return te.run_turboaggregate_edge(ds, FedConfig(**_ta_run(4, 1)), device="cpu",
                                              comm_factory=factory)

        local, over = run(), _over_grpc(run, 5)
        _assert_same_vars(local.variables, over.variables, rtol=0, atol=0)
        assert over.history == local.history
    elif protocol == "vfl":
        ds = tvert.make_synthetic_vertical((6, 5), n_train=64, n_test=32, seed=3)

        def run(factory=None):
            return ve.run_vfl_edge(ds, hidden_dim=8, lr=0.05, batch_size=32, epochs=1, seed=1,
                                   device="cpu", comm_factory=factory)

        local, over = run(), _over_grpc(run, ds.num_parties)
        for k, v in local.party.params.items():
            assert torch.equal(over.party.params[k], v), k
        assert over.history == local.history
    else:
        def run(factory=None):
            ds, cb, sb = _split()
            return se.run_splitnn_edge(ds, FedConfig(**dict(SPLIT, epochs=1)), cb, sb,
                                       device="cpu", comm_factory=factory)

        local, over = run(), _over_grpc(run, 4)
        assert over.val_history == local.val_history
        _assert_same_vars(local.variables, over.variables, rtol=0, atol=0)
