"""The port's edge FedAvg (``distributed/fedavg_edge.py``) against the JAX
package's, and against the port's own simulation.

Parity uses JAX's equivalence set-up (tests/test_fedavg_edge.py:41-60):
full-batch local epochs (``batch_size = n_pad``) and one sampled client a
worker, so the per-client orders (the port's ``client_generator`` draws,
JAX's ``fold_in`` threefry stream) only permute records inside the one
batch, which changes no sum. There, at JAX's tolerances (weights rtol 1e-5
/ atol 1e-6, acc 1e-6, loss 1e-4; tests/test_fedavg_edge.py:70-77), with
``lr`` and with the CI-size ``CifarResNet(1, 10, widths=(8, 16, 16),
bn_impl="pallas")`` (the plain K1/K2 on the CPU):

- ``run_fedavg_edge`` equals the port's ``FedAvgAPI``;
- the port's edge, built through the port's seams (``build_edge_rank``,
  ``comm.local.run_ranks``), equals the JAX edge built through JAX's, from
  JAX's initial weights.

Bit for bit: gRPC (``importorskip``) and MQTT federations against the local
transport, kill-and-resume against a straight run, a fault-tolerant healthy
run against a strict one; ``wire_delta`` under ``raw`` reproduces full
uploads at JAX's own 1e-6 (``(new - old) + old`` rounds), and the ``q8``
error-feedback residual and delta equal JAX's on the same inputs. The
failure tests (after tests/test_edge_failures.py) replace the deadline
timer's wait by a deterministic trigger: the server closes a round the
moment every upload but the doomed workers' is in, so nothing sleeps.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.comm.local import run_ranks as jax_run_ranks
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.rng import seed_everything
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.distributed import fedavg_edge as jedge
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.comm import Message
from fedml_tpu_torch.comm.local import run_ranks
from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager
from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.distributed import fedavg_edge as edge
from fedml_tpu_torch.experiments import run_experiment
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.convert import flax_to_torch
from torch_edge_refs import TOL
from torch_edge_refs import assert_history_close as _assert_history_close
from torch_edge_refs import assert_tree_close as _assert_tree_close
from torch_edge_refs import equiv as _equiv
from torch_edge_refs import free_base as _free_base
from torch_edge_refs import jax_bundle as _jax_bundle
from torch_edge_refs import port_bundle as _bundle
from torch_edge_refs import same as _same
from torch_edge_refs import to_flax as _flax


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite's parallel workers each using every
    core slow the small CPU convs by orders of magnitude."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)




@pytest.mark.parametrize("model", ["lr", "resnet"])
def test_edge_matches_the_simulation(model):
    data, run, workers = _equiv(model)
    ds = make_synthetic_classification(**data)
    cfg = FedConfig(**run)
    agg = edge.run_fedavg_edge(ds, cfg, worker_num=workers, bundle=_bundle(model), device="cpu")
    sim = FedAvgAPI(ds, cfg, _bundle(model), device="cpu")
    hist = sim.train()
    for k, v in sim.variables.items():
        np.testing.assert_allclose(agg.variables[k], v.numpy(), **TOL, err_msg=k)
    _assert_history_close(agg.test_history, hist["Test/Acc"], hist["Test/Loss"], hist["round"])


def _jax_edge(model: str, data: dict, run: dict, workers: int, init):
    """The JAX edge through JAX's own seams, from ``init``; the workers share
    one jitted local step (one compile)."""
    jds = jax_synthetic(**data)
    jcfg = JaxFedConfig(**run)
    jbundle = _jax_bundle(model)
    root = seed_everything(jcfg.seed)
    agg = jedge.make_aggregator(init, workers, jcfg, dataset=jds, bundle=jbundle)
    shared = {}

    def make(rank, comm):
        m = jedge.build_edge_rank(jds, jcfg, rank, workers + 1, comm, bundle=jbundle,
                                  root_key=root, aggregator=agg)
        if rank:
            m.trainer.local_train = shared.setdefault("fn", m.trainer.local_train)
        return m

    jax_run_ranks(make, workers + 1, wire_roundtrip=True)
    return agg


@pytest.mark.parametrize("model", ["lr", "resnet"])
def test_port_edge_matches_the_jax_edge(model):
    data, run, workers = _equiv(model)
    jinit = _jax_bundle(model).init(seed_everything(run["seed"]))
    want = _jax_edge(model, data, run, workers, jinit)
    ds = make_synthetic_classification(**data)
    cfg = FedConfig(**run)
    bundle = _bundle(model)
    init = flax_to_torch(jax.tree.map(np.asarray, jinit),
                         bn_name=None if model == "lr" else "PallasBatchNorm")
    agg = edge.make_aggregator(init, workers, cfg, dataset=ds, bundle=bundle, device="cpu")
    run_ranks(lambda r, comm: edge.build_edge_rank(ds, cfg, r, workers + 1, comm, bundle=bundle,
                                                   aggregator=agg, device="cpu"),
              workers + 1, wire_roundtrip=True)
    _assert_tree_close(_flax(model, agg.variables), jax.tree.map(np.asarray, want.variables),
                       **TOL)
    _assert_history_close(agg.test_history, [h["acc"] for h in want.test_history],
                          [h["loss"] for h in want.test_history],
                          [h["round"] for h in want.test_history])
    assert agg.uploads_accepted == want.uploads_accepted == run["comm_round"] * workers


def _lr_setup(**kw):
    data, run, workers = _equiv("lr")
    return make_synthetic_classification(**data), FedConfig(**{**run, **kw}), workers




def test_grpc_federation_equals_local():
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

    ds, cfg, w = _lr_setup()
    local = edge.run_fedavg_edge(ds, cfg, worker_num=w, device="cpu")
    for attempt in range(3):
        base = _free_base(w + 1)
        try:
            over = edge.run_fedavg_edge(ds, cfg, worker_num=w, device="cpu",
                                        comm_factory=lambda r: GRPCCommManager(
                                            r, w + 1, base_port=base, host="127.0.0.1"))
            break
        except OSError:
            if attempt == 2:
                raise
    _same(over, local)


@pytest.mark.parametrize("delta", [False, True], ids=["full", "delta_raw"])
def test_mqtt_federation_equals_local(delta):
    ds, cfg, w = _lr_setup(wire_delta=delta)
    local = edge.run_fedavg_edge(ds, cfg, worker_num=w, device="cpu")
    with MqttBroker(0) as broker:
        over = edge.run_fedavg_edge(ds, cfg, worker_num=w, device="cpu",
                                    comm_factory=lambda r: MqttCommManager(
                                        "127.0.0.1", broker.port, r, w))
    _same(over, local)


def test_wire_delta_raw_reproduces_full_uploads_and_q8_learns():
    ds, cfg, w = _lr_setup()
    full = edge.run_fedavg_edge(ds, cfg, worker_num=w, device="cpu")
    delta = edge.run_fedavg_edge(ds, cfg.replace(wire_delta=True), worker_num=w, device="cpu")
    for k in full.variables:   # JAX's own pin (tests/test_compression.py:137-152)
        np.testing.assert_allclose(delta.variables[k], full.variables[k], rtol=1e-6, atol=1e-6)
    q8 = edge.run_fedavg_edge(ds, cfg.replace(wire_codec="q8", wire_delta=True), worker_num=w,
                              device="cpu")
    hist = q8.test_history
    assert min(h["loss"] for h in hist[1:]) < hist[0]["loss"]


class _Capture:
    def __init__(self):
        self.sent = []

    def add_observer(self, o):
        pass


class _FixedTrainer:
    """Returns the given trained weights, whatever it is sent."""

    def __init__(self, config, outs):
        self.config, self.outs = config, list(outs)

    def update_dataset(self, idx):
        pass

    def train(self, variables, round_idx, *root):
        return self.outs.pop(0), 12.0


def test_q8_delta_and_residual_equal_jax():
    rng = np.random.default_rng(5)
    shapes = {"w": (20, 16), "b": (16,)}
    glob = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
            for _ in range(2)]
    new = [{k: g[k] + 1e-2 * rng.standard_normal(g[k].shape).astype(np.float32) for k in g}
           for g in glob]
    run = dict(model="lr", wire_codec="q8", wire_delta=True)
    sent = {"jax": [], "port": []}

    class JaxClient(jedge.FedAvgEdgeClientManager):
        def send_message(self, m):
            sent["jax"].append(m)

    class PortClient(edge.FedAvgEdgeClientManager):
        def send_message(self, m):
            sent["port"].append(m)

    args = type("A", (), {"comm_round": 2})()
    jm = JaxClient(args, _Capture(), 1, 2, _FixedTrainer(JaxFedConfig(**run), new),
                   seed_everything(0))
    pm = PortClient(args, _Capture(), 1, 2, _FixedTrainer(FedConfig(**run), new))
    for r, g in enumerate(glob):
        for mgr, msg_cls, mod in ((jm, jedge.Message, jedge), (pm, Message, edge)):
            m = msg_cls(mod.MSG_TYPE_S2C_SYNC_MODEL, 0, 1)
            m.add_params(mod.MSG_ARG_KEY_MODEL_PARAMS, g)
            m.add_params(mod.MSG_ARG_KEY_CLIENT_INDEX, [r])
            m.add_params(mod.MSG_ARG_KEY_ROUND, r)
            mgr.handle_message_receive_model_from_server(m)
        jd, pd = (sent[s][-1].get(edge.MSG_ARG_KEY_MODEL_DELTA) for s in ("jax", "port"))
        for k in shapes:
            np.testing.assert_array_equal(pd[k], np.asarray(jd[k]))
            np.testing.assert_array_equal(pm._residual[k], np.asarray(jm._residual[k]))
        assert np.abs(pm._residual["w"]).max() > 0


def _resume_cfg(**kw):
    return FedConfig(model="lr", dataset="synthetic_1_1", client_num_in_total=9,
                     client_num_per_round=6, comm_round=4, batch_size=10, lr=0.1, epochs=1,
                     frequency_of_the_test=1, seed=5, device_data="off", **kw)


@pytest.mark.parametrize("wire", [{}, {"wire_codec": "q8", "wire_delta": True}],
                         ids=["raw", "q8_delta"])
def test_kill_and_resume_is_bit_identical(tmp_path, wire):
    ds = load_dataset("synthetic_1_1", num_clients=9, batch_size=10, seed=5)
    full = edge.run_fedavg_edge(ds, _resume_cfg(**wire), worker_num=3, device="cpu")
    ck = str(tmp_path / "ck")
    edge.run_fedavg_edge(ds, _resume_cfg(**wire).replace(comm_round=2, checkpoint_dir=ck,
                                                           checkpoint_frequency=2),
                         worker_num=3, device="cpu")
    path = os.path.join(ck, "edge_server.ckpt")
    assert os.path.exists(path)
    if wire:
        assert os.path.exists(os.path.join(ck, "edge_worker_1.residual"))
    resumed = edge.run_fedavg_edge(
        ds, _resume_cfg(**wire).replace(checkpoint_dir=ck, checkpoint_frequency=2,
                                        resume_from=path), worker_num=3, device="cpu")
    _same(resumed, full)


def test_resume_of_a_finished_run_is_a_noop(tmp_path):
    ds = load_dataset("synthetic_1_1", num_clients=9, batch_size=10, seed=5)
    ck = str(tmp_path / "ck")
    first = edge.run_fedavg_edge(ds, _resume_cfg(checkpoint_dir=ck, checkpoint_frequency=2),
                                 worker_num=3, device="cpu")
    again = edge.run_fedavg_edge(
        ds, _resume_cfg(resume_from=os.path.join(ck, "edge_server.ckpt")), worker_num=3,
        device="cpu")
    _same(again, first)


# -- fault tolerance (after tests/test_edge_failures.py) ----------------------

WORKERS = 3


def _ft_cfg(**kw):
    base = dict(model="lr", dataset="synthetic_1_1", client_num_in_total=9,
                client_num_per_round=6, comm_round=5, batch_size=10, lr=0.1, epochs=1,
                frequency_of_the_test=1, seed=7, device_data="off",
                # long: the test's own trigger closes every round first
                straggler_deadline_sec=120.0)
    return FedConfig(**{**base, **kw})


def _ft_ds():
    return load_dataset("synthetic_1_1", num_clients=9, batch_size=10, seed=7)


class _Server(edge.FedAvgEdgeServerManager):
    """Records each round's deal, and closes a round by its deadline the
    moment every upload but those of the workers doomed in that round is in
    (``doomed(round) -> set``): the deterministic stand-in for the timer."""

    _MAX_EMPTY_DEADLINES = 3
    doomed = staticmethod(lambda r: set())

    def _broadcast_model(self, msg_type, global_params, assignments):
        self.__dict__.setdefault("assignment_log", []).append((self.round_idx,
                                                               dict(assignments)))
        super()._broadcast_model(msg_type, global_params, assignments)

    def handle_message_receive_model_from_client(self, msg):
        r = self.round_idx
        super().handle_message_receive_model_from_client(msg)
        doomed = self.doomed(r)
        if (self.round_idx == r and doomed
                and set(self.aggregator.model_dict) >= self._expected - doomed):
            m = Message(edge.MSG_TYPE_LOCAL_ROUND_DEADLINE, 0, 0)
            m.add_params(edge.MSG_ARG_KEY_ROUND, r)
            self.handle_round_deadline(m)


class _Crashing(edge.FedAvgEdgeClientManager):
    """Stops (like a killed process) instead of training once the round tag
    reaches ``crash_at``; with ``post_deadline`` it then hands the server a
    deadline event for that round (the timer firing after it died)."""

    crash_at = {}
    post_deadline = False

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.uploads = 0

    def _train_and_send(self, msg):
        r = int(msg.get(edge.MSG_ARG_KEY_ROUND))
        if r >= self.crash_at.get(self.rank, 10 ** 9):
            self.finish()
            if self.post_deadline:
                m = Message(edge.MSG_TYPE_LOCAL_ROUND_DEADLINE, 0, 0)
                m.add_params(edge.MSG_ARG_KEY_ROUND, r)
                self.com_manager.router.post(0, m)
            return
        self.uploads += 1
        super()._train_and_send(msg)


def _ft_run(cfg, server_cls=_Server, client_cls=_Crashing, timeout=120.0):
    ds = _ft_ds()
    bundle = create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:])
    agg = edge.make_aggregator(bundle.init(cfg.seed, "cpu"), WORKERS, cfg, dataset=ds,
                               bundle=bundle, device="cpu")
    managers = {}

    def make(rank, comm):
        args = edge._edge_args(cfg, ds)
        if rank == 0:
            m = server_cls(args, comm, 0, WORKERS + 1, agg)
        else:
            m = client_cls(args, comm, rank, WORKERS + 1,
                           edge.FedAVGTrainer(ds, bundle, cfg, device="cpu"))
        managers[rank] = m
        return m

    run_ranks(make, WORKERS + 1, wire_roundtrip=True, timeout=timeout)
    return managers


def test_fault_tolerant_healthy_run_equals_strict():
    ds = _ft_ds()
    strict = edge.run_fedavg_edge(ds, _ft_cfg(comm_round=3, straggler_deadline_sec=None),
                                  worker_num=WORKERS, device="cpu")
    ft = edge.run_fedavg_edge(ds, _ft_cfg(comm_round=3), worker_num=WORKERS, device="cpu")
    _same(ft, strict)


def test_worker_crash_keeps_the_survivors_working():
    class Server(_Server):
        doomed = staticmethod(lambda r: {2} if r == 2 else set())

    class Client(_Crashing):
        crash_at = {3: 2}

    managers = _ft_run(_ft_cfg(), Server, Client)
    server = managers[0]
    assert [h["round"] for h in server.aggregator.test_history] == list(range(5))
    assert server._alive[0] and server._alive[1] and not server._alive[2]
    for rnd, amap in server.assignment_log:
        if rnd > 2:   # the dead worker's clients are dealt to the survivors
            assert amap[2] == [] and len(amap[0]) + len(amap[1]) == 6
    assert [managers[r].uploads for r in (1, 2, 3)] == [5, 5, 2]


def test_all_workers_crashing_tears_the_federation_down():
    class Client(_Crashing):
        crash_at = {1: 1, 2: 1, 3: 1}
        post_deadline = True

    managers = _ft_run(_ft_cfg(), _Server, Client)
    server = managers[0]
    # round 0 closed before the crash; three empty deadlines, then teardown
    assert [h["round"] for h in server.aggregator.test_history] == [0]
    assert not any(server._alive.values()) and server._empty_deadlines == 3


def test_worker_rejoins_the_federation():
    dead = {}

    class Server(_Server):
        doomed = staticmethod(lambda r: {1} if r == 1 else set())

        def _mark_dead(self, w):
            super()._mark_dead(w)
            dead.setdefault(w, threading.Event()).set()

    class Client(_Crashing):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.dropped, self.after = False, 0

        def _train_and_send(self, msg):
            if self.rank == 2 and int(msg.get(edge.MSG_ARG_KEY_ROUND)) == 1 \
                    and not self.dropped:
                # silent for round 1; JOIN once the server has marked it dead
                self.dropped = True
                ev = dead.setdefault(1, threading.Event())

                def rejoin():
                    ev.wait(60)
                    self.send_message(Message(edge.MSG_TYPE_C2S_JOIN, self.rank, 0))

                threading.Thread(target=rejoin, daemon=True).start()
                return
            self.after += self.dropped and bool(msg.get(edge.MSG_ARG_KEY_CLIENT_INDEX))
            super()._train_and_send(msg)

    managers = _ft_run(_ft_cfg(comm_round=5), Server, Client)
    server = managers[0]
    assert [h["round"] for h in server.aggregator.test_history] == list(range(5))
    assert all(server._alive.values())
    assert managers[2].after > 0           # trained real clients after rejoining
    assert all(np.isfinite(h["loss"]) for h in server.aggregator.test_history)


def test_stale_upload_after_a_deadline_close_never_folds():
    """Worker 1 misses the deadline and round 0 closes on the survivor's
    fold; its late round-0 upload is dropped as stale, never folded into
    round 1 (tests/test_fedsched.py:498-570)."""
    ds = load_dataset("synthetic_1_1", num_clients=6, batch_size=10, seed=5)
    cfg = FedConfig(model="lr", dataset="synthetic_1_1", client_num_in_total=6,
                    client_num_per_round=6, comm_round=2, batch_size=10, lr=0.1, seed=5,
                    straggler_deadline_sec=30.0, frequency_of_the_test=10_000,
                    stream_aggregate="deterministic")

    class Comm:
        def add_observer(self, o):
            pass

        def send_message(self, m):
            pass

        def inject_local(self, m):
            pass

        def supports_local_injection(self):
            return True

        def stop_receive_message(self):
            pass

    bundle = create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:])
    init = bundle.init(cfg.seed, "cpu")
    agg = edge.StreamingFedAVGAggregator(init, 2, cfg, dataset=ds, bundle=bundle, device="cpu")
    server = edge.FedAvgEdgeServerManager(edge._edge_args(cfg, ds), Comm(), 0, 3, agg)
    server._assignment_map = server._assignments(0)
    server._broadcast_model(2, agg.get_global_model_params(), server._assignment_map)

    def upload(worker, tag):
        m = Message(edge.MSG_TYPE_C2S_SEND_MODEL, worker + 1, 0)
        m.add_params(edge.MSG_ARG_KEY_ROUND, tag)
        m.add_params(edge.MSG_ARG_KEY_GEN, server._bcast_gen)
        m.add_params(edge.MSG_ARG_KEY_MODEL_PARAMS, edge.host_tree(init))
        m.add_params(edge.MSG_ARG_KEY_NUM_SAMPLES, 10.0)
        return m

    server.handle_message_receive_model_from_client(upload(0, 0))
    assert agg.uploads_accepted == 1 and agg._stream.folded == 1
    deadline = Message(edge.MSG_TYPE_LOCAL_ROUND_DEADLINE, 0, 0)
    deadline.add_params(edge.MSG_ARG_KEY_ROUND, 0)
    server.handle_round_deadline(deadline)
    assert server.round_idx == 1 and not server._alive[1] and agg._stream.folded == 0
    server.handle_message_receive_model_from_client(upload(1, 0))
    assert server.stale_uploads == 1 and agg.uploads_accepted == 1
    assert agg._stream.folded == 0 and agg.duplicate_uploads == 0
    server._cancel_timer()


def test_streaming_aggregator_matches_the_batch_one_and_jax():
    """Order independence, batch parity at the streaming tolerance (rtol
    1e-6 / atol 1e-7, tests/test_fedsched.py:415-467) and JAX's fold bit for
    bit on the same uploads."""
    rng = np.random.default_rng(2)
    v0 = {"w": rng.standard_normal((10, 6)).astype(np.float32),
          "b": np.zeros(6, np.float32)}
    ups = [(i, {k: v + rng.standard_normal(v.shape).astype(np.float32) for k, v in v0.items()},
            float(rng.integers(1, 40))) for i in range(6)]
    cfg = FedConfig(model="lr", stream_aggregate="deterministic")

    def streamed(order, mod=edge, config=cfg):
        agg = mod.StreamingFedAVGAggregator(v0, 6, config, **({"device": "cpu"}
                                                               if mod is edge else {}))
        for i in order:
            agg.add_local_trained_result(*ups[i])
        return agg, agg.aggregate()

    ordered, a = streamed(range(6))
    shuffled, b = streamed([3, 0, 5, 1, 4, 2])
    assert shuffled.stream_peak_held >= 2
    _, j = streamed([3, 0, 5, 1, 4, 2], jedge, JaxFedConfig(model="lr",
                                                           stream_aggregate="deterministic"))
    batch = edge.make_aggregator(v0, 6, FedConfig(model="lr"), device="cpu")
    assert type(batch) is edge.FedAVGAggregator
    for u in ups:
        batch.add_local_trained_result(*u)
    want = batch.aggregate()
    for k in v0:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], np.asarray(j[k]))
        np.testing.assert_allclose(a[k], want[k], rtol=1e-6, atol=1e-7)
    dup = edge.make_aggregator(v0, 6, cfg, device="cpu")
    dup.add_local_trained_result(*ups[0])
    dup.add_local_trained_result(*ups[0])
    assert dup.duplicate_uploads == 1 and dup._stream.folded == 1


def test_launcher_runs_fedavg_edge(tmp_path):
    small = dict(dataset="synthetic_1_1", model="lr", client_num_in_total=4,
                 client_num_per_round=2, comm_round=2, batch_size=10, lr=0.1,
                 frequency_of_the_test=1, seed=3)
    got = run_experiment(FedConfig(**small), "fedavg_edge", device="cpu")
    assert got["round"] == [0, 1] and all(np.isfinite(got["Test/Loss"]))
    from fedml_tpu_torch.experiments.run import main

    via_cli = main(["--algorithm", "fedavg_edge", "--device", "cpu",
                    *[f"--{k}={v}" for k, v in small.items()]])
    assert via_cli == got
    if __import__("importlib").util.find_spec("grpc") is not None:
        assert run_experiment(FedConfig(**small, backend="grpc"), "fedavg_edge",
                              device="cpu") == got


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device`` the edge runs on CUDA, and raises on a host
    without it rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds, cfg, w = _lr_setup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edge.run_fedavg_edge(ds, cfg, worker_num=w)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment(cfg.replace(dataset="synthetic_1_1"), "fedavg_edge")


def test_launch_edge_runs_one_process_per_rank_over_grpc(tmp_path, monkeypatch):
    """``experiments/launch_edge.py``: 3 OS processes (``--rank`` 0-2) over
    gRPC on loopback, on the CPU (``--device cpu``); the server's history
    equals the in-process federation's at JAX's tolerances."""
    pytest.importorskip("grpc")
    import json
    from pathlib import Path

    from fedml_tpu_torch.experiments import launch_edge

    root = Path(__file__).resolve().parent.parent
    monkeypatch.chdir(root)
    monkeypatch.setenv("PYTHONPATH", str(root))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    small = dict(dataset="synthetic_1_1", model="lr", client_num_in_total=4,
                 client_num_per_round=2, comm_round=2, batch_size=10, lr=0.1,
                 frequency_of_the_test=1, seed=3)
    want = run_experiment(FedConfig(**small), "fedavg_edge", device="cpu")
    out = tmp_path / "server.json"
    argv = [*(f"--{k}={v}" for k, v in small.items()), "--backend", "grpc", "--device", "cpu",
            "--grpc_base_port", str(_free_base(3)), "--result_json", str(out)]
    assert launch_edge.main(["--world_size", "3", *argv]) == 0
    got = json.loads(out.read_text())
    assert got["role"] == "server" and got["round"] == want["round"] == [0, 1]
    np.testing.assert_allclose(got["Test/Acc"], want["Test/Acc"], rtol=1e-6)
    np.testing.assert_allclose(got["Test/Loss"], want["Test/Loss"], rtol=1e-4)
    assert launch_edge.main(argv) == 2                 # --world_size is required


def test_device_calls_are_serialized_on_one_thread():
    """``device_call`` from more rank threads than cores, with a short
    switch interval: a read-modify-write inside the calls loses no update,
    every call runs on the one device thread, and an error reaches its
    caller."""
    import sys

    counter = {"n": 0}
    idents = set()

    def bump():
        idents.add(threading.get_ident())
        n = counter["n"]
        for _ in range(50):
            pass
        counter["n"] = n + 1
        return edge.device_call(lambda: "nested")   # a call from the device thread

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [edge.device_call(bump) for _ in range(50)])
                   for _ in range(4 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter["n"] == 50 * len(threads) and len(idents) == 1
    with pytest.raises(ZeroDivisionError):
        edge.device_call(lambda: 1 / 0)


def test_shared_program_follows_the_module_tensors():
    """Workers of one bundle share one local-train program while the
    module's tensors stay put; once they move (``ModelBundle.init`` moves
    the module to the CPU and back on a card, which a captured step would
    replay stale), a new program takes its place."""
    ds, cfg, _ = _lr_setup()
    bundle = create_model("lr", 3, input_shape=(8,))
    first = edge.edge_local_train(bundle, ds, cfg)
    assert edge.edge_local_train(bundle, ds, cfg) is first
    assert edge.edge_local_train(bundle, ds, cfg.replace(lr=0.5)) is not first
    with torch.no_grad():
        for p in bundle.module.parameters():
            p.data = p.data.clone()                  # what a round trip through .to() does
    moved = edge.edge_local_train(bundle, ds, cfg)
    assert moved is not first and edge.edge_local_train(bundle, ds, cfg) is moved
