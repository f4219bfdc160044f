"""The port's FedBuff (``algorithms/fedbuff.py``,
``distributed/fedbuff_edge.py``) against the JAX package's, and the port's
own counterparts of tests/test_fedbuff.py:195-600.

Against JAX: ``staleness_weight``, ``FedBuffBuffer`` and
``DeterministicFrontier`` over one sequence of folds, emissions, ejections
and admissions (emitted weights bit for bit: both fold in float64 and add
the mean in float32), and ``run_fedbuff_edge`` in deterministic mode with
``buffer_k`` = workers from JAX's initial weights, under the FedAvg edge's full-batch
equivalence set-up (the two packages' client orders then only permute the
records of one batch) at JAX's edge tolerances (weights rtol 1e-5 / atol
1e-6, acc 1e-6, loss 1e-4; tests/test_fedavg_edge.py:70-77): ``lr`` on
``synthetic_1_1``, and the CI-size ``CifarResNet(1, 10, widths=(8, 16, 16),
bn_impl="pallas")`` (the plain K1/K2 on the CPU). JAX's reference runs are
module-scoped fixtures.

The port's own: the sync pin against the port's FedAvg edge (JAX's RTOL
1e-3 / ATOL 1e-5, tests/test_fedbuff.py:49), deterministic replay bit for
bit under drop/dup/delay chaos and under crash-stop chaos (local; gRPC with
``importorskip``), exactly-once folds in arrival mode under dup-heavy chaos,
crash-restart, JOIN readmission, and the probe's resend of the original
assignment. The pulse and fedtop cases are ROADMAP §1 item 12's.
"""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms import fedbuff as jfedbuff
from fedml_tpu.comm.local import run_ranks as jax_run_ranks
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.rng import seed_everything
from fedml_tpu.data import load_dataset as jax_load_dataset
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.distributed import fedbuff_edge as jfb
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu_torch.algorithms.fedbuff import (DeterministicFrontier, FedBuffBuffer,
                                                staleness_weight)
from fedml_tpu_torch.comm import Message
from fedml_tpu_torch.comm.local import run_ranks
from fedml_tpu_torch.comm.message import MSG_ARG_KEY_MODEL_PARAMS, MSG_ARG_KEY_NUM_SAMPLES
from fedml_tpu_torch.comm.reliable import ReliableCommManager
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.distributed import fedavg_edge as edge
from fedml_tpu_torch.distributed import fedbuff_edge as fb
from fedml_tpu_torch.models import ModelBundle, create_model
from fedml_tpu_torch.models.convert import flax_to_torch
from fedml_tpu_torch.models.resnet import CifarResNet
from torch_edge_refs import (TOL, assert_history_close, assert_tree_close, equiv, free_base,
                             jax_bundle, port_bundle, to_flax)

WORKERS = 3
VERSIONS = 3
#: the fast retry schedule: gave-up after ~1.4 s (tests/test_fedbuff.py:42-45)
FAST_WIRE = dict(wire_retry_base_s=0.02, wire_retry_max=6)
#: the acceptance rates and latency of tests/test_fedbuff.py:46-47
CHAOS = dict(wire_reliable=True, chaos_drop=0.2, chaos_dup=0.1, chaos_delay_ms=20, chaos_seed=7,
             **FAST_WIRE)
#: the sync pin's tolerance (float64 fold against the float32 batch mean)
RTOL, ATOL = 1e-3, 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread (the suite's parallel workers share the cores);
    the count is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**kw):
    base = dict(model="lr", dataset="synthetic_1_1", client_num_in_total=6,
                client_num_per_round=6, comm_round=VERSIONS, batch_size=10, lr=0.1, epochs=1,
                frequency_of_the_test=1, seed=5, device_data="off")
    return FedConfig(**{**base, **kw})


def _ds():
    return load_dataset("synthetic_1_1", num_clients=6, batch_size=10, seed=5)


def _run(cfg, **kw):
    return fb.run_fedbuff_edge(_ds(), cfg, worker_num=WORKERS, device="cpu", **kw)


def _assert_bit_identical(a, b):
    for k in a.variables:
        np.testing.assert_array_equal(a.variables[k], b.variables[k], err_msg=k)
    assert [h["loss"] for h in a.test_history] == [h["loss"] for h in b.test_history]


# -- the buffer and the frontier against JAX --------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0, 2.5])
def test_staleness_weight_equals_jax(alpha):
    for n in (0.0, 1.0, 10.0, 1562.0):
        for s in (-2, 0, 1, 3, 7, 40):
            assert staleness_weight(n, s, alpha) == jfedbuff.staleness_weight(n, s, alpha)


def _fold_script(rng):
    """One sequence of buffer operations: (op, args) with deltas as numpy."""
    shapes = {"w": (7, 5), "b": (5,)}
    ops = []
    for step in range(14):
        delta = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        n = float(rng.integers(0, 40)) if step != 5 else 0.0
        ops.append(("fold", delta, n, int(rng.integers(0, 3))))
        if step % 3 == 2:
            ops.append(("emit",))
    return shapes, ops


def test_buffer_equals_jax_over_a_fold_sequence():
    """Staleness, weights, the fold log, emission records and emitted
    weights bit for bit over folds of stale, fresh and zero-weight
    contributions."""
    shapes, ops = _fold_script(np.random.default_rng(3))
    params = {k: np.full(s, 0.25, np.float32) for k, s in shapes.items()}
    port, ref = FedBuffBuffer(k=3, alpha=0.5), jfedbuff.FedBuffBuffer(k=3, alpha=0.5)
    pp, jp = dict(params), dict(params)
    for op in ops:
        if op[0] == "fold":
            _, delta, n, lag = op
            trained = max(port.version - lag, 0)
            assert port.fold(delta, n, trained) == ref.fold(delta, n, trained)
            assert port.ready == ref.ready
        else:
            pp, prec = port.emit(pp)
            jp, jrec = ref.emit(jp)
            assert prec == jrec
            for k in shapes:
                np.testing.assert_array_equal(pp[k], np.asarray(jp[k]), err_msg=k)
    assert list(port.fold_log) == list(ref.fold_log)
    for attr in ("version", "pending", "folds", "zero_weight_folds", "versions_emitted"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.zero_weight_folds == 1 and port.versions_emitted == 4


def test_frontier_equals_jax_through_ejections_and_admissions():
    rng = np.random.default_rng(8)
    port, ref = DeterministicFrontier(range(4)), jfedbuff.DeterministicFrontier(range(4))
    drained = {"port": [], "jax": []}
    for step in range(60):
        w, t = int(rng.integers(0, 4)), int(rng.integers(0, 6))
        if step == 20:
            port.eject(2), ref.eject(2)
        elif step == 40:
            port.admit(2, 4), ref.admit(2, 4)
        else:
            assert port.offer(w, t, (w, t)) == ref.offer(w, t, (w, t))
        drained["port"] += list(port.drain())
        drained["jax"] += list(ref.drain())
        assert port.head() == ref.head() and port.admitted == ref.admitted
    assert drained["port"] == drained["jax"] and len(drained["port"]) > 5
    assert port.peak_held == ref.peak_held
    assert [port.next_tag(w) for w in range(5)] == [ref.next_tag(w) for w in range(5)]


# -- the port's own units (tests/test_fedbuff.py:99-170) ---------------------

def test_buffer_folds_staleness_weighted_deltas_and_emits_every_k():
    buf = FedBuffBuffer(k=2, alpha=1.0)
    g = {"w": np.zeros(2, np.float32)}
    buf.fold({"w": np.ones(2, np.float32)}, 10.0, trained_version=0)
    assert not buf.ready
    buf.fold({"w": 3.0 * np.ones(2, np.float32)}, 10.0, trained_version=0)
    assert buf.ready
    g, rec = buf.emit(g)
    np.testing.assert_allclose(g["w"], 2.0)
    assert rec["version"] == 1 and rec["folds"] == 2 and buf.pending == 0
    r = buf.fold({"w": np.ones(2, np.float32)}, 10.0, trained_version=0)
    assert r["staleness"] == 1 and r["weight"] == pytest.approx(5.0)
    r2 = buf.fold({"w": np.zeros(2, np.float32)}, 10.0, trained_version=1)
    assert r2["staleness"] == 0 and r2["weight"] == 10.0
    g, rec = buf.emit(g)
    np.testing.assert_allclose(g["w"], 2.0 + 5.0 / 15.0)
    assert rec["staleness_max"] == 1 and buf.folds == 4 and buf.versions_emitted == 2
    assert buf.nbytes == 0     # the accumulator is new after an emission


def test_buffer_zero_weight_folds_count_toward_k_as_noops():
    buf = FedBuffBuffer(k=2, alpha=0.5)
    g = {"w": np.full(2, 7.0, np.float32)}
    buf.fold({"w": np.ones(2, np.float32)}, 0.0, trained_version=0)
    buf.fold({"w": np.ones(2, np.float32)}, 4.0, trained_version=0)
    assert buf.ready and buf.zero_weight_folds == 1
    assert buf.nbytes == 2 * 8     # one float64 sum, whatever the folds
    g, _ = buf.emit(g)
    np.testing.assert_allclose(g["w"], 8.0)


def test_frontier_canonical_order_eject_and_dedup():
    f = DeterministicFrontier(range(3))
    assert f.head() == (0, 0)
    assert f.offer(2, 0, "c") and f.offer(1, 0, "b")
    assert list(f.drain()) == []
    assert f.offer(0, 0, "a")
    assert [(w, t) for w, t, _ in f.drain()] == [(0, 0), (1, 0), (2, 0)]
    assert not f.offer(0, 0, "dup")
    assert f.offer(2, 1, "c1") and f.offer(0, 1, "a1")
    assert [(w, t) for w, t, _ in f.drain()] == [(0, 1)]
    f.eject(1)
    assert [(w, t) for w, t, _ in f.drain()] == [(2, 1)]
    f.admit(1, 2)
    assert f.head() == (2, 0) and not f.offer(1, 1, "stale")


def test_config_validation():
    for bad in (dict(buffer_k=0), dict(buffer_mode="sorted"), dict(buffer_staleness_alpha=-1.0),
                dict(chaos_crash_restart_s=1.0), dict(wire_retry_base_s=0.0)):
        with pytest.raises(ValueError):
            _cfg(**bad)
    with pytest.raises(ValueError, match="buffer_k <= workers"):
        _run(_cfg(buffer_k=5, buffer_mode="deterministic"), timeout=30.0)


# -- the port's FedBuff against JAX's ----------------------------------------

def _lr_full_batch():
    """``lr`` on ``synthetic_1_1`` in full-batch epochs: (data kwargs, run
    kwargs, workers)."""
    n_pad = _ds().train_x.shape[1]
    run = dict(model="lr", dataset="synthetic_1_1", client_num_in_total=6,
               client_num_per_round=WORKERS, comm_round=VERSIONS, batch_size=int(n_pad), lr=0.2,
               momentum=0.9, epochs=2, frequency_of_the_test=1, seed=5, device_data="off",
               buffer_k=WORKERS, buffer_mode="deterministic")
    return run, WORKERS


def _setup(model):
    """(port dataset, JAX dataset, run kwargs, workers, port bundle, JAX
    bundle)."""
    if model == "lr":
        run, workers = _lr_full_batch()
        ds = _ds()
        jds = jax_load_dataset("synthetic_1_1", num_clients=6, batch_size=10, seed=5)
        np.testing.assert_array_equal(ds.train_x, np.asarray(jds.train_x))
        shape = ds.train_x.shape[2:]
        return (ds, jds, run, workers, create_model("lr", ds.class_num, input_shape=shape),
                jax_create_model("lr", ds.class_num, input_shape=shape))
    data, run, workers = equiv(model)
    run = {**run, "buffer_k": workers, "buffer_mode": "deterministic"}
    return (make_synthetic_classification(**data), jax_synthetic(**data), run, workers,
            port_bundle(model), jax_bundle(model))


@pytest.fixture(scope="module", params=["lr", "resnet"])
def jax_fedbuff(request):
    """JAX's FedBuff through JAX's seams (``build_fedbuff_rank``, its
    ``run_ranks``) from JAX's initial weights; the workers share one jitted
    local step. Returns (model, JAX init, aggregator)."""
    model = request.param
    _, jds, run, workers, _, jb = _setup(model)
    jcfg = JaxFedConfig(**run)
    root = seed_everything(jcfg.seed)
    init = jb.init(root)
    agg = jfb.FedBuffAggregator(init, workers, jcfg, dataset=jds, bundle=jb)
    shared = {}

    def make(rank, comm):
        m = jfb.build_fedbuff_rank(jds, jcfg, rank, workers + 1, comm, bundle=jb, root_key=root,
                                   aggregator=agg)
        if rank:
            m.trainer.local_train = shared.setdefault("fn", m.trainer.local_train)
        return m

    jax_run_ranks(make, workers + 1, wire_roundtrip=True)
    return model, init, agg


def test_port_fedbuff_matches_the_jax_fedbuff(jax_fedbuff):
    model, jinit, want = jax_fedbuff
    ds, _, run, workers, bundle, _ = _setup(model)
    cfg = FedConfig(**run)
    init = flax_to_torch(jax.tree.map(np.asarray, jinit),
                         bn_name=None if model == "lr" else "PallasBatchNorm")
    agg = fb.FedBuffAggregator(init, workers, cfg, dataset=ds, bundle=bundle, device="cpu")
    run_ranks(lambda r, comm: fb.build_fedbuff_rank(ds, cfg, r, workers + 1, comm, bundle=bundle,
                                                    aggregator=agg, device="cpu"),
              workers + 1, wire_roundtrip=True)
    assert_tree_close(to_flax(model, agg.variables), jax.tree.map(np.asarray, want.variables),
                      **TOL)
    assert_history_close(agg.test_history, [h["acc"] for h in want.test_history],
                         [h["loss"] for h in want.test_history],
                         [h["round"] for h in want.test_history])
    assert agg.uploads_folded == want.uploads_folded == run["comm_round"] * workers
    assert list(agg.buffer.fold_log) == list(want.buffer.fold_log)


# -- the sync pin and replay ---------------------------------------------------

@pytest.fixture(scope="module")
def sync_run():
    """The port's FedAvg edge: the sync pin's reference."""
    return edge.run_fedavg_edge(_ds(), _cfg(), worker_num=WORKERS, device="cpu")


@pytest.fixture(scope="module")
def det_run():
    """FedBuff, deterministic, buffer_k = workers, no faults."""
    return _run(_cfg(buffer_k=WORKERS, buffer_mode="deterministic"))


def test_sync_equivalence_pin(sync_run, det_run):
    """buffer_k = workers, deterministic, no faults: every sweep is a
    synchronous round, staleness is 0, and the emitted model is FedAvg's."""
    fbr = det_run
    assert [h["round"] for h in fbr.test_history] == list(range(VERSIONS))
    for a, b in zip(sync_run.test_history, fbr.test_history):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-5)
    for k in sync_run.variables:
        np.testing.assert_allclose(fbr.variables[k], sync_run.variables[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert all(r["staleness"] == 0 for r in fbr.buffer.fold_log)
    assert fbr.uploads_folded == WORKERS * VERSIONS


def test_deterministic_replay_bit_identical_under_chaos_local(det_run):
    """Same (seed, chaos_seed): the same weights byte for byte under 20% / 10%
    drop / dup and injected delay, and those of the run without faults."""
    a, b = (_run(_cfg(buffer_k=WORKERS, buffer_mode="deterministic", **CHAOS))
            for _ in range(2))
    _assert_bit_identical(a, b)
    _assert_bit_identical(a, det_run)
    assert a.uploads_folded == WORKERS * VERSIONS
    assert a.wire_stats["chaos/dropped"] > 0 and a.wire_stats["wire/retransmits"] > 0


def test_deterministic_replay_bit_identical_under_crash_chaos(monkeypatch):
    """A crash-stopped worker is ejected by the gave-up path without
    stalling emission, the schedule replays bit for bit, and no rank's
    retransmit thread outlives the run, the crashed rank's included."""
    layers = []
    init = ReliableCommManager.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        layers.append(self)

    monkeypatch.setattr(ReliableCommManager, "__init__", keep)
    kw = dict(buffer_k=2, buffer_mode="deterministic", comm_round=4, wire_reliable=True,
              chaos_crash_rank=2, chaos_crash_after=2, chaos_seed=1, straggler_deadline_sec=1.0,
              **FAST_WIRE)
    a, b = (_run(_cfg(**kw)) for _ in range(2))
    _assert_bit_identical(a, b)
    assert a.versions_emitted == 4 and a.uploads_folded == b.uploads_folded
    assert a.wire_stats["chaos/crash_stops"] == 1 and a.wire_stats["wire/gave_up"] > 0
    assert len(layers) == 2 * (WORKERS + 1)
    assert all(layer.join(timeout=10.0) for layer in layers)


def test_deterministic_replay_bit_identical_grpc():
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

    cfg = _cfg(buffer_k=WORKERS, buffer_mode="deterministic", comm_round=2, **CHAOS)
    runs = []
    for _ in range(2):
        for attempt in range(3):
            base = free_base(WORKERS + 1)
            try:
                runs.append(_run(cfg, comm_factory=lambda r, p=base: GRPCCommManager(
                    r, WORKERS + 1, base_port=p, host="127.0.0.1")))
                break
            except OSError:
                if attempt == 2:
                    raise
    _assert_bit_identical(*runs)
    assert runs[0].uploads_folded == WORKERS * 2


# -- arrival mode and crash-restart ------------------------------------------

def test_arrival_mode_exact_once_under_dup_heavy_chaos():
    agg = _run(_cfg(buffer_k=2, buffer_mode="arrival", comm_round=4, wire_reliable=True,
                    chaos_drop=0.1, chaos_dup=0.3, chaos_seed=11, **FAST_WIRE))
    assert agg.versions_emitted == 4 and agg.uploads_folded == 2 * 4
    assert agg.wire_stats["wire/dup_dropped"] > 0
    assert all(np.isfinite(h["loss"]) for h in agg.test_history)


def test_crash_restart_worker_revives_and_contributes_with_staleness():
    """The worker crash-stops after its 3rd protocol message, revives 0.6 s
    later, and its uploads fold, with nonzero staleness for the versions the
    outage cost it."""
    agg = _run(_cfg(buffer_k=2, buffer_mode="arrival", comm_round=8, wire_reliable=True,
                    chaos_crash_rank=2, chaos_crash_after=3, chaos_crash_restart_s=0.6,
                    chaos_seed=1, chaos_delay_ms=60, straggler_deadline_sec=1.0, **FAST_WIRE))
    assert agg.wire_stats["chaos/crash_stops"] == 1
    assert agg.wire_stats["chaos/crash_restarts"] == 1
    assert agg.versions_emitted == 8 and agg.uploads_folded == 2 * 8
    assert max(r["staleness"] for r in agg.buffer.fold_log) >= 1


# -- handler-level cases -----------------------------------------------------

class _Comm:
    def __init__(self):
        self.sent = []

    def add_observer(self, o):
        pass

    def send_message(self, m):
        self.sent.append(m)

    def inject_local(self, m):
        pass

    def supports_local_injection(self):
        return True

    def stop_receive_message(self):
        pass


def _server(mode, comm):
    ds = _ds()
    cfg = _cfg(buffer_k=2, buffer_mode=mode, comm_round=50, frequency_of_the_test=10_000)
    bundle = create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:])
    agg = fb.FedBuffAggregator(bundle.init(cfg.seed, "cpu"), 3, cfg, dataset=ds, bundle=bundle,
                               device="cpu")
    server = fb.FedBuffEdgeServerManager(edge._edge_args(cfg, ds), comm, 0, 4, agg)
    for w in range(3):
        server._send_assignment(w, 0)
    return server, agg


def _upload(agg, worker, tag, version, scale=0.0):
    m = Message(fb.MSG_TYPE_C2S_SEND_MODEL, worker + 1, 0)
    m.add_params(edge.MSG_ARG_KEY_MODEL_DELTA,
                 {k: np.full_like(v, scale) for k, v in agg.variables.items()})
    m.add_params(MSG_ARG_KEY_NUM_SAMPLES, 10.0)
    m.add_params(fb.MSG_ARG_KEY_TRAIN_TAG, tag)
    m.add_params(fb.MSG_ARG_KEY_VERSION, version)
    return m


def test_join_readmission_after_ejection():
    """An ejected worker's JOIN re-admits it at the current sweep with a
    fresh assignment; its stale pre-ejection upload meets the exactly-once
    guard, and its fresh one folds with the staleness its lag earned."""
    comm = _Comm()
    server, agg = _server("deterministic", comm)
    server.handle_upload(_upload(agg, 0, 0, 0))
    server.handle_upload(_upload(agg, 1, 0, 0))
    assert agg.versions_emitted == 1 and agg.uploads_folded == 2
    server.handle_upload(_upload(agg, 2, 0, 0))
    assert agg.uploads_folded == 3
    ev = Message(fb.MSG_TYPE_LOCAL_PEER_GAVE_UP, 0, 0)
    ev.add_params(fb.MSG_ARG_KEY_PEER, 3)
    server.handle_peer_gave_up(ev)
    assert not server._alive[2] and server.frontier.admitted == {0, 1}
    server.handle_upload(_upload(agg, 0, 1, 1))
    assert agg.versions_emitted == 2
    n_sent = len(comm.sent)
    server.handle_join(Message(fb.MSG_TYPE_C2S_JOIN, 3, 0))
    assert server._alive[2] and agg.rejoins == 1 and server.frontier.next_tag(2) == 2
    assert len(comm.sent) == n_sent + 1 and comm.sent[-1].get_receiver_id() == 3
    assert int(comm.sent[-1].get(fb.MSG_ARG_KEY_TRAIN_TAG)) == 2
    server.handle_upload(_upload(agg, 2, 0, 0))
    assert agg.duplicate_uploads == 1 and agg.uploads_folded == 4
    server.handle_upload(_upload(agg, 1, 1, 1))
    server.handle_upload(_upload(agg, 2, 2, 1))
    server.handle_upload(_upload(agg, 0, 2, 2))
    server.handle_upload(_upload(agg, 1, 2, 2))
    assert agg.uploads_folded == 8 and agg.versions_emitted == 4
    assert agg.buffer.fold_log[-1]["staleness"] == 2
    server._cancel_probe()


def test_join_from_alive_worker_resends_assignment_in_arrival_mode():
    """Arrival mode answers an alive worker's JOIN (its starvation signal)
    with its pending assignment again; deterministic mode does not answer
    at a time set by arrival."""
    comm = _Comm()
    arrival, agg = _server("arrival", comm)
    n0 = len(comm.sent)
    arrival.handle_join(Message(fb.MSG_TYPE_C2S_JOIN, 2, 0))
    assert len(comm.sent) == n0 + 1 and comm.sent[-1].get_receiver_id() == 2
    assert int(comm.sent[-1].get(fb.MSG_ARG_KEY_TRAIN_TAG)) == 0 and agg.rejoins == 0
    det, _ = _server("deterministic", comm)
    n0 = len(comm.sent)
    det.handle_join(Message(fb.MSG_TYPE_C2S_JOIN, 2, 0))
    assert len(comm.sent) == n0
    det._cancel_probe()


def test_probe_resend_repeats_the_original_assignment_content():
    """A stall probe's resend carries the original assignment's version and
    weights, not the model emitted since."""
    comm = _Comm()
    server, agg = _server("deterministic", comm)
    g0 = {k: v.copy() for k, v in agg.variables.items()}
    server.handle_upload(_upload(agg, 0, 0, 0, 0.5))
    server.handle_upload(_upload(agg, 1, 0, 0, 0.5))
    assert agg.versions_emitted == 1
    assert any(not np.array_equal(agg.variables[k], g0[k]) for k in g0)
    probe = Message(fb.MSG_TYPE_LOCAL_STALL_PROBE, 0, 0)
    probe.add_params(fb.MSG_ARG_KEY_PEER, 3)
    probe.add_params(fb.MSG_ARG_KEY_TRAIN_TAG, 0)
    server.handle_stall_probe(probe)
    resent = comm.sent[-1]
    assert resent.get_receiver_id() == 3 and int(resent.get(fb.MSG_ARG_KEY_TRAIN_TAG)) == 0
    assert int(resent.get(fb.MSG_ARG_KEY_VERSION)) == 0
    for k, v in resent.get(MSG_ARG_KEY_MODEL_PARAMS).items():
        np.testing.assert_array_equal(v, g0[k], err_msg=k)
    server._cancel_probe()


# -- BN running variances under stale deltas (ROADMAP §3) ----------------------

def _bn_setup(**kw):
    ds = make_synthetic_classification("fb-bn", (8, 8, 3), 10, 8, records_per_client=40,
                                       partition_method="hetero", partition_alpha=0.5,
                                       batch_size=8, seed=0)
    cfg = FedConfig(**{**dict(model="resnet", dataset="fb-bn", client_num_in_total=8,
                              client_num_per_round=8, comm_round=12, batch_size=8, lr=0.1,
                              momentum=0.9, epochs=1, frequency_of_the_test=4, seed=0), **kw})
    return ds, cfg, ModelBundle("fb-bn", CifarResNet(1, 10, widths=(8, 16, 16)), (8, 8, 3))


def test_stale_variance_delta_takes_the_uploads_mean_variance():
    """A stale delta that carries a BN running variance below 0 (0.5 + -0.8)
    takes the weighted mean of the uploads' own variances there (1.0 -
    0.8), and the version evaluates finite; every other leaf is the
    buffer's emission."""
    ds, cfg, bundle = _bn_setup(buffer_k=1, buffer_mode="arrival", comm_round=50,
                                frequency_of_the_test=1)
    agg = fb.FedBuffAggregator(bundle.init(0, "cpu"), 2, cfg, dataset=ds, bundle=bundle,
                               device="cpu")
    server = fb.FedBuffEdgeServerManager(edge._edge_args(cfg, ds), _Comm(), 0, 3, agg)
    for w in range(2):
        server._send_assignment(w, 0)
    var = agg.variance_leaves
    assert var and all(np.all(agg.variables[k] == 1.0) for k in var)

    def upload(worker, dvar):
        m = _upload(agg, worker, 0, 0)
        for k in var:
            m.get(edge.MSG_ARG_KEY_MODEL_DELTA)[k][:] = dvar
        return m

    server.handle_upload(upload(0, -0.5))      # fresh: 1.0 - 0.5
    assert all(np.all(agg.variables[k] == 0.5) for k in var)
    server.handle_upload(upload(1, -0.8))      # stale by one version
    assert agg.buffer.fold_log[-1]["staleness"] == 1
    for k in var:
        np.testing.assert_array_equal(agg.variables[k], np.float32(1.0) + np.float32(-0.8))
    assert agg.variances_from_values == sum(agg.variables[k].size for k in var)
    assert all(np.isfinite(h["loss"]) for h in agg.test_history)
    server._cancel_probe()


def test_stale_folds_keep_bn_running_variances_valid():
    """Deterministic FedBuff at buffer_k 1 over 4 workers (staleness up to
    3) on a BN ResNet at lr 0.1: the delta rule alone evaluates NaN at
    version 4 (negative running variances from version 3 on); every
    version now evaluates finite, and no running variance is below 0."""
    ds, cfg, bundle = _bn_setup(buffer_k=1, buffer_mode="deterministic")
    agg = fb.run_fedbuff_edge(ds, cfg, worker_num=4, bundle=bundle, device="cpu")
    assert agg.versions_emitted == 12 and max(r["staleness"] for r in agg.buffer.fold_log) >= 2
    assert all(np.isfinite(h["loss"]) for h in agg.test_history)
    assert agg.variances_from_values > 0
    assert all(agg.variables[k].min() >= 0 for k in agg.variance_leaves)


# -- the device contract -------------------------------------------------------

def test_workers_share_the_bundle_program_and_follow_its_tensors():
    """FedBuff's workers train through the bundle's shared local-train
    program (``fedavg_edge.edge_local_train``); once the module's tensors
    move (``ModelBundle.init`` on a card), a new program takes its place,
    and a second run on the bundle equals a run on a fresh one."""
    ds, cfg = _ds(), _cfg(buffer_k=WORKERS, buffer_mode="deterministic", comm_round=2)
    bundle = create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:])
    programs = []

    def make(r, comm):
        m = fb.build_fedbuff_rank(ds, cfg, r, WORKERS + 1, comm, bundle=bundle, device="cpu")
        if r:
            programs.append(m.trainer.local_train)
        return m

    run_ranks(make, WORKERS + 1, wire_roundtrip=True)
    assert len({id(p) for p in programs}) == 1
    assert programs[0] is edge.edge_local_train(bundle, ds, cfg)
    with torch.no_grad():
        for p in bundle.module.parameters():
            p.data = p.data.clone()                  # what a round trip through .to() does
    again = fb.run_fedbuff_edge(ds, cfg, worker_num=WORKERS, bundle=bundle, device="cpu")
    assert edge.edge_local_train(bundle, ds, cfg) is not programs[0]
    fresh = fb.run_fedbuff_edge(ds, cfg, worker_num=WORKERS, device="cpu")
    _assert_bit_identical(again, fresh)


def test_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fb.run_fedbuff_edge(_ds(), _cfg(), worker_num=WORKERS)


def test_server_loop_exit_cancels_the_probe():
    """Every exit of the server's loop drops the stall probe's timer."""
    comm = _Comm()
    comm.handle_receive_message = lambda: None
    server, _ = _server("deterministic", comm)
    server._arm_probe()
    timer = server._probe_timer
    assert timer is not None and timer.is_alive()
    server.run()
    assert server._probe_timer is None
    timer.join(timeout=5.0)
    assert not timer.is_alive() and server._finished
