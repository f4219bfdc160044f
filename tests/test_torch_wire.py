"""The port's wire middleware (``comm/chaos.py``, ``comm/reliable.py``)
against the JAX package's, and the port's own counterparts of the
FedAvg-edge cases of tests/test_chaos.py.

Against JAX: chaos fates over a grid of (seed, message identity, attempt),
exactly (both draw from ``np.random.default_rng([seed, blake2s(repr(ident)),
attempt])``): the copies the inner transport receives, in order, with their
delays, and the crash point; ``retry_schedule`` and ``retry_budget_s``;
``build_wire_stack``'s layers and their settings; and ``wire_stats``'s keys.

The port's own: the reliable layer over seeded chaos recovers drops, eats
duplicates, survives all four faults together, does not take a restarted
sender's new stream for duplicates, handles ``WIRE_BUSY``, collects idle
dedup windows, and stops its retransmit thread on a crash-stopped rank;
the FedAvg edge under the reliable layer alone and under chaos (local,
MQTT, gRPC with ``importorskip``) equals its run without, bit for bit; a
chaos crash-stop is absorbed by the straggler deadline; the per-process
rank entry and the base framework stack the layers too.
"""

import threading
import time

import numpy as np
import pytest
import torch

from fedml_tpu.comm import chaos as jchaos
from fedml_tpu.comm import reliable as jreliable
from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.utils.metrics import wire_stats as jax_wire_stats
from fedml_tpu_torch.comm import Message
from fedml_tpu_torch.comm.chaos import ChaosCommManager, chaos_enabled, find_chaos
from fedml_tpu_torch.comm.local import LocalCommunicationManager, LocalRouter
from fedml_tpu_torch.comm.message import (KEY_ACK_SEQ, MSG_ARG_KEY_WIRE_SEQ, MSG_TYPE_WIRE_ACK,
                                          MSG_TYPE_WIRE_BUSY)
from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager
from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
from fedml_tpu_torch.comm.reliable import (KEY_BUSY_MID, KEY_BUSY_RETRY_S, KEY_BUSY_TERMINAL,
                                           ReliableCommManager, build_wire_stack,
                                           retry_budget_s, retry_schedule, wire_wrap_factory)
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.distributed import fedavg_edge as edge
from fedml_tpu_torch.distributed.base_framework import run_base_framework
from fedml_tpu_torch.utils.metrics import wire_stats
from torch_edge_refs import free_base, same

WORKERS = 3
ROUNDS = 2
#: the fast retry schedule of tests/test_fedbuff.py:42-45: a stack's drain
#: at teardown waits ~1.9 s for a lost tail, not ~7.1 s
FAST_WIRE = dict(wire_retry_base_s=0.02, wire_retry_max=6)
#: the acceptance rates of tests/test_chaos.py:42-43, on the fast schedule
CHAOS = dict(wire_reliable=True, chaos_drop=0.2, chaos_dup=0.1, chaos_reorder=0.1, chaos_seed=7,
             **FAST_WIRE)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread (the suite's parallel workers share the cores);
    the count is restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Null:
    """A transport that records what it is given to send."""

    codec = "raw"

    def __init__(self, rank=0):
        self.rank = rank
        self.sent = []
        self.stopped = False

    def add_observer(self, o):
        pass

    def send_message(self, m):
        self.sent.append(m)

    def stop_receive_message(self):
        self.stopped = True


# -- against JAX ----------------------------------------------------------------

def _grid_messages(msg_cls):
    """Stamped messages of several pairs, unstamped ones of str and int
    types and acks, several of each sent again (later attempts)."""
    out = []
    for i in range(40):
        kind = i % 4
        if kind == 0:
            m = msg_cls("data", i % 3, (i + 1) % 3)
            m.add_params(MSG_ARG_KEY_WIRE_SEQ, i // 4)
        elif kind == 1:
            m = msg_cls(MSG_TYPE_WIRE_ACK, 1, 0)
            m.add_params(KEY_ACK_SEQ, i // 4)
        elif kind == 2:
            m = msg_cls(3 if i % 8 == 2 else "sync", 0, 2)
        else:
            m = msg_cls("data", 2, 0)
            m.add_params(MSG_ARG_KEY_WIRE_SEQ, 7)     # one message, retransmitted
        m.add_params("i", i)
        out.append(m)
    return out + out[:10]


def _fates(cls, msg_cls, seed, crash_after):
    inner = _Null()
    chaos = cls(inner, drop=0.3, dup=0.25, delay_ms=50.0, reorder=0.2, seed=seed, rank=1,
                crash_after_sends=crash_after)
    out = []
    chaos._send_later = lambda m, d: out.append((int(m.get("i")), d))
    for m in _grid_messages(msg_cls):
        chaos.send_message(m)
    chaos._held = None
    return out, dict(chaos.stats), inner.stopped


@pytest.mark.parametrize("seed", [0, 7, 1234567])
@pytest.mark.parametrize("crash_after", [None, 9])
def test_chaos_fates_equal_jax(seed, crash_after):
    port = _fates(ChaosCommManager, Message, seed, crash_after)
    ref = _fates(jchaos.ChaosCommManager, JaxMessage, seed, crash_after)
    assert port[0] == ref[0]
    assert port[2] == ref[2] == (crash_after is not None)
    assert port[1] == {k: ref[1][k] for k in port[1]}
    assert 0 < len(port[0]) and port[1]["dropped"] > 0 and port[1]["duplicated"] > 0


@pytest.mark.parametrize("wire", [{}, dict(wire_retry_base_s=0.02, wire_retry_max=6),
                                  dict(wire_retry_base_s=0.3, wire_retry_max=3),
                                  dict(wire_retry_base_s=0.01, wire_retry_max=14)])
def test_retry_schedule_and_budget_equal_jax(wire):
    assert retry_schedule(FedConfig(**wire)) == jreliable.retry_schedule(JaxFedConfig(**wire))
    assert retry_budget_s(FedConfig(**wire)) == jreliable.retry_budget_s(JaxFedConfig(**wire))


def _layers(stack):
    out = []
    while stack is not None and hasattr(stack, "inner"):
        if type(stack).__name__ == "ChaosCommManager":
            out.append(("chaos", stack.drop, stack.dup, stack.delay_ms, stack.reorder, stack.seed,
                        stack.rank, stack.crash_after_sends, stack.restart_after_s))
        else:
            out.append(("reliable", stack.rank, stack.retry_base_s, stack.retry_cap_s,
                        stack.retry_max, stack.drain_timeout_s, stack.dedup_window,
                        stack.idle_gc_s))
        stack = stack.inner
    return out


@pytest.mark.parametrize("wire", [
    dict(wire_reliable=True),
    dict(chaos_delay_ms=120.0, chaos_seed=3),
    dict(CHAOS, chaos_delay_ms=20.0),
    dict(wire_reliable=True, chaos_crash_rank=2, chaos_crash_after=3, chaos_crash_restart_s=0.6,
         chaos_seed=1)], ids=["reliable", "delay", "lossy", "crash_restart"])
def test_wire_stack_and_counters_equal_jax(wire):
    """The same layers in the same order with the same settings, on every
    rank, and ``wire_stats`` reports the JAX package's keys."""
    cfg, jcfg = FedConfig(**wire), JaxFedConfig(**wire)
    assert chaos_enabled(cfg) == jchaos.chaos_enabled(jcfg)
    for rank in range(4):
        port = build_wire_stack(_Null(rank), cfg, rank)
        ref = jreliable.build_wire_stack(_Null(rank), jcfg, rank)
        try:
            assert _layers(port) == _layers(ref)
            assert set(wire_stats(port)) == set(jax_wire_stats(ref))
        finally:
            port.stop_receive_message()
            ref.stop_receive_message()
    assert wire_wrap_factory(FedConfig()) is None


# -- the chaos layer --------------------------------------------------------------

def test_chaos_fates_are_seed_deterministic():
    def run(seed):
        inner = _Null()
        chaos = ChaosCommManager(inner, drop=0.4, seed=seed, rank=1)
        for i in range(60):
            m = Message("d", 1, 0)
            m.add_params("i", i)
            m.add_params(MSG_ARG_KEY_WIRE_SEQ, i)
            chaos.send_message(m)
        return [int(m.get("i")) for m in inner.sent]

    a, b, c = run(11), run(11), run(12)
    assert a == b and a != c and 0 < len(a) < 60


def test_chaos_crash_restart_fate_unit():
    """The outage swallows both ways; the revival restores them and calls
    ``on_restart``; the crash fires once."""
    inner = _Null()
    chaos = ChaosCommManager(inner, seed=3, rank=1, crash_after_sends=2, restart_after_s=0.2)
    revived = threading.Event()
    chaos.on_restart = revived.set
    got = []

    class Sink:
        def receive_message(self, t, m):
            got.append(m)

    chaos.add_observer(Sink())
    for i in range(4):
        m = Message("d", 1, 0)
        m.add_params("i", i)
        chaos.send_message(m)
    assert [int(m.get("i")) for m in inner.sent] == [0, 1] and not inner.stopped
    chaos.receive_message("d", Message("d", 0, 1))
    assert got == []
    assert chaos.stats["crash_stops"] == 1 and chaos.stats["crashed_dropped"] == 2
    assert revived.wait(5.0)
    m = Message("d", 1, 0)
    m.add_params("i", 9)
    chaos.send_message(m)
    chaos.receive_message("d", Message("d", 0, 1))
    assert [int(m.get("i")) for m in inner.sent] == [0, 1, 9] and len(got) == 1
    assert chaos.stats["crash_restarts"] == 1 and chaos.stats["crash_stops"] == 1
    assert find_chaos(chaos) is chaos and find_chaos(inner) is None


# -- the reliable layer -----------------------------------------------------------

def _reliable_pair(**chaos):
    router = LocalRouter(2)
    comms = []
    for r in range(2):
        c = ChaosCommManager(LocalCommunicationManager(router, r, wire_roundtrip=True), rank=r,
                             **chaos)
        comms.append(ReliableCommManager(c, rank=r, retry_base_s=0.01, retry_cap_s=0.1,
                                         retry_max=14))
    return comms


def _drive_pair(comms, n, timeout=30.0):
    """Send payloads 0..n-1 from rank 0 to rank 1 with both loops running;
    returns what rank 1's handler saw, in order."""
    got = []
    done = threading.Event()

    class Sink:
        def receive_message(self, t, m):
            got.append(int(m.get("i")))
            if len(got) >= n:
                done.set()

    comms[1].add_observer(Sink())
    threads = [threading.Thread(target=c.handle_receive_message, daemon=True) for c in comms]
    for t in threads:
        t.start()
    for i in range(n):
        m = Message("data", 0, 1)
        m.add_params("i", i)
        comms[0].send_message(m)
    assert done.wait(timeout)
    time.sleep(0.3)      # let straggling copies be counted
    for c in comms:
        c.stop_receive_message()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    assert all(c.join(timeout=10.0) for c in comms)
    return got


@pytest.mark.parametrize("faults", [dict(drop=0.3, seed=3), dict(dup=0.5, seed=4),
                                    dict(drop=0.2, dup=0.2, reorder=0.2, delay_ms=20, seed=5)],
                         ids=["drops", "dups", "all_four"])
def test_reliable_delivers_each_message_exactly_once(faults):
    comms = _reliable_pair(**faults)
    got = _drive_pair(comms, 40)
    assert sorted(got) == list(range(40)) and len(got) == 40
    if set(faults) == {"drop", "seed"}:
        # with reorder on, an ack held back by the reorder at the end is
        # retransmitted for after the receiver stopped acking (tests/test_chaos.py
        # pins gave_up on the drops alone too)
        assert comms[0].stats["retransmits"] > 0 and comms[0].stats["gave_up"] == 0
    if "dup" in faults:
        assert comms[1].stats["dup_dropped"] > 0


def test_restarted_sender_incarnation_not_deduped():
    router = LocalRouter(2)
    recv = ReliableCommManager(LocalCommunicationManager(router, 1, wire_roundtrip=True), rank=1)
    got = []

    class Sink:
        def receive_message(self, t, m):
            got.append(int(m.get("i")))

    recv.add_observer(Sink())
    t = threading.Thread(target=recv.handle_receive_message, daemon=True)
    t.start()
    for incarnation in range(2):    # a rank, then its restart: both stamp seq 0
        sender = ReliableCommManager(LocalCommunicationManager(router, 0, wire_roundtrip=True),
                                     rank=0)
        m = Message("data", 0, 1)
        m.add_params("i", incarnation)
        sender.send_message(m)
        sender.stop_receive_message()
    deadline = time.monotonic() + 10
    while len(got) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    recv.stop_receive_message()
    t.join(timeout=10.0)
    assert got == [0, 1] and recv.stats["dup_dropped"] == 0


def test_busy_rearms_the_retry_clock_then_terminal_evicts():
    inner = _Null()
    rel = ReliableCommManager(inner, rank=1, retry_base_s=5.0, retry_cap_s=5.0, retry_max=2)
    try:
        m = Message("data", 1, 0)
        rel.send_message(m)
        mid = m.get("__wire_mid__")
        busy = Message(MSG_TYPE_WIRE_BUSY, 0, 1)
        busy.add_params(KEY_BUSY_MID, mid)
        busy.add_params(KEY_BUSY_RETRY_S, 0.05)
        rel.receive_message(MSG_TYPE_WIRE_BUSY, busy)
        assert rel.stats["busy_backoff"] == 1
        deadline = time.monotonic() + 5
        while rel.stats["retransmits"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert rel.stats["retransmits"] == 1 and rel.stats["gave_up"] == 0
        evict = Message(MSG_TYPE_WIRE_BUSY, 0, 1)
        evict.add_params(KEY_BUSY_TERMINAL, True)
        rel.receive_message(MSG_TYPE_WIRE_BUSY, evict)
        assert rel.stats["evicted"] == 1 and not rel._outstanding
        assert rel.join(timeout=5.0) and inner.stopped
    finally:
        rel.stop_receive_message()


def test_idle_dedup_windows_are_collected():
    rel = ReliableCommManager(_Null(), rank=1, idle_gc_s=0.05)
    try:
        rel._is_dup_and_mark((0, "a"), 0)
        assert (0, "a") in rel._seen
        deadline = time.monotonic() + 5
        while (0, "a") in rel._seen and time.monotonic() < deadline:
            time.sleep(0.02)
        assert (0, "a") not in rel._seen and not rel._is_dup_and_mark((0, "a"), 0)
    finally:
        rel.stop_receive_message()


def test_retransmit_thread_stops_on_a_crash_stopped_rank():
    """A chaos crash-stop ends the transport's loop without the protocol's
    finish(); a stop of the stack (the launchers' teardown) still ends the
    reliable layer's thread after its drain."""
    router = LocalRouter(2)
    rel = ReliableCommManager(ChaosCommManager(LocalCommunicationManager(router, 1), rank=1,
                                               crash_after_sends=1),
                              rank=1, retry_base_s=0.01, retry_cap_s=0.02, retry_max=2)
    loop = threading.Thread(target=rel.handle_receive_message, daemon=True)
    loop.start()
    rel.send_message(Message("data", 1, 0))      # the crash fires on it
    loop.join(timeout=10.0)
    assert not loop.is_alive() and rel._retx.is_alive()
    edge.release_wire([rel])
    assert rel.join(timeout=10.0) and rel.stats["gave_up"] == 1


# -- the FedAvg edge under the wire (tests/test_chaos.py) --------------------------

def _cfg(**kw):
    base = dict(model="lr", dataset="synthetic_1_1", client_num_in_total=6,
                client_num_per_round=6, comm_round=ROUNDS, batch_size=10, lr=0.1, epochs=1,
                frequency_of_the_test=1, seed=5, device_data="off")
    return FedConfig(**{**base, **kw})


def _ds():
    return load_dataset("synthetic_1_1", num_clients=6, batch_size=10, seed=5)


@pytest.fixture(scope="module")
def strict_run():
    return edge.run_fedavg_edge(_ds(), _cfg(), worker_num=WORKERS, device="cpu")


def test_reliable_zero_faults_bit_identical(strict_run):
    rel = edge.run_fedavg_edge(_ds(), _cfg(wire_reliable=True), worker_num=WORKERS, device="cpu")
    same(rel, strict_run)
    assert rel.wire_stats["wire/gave_up"] == 0 and rel.wire_stats["wire/acks_sent"] > 0
    assert "chaos/dropped" not in rel.wire_stats


def test_chaos_local_completes_exact_once(strict_run):
    agg = edge.run_fedavg_edge(_ds(), _cfg(**CHAOS), worker_num=WORKERS, device="cpu")
    assert agg.uploads_accepted == ROUNDS * WORKERS
    assert agg.wire_stats["wire/retransmits"] > 0 and agg.wire_stats["chaos/dropped"] > 0
    assert agg.wire_stats["wire/dup_dropped"] > 0
    same(agg, strict_run)


def test_chaos_mqtt_completes_exact_once(strict_run):
    with MqttBroker(0) as broker:
        agg = edge.run_fedavg_edge(_ds(), _cfg(**CHAOS), worker_num=WORKERS, device="cpu",
                                   comm_factory=lambda r: MqttCommManager(
                                       "127.0.0.1", broker.port, r, WORKERS))
    assert agg.uploads_accepted == ROUNDS * WORKERS
    same(agg, strict_run)


def test_chaos_grpc_completes_exact_once(strict_run):
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

    for attempt in range(3):
        base = free_base(WORKERS + 1)
        try:
            agg = edge.run_fedavg_edge(
                _ds(), _cfg(**CHAOS), worker_num=WORKERS, device="cpu",
                comm_factory=lambda r: GRPCCommManager(r, WORKERS + 1, base_port=base,
                                                       host="127.0.0.1"))
            break
        except OSError:
            if attempt == 2:
                raise
    assert agg.uploads_accepted == ROUNDS * WORKERS and agg.wire_stats["wire/retransmits"] > 0
    same(agg, strict_run)


def test_chaos_crash_stop_absorbed_by_deadline():
    """A chaos crash-stop silences a worker mid-federation (its loop ends,
    as a killed process's); the deadline marks it dead, the survivors take
    its clients, and every round closes."""
    agg = edge.run_fedavg_edge(_ds(), _cfg(straggler_deadline_sec=2.0, comm_round=4,
                                           chaos_crash_rank=2, chaos_crash_after=3, chaos_seed=1),
                               worker_num=WORKERS, device="cpu")
    assert [h["round"] for h in agg.test_history] == list(range(4))
    assert all(np.isfinite(h["loss"]) for h in agg.test_history)
    assert agg.wire_stats["chaos/crash_stops"] == 1


def test_rank_entry_stacks_the_wire(strict_run, monkeypatch):
    """``run_fedavg_edge_rank`` (one rank a process; here one a thread, its
    gRPC transport replaced by the in-process router) stacks the reliable
    and chaos layers as the in-process launcher does."""
    import fedml_tpu_torch.comm.grpc_backend as grpc_backend

    router = LocalRouter(WORKERS + 1)
    monkeypatch.setattr(grpc_backend, "GRPCCommManager",
                        lambda rank, size, codec="raw", **kw: LocalCommunicationManager(
                            router, rank, wire_roundtrip=True, codec=codec))
    out = {}

    def rank(r):
        cfg = _cfg(**CHAOS, backend="grpc", rank=r, world_size=WORKERS + 1)
        out[r] = edge.run_fedavg_edge_rank(_ds(), cfg, device="cpu")

    threads = [threading.Thread(target=rank, args=(r,), daemon=True)
               for r in range(WORKERS + 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads)
    assert [out[r] for r in range(1, WORKERS + 1)] == [None] * WORKERS
    same(out[0], strict_run)
    assert out[0].wire_stats["wire/acks_sent"] > 0 and out[0].wire_stats["chaos/sent"] > 0


def test_base_framework_chaos_roundtrip():
    bare = run_base_framework(client_num=3, comm_round=3)
    hist = run_base_framework(client_num=3, comm_round=3, config=FedConfig(**CHAOS))
    assert len(hist) == 3
    np.testing.assert_allclose(hist, bare, rtol=1e-6)


def test_chaos_requires_reliable_layer():
    with pytest.raises(ValueError):
        _cfg(chaos_drop=0.2)
    with pytest.raises(ValueError):
        _cfg(wire_reliable=True, chaos_drop=1.5)
    with pytest.raises(ValueError):
        _cfg(chaos_crash_rank=1)
