"""The port's FedGKT edge (``distributed/fedgkt_edge.py``) against the JAX
package's and against the port's own simulation, at CI depth (client 1
block, server 1 block a stage, 8 x 8 x 3 images, 4 clients, 2 rounds).

- The edge runs the simulation's own steps (``FedGKTAPI.train_client`` and
  ``server_phase``), so it equals ``FedGKTAPI.train`` run on the same
  (device) thread bit for bit: the history, the server net and its logits.
- From JAX's initial state and with JAX's orders (tests/test_torch_
  fedgkt.py's ``_load_from_jax`` and ``_hooks``), the port's edge against
  ``run_fedgkt_edge`` of the JAX package at tests/test_fedgkt.py:95-109's
  tolerances: Test/Acc within one boundary sample, Test/Loss and
  Train/ServerLoss rtol 5e-3 / atol 5e-4, the server logits 5e-2; under
  ``q8`` the port's edge against JAX's q8 edge at the same tolerances, and
  both within 0.11 of their raw runs' accuracy (tests/test_fedgkt.py:
  114-133).
- Under the wire's chaos (drop 0.2, dup 0.1, delay 20 ms, seed 7) the edge
  equals its run without, bit for bit; ``topk`` is refused.
- The straggler deadline (after tests/test_gkt_failures.py, each deadline
  injected the moment the live clients' uploads are in): a healthy
  fault-tolerant run equals the strict one; a client silent from round 1 or
  from round 0 is marked dead and the rounds complete; clients whose
  uploads come after the deadline rejoin; a deadline needs a transport with
  local injection; kill and resume (with and without ``checkpoint_dir``)
  equal the straight run.
- The clients share the API's one client program (and the server its one
  server program), which follows the nets' tensors; a second run on the
  pair equals a run on a fresh one.
"""

import threading

import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fedgkt import FedGKTAPI as JaxFedGKTAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.distributed.fedgkt_edge import run_fedgkt_edge as jax_run_fedgkt_edge
from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
from fedml_tpu_torch.comm import Message
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.distributed import fedgkt_edge as fe
from fedml_tpu_torch.distributed.base_framework import MSG_TYPE_LOCAL_ROUND_DEADLINE
from fedml_tpu_torch.distributed.fedavg_edge import device_call
from fedml_tpu_torch.models.gkt import create_gkt_pair
from test_torch_fedgkt import _hooks, _load_from_jax

C = 4
DATA = dict(name="gkt", input_shape=(8, 8, 3), classes=3, num_clients=C, records_per_client=8,
            partition_method="homo", batch_size=4, seed=3)
RUN = dict(model="lr", dataset="synthetic", client_num_in_total=C, client_num_per_round=C,
           comm_round=2, epochs=1, epochs_server=1, batch_size=4, lr=0.05, seed=5,
           frequency_of_the_test=1)
CI = dict(client_blocks=1, server_blocks_per_stage=1)
CHAOS = dict(wire_reliable=True, chaos_drop=0.2, chaos_dup=0.1, chaos_delay_ms=20.0,
             chaos_seed=7, wire_retry_base_s=0.01)


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ds():
    return make_synthetic_classification(**DATA)


def _run(cfg=None, **kw):
    return fe.run_fedgkt_edge(_ds(), cfg or FedConfig(**RUN), device="cpu", **CI, **kw)


def _fire(manager, tag: int) -> None:
    m = Message(MSG_TYPE_LOCAL_ROUND_DEADLINE, 0, 0)
    m.add_params(fe.KEY_ROUND, int(tag))
    manager.com_manager.inject_local(m)


def test_edge_equals_the_simulation():
    # on the edge's device thread too: the CPU's OpenMP team size is a
    # per-thread setting, and another team sums in another order
    sim = device_call(FedGKTAPI, _ds(), FedConfig(**RUN), device="cpu", **CI)
    device_call(sim.train)
    server = _run()
    want = [{k: h[k] for k in ("round", "Test/Acc", "Test/Loss", "Train/ServerLoss")}
            for h in sim.history]
    assert server.history == want
    assert torch.equal(server.api.server_logits, sim.server_logits)
    got = server.api.server_vars
    for k, v in sim.server_vars.items():
        assert torch.equal(got[k], v), k


def _jax_edge(codec: str):
    cfg = JaxFedConfig(**RUN, wire_codec=codec)
    return jax_run_fedgkt_edge(jax_synthetic(**DATA), cfg, **CI)


def _port_edge_from_jax(codec: str):
    jds = jax_synthetic(**DATA)
    japi = JaxFedGKTAPI(jds, JaxFedConfig(**RUN), **CI)
    clients, server = _hooks(japi)
    cfg = FedConfig(**RUN, wire_codec=codec)
    api = FedGKTAPI(_ds(), cfg, create_gkt_pair(3, (8, 8, 3), **CI), device="cpu",
                    order_hook=clients, server_order_hook=server)
    _load_from_jax(api, japi, None)
    return fe.run_fedgkt_edge(_ds(), cfg, api=api), japi


def test_edge_matches_the_jax_edge():
    want = _jax_edge("raw")
    got, japi = _port_edge_from_jax("raw")
    n_test = int(np.sum(japi._test_shards[2]))
    g, w = got.history[-1], want.history[-1]
    assert g["round"] == w["round"] == 1
    np.testing.assert_allclose(g["Test/Acc"], w["Test/Acc"], atol=1.0 / n_test + 1e-9)
    for key in ("Test/Loss", "Train/ServerLoss"):
        np.testing.assert_allclose(g[key], w[key], rtol=5e-3, atol=5e-4, err_msg=key)
    np.testing.assert_allclose(got.api.server_logits.numpy(), np.asarray(want.api.server_logits),
                               rtol=5e-2, atol=5e-2)
    # q8: the port's edge against JAX's q8 edge at the raw tolerances (the
    # codec is JAX's bit for bit), and JAX's own property: q8 within 0.11 of raw
    q8, _ = _port_edge_from_jax("q8")
    jq8 = _jax_edge("q8")
    g8, w8 = q8.history[-1], jq8.history[-1]
    assert g8["round"] == w8["round"] == 1
    np.testing.assert_allclose(g8["Test/Acc"], w8["Test/Acc"], atol=1.0 / n_test + 1e-9)
    for key in ("Test/Loss", "Train/ServerLoss"):
        np.testing.assert_allclose(g8[key], w8[key], rtol=5e-3, atol=5e-4, err_msg=key)
    np.testing.assert_allclose(q8.api.server_logits.numpy(), np.asarray(jq8.api.server_logits),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(g8["Test/Acc"], g["Test/Acc"], atol=0.11)
    np.testing.assert_allclose(w8["Test/Acc"], w["Test/Acc"], atol=0.11)


def test_edge_under_chaos_equals_its_run_without_and_topk_is_refused():
    bare = _run()
    chaos = _run(FedConfig(**RUN, **CHAOS))
    assert chaos.history == bare.history
    assert torch.equal(chaos.api.server_logits, bare.api.server_logits)
    with pytest.raises(ValueError, match="topk"):
        _run(FedConfig(**RUN, wire_codec="topk:0.1"))


# -- the straggler deadline -------------------------------------------------------------------

FT = dict(RUN, comm_round=3, straggler_deadline_sec=60.0)


def test_healthy_fault_tolerant_run_equals_the_strict_one():
    strict = _run(FedConfig(**dict(RUN, comm_round=3)))
    ft = _run(FedConfig(**FT))
    assert ft.history == strict.history


@pytest.mark.parametrize("silent_from", [0, 1])
def test_silent_client_is_dropped_and_the_rounds_complete(monkeypatch, silent_from):
    class Silent(fe.GKTEdgeClientManager):
        def _on_sync(self, msg):
            if self.rank == 3 and int(msg.get(fe.KEY_ROUND)) >= silent_from:
                return                     # a dead process: never replies again
            super()._on_sync(msg)

    class Server(fe.GKTEdgeServerManager):
        def _on_features(self, msg):
            super()._on_features(msg)
            live = {k for k in range(self.C) if self._alive[k]}
            if self._feat and set(self._feat) == live - {2}:
                _fire(self, self.round_idx)

    monkeypatch.setattr(fe, "GKTEdgeClientManager", Silent)
    monkeypatch.setattr(fe, "GKTEdgeServerManager", Server)
    server = _run(FedConfig(**FT))
    assert [h["round"] for h in server.history] == [0, 1, 2]
    assert all(np.isfinite(h["Test/Loss"]) for h in server.history)
    assert server._alive == {0: True, 1: True, 2: False, 3: True}


def test_late_clients_rejoin(monkeypatch):
    """Every round-1 upload comes after the round's deadline: the round
    waits with every client marked dead, the late uploads revive them and
    the federation completes with everyone."""
    fired = threading.Event()

    class Late(fe.GKTEdgeClientManager):
        def _on_sync(self, msg):
            if int(msg.get(fe.KEY_ROUND)) == 1:
                assert fired.wait(30.0)
            super()._on_sync(msg)

    class Server(fe.GKTEdgeServerManager):
        def _send_logits(self, msg_type):
            super()._send_logits(msg_type)
            if self.round_idx == 1 and not fired.is_set():
                _fire(self, 1)

        def _on_deadline(self, msg):
            super()._on_deadline(msg)
            fired.set()

    monkeypatch.setattr(fe, "GKTEdgeClientManager", Late)
    monkeypatch.setattr(fe, "GKTEdgeServerManager", Server)
    server = _run(FedConfig(**dict(FT, comm_round=4)))
    assert [h["round"] for h in server.history] == [0, 1, 2, 3]
    assert server._alive == {k: True for k in range(C)}
    assert all(np.isfinite(h["Test/Loss"]) for h in server.history)


def test_deadline_needs_a_transport_with_local_injection():
    class NoInject:
        def add_observer(self, o):
            pass

        def supports_local_injection(self):
            return False

    api = FedGKTAPI(_ds(), FedConfig(**FT), device="cpu", **CI)

    class Args:
        comm_round = 2

    with pytest.raises(ValueError, match="local event injection"):
        fe.GKTEdgeServerManager(Args(), NoInject(), 0, C + 1, api)


def test_kill_and_resume_equals_the_straight_run(tmp_path):
    full = _run(FedConfig(**dict(RUN, comm_round=4)))
    ckpt_dir = str(tmp_path / "gkt")
    _run(FedConfig(**dict(RUN, comm_round=2, checkpoint_dir=ckpt_dir, checkpoint_frequency=2)))
    ckpt = f"{ckpt_dir}/gkt_server.ckpt"
    resumed = _run(FedConfig(**dict(RUN, comm_round=4, checkpoint_dir=ckpt_dir,
                                    checkpoint_frequency=2, resume_from=ckpt)))
    assert resumed.history == full.history
    # without checkpoint_dir the clients' states are found beside the server's
    again = _run(FedConfig(**dict(RUN, comm_round=4, checkpoint_frequency=2, resume_from=ckpt)))
    assert again.history == full.history


def test_clients_share_the_api_programs_and_follow_their_tensors(monkeypatch):
    made = []

    class Client(fe.GKTEdgeClientManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(fe, "GKTEdgeClientManager", Client)
    pair = create_gkt_pair(3, (8, 8, 3), **CI)
    server = fe.run_fedgkt_edge(_ds(), FedConfig(**RUN), pair=pair, device="cpu")
    api = server.api
    assert len(made) == C and all(c.api is api for c in made)
    first = dict(api.programs)
    assert set(first) == {"client", "server"} and api.program("client") is first["client"]
    with torch.no_grad():
        for p in pair.client.module.parameters():
            p.data = p.data.clone()                 # what a round trip through .to() does
    assert api.program("client") is not first["client"]
    assert api.program("server") is first["server"]
    again = fe.run_fedgkt_edge(_ds(), FedConfig(**RUN), pair=pair, device="cpu")
    fresh = _run()
    assert again.history == fresh.history


def test_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fe.run_fedgkt_edge(_ds(), FedConfig(**RUN), **CI)


def test_grpc_loopback_equals_local():
    """Over real gRPC sockets on the CPU (the card's machine has no gRPC)."""
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager
    from torch_edge_refs import free_base

    local = _run()
    for attempt in range(3):
        base = free_base(C + 1)
        try:
            over = _run(comm_factory=lambda r: GRPCCommManager(r, C + 1, base_port=base,
                                                               host="127.0.0.1"))
            break
        except OSError:
            if attempt == 2:
                raise
    assert over.history == local.history
