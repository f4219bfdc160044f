"""The fault-tolerant modes and the kill-and-resume of the port's
TurboAggregate, SplitNN and VFL edges (after tests/test_edge_ft_protocols.py
and tests/test_edge_checkpoint_all.py).

No test waits on a wall-clock deadline: every deadline is 60 s, and a test
whose client dies injects the deadline event itself
(``MSG_TYPE_LOCAL_ROUND_DEADLINE`` into the server's own queue) the moment
everything but the doomed clients' messages is in, as the timer would.

- TurboAggregate's threshold protocol: a client that never deals is left
  out of D and every round closes with the other three; two clients that
  deal and then die before REVEAL still count in round 1 (its history
  equals the healthy run's) and the survivors finish the run.
- SplitNN's managed ring: a silent client is skipped and the ring re-forms
  (2 live clients x 2 epochs of validation).
- Kill and resume: TurboAggregate (the ring and the threshold protocol)
  resumed at the checkpoint equals the uninterrupted run, bit for bit; the
  managed ring stopped after one turn and resumed gives the uninterrupted
  run's validations; VFL resumed at an epoch equals the straight run, and
  a host state of another epoch than the guest's fails loudly
  (tests/test_edge_checkpoint.py:120-148).
- A deadline needs a transport with local injection.
- The workers share the bundle's one local-train program, which follows
  the module's tensors (tests/test_torch_fedbuff.py's case, for
  TurboAggregate).
- ``OrderedStream`` (VFL's and SplitNN's in-order handling) handles a
  reordered stream in order, drops duplicates, and takes a restarted
  sender's new stream for a new one.
"""

import os

import numpy as np
import pytest
import torch

from fedml_tpu_torch.comm import Message
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.serialization import tree_from_bytes, tree_to_bytes
from fedml_tpu_torch.data import load_dataset
from fedml_tpu_torch.data import vertical as tvert
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.distributed import fedavg_edge as edge
from fedml_tpu_torch.distributed import split_nn_edge as se
from fedml_tpu_torch.distributed import turboaggregate_edge as te
from fedml_tpu_torch.distributed import vfl_edge as ve
from fedml_tpu_torch.distributed.base_framework import (MSG_TYPE_LOCAL_ROUND_DEADLINE,
                                                        OrderedStream)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.split import create_split_mlp

C = 4


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _fire(manager, key: str, tag: int) -> None:
    """The deadline timer's event, now."""
    m = Message(MSG_TYPE_LOCAL_ROUND_DEADLINE, manager.rank, manager.rank)
    m.add_params(key, int(tag))
    manager.com_manager.inject_local(m)


def _ta_ds():
    return make_synthetic_classification(
        name="ta-ft", input_shape=(8,), classes=3, num_clients=C, records_per_client=12,
        partition_method="hetero", partition_alpha=0.5, batch_size=6, seed=2)


def _ta_cfg(**kw):
    base = dict(model="lr", client_num_in_total=C, client_num_per_round=C, comm_round=3,
                epochs=1, batch_size=6, lr=0.3, seed=9, frequency_of_the_test=1,
                device_data="off")
    base.update(kw)
    return FedConfig(**base)


def _same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


# -- TurboAggregate's threshold protocol ----------------------------------------------------


def test_ta_client_dead_from_the_start_is_left_out(monkeypatch):
    class NeverDeals(te.TAThresholdClientManager):
        def _on_sync(self, msg):
            if self.rank != 4:
                super()._on_sync(msg)

    class Server(te.TAThresholdServerManager):
        def _on_dealt(self, msg):
            super()._on_dealt(msg)
            if self._phase == "deal" and set(self._dealt) == set(self._live()) - {3}:
                _fire(self, te.KEY_ROUND, self._gen * 2)

    monkeypatch.setattr(te, "TAThresholdClientManager", NeverDeals)
    monkeypatch.setattr(te, "TAThresholdServerManager", Server)
    server = te.run_turboaggregate_edge(_ta_ds(), _ta_cfg(straggler_deadline_sec=60.0),
                                        threshold_t=1, device="cpu")
    assert server._alive == {0: True, 1: True, 2: True, 3: False}
    assert server.history["round"] == [0, 1, 2]
    assert all(np.isfinite(v) for v in server.history["Test/Loss"])


def test_ta_clients_dying_between_the_phases_still_count(monkeypatch):
    """Clients 1 and 2 deal their round-1 shares, then die before REVEAL:
    the server reconstructs from the other T + 1 = 2 evaluations and their
    updates still count (they are in D), so round 1 equals the healthy
    run's; the survivors finish round 2."""
    ds = _ta_ds()
    healthy = te.run_turboaggregate_edge(ds, _ta_cfg(straggler_deadline_sec=60.0),
                                         threshold_t=1, device="cpu")

    class DiesAfterDealing(te.TAThresholdClientManager):
        def _on_reveal(self, msg):
            if self.rank in (2, 3) and self.round_idx >= 1:
                return
            super()._on_reveal(msg)

    class Server(te.TAThresholdServerManager):
        def _on_eval(self, msg):
            super()._on_eval(msg)
            if (self._phase == "eval" and self.round_idx >= 1
                    and set(self._evals) == set(self._live()) - {1, 2}):
                _fire(self, te.KEY_ROUND, self._gen * 2 + 1)

    monkeypatch.setattr(te, "TAThresholdClientManager", DiesAfterDealing)
    monkeypatch.setattr(te, "TAThresholdServerManager", Server)
    server = te.run_turboaggregate_edge(ds, _ta_cfg(straggler_deadline_sec=60.0),
                                        threshold_t=1, device="cpu")
    assert server._alive == {0: True, 1: False, 2: False, 3: True}
    assert server.history["round"] == [0, 1, 2]
    for key in ("Test/Acc", "Test/Loss", "Train/Loss"):
        assert server.history[key][:2] == healthy.history[key][:2], key
    assert all(np.isfinite(v) for v in server.history["Test/Loss"])


class _NoInject:
    def add_observer(self, o):
        pass

    def supports_local_injection(self):
        return False


def test_deadlines_need_a_transport_with_local_injection():
    ds = _ta_ds()
    bundle = create_model("lr", ds.class_num, input_shape=(8,))
    cfg = _ta_cfg(straggler_deadline_sec=5.0)
    with pytest.raises(ValueError, match="local event injection"):
        te.TAThresholdServerManager(cfg, _NoInject(), 0, C + 1, bundle.init(0, "cpu"), ds, bundle,
                                    20, 1, 5.0, device="cpu")
    trainer = se.SplitNNServerTrainer(create_split_mlp(3, (8,), 8)[1], FedConfig(), None, 3,
                                      device="cpu")
    with pytest.raises(ValueError, match="local event injection"):
        se.SplitNNEdgeServerManager(FedConfig(), _NoInject(), 0, 4, trainer, deadline=5.0)


@pytest.mark.parametrize("mode", ["strict", "threshold"])
def test_ta_kill_and_resume_equals_the_straight_run(tmp_path, mode):
    extra = {} if mode == "strict" else dict(straggler_deadline_sec=60.0)
    ds = _ta_ds()
    full = te.run_turboaggregate_edge(ds, _ta_cfg(comm_round=4, **extra), device="cpu")
    ckpt_dir = str(tmp_path / "ta")
    te.run_turboaggregate_edge(ds, _ta_cfg(comm_round=2, checkpoint_dir=ckpt_dir,
                                           checkpoint_frequency=2, **extra), device="cpu")
    ckpt = os.path.join(ckpt_dir, "ta_server.ckpt")
    assert os.path.exists(ckpt)
    resumed = te.run_turboaggregate_edge(ds, _ta_cfg(comm_round=4, resume_from=ckpt, **extra),
                                         device="cpu")
    assert resumed.history["round"] == full.history["round"]
    for key in ("Test/Acc", "Test/Loss"):
        assert resumed.history[key] == full.history[key], key
    _same(full.variables, resumed.variables)


def test_ta_workers_share_the_bundle_program_and_follow_its_tensors(monkeypatch):
    ds = _ta_ds()
    cfg = _ta_cfg(comm_round=2)
    bundle = create_model("lr", ds.class_num, input_shape=(8,))
    programs = []

    class Worker(te.TAEdgeClientManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            programs.append(self.local_train)

    monkeypatch.setattr(te, "TAEdgeClientManager", Worker)
    te.run_turboaggregate_edge(ds, cfg, bundle=bundle, device="cpu")
    assert len(programs) == C and len({id(p) for p in programs}) == 1
    assert programs[0] is edge.edge_local_train(bundle, ds, cfg)
    with torch.no_grad():
        for p in bundle.module.parameters():
            p.data = p.data.clone()                 # what a round trip through .to() does
    again = te.run_turboaggregate_edge(ds, cfg, bundle=bundle, device="cpu")
    assert programs[-1] is not programs[0]
    assert programs[-1] is edge.edge_local_train(bundle, ds, cfg)
    fresh = te.run_turboaggregate_edge(ds, cfg, device="cpu")
    _same(again.variables, fresh.variables)
    assert again.history == fresh.history


# -- SplitNN's managed ring -----------------------------------------------------------------


def _split():
    ds = load_dataset("synthetic_1_1", num_clients=3, batch_size=10, seed=0)
    return (ds,) + create_split_mlp(ds.class_num, ds.train_x.shape[2:], cut_dim=32)


SPLIT = dict(batch_size=10, lr=0.1, momentum=0.9, epochs=2, seed=0, straggler_deadline_sec=60.0)


def test_split_silent_client_is_skipped_and_the_ring_reforms(monkeypatch):
    class Silent(se.SplitNNEdgeClientManager):
        def handle_semaphore(self, msg):
            if self.rank != 2:
                super().handle_semaphore(msg)

    class Server(se.SplitNNEdgeServerManager):
        def _advance(self):
            super()._advance()
            if self._pos < len(self._ring) and self._ring[self._pos] == 2:
                _fire(self, "pos", self._pos)

    monkeypatch.setattr(se, "SplitNNEdgeClientManager", Silent)
    monkeypatch.setattr(se, "SplitNNEdgeServerManager", Server)
    ds, cb, sb = _split()
    server = se.run_splitnn_edge(ds, FedConfig(**SPLIT), cb, sb, device="cpu")
    assert len(server.val_history) == 4           # 2 live clients x 2 epochs
    assert server.ring_alive == {1: True, 2: False, 3: True}


def test_split_managed_ring_kill_and_resume(tmp_path):
    ds, cb, sb = _split()
    full = se.run_splitnn_edge(ds, FedConfig(**SPLIT), cb, sb, device="cpu")
    ckpt_dir = str(tmp_path / "snn")
    ds, cb, sb = _split()
    first = se.run_splitnn_edge(ds, FedConfig(**SPLIT, checkpoint_dir=ckpt_dir), cb, sb,
                                max_turns=1, device="cpu")
    assert len(first.val_history) == 2
    ckpt = os.path.join(ckpt_dir, "splitnn_server.ckpt")
    assert os.path.exists(ckpt)
    ds, cb, sb = _split()
    resumed = se.run_splitnn_edge(ds, FedConfig(**SPLIT, resume_from=ckpt), cb, sb,
                                  device="cpu")
    assert resumed.val_history == full.val_history
    _same(full.variables, resumed.variables)


# -- VFL --------------------------------------------------------------------------------------


def test_vfl_kill_and_resume_equals_the_straight_run(tmp_path):
    ds = tvert.make_synthetic_vertical((6, 5), n_train=96, n_test=48, seed=3)
    kw = dict(batch_size=16, seed=1, device="cpu")
    full = ve.run_vfl_edge(ds, epochs=4, **kw)
    ckpt_dir = str(tmp_path / "vfl")
    ve.run_vfl_edge(ds, epochs=2, checkpoint_dir=ckpt_dir, **kw)
    assert os.path.exists(os.path.join(ckpt_dir, "vfl_guest.ckpt"))
    resumed = ve.run_vfl_edge(ds, epochs=4, checkpoint_dir=ckpt_dir, resume=True, **kw)
    assert resumed.losses == full.losses
    assert resumed.history[-1] == full.history[-1]
    for k, v in full.party.params.items():
        assert torch.equal(resumed.party.params[k], v), k


def test_vfl_host_state_of_another_epoch_fails_loudly(tmp_path):
    ds = tvert.make_synthetic_vertical((4, 3), n_train=64, n_test=32, seed=0)
    ckpt_dir = str(tmp_path / "vfl")
    ve.run_vfl_edge(ds, epochs=2, batch_size=16, seed=1, checkpoint_dir=ckpt_dir, device="cpu")
    path = os.path.join(ckpt_dir, "vfl_host_1.state")
    with open(path, "rb") as f:
        st = tree_from_bytes(f.read())
    assert int(np.asarray(st["epoch"]).item()) == 2
    st["epoch"] = np.int64(1)                      # the pair torn: another epoch's host
    with open(path, "wb") as f:
        f.write(tree_to_bytes(st))
    with pytest.raises(RuntimeError) as err:
        ve.run_vfl_edge(ds, epochs=4, batch_size=16, seed=1, checkpoint_dir=ckpt_dir,
                        resume=True, device="cpu")
    assert "resume inconsistency" in str(err.value.__cause__)


def test_edge_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        te.run_turboaggregate_edge(_ta_ds(), _ta_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ve.run_vfl_edge(tvert.make_synthetic_vertical((4, 3), n_train=32, n_test=16, seed=0))
    ds, cb, sb = _split()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        se.run_splitnn_edge(ds, FedConfig(batch_size=10), cb, sb)


def test_ordered_stream_reorders_dedups_and_keys_by_incarnation():
    def sent(stream, tag):
        m = Message("x", 1, 0)
        m.add_params("tag", tag)
        return stream.stamp(m)

    first = OrderedStream()
    a, b, c = (sent(first, t) for t in "abc")
    got = []
    recv = OrderedStream().wrap(lambda m: got.append(m.get("tag")))
    for m in (c, a, a, b, c, Message("deadline", 0, 0)):   # reordered, duplicated, a local event
        recv(m)
    assert got == ["a", "b", "c", None]
    restarted = OrderedStream()                # the sender's manager made anew: places from 0
    for t in "de":
        recv(sent(restarted, t))
    recv(b)                                    # a late copy from the old stream
    assert got == ["a", "b", "c", None, "d", "e"]
