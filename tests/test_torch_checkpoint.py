"""Serialization, checkpoints, resume and the training loop's records.

- ``frame_pack`` gives the JAX package's bytes for the same header and
  payloads, and each package's ``frame_unpack`` reads the other's frames;
  a checkpoint's header is the JAX package's (``FTCKPT1``, ``round_idx``,
  ``extra``).
- The state-dict tree form round-trips bit for bit, every dtype (bf16
  included) and container kept; a torn or corrupted frame raises.
- Resume is bit-identical to the uninterrupted run (the port's counterpart
  of tests/test_checkpoint_resume.py:41, :64, :154): ``lr``, a tiny
  ResNet (plain and packed, ``train()`` with ``checkpoint_dir`` and
  ``resume_from``) and FedOpt-adam with its server state.
- ``train()``'s records: ``latest.ckpt`` every ``checkpoint_frequency``
  rounds and after the last, ``rounds_per_sec`` over the rounds that ran,
  the timing keys, the metrics logger, the sweep signal and the profiler
  trace.
"""

import json
import os

import numpy as np
import pytest
import torch

from fedml_tpu.core.serialization import frame_pack as jax_frame_pack
from fedml_tpu.core.serialization import frame_unpack as jax_frame_unpack
from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.serialization import (frame_pack, frame_unpack, tree_from_bytes,
                                                tree_to_bytes)
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import ModelBundle
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.utils import metrics
from fedml_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


@pytest.mark.parametrize("magic,header,payloads", [
    (b"FTCKPT1", {"round_idx": 3, "extra": {}}, (b"abc",)),
    (b"FTPU1", {"treedef": {"__d__": {"a": 0}}, "shapes": [[2, 3]], "dtypes": ["<f4"]},
     (bytes(range(24)), b"")),
    (b"X", [1, 2.5, "s", None, True], ()),
])
def test_frame_pack_is_jax_bytes(magic, header, payloads):
    buf = frame_pack(magic, header, *payloads)
    assert buf == jax_frame_pack(magic, header, *payloads)
    assert frame_unpack(magic, buf) == jax_frame_unpack(magic, buf)


def test_frame_unpack_rejects_foreign_and_torn_frames():
    buf = frame_pack(b"FTCKPT1", {"round_idx": 1}, b"xyz")
    with pytest.raises(ValueError, match="bad magic"):
        frame_unpack(b"FTPU1", buf)
    with pytest.raises(ValueError, match="truncated"):
        frame_unpack(b"FTCKPT1", buf[:9])
    with pytest.raises(ValueError, match="truncated"):
        frame_unpack(b"FTCKPT1", buf[:20])


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn(3, 4, generator=g),
        "bf16": torch.randn(5, generator=g).to(torch.bfloat16),
        "count": torch.tensor(7, dtype=torch.int32),
        "mask": torch.tensor([True, False]),
        "empty": torch.empty(0, 2, dtype=torch.float64),
        "np": np.arange(6, dtype=np.int16).reshape(2, 3),
        "opt": ({"mu": [torch.ones(2), torch.zeros(1, 1)]}, None, [np.float32(1.5)]),
    }


def _assert_same_tree(a, b):
    assert type(a) is type(b) or (isinstance(a, np.generic) and isinstance(b, np.ndarray))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same_tree(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))
    elif a is not None:
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(b, np.asarray(a))


def test_tree_round_trip_is_bit_exact():
    tree = _tree()
    _assert_same_tree(tree, tree_from_bytes(tree_to_bytes(tree)))


def test_tree_frame_checks():
    buf = bytearray(tree_to_bytes(_tree()))
    buf[-1] ^= 0xFF
    with pytest.raises(ValueError, match="corrupt"):
        tree_from_bytes(bytes(buf))
    with pytest.raises(ValueError, match="truncated"):
        tree_from_bytes(bytes(buf[:-3]))
    with pytest.raises(TypeError, match="string dict keys"):
        tree_to_bytes({1: torch.ones(1)})


def test_checkpoint_file_is_atomic_and_jax_framed(tmp_path):
    path = str(tmp_path / "sub" / "a.ckpt")
    save_checkpoint(path, {"w": torch.ones(2)}, {"opt": [torch.zeros(1)]}, 4, {"k": "v"})
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    with open(path, "rb") as f:
        header, _ = jax_frame_unpack(b"FTCKPT1", f.read())
    assert header == {"round_idx": 4, "extra": {"k": "v"}}
    got = load_checkpoint(path)
    assert (got["round_idx"], got["extra"]) == (4, {"k": "v"})
    _assert_same_tree({"w": torch.ones(2)}, got["variables"])
    _assert_same_tree({"opt": [torch.zeros(1)]}, got["server_state"])


# -- resume ---------------------------------------------------------------------

def _lr_ds():
    return make_synthetic_classification("ckpt-tiny", (6,), 3, 5, records_per_client=12,
                                         partition_method="homo", batch_size=4, seed=0)


def _lr_cfg(**kw):
    return FedConfig(**{**dict(model="lr", dataset="ckpt-tiny", client_num_in_total=5,
                               client_num_per_round=3, comm_round=6, batch_size=4, epochs=1,
                               lr=0.2, momentum=0.9, frequency_of_the_test=100, seed=13), **kw})


def _assert_same_state(a, b):
    assert list(a.variables) == list(b.variables)
    for k, v in a.variables.items():
        assert v.dtype == b.variables[k].dtype
        assert torch.equal(v, b.variables[k]), k
    _assert_same_tree(a.server_state, b.server_state)


def test_resume_is_bit_identical_to_uninterrupted(tmp_path):
    ds = _lr_ds()
    straight = FedAvgAPI(ds, _lr_cfg(), device="cpu")
    for r in range(6):
        straight.run_round(r)
    first = FedAvgAPI(ds, _lr_cfg(), device="cpu")
    for r in range(3):
        first.run_round(r)
    path = str(tmp_path / "mid.ckpt")
    first.save(path, round_idx=3)
    resumed = FedAvgAPI(ds, _lr_cfg(), device="cpu")
    start = resumed.restore(path)
    assert start == 3
    for r in range(start, 6):
        resumed.run_round(r)
    _assert_same_state(straight, resumed)


def test_fedopt_server_state_round_trips_and_trains_on(tmp_path):
    ds = _lr_ds()
    cfg = _lr_cfg(server_optimizer="adam", server_lr=0.05)
    api = FedOptAPI(ds, cfg, device="cpu")
    for r in range(3):
        api.run_round(r)
    path = str(tmp_path / "fedopt.ckpt")
    api.save(path, round_idx=3)
    fresh = FedOptAPI(ds, cfg, device="cpu")
    assert fresh.restore(path) == 3
    _assert_same_state(api, fresh)
    assert int(fresh.server_state["opt"][0]["count"]) == 3
    for r in range(3, 5):
        api.run_round(r)
        fresh.run_round(r)
    _assert_same_state(api, fresh)


def test_restore_refuses_another_model_and_orbax(tmp_path):
    ds = _lr_ds()
    api = FedAvgAPI(ds, _lr_cfg(), device="cpu")
    path = str(tmp_path / "x.ckpt")
    save_checkpoint(path, {"other.weight": torch.ones(1)})
    with pytest.raises(ValueError, match="do not match"):
        api.restore(path)
    for call in (lambda: api.save(path, orbax=True), lambda: api.restore(path, orbax=True)):
        with pytest.raises(NotImplementedError, match="orbax"):
            call()


RES_DATA = dict(name="ckpt-res", input_shape=(8, 8, 3), classes=10, num_clients=4,
                records_per_client=16, test_records=40, partition_method="hetero",
                partition_alpha=0.5, batch_size=8, seed=0)
RES_RUN = dict(model="cifar-small", dataset="ckpt-res", client_num_in_total=4,
               client_num_per_round=4, comm_round=4, batch_size=8, epochs=1, lr=0.05,
               momentum=0.9, frequency_of_the_test=2, seed=0, device_data="on",
               checkpoint_frequency=2)


def _res_api(ds, **kw):
    bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16), bn_impl="pallas"),
                         (8, 8, 3))
    return FedAvgAPI(ds, FedConfig(**{**RES_RUN, **kw}), bundle, device="cpu")


@pytest.mark.parametrize("pack_lanes", [0, 2], ids=["plain", "packed"])
def test_train_resumes_a_tiny_resnet_bit_identically(tmp_path, pack_lanes):
    """train() with checkpoints: 4 rounds straight, against 2 rounds and 2
    more from resume_from; the resumed history holds only its own rounds."""
    ds = make_synthetic_classification(**RES_DATA)
    d_full, d_half = str(tmp_path / "full"), str(tmp_path / "half")
    straight = _res_api(ds, pack_lanes=pack_lanes, checkpoint_dir=d_full)
    h = straight.train()
    assert straight.packed_status()["scheduled"] == bool(pack_lanes)
    assert load_checkpoint(os.path.join(d_full, "latest.ckpt"))["round_idx"] == 4
    first = _res_api(ds, pack_lanes=pack_lanes, comm_round=2, checkpoint_dir=d_half)
    first.train()
    resumed = _res_api(ds, pack_lanes=pack_lanes,
                       resume_from=os.path.join(d_half, "latest.ckpt"))
    hr = resumed.train()
    _assert_same_state(straight, resumed)
    assert h["round"] == [0, 2, 3] and hr["round"] == [2, 3]
    assert hr["Test/Acc"] == h["Test/Acc"][1:] and hr["Test/Loss"] == h["Test/Loss"][1:]
    assert resumed.metrics_logger.series("round") == [2, 3]


def test_train_checkpoints_at_the_frequency_and_after_the_last_round(tmp_path, monkeypatch):
    ds = _lr_ds()
    api = FedAvgAPI(ds, _lr_cfg(comm_round=5, checkpoint_dir=str(tmp_path),
                                checkpoint_frequency=2), device="cpu")
    saved = []
    save = api.save
    monkeypatch.setattr(api, "save", lambda p, r=0, **kw: saved.append(r) or save(p, r, **kw))
    api.train()
    assert saved == [2, 4, 5]
    assert load_checkpoint(str(tmp_path / "latest.ckpt"))["round_idx"] == 5


def test_train_timing_counts_the_rounds_that_ran(tmp_path):
    ds = _lr_ds()
    a = FedAvgAPI(ds, _lr_cfg(comm_round=2, checkpoint_dir=str(tmp_path)), device="cpu")
    a.train()
    b = FedAvgAPI(ds, _lr_cfg(comm_round=6, resume_from=str(tmp_path / "latest.ckpt")),
                  device="cpu")
    h = b.train()
    t = h["timing"]
    assert set(t) == {"time/train_s", "time/eval_s", "time/wall_s", "rounds_per_sec"}
    # 4 rounds ran (the wall is rounded to 0.1 ms)
    assert h["rounds_per_sec"] == t["rounds_per_sec"]
    assert t["rounds_per_sec"] * t["time/wall_s"] == pytest.approx(4, rel=0.02)
    assert h["round"] == [5]                      # frequency 100: only the last round
    c = FedAvgAPI(ds, _lr_cfg(comm_round=2, async_rounds=True, device_data="off"), device="cpu")
    t = c.train()["timing"]
    assert t["time/train_is_dispatch_only"] is True
    assert t["host_pipeline"]["rounds"] == 2


def test_round_timer_syncs_each_phase_and_the_summary():
    calls = []
    timer = metrics.RoundTimer(sync=lambda: calls.append(1))
    with timer.phase("train"):
        pass
    with timer.phase("train", sync=False):
        pass
    timer.tick_round()
    s = timer.summary()
    assert len(calls) == 2 and s["rounds_per_sec"] > 0 and "time/train_s" in s


def test_metrics_logger_jsonl_and_missing_wandb(tmp_path, caplog):
    path = tmp_path / "m.jsonl"
    with metrics.MetricsLogger("run", enable_wandb=True, jsonl_path=str(path)) as lg:
        lg.log({"Test/Acc": 0.5}, 3)
        lg.log({"Test/Acc": 0.75}, 4)
    assert "wandb requested but not installed" in caplog.text
    assert [json.loads(x) for x in path.read_text().splitlines()] == \
        [{"Test/Acc": 0.5, "round": 3}, {"Test/Acc": 0.75, "round": 4}]
    assert lg.last("Test/Acc") == 0.75 and lg.series("round") == [3, 4]


def test_notify_sweep_complete_writes_to_a_listening_fifo(tmp_path, monkeypatch):
    fifo = str(tmp_path / "sweep")
    os.mkfifo(fifo)
    monkeypatch.delenv("FEDML_SWEEP_PIPE", raising=False)
    assert metrics.notify_sweep_complete() is False
    assert metrics.notify_sweep_complete(fifo) is False          # no reader: no block
    rd = os.open(fifo, os.O_RDONLY | os.O_NONBLOCK)
    try:
        monkeypatch.setenv("FEDML_SWEEP_PIPE", fifo)
        assert metrics.notify_sweep_complete() is True
        assert os.read(rd, 64) == b"training is finished!\n"
    finally:
        os.close(rd)


def test_profile_trace_writes_a_trace(tmp_path):
    with metrics.profile_trace(None):
        pass
    with metrics.profile_trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
