"""The port's edge message plane against the JAX package's.

- ``Message`` round-trips JSON values, state dicts of numpy arrays and
  tensors, numpy scalars, under every codec.
- The codecs (``core/compression.py``): ``parse_codec`` accepts and refuses
  what JAX's does, and ``raw`` / ``q8`` / ``topk`` decode the same arrays
  (made from a seed) to JAX's values bit for bit, with JAX's per-leaf
  payload sizes; ``FedConfig`` checks its codec through ``parse_codec``.
- ``StreamAccumulator`` folds as JAX's does, bit for bit, in both modes.
- The transports: the local router's bounded mailboxes and teardown post,
  the MQTT broker and socket client (topics, a payload of megabytes, the
  star rule), gRPC (``importorskip``), local event injection, and
  ``run_base_framework`` on both packages and over every transport.

Sockets bind port 0; nothing sleeps in place of a synchronisation.
"""

import queue
import threading

import numpy as np
import pytest
import torch

from fedml_tpu.core import compression as jax_compression
from fedml_tpu.core.streaming import StreamAccumulator as JaxStreamAccumulator
from fedml_tpu.distributed.base_framework import run_base_framework as jax_run_base_framework
from fedml_tpu_torch.comm import Message, create_comm_manager
from fedml_tpu_torch.comm.base import put_control
from fedml_tpu_torch.comm.local import LocalCommunicationManager, LocalRouter, run_ranks
from fedml_tpu_torch.comm.mqtt_backend import MqttCommManager
from fedml_tpu_torch.comm.mqtt_broker import MqttBroker
from fedml_tpu_torch.core import compression
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.core.streaming import StreamAccumulator
from fedml_tpu_torch.distributed.base_framework import (MSG_TYPE_LOCAL_ROUND_DEADLINE,
                                                        RoundDeadlineTimer, require_injectable,
                                                        run_base_framework)
from fedml_tpu_torch.utils.metrics import merge_wire_stats, wire_stats

CODECS = ("raw", "q8", "topk:0.1")


def _tree(seed: int = 0) -> dict:
    """A state dict as the edge ships it: large and small float leaves, an
    integer leaf, a scalar."""
    rng = np.random.default_rng(seed)
    return {"conv.weight": rng.standard_normal((8, 4, 3, 3)).astype(np.float32),
            "bn.scale": rng.standard_normal(8).astype(np.float32),
            "fc.weight": (rng.standard_normal((10, 32)) * 1e-3).astype(np.float32),
            "steps": np.arange(70, dtype=np.int32),
            "scalar": np.float32(0.5) * np.ones((), np.float32)}


@pytest.mark.parametrize("codec", CODECS)
def test_codec_decodes_as_jax(codec):
    tree = _tree(1)
    ours = compression.decode_tree(compression.encode_tree(tree, codec))
    theirs = jax_compression.decode_tree(jax_compression.encode_tree(tree, codec))
    assert set(ours) == set(theirs) == set(tree)
    for k in tree:
        assert ours[k].dtype == np.asarray(theirs[k]).dtype == tree[k].dtype, k
        np.testing.assert_array_equal(ours[k], np.asarray(theirs[k]), err_msg=k)
    # the same encoding of each leaf: JAX's header lists them in its
    # flatten order (sorted keys)
    meta_o, _ = compression.frame_unpack(compression.MAGIC, compression.encode_tree(tree, codec))
    meta_j, _ = jax_compression.frame_unpack(jax_compression.MAGIC,
                                             jax_compression.encode_tree(tree, codec))
    by_key = dict(zip(tree, zip(meta_o["leaves"], meta_o["lens"])))
    assert [by_key[k] for k in sorted(tree)] == list(zip(meta_j["leaves"], meta_j["lens"]))


@pytest.mark.parametrize("spec", ["raw", "q8", "topk:0.05", "topk:1", "topk:0", "topk:1.5",
                                  "gzip", "topk"])
def test_parse_codec_matches_jax(spec):
    try:
        want = jax_compression.parse_codec(spec)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" (")[0][:20]):
            compression.parse_codec(spec)
        with pytest.raises(ValueError):
            FedConfig(wire_codec=spec)
        return
    assert compression.parse_codec(spec) == want


def test_lossy_floor_and_frames_match_jax():
    assert compression.MIN_LOSSY_ELEMENTS == jax_compression.MIN_LOSSY_ELEMENTS
    assert compression.MAGIC == jax_compression.MAGIC
    buf = compression.encode_tree({"w": np.ones(100, np.float32)}, "q8")
    assert compression.is_compressed_frame(buf) and jax_compression.is_compressed_frame(buf)
    # a tensor leaf is copied to the host
    t = {"w": torch.linspace(-1, 1, 100)}
    np.testing.assert_array_equal(compression.decode_tree(compression.encode_tree(t, "raw"))["w"],
                                  t["w"].numpy())


@pytest.mark.parametrize("codec", CODECS)
def test_message_round_trip(codec):
    tree = _tree(2)
    m = Message(3, 1, 0)
    m.codec = None
    m.add_params("model_params", tree)
    m.add_params("client_idx", [4, 7])
    m.add_params("num_samples", 12.0)
    m.add_params("tensors", {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)})
    m.add_params("n", np.int64(5))
    back = Message.from_bytes(m.to_bytes(codec))
    assert (back.get_type(), back.get_sender_id(), back.get_receiver_id()) == (3, 1, 0)
    assert back.get("client_idx") == [4, 7] and back.get("num_samples") == 12.0
    n = back.get("n")
    assert n.shape == () and n.dtype == np.int64 and n.item() == 5
    want = compression.decode_tree(compression.encode_tree(tree, codec))
    for k in tree:
        np.testing.assert_array_equal(back.get("model_params")[k], want[k])
    got = back.get("tensors")["a"]
    torch.testing.assert_close(torch.as_tensor(got), m.get("tensors")["a"], rtol=0, atol=0)
    assert "model_params" in back and "Message(type=3" in repr(back)


def test_zero_d_leaves_keep_their_shape():
    """A 0-d numpy leaf (a numpy scalar, the residual file's round) comes
    back 0-d, not 1-d; tensors and n-d arrays as before."""
    from fedml_tpu_torch.core.serialization import tree_from_bytes, tree_to_bytes

    tree = {"i": np.int64(5), "f": np.ones((), np.float32), "v": np.arange(3),
            "t": torch.tensor(2.0)}
    back = tree_from_bytes(tree_to_bytes(tree))
    assert [np.shape(back[k]) for k in tree] == [(), (), (3,), ()]
    assert back["i"].item() == 5 and isinstance(back["t"], torch.Tensor)


def test_stream_accumulator_folds_as_jax():
    rng = np.random.default_rng(3)
    ups = [({"w": rng.standard_normal((5, 7)).astype(np.float32),
             "b": rng.standard_normal(7).astype(np.float32)}, float(rng.integers(1, 40)))
           for _ in range(5)]
    ups[2] = (ups[2][0], 0.0)                 # a zero-weight contribution
    template = ups[0][0]
    order = [3, 0, 4, 1, 2]
    for mode in ("deterministic", "arrival"):
        ours, theirs = StreamAccumulator(mode), JaxStreamAccumulator(mode)
        for i in order:
            ours.add(i, *ups[i])
            theirs.add(i, *ups[i])
        assert (ours.peak_held, ours.folded) == (theirs.peak_held, theirs.folded)
        assert ours.nbytes == theirs.nbytes
        a, b = ours.finalize(template), theirs.finalize(template)
        for k in template:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))
    empty = StreamAccumulator()
    empty.add(0, template, 0.0)
    assert empty.finalize(template) is None
    with pytest.raises(ValueError, match="deterministic"):
        StreamAccumulator("lifo")


def test_local_router_bounds_and_teardown_post():
    router = LocalRouter(2, cap=1)
    router.post(1, "a")
    done = threading.Event()

    def blocked():
        router.post(1, "b")          # the mailbox is full: blocks
        done.set()

    t = threading.Thread(target=blocked, daemon=True)
    t.start()
    assert router.take(1) == "a"      # draining releases the sender
    t.join(timeout=30)
    assert done.is_set() and router.take(1) == "b"
    q = queue.Queue(maxsize=1)
    q.put("old")
    put_control(q, "stop")            # drops the oldest to make room
    assert q.get_nowait() == "stop"


def test_mqtt_topics_payload_and_star_rule():
    with MqttBroker(0) as broker:
        server = MqttCommManager("127.0.0.1", broker.port, 0, 2)
        client = MqttCommManager("127.0.0.1", broker.port, 2, 2, codec="q8")
        got = []

        class Obs:
            def receive_message(self, t, m):
                got.append(m)
                server.stop_receive_message()

        server.add_observer(Obs())
        big = np.random.default_rng(0).standard_normal(1 << 19).astype(np.float32)  # 2 MiB
        m = Message(7, 2, 0)
        m.add_params("w", {"x": big})
        client.send_message(m)
        server.handle_receive_message()
        assert got[0].get_sender_id() == 2
        want = compression.decode_tree(compression.encode_tree({"x": big}, "q8"))["x"]
        np.testing.assert_array_equal(got[0].get("w")["x"], want)
        with pytest.raises(NotImplementedError, match="star"):
            client.send_message(Message(7, 2, 1))
        assert not server.supports_local_injection()
        with pytest.raises(ValueError, match="local event injection"):
            require_injectable(server)
        client.stop_receive_message()
        client.handle_receive_message()


def test_local_injection_and_deadline_timer():
    router = LocalRouter(1)
    comm = create_comm_manager("local", router=router, rank=0)
    require_injectable(comm)
    timer = RoundDeadlineTimer(comm, 0.01, 0, "round_idx")
    timer.arm(3)
    msg = router.take(0, timeout=30)
    assert msg.get_type() == MSG_TYPE_LOCAL_ROUND_DEADLINE and msg.get("round_idx") == 3
    timer.arm(4)
    timer.cancel()
    with pytest.raises(queue.Empty):
        router.take(0, timeout=0.2)
    with pytest.raises(ValueError, match="unknown comm backend"):
        create_comm_manager("carrier-pigeon")


def test_wire_stats_walk_the_middleware_chain():
    class Layer:
        stats_prefix = "wire"

        def __init__(self, inner, **stats):
            self.inner, self.stats = inner, stats

    bare = LocalCommunicationManager(LocalRouter(1), 0)
    assert wire_stats(bare) == {}
    stack = Layer(Layer(bare, retransmits=2), retransmits=1, gave_up=1)
    assert wire_stats(stack) == {"wire/retransmits": 3, "wire/gave_up": 1}
    assert merge_wire_stats([stack, stack, bare]) == {"wire/retransmits": 6, "wire/gave_up": 2}


def test_run_base_framework_matches_jax():
    want = jax_run_base_framework(3, comm_round=3)
    assert run_base_framework(3, comm_round=3) == want
    assert run_base_framework(3, comm_round=3, wire_roundtrip=False) == want
    assert run_base_framework(3, comm_round=3, config=FedConfig(wire_inbox_cap=1)) == want
    with pytest.raises(NotImplementedError, match="11b"):
        run_base_framework(2, config=FedConfig(wire_reliable=True))


def test_run_base_framework_over_mqtt():
    want = jax_run_base_framework(3, comm_round=2)
    with MqttBroker(0) as broker:
        got = run_base_framework(3, comm_round=2, comm_factory=lambda r: MqttCommManager(
            "127.0.0.1", broker.port, r, 3))
    assert got == want


def _free_base(n: int) -> int:
    """A base port whose block of ``n`` ports was free when probed."""
    import socket

    for _ in range(20):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + n < 65000:
            return base
    raise RuntimeError("no free port block")


def test_run_base_framework_over_grpc():
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import GRPCCommManager

    want = jax_run_base_framework(2, comm_round=2)
    base = _free_base(3)
    got = run_base_framework(2, comm_round=2, comm_factory=lambda r: GRPCCommManager(
        r, 3, base_port=base, host="127.0.0.1"))
    assert got == want


def test_grpc_ip_table(tmp_path):
    pytest.importorskip("grpc")
    from fedml_tpu_torch.comm.grpc_backend import build_ip_table

    path = tmp_path / "ip.csv"
    path.write_text("receiver_id,ip\n0,10.0.0.1\n1, 10.0.0.2\n\n")
    assert build_ip_table(str(path)) == {0: "10.0.0.1", 1: "10.0.0.2"}


def test_run_ranks_propagates_a_rank_error():
    class Boom:
        def __init__(self, rank, comm):
            self.rank, self.comm = rank, comm

        def run(self):
            if self.rank == 1:
                raise KeyError("rank one fails")
            self.comm.handle_receive_message()      # released by the failure

    with pytest.raises(RuntimeError, match="rank 1 raised") as err:
        run_ranks(Boom, 3, timeout=60)
    assert isinstance(err.value.__cause__, KeyError)
