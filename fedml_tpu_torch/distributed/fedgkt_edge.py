"""Message-driven FedGKT for remote (weak edge) clients (counterpart of
``fedml_tpu/distributed/fedgkt_edge.py``; the reference's
fedml_api/distributed/fedgkt/: message_def.py, GKTClientMananger,
GKTServerMananger).

Each client trains its small net with distillation, then sends the
features and soft logits it extracts from its train records, and the
features of its test shard, to the server; the server trains its large net
on the union and returns each client's per-record logits for the next
round's distillation.

The compute is the simulation's own (``algorithms/fedgkt.FedGKTAPI``, the
program and state host): a client runs ``FedGKTAPI.train_client`` for its
own index from its own state (its net's state dict and optimizer state,
copied into the edge net's static tensors before its step and back after),
and the server stacks the uploads in client order and runs
``FedGKTAPI.server_phase`` on them. On CUDA each client step and each
server step is a replay of the API's one captured graph of its kind
(through K1/K2 on a kernel-BN pair), shared by every client of the
process; a program follows its net's tensors (``FedGKTAPI.program``).
Every device call runs on the edge runtime's one device thread
(``fedavg_edge.device_call``), so the edge equals the simulation on the
same federation. Features travel in the net's dtype (bf16 frames carry
torch tensors; ``q8`` widens them to f32 and quantizes them).

With ``straggler_deadline_sec`` a round closes at its deadline with the
uploads in: a missing client's slot keeps its last features under a zero
mask (no training contribution) and its server logits carry over, a late
upload revives the client (a stale one is answered with the current
round's logits), and after ``MAX_EMPTY_DEADLINES`` deadlines with nobody
alive the federation ends. The deadline must also cover the first round's
captures on the card. Checkpoints keep the server's net, optimizer state,
logits, round and history (``gkt_server.ckpt``) and each client's own state
(``gkt_client_{k}.state``, written at the server's checkpoint rounds).
``topk`` codecs are refused: GKT's payloads are full features and logits,
not deltas with an error-feedback stream.
"""

from __future__ import annotations

import logging
import os
import time
import types
from typing import Optional, Union

import numpy as np
import torch

from fedml_tpu_torch.comm import ClientManager, Message, ServerManager
from fedml_tpu_torch.comm.local import run_ranks
from fedml_tpu_torch.core.config import check_ported
from fedml_tpu_torch.core.tasks import int_cross_entropy
from fedml_tpu_torch.distributed.base_framework import (MAX_EMPTY_DEADLINES,
                                                        MSG_TYPE_LOCAL_ROUND_DEADLINE,
                                                        RoundDeadlineTimer, require_injectable)
from fedml_tpu_torch.distributed.fedavg_edge import device_call, host_array, release_wire

log = logging.getLogger(__name__)

# message_def.py:1-24
MSG_TYPE_S2C_INIT_CONFIG = 1
MSG_TYPE_S2C_SYNC_TO_CLIENT = 2
MSG_TYPE_C2S_SEND_FEATURE_AND_LOGITS = 3
MSG_TYPE_S2C_FINISH = 4

KEY_FEATURE = "feature"
KEY_LOGITS = "logits"
KEY_LABELS = "labels"
KEY_MASK = "mask"
KEY_FEATURE_TEST = "feature_test"
KEY_LABELS_TEST = "labels_test"
KEY_MASK_TEST = "mask_test"
KEY_GLOBAL_LOGITS = "global_logits"
KEY_ROUND = "round"

_TRAIN_KEYS = (KEY_FEATURE, KEY_LOGITS, KEY_LABELS, KEY_MASK)
_TEST_KEYS = (KEY_FEATURE_TEST, KEY_LABELS_TEST, KEY_MASK_TEST)


def _stack(values: list, device: torch.device, dtype=None) -> torch.Tensor:
    """Uploaded arrays or tensors, stacked on ``device``."""
    out = torch.stack([torch.as_tensor(np.array(v) if isinstance(v, np.ndarray) else v)
                       for v in values]).to(device)
    return out if dtype is None else out.to(dtype)


class GKTEdgeServerManager(ServerManager):
    """Collects the clients' features and logits, trains the server net on
    their union and returns fresh logits (the reference's
    GKTServerMananger)."""

    def __init__(self, args, comm, rank, size, api):
        super().__init__(args, comm, rank, size)
        self.api = api                      # FedGKTAPI: the programs and the state
        self.C = size - 1
        self.round_idx = 0
        self.round_num = int(args.comm_round)
        self._feat: dict[int, tuple] = {}
        self._test: dict[int, tuple] = {}
        self.history: list[dict] = []
        cfg = api.config
        self._deadline = getattr(cfg, "straggler_deadline_sec", None)
        self._deadline_timer = None
        if self._deadline is not None:
            require_injectable(comm)
            self._deadline_timer = RoundDeadlineTimer(comm, self._deadline, rank, KEY_ROUND)
        self._alive = {k: True for k in range(self.C)}
        self._last_feat: dict[int, tuple] = {}
        self._last_test: dict[int, tuple] = {}
        self._empty_deadlines = 0
        #: ``time.perf_counter()`` when the first round went out, and at each
        #: round's close: the rounds' walls
        self.t_start: Optional[float] = None
        self.round_closes: list[float] = []
        self._ckpt_path = None
        if getattr(cfg, "checkpoint_dir", None):
            os.makedirs(cfg.checkpoint_dir, exist_ok=True)
            self._ckpt_path = os.path.join(cfg.checkpoint_dir, "gkt_server.ckpt")
        self._ckpt_freq = int(getattr(cfg, "checkpoint_frequency", 10) or 10)
        resume = getattr(cfg, "resume_from", None)
        if resume:
            from fedml_tpu_torch.utils.checkpoint import load_checkpoint

            state = load_checkpoint(resume)
            device_call(self._restore, state["variables"])
            self.round_idx = int(state["round_idx"])
            self.history.extend(state["extra"].get("history", []))
            log.info("resumed GKT federation at round %d from %s", self.round_idx, resume)

    def _restore(self, t: dict) -> None:
        api = self.api
        api.server_vars = t["server_vars"]
        torch._foreach_copy_(api._sopt.tensors(), [v.to(api.device) for v in t["server_opt"]])
        api.server_logits.copy_(t["server_logits"])

    def run(self):
        self.register_message_receive_handlers()
        if self.round_idx >= self.round_num:        # resumed a finished run
            self._teardown()
            return
        self.t_start = time.perf_counter()
        self._send_logits(MSG_TYPE_S2C_INIT_CONFIG)
        self.com_manager.handle_receive_message()

    def _maybe_checkpoint(self):
        if self._ckpt_path is None:
            return
        if self.round_idx % self._ckpt_freq == 0 or self.round_idx >= self.round_num:
            from fedml_tpu_torch.utils.checkpoint import save_checkpoint

            api = self.api
            device_call(lambda: save_checkpoint(
                self._ckpt_path, {"server_vars": api.server_vars,
                                  "server_opt": api._sopt.tensors(),
                                  "server_logits": api.server_logits},
                round_idx=self.round_idx, extra={"history": list(self.history)}))

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_C2S_SEND_FEATURE_AND_LOGITS,
                                              self._on_features)
        self.register_message_receive_handler(MSG_TYPE_LOCAL_ROUND_DEADLINE, self._on_deadline)

    def _send_logits(self, msg_type: int):
        slogits = device_call(lambda: host_array(self.api.server_logits))
        for rank in range(1, self.size):
            if self._deadline is not None and not self._alive[rank - 1]:
                continue
            m = Message(msg_type, self.rank, rank)
            m.add_params(KEY_GLOBAL_LOGITS, slogits[rank - 1])
            m.add_params(KEY_ROUND, self.round_idx)
            try:
                self.send_message(m)
            except Exception as e:
                if self._deadline is None:
                    raise
                log.warning("GKT sync to client %d failed (%s); marking it dead", rank - 1, e)
                self._alive[rank - 1] = False
        if self._deadline_timer is not None:
            self._deadline_timer.arm(self.round_idx)

    def _on_deadline(self, msg: Message):
        if self._deadline is None or int(msg.get(KEY_ROUND)) != self.round_idx:
            return
        for k in range(self.C):
            if self._alive[k] and k not in self._feat:
                log.warning("GKT round %d: client %d missed the %.1fs deadline; marking it "
                            "dead", self.round_idx, k, self._deadline)
                self._alive[k] = False
        if self._feat:
            self._empty_deadlines = 0
            self._complete_round()
            return
        # nothing arrived, so every client is now marked dead: wait for a late
        # upload to revive one, a bounded number of times
        self._empty_deadlines += 1
        if self._empty_deadlines >= MAX_EMPTY_DEADLINES:
            log.error("GKT: all clients dead for %d deadlines; tearing down with %d/%d rounds "
                      "done", self._empty_deadlines, self.round_idx, self.round_num)
            self._teardown()
        else:
            self._deadline_timer.arm(self.round_idx)

    def _teardown(self):
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        for rank in range(1, self.size):
            try:
                self.send_message(Message(MSG_TYPE_S2C_FINISH, self.rank, rank))
            except Exception as e:
                if self._deadline is None:
                    raise
                log.warning("FINISH to client %d failed (%s)", rank - 1, e)
        self.finish()

    def _on_features(self, msg: Message):
        k = msg.get_sender_id() - 1
        rnd = int(msg.get(KEY_ROUND))
        if self._deadline is not None:
            self._empty_deadlines = 0
            if not self._alive.get(k, False):
                log.info("GKT client %d rejoined at round %d", k, self.round_idx)
                self._alive[k] = True
                if rnd != self.round_idx:
                    # a stale upload: catch the client up with this round's logits
                    m = Message(MSG_TYPE_S2C_SYNC_TO_CLIENT, self.rank, k + 1)
                    m.add_params(KEY_GLOBAL_LOGITS,
                                 device_call(lambda: host_array(self.api.server_logits[k])))
                    m.add_params(KEY_ROUND, self.round_idx)
                    try:
                        self.send_message(m)
                    except Exception as e:
                        log.warning("GKT catch-up to client %d failed (%s)", k, e)
                        self._alive[k] = False
                    return
            if rnd != self.round_idx:
                return                  # a stale upload of a closed round
        elif rnd != self.round_idx:
            raise RuntimeError(f"GKT features for round {rnd} arrived at the server in round "
                               f"{self.round_idx}")
        self._feat[k] = tuple(msg.get(key) for key in _TRAIN_KEYS)
        self._test[k] = tuple(msg.get(key) for key in _TEST_KEYS)
        expected = ({j for j in range(self.C) if self._alive[j]}
                    if self._deadline is not None else set(range(self.C)))
        if expected <= set(self._feat):
            self._complete_round()

    def _complete_round(self):
        if self._deadline_timer is not None:
            self._deadline_timer.cancel()
        received = sorted(self._feat)
        for k in received:
            self._last_feat[k] = self._feat[k]
            self._last_test[k] = self._test[k]
        record = device_call(self._server_round, received)
        self.round_closes.append(time.perf_counter())
        if record is not None:
            self.history.append(record)
            log.info("GKT-edge round %d: test acc %.4f", self.round_idx, record["Test/Acc"])
        self._feat.clear()
        self._test.clear()
        self.round_idx += 1
        self._maybe_checkpoint()
        if self.round_idx >= self.round_num:
            self._teardown()
        else:
            self._send_logits(MSG_TYPE_S2C_SYNC_TO_CLIENT)

    def _server_round(self, received: list) -> Optional[dict]:
        api, dev = self.api, self.api.device
        template = self._feat[received[0]]

        def slot(k):
            """A missing client's slot: its last features under a zero mask
            (no training contribution), or zeros if it never uploaded; the
            union keeps its [C, ...] shape either way."""
            if k in self._feat:
                return self._feat[k]
            if k in self._last_feat:
                f, lg, y, m = self._last_feat[k]
                return f, lg, y, np.zeros_like(np.asarray(m))
            return tuple(torch.zeros_like(torch.as_tensor(t)) for t in template)

        slots = [slot(k) for k in range(self.C)]
        feats, clogits, ys, masks = (_stack([s[j] for s in slots], dev) for j in range(4))
        old = None if len(received) == self.C else api.server_logits.clone()
        sloss = api.server_phase(self.round_idx, feats.to(api._feats.dtype), ys, masks, clogits)
        if old is not None:
            # a missing client keeps its logits: its slot held stale or no data
            keep = [k for k in range(self.C) if k not in received]
            api.server_logits[keep] = old[keep]
        cfg = api.config
        if not (self.round_idx % cfg.frequency_of_the_test == 0
                or self.round_idx == self.round_num - 1):
            return None
        sums = {"correct": 0.0, "loss_sum": 0.0, "count": 0.0}
        sm = api.pair.server.module
        sm.eval()
        with torch.no_grad():
            for k in range(self.C):
                got = self._test.get(k) or self._last_test.get(k)
                if got is None:
                    continue
                tf, ty, tm = (_stack([v], dev)[0] for v in got)
                logits = sm(tf.to(api._feats.dtype))
                m = tm.to(torch.float32)
                sums["correct"] += float(((logits.argmax(-1) == ty.long()).float() * m).sum())
                sums["loss_sum"] += float((int_cross_entropy(logits, ty) * m).sum())
                sums["count"] += float(m.sum())
        count = max(sums["count"], 1.0)
        return {"round": self.round_idx, "Test/Acc": sums["correct"] / count,
                "Test/Loss": sums["loss_sum"] / count, "Train/ServerLoss": float(sloss)}


class GKTEdgeClientManager(ClientManager):
    """Trains its small net with distillation, extracts and uploads its
    features and logits (the reference's GKTClientMananger)."""

    def __init__(self, args, comm, rank, size, *, api, state, x, y, mask, count, test_x,
                 test_y, test_mask, state_path=None, resume=False, state_every=10):
        super().__init__(args, comm, rank, size)
        self.api = api
        self.k = rank - 1
        # the client's own state: its net's state-dict tensors, then its
        # optimizer's (FedGKTAPI._client_tensors() order)
        self.state = state
        self.x, self.y, self.mask, self.count = x, y, mask, int(count)
        self.test_x, self.test_y, self.test_mask = test_x, test_y, test_mask
        self._clogits = torch.empty_like(api._clogits[self.k])
        self._feats = torch.empty_like(api._feats[self.k])
        # a GKT client owns its net (FedAvg's workers get the model at every
        # sync), so a resume restores it from its own file
        self._state_path = state_path
        self._state_every = max(int(state_every), 1)
        self._state_round: Optional[int] = None
        self._init_state = [t.clone() for t in state]
        if resume and state_path is not None and os.path.exists(state_path):
            from fedml_tpu_torch.core.serialization import tree_from_bytes

            with open(state_path, "rb") as f:
                st = tree_from_bytes(f.read())
            device_call(lambda: torch._foreach_copy_(self.state,
                                                     [t.to(api.device) for t in st["state"]]))
            self._state_round = int(np.asarray(st["round"]).item())
            log.info("GKT client %d resumed its state for round %d", self.k, self._state_round)

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_S2C_INIT_CONFIG, self._on_sync)
        self.register_message_receive_handler(MSG_TYPE_S2C_SYNC_TO_CLIENT, self._on_sync)
        self.register_message_receive_handler(MSG_TYPE_S2C_FINISH, lambda m: self.finish())

    def _on_sync(self, msg: Message):
        rnd = int(msg.get(KEY_ROUND))
        if self._state_round is not None:
            # a future-tagged state (the server resumed from an older
            # checkpoint) is dropped; a past one is a straggler's, which the
            # uninterrupted run would rejoin with, so it stays
            if self._state_round > rnd:
                log.warning("GKT client %d: resumed state targets future round %d but the "
                            "federation is at round %d; discarding it", self.k,
                            self._state_round, rnd)
                device_call(torch._foreach_copy_, self.state, self._init_state)
            self._state_round = None
        feats, logits, tfeats = device_call(self._train, rnd, msg.get(KEY_GLOBAL_LOGITS))
        out = Message(MSG_TYPE_C2S_SEND_FEATURE_AND_LOGITS, self.rank, 0)
        out.add_params(KEY_FEATURE, feats)
        out.add_params(KEY_LOGITS, logits)
        out.add_params(KEY_LABELS, np.asarray(self.api.dataset.train_y[self.k]))
        out.add_params(KEY_MASK, np.asarray(self.api.dataset.train_mask[self.k]))
        out.add_params(KEY_FEATURE_TEST, tfeats)
        out.add_params(KEY_LABELS_TEST, self.test_y)
        out.add_params(KEY_MASK_TEST, self.test_mask)
        out.add_params(KEY_ROUND, rnd)
        self.send_message(out)
        # the state is written only at the server's checkpoint rounds, so the
        # files on disk always pair with a server checkpoint
        if self._state_path is not None and ((rnd + 1) % self._state_every == 0
                                             or rnd + 1 >= int(self.args.comm_round)):
            from fedml_tpu_torch.core.serialization import tree_to_bytes

            blob = device_call(lambda: tree_to_bytes({"state": list(self.state),
                                                      "round": np.int64(rnd + 1)}))
            tmp = self._state_path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, self._state_path)

    def _train(self, rnd: int, slogits) -> tuple:
        """Load the client's state, run its step, extract its test features,
        store the state back; the uploads on the host (features as CPU
        tensors in the net's dtype)."""
        api = self.api
        with torch.no_grad():
            torch._foreach_copy_(api._client_tensors(), self.state)
        teacher = torch.from_numpy(np.array(slogits)).to(api.device)
        api.train_client(rnd, self.k, self.x, self.y, self.mask, self.count, teacher,
                         self._clogits, self._feats)
        cm = api.pair.client.module
        cm.eval()
        with torch.no_grad():
            tfeats = cm(self.test_x)[1]
            torch._foreach_copy_(self.state, api._client_tensors())
        return self._feats.cpu(), host_array(self._clogits), tfeats.cpu()


def run_fedgkt_edge(dataset, config, pair=None, client_blocks=None,
                    server_blocks_per_stage=None, wire_roundtrip: bool = True,
                    comm_factory=None, device: Optional[Union[str, torch.device]] = None,
                    api=None) -> GKTEdgeServerManager:
    """The server and one manager per client on threads over the local
    transport (or ``comm_factory``'s, e.g. gRPC loopback), the whole
    feature and logit federation; returns the server manager (``history``,
    the trained server net through ``.api``). A ``FedGKTAPI`` of
    ``dataset``, ``config`` and ``pair`` is the program and state host
    (``api`` passes one made by the caller, with its order hooks), so the
    edge shares the simulation's init and compute. ``config.wire_codec``
    compresses the payloads (``q8`` suits the soft-logit exchange) and the
    reliable and chaos layers it asks for stack over every rank's
    transport. Runs on the GPU unless ``device`` says otherwise."""
    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
    from fedml_tpu_torch.comm.reliable import wire_wrap_factory

    check_ported(config)
    codec = getattr(config, "wire_codec", "raw")
    if codec.startswith("topk"):
        # topk compresses deltas whose unsent mass an error-feedback residual
        # keeps (the FedAvg edge's uploads); GKT's payloads are full features
        # and logits, which sparsifying would silently corrupt
        raise ValueError("wire_codec='topk:..' is only valid for delta uploads (fedavg_edge with "
                         "wire_delta); fedgkt_edge exchanges full feature/logit payloads: use "
                         "'q8' or 'raw'")
    if api is None:
        api = device_call(FedGKTAPI, dataset, config, pair=pair, client_blocks=client_blocks,
                          server_blocks_per_stage=server_blocks_per_stage, device=device)
    tx_, ty_, tm_ = api._build_test_shards()
    size = api.C + 1
    args = types.SimpleNamespace(comm_round=config.comm_round)
    resume_from = getattr(config, "resume_from", None)
    ckpt_dir = getattr(config, "checkpoint_dir", None)
    if ckpt_dir is None and resume_from:
        # resuming without writing new checkpoints: the clients' states lie
        # next to the server checkpoint
        ckpt_dir = os.path.dirname(os.path.abspath(resume_from))
    ckpt_freq = int(getattr(config, "checkpoint_frequency", 10) or 10)

    def client_inputs(k: int) -> dict:
        return dict(
            state=[v[k].clone() for v in api.client_vars.values()]
            + [t[k].clone() for t in api.client_opt],
            x=api._x[k], y=api._y[k], mask=api._mask[k],
            count=int(dataset.train_counts[k]),
            test_x=torch.from_numpy(np.ascontiguousarray(tx_[k])).to(api.device))

    def make(rank, comm):
        if rank == 0:
            return GKTEdgeServerManager(args, comm, rank, size, api)
        k = rank - 1
        return GKTEdgeClientManager(
            args, comm, rank, size, api=api, **device_call(client_inputs, k),
            test_y=np.asarray(ty_[k]), test_mask=np.asarray(tm_[k]),
            state_path=os.path.join(ckpt_dir, f"gkt_client_{k}.state") if ckpt_dir else None,
            resume=bool(resume_from), state_every=ckpt_freq)

    wrap = wire_wrap_factory(config)
    managers = run_ranks(make, size, wire_roundtrip=wire_roundtrip, comm_factory=comm_factory,
                         codec=codec, wrap=wrap, inbox_cap=config.wire_inbox_cap)
    if wrap is not None:
        release_wire([m.com_manager for m in managers])
    return managers[0]
