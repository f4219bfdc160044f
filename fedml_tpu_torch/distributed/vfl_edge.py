"""Message-driven vertical FL: the guest/host exchange over the edge
transport (counterpart of ``fedml_tpu/distributed/vfl_edge.py``; the
reference's fedml_api/distributed/classical_vertical_fl/ vfl_api.py:16-42,
guest_manager.py, host_manager.py).

The parties of the in-process protocol (``algorithms/vfl.py``'s
``VFLGuestParty`` and ``VFLHostParty``) run inside the manager runtimes,
one rank each: per batch the guest sends the row indices, each host answers
with its [B, 1] logit component, the guest fuses them, steps and returns
the common gradient [B, 1]. Raw features never leave a party. The guest
drives ``VFLAPI.fit``'s schedule (an epoch-wise permutation from numpy's
``default_rng(seed)``), the parties start from ``build_protocol_vfl``'s
init of the seed, the components are summed in host-rank order and the
wire carries host numpy exactly, so the edge run equals the in-process
protocol bit for bit. The guest's messages to a host form one sequence,
which the host handles in the guest's order (``base_framework.
OrderedStream``): a wire that resends a dropped gradient behind the next
batch would otherwise change the host's component.

Device work (each party's compute) runs on the edge runtime's one device
thread (``fedavg_edge.device_call``).

VFL keeps the strict barrier: each party owns a disjoint feature slice, so
every forward needs every party, and ``straggler_deadline_sec`` is warned
about and ignored. Checkpoints are taken at epoch ends: the guest's
``vfl_guest.ckpt`` (its parameters, optimizer state, epoch and losses) and
each host's ``vfl_host_{rank}.state`` (its own, tagged with the guest's
epoch, so a resume from a torn set fails loudly).
"""

from __future__ import annotations

import os
import types
from typing import Optional, Union

import numpy as np
import torch

from fedml_tpu_torch import default_device
from fedml_tpu_torch.algorithms.vfl import (VFLGuestParty, VFLHostParty, bce_with_logits,
                                            init_party_params, party_component)
from fedml_tpu_torch.comm import ClientManager, Message, ServerManager
from fedml_tpu_torch.comm.local import run_ranks
from fedml_tpu_torch.core.rng import init_generator
from fedml_tpu_torch.distributed.base_framework import OrderedStream
from fedml_tpu_torch.distributed.fedavg_edge import device_call, device_tensor, host_array

MSG_TYPE_G2H_BATCH = "vfl_batch"       # guest -> host: row indices
MSG_TYPE_H2G_COMPONENT = "vfl_comp"    # host -> guest: logit component
MSG_TYPE_G2H_GRAD = "vfl_grad"         # guest -> host: common gradient
MSG_TYPE_G2H_EVAL = "vfl_eval"         # guest -> host: test components request
MSG_TYPE_H2G_EVAL_COMP = "vfl_eval_comp"
MSG_TYPE_G2H_FINISH = "vfl_finish"
MSG_TYPE_G2H_CKPT = "vfl_ckpt"         # guest -> host: persist party state now

KEY_IDX = "idx"
KEY_U = "u"
KEY_STEP = "step"
KEY_EPOCH = "epoch"


def tree_to(tree, device: torch.device):
    """A tree of dicts, tuples and lists with its tensors and arrays as
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, device) for v in tree)
    return torch.as_tensor(tree).to(device)


class VFLHostManager(ClientManager):
    """A host party's runtime (the reference's host_manager.py): holds its
    feature slice and a ``VFLHostParty``, answers batches with components
    and learns from the common gradient."""

    def __init__(self, args, comm, rank, size, party: VFLHostParty, x_train, x_test,
                 state_path=None, resume=False):
        super().__init__(args, comm, rank, size)
        self.party = party
        self.device = party.params["local_w"].device
        self._stream = OrderedStream()
        self.x_train = np.asarray(x_train)
        self.x_test = np.asarray(x_test)
        # a host owns its slice's model (raw parameters never travel), so a
        # resume restores it from its own file
        self._state_path = state_path
        # the guest epoch the restored state belongs to, checked against the
        # guest's on the first batch
        self._resumed_epoch: Optional[int] = None
        if resume and state_path is not None and os.path.exists(state_path):
            from fedml_tpu_torch.core.serialization import tree_from_bytes

            with open(state_path, "rb") as f:
                st = tree_from_bytes(f.read())
            self.party.params = device_call(tree_to, st["params"], self.device)
            self.party.opt_state = device_call(tree_to, st["opt"], self.device)
            if "epoch" in st:
                self._resumed_epoch = int(np.asarray(st["epoch"]).item())

    def register_message_receive_handlers(self):
        # the guest's messages form one sequence (batch, gradient, ..., eval),
        # handled in the guest's order whatever order the wire delivers
        for msg_type, handler in ((MSG_TYPE_G2H_BATCH, self._on_batch),
                                  (MSG_TYPE_G2H_GRAD, self._on_grad),
                                  (MSG_TYPE_G2H_EVAL, self._on_eval),
                                  (MSG_TYPE_G2H_CKPT, self._on_ckpt),
                                  (MSG_TYPE_G2H_FINISH, lambda m: self.finish())):
            self.register_message_receive_handler(msg_type, self._stream.wrap(handler))

    def _on_ckpt(self, msg: Message):
        if self._state_path is None:
            return
        from fedml_tpu_torch.core.serialization import tree_to_bytes

        blob = device_call(lambda: tree_to_bytes({
            "params": self.party.params, "opt": self.party.opt_state,
            "epoch": np.int64(msg.get(KEY_EPOCH, -1))}))
        tmp = self._state_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._state_path)

    def _on_batch(self, msg: Message):
        if self._resumed_epoch is not None:
            guest_epoch = msg.get(KEY_EPOCH)
            if guest_epoch is not None and int(guest_epoch) != self._resumed_epoch:
                raise RuntimeError(
                    f"VFL resume inconsistency: host rank {self.rank} restored party state "
                    f"from epoch {self._resumed_epoch} but the guest resumed at epoch "
                    f"{int(guest_epoch)}; the parties' checkpoints are from different "
                    "training points (a crash between the guest's save and a host's "
                    "persist?): restore a matching set or restart from scratch")
            self._resumed_epoch = None
        idx = np.asarray(msg.get(KEY_IDX), np.int64)
        out = Message(MSG_TYPE_H2G_COMPONENT, self.rank, 0)
        out.add_params(KEY_STEP, msg.get(KEY_STEP))
        out.add_params(KEY_U, device_call(self._component, self.x_train[idx]))
        self.send_message(out)

    def _component(self, x) -> np.ndarray:
        self.party.set_batch(x)
        return host_array(self.party.send_components())

    def _on_grad(self, msg: Message):
        device_call(lambda g: self.party.receive_gradients(device_tensor(g, self.device)),
                    msg.get(KEY_U))

    def _on_eval(self, msg: Message):
        out = Message(MSG_TYPE_H2G_EVAL_COMP, self.rank, 0)
        out.add_params(KEY_U, device_call(lambda: host_array(self.party.predict(self.x_test))))
        self.send_message(out)


class VFLGuestManager(ServerManager):
    """The guest party's runtime and the batch schedule's owner (the reference's
    guest_manager.py and vfl_api.py:16-42): owns the labels, fuses the
    components, sends the common gradient, drives ``VFLAPI.fit``'s
    epoch and batch schedule, and evaluates at the end."""

    def __init__(self, args, comm, rank, size, party: VFLGuestParty, dataset, ckpt_path=None,
                 resume_from=None):
        super().__init__(args, comm, rank, size)
        self.party = party
        self.device = party.params["local_w"].device
        self._stream = OrderedStream()
        self.dataset = dataset
        n = len(dataset.train_y)
        self.bs = min(int(args.batch_size), n)
        self.steps = n // self.bs
        self.epochs = int(args.epochs)
        self._order_rng = np.random.default_rng(args.seed)
        self.epoch = 0
        self.step = 0
        self._ckpt_path = ckpt_path
        self.losses: list[float] = []
        if resume_from:
            from fedml_tpu_torch.utils.checkpoint import load_checkpoint

            state = load_checkpoint(resume_from)
            self.party.params = device_call(tree_to, state["variables"]["params"], self.device)
            self.party.opt_state = device_call(tree_to, state["variables"]["opt"], self.device)
            self.epoch = int(state["round_idx"])
            self.losses = list(state["extra"].get("losses", []))
            # the permutation stream is stateful: skip the completed epochs'
            # draws, so the resumed order is the uninterrupted run's
            for _ in range(self.epoch):
                self._order_rng.permutation(n)
        self._components: dict[int, np.ndarray] = {}
        self._eval_components: dict[int, np.ndarray] = {}
        self.history: list[dict] = []

    def run(self):
        self.register_message_receive_handlers()
        if self.epoch >= self.epochs:           # resumed a finished run: evaluate only
            for rank in range(1, self.size):
                self.send_message(Message(MSG_TYPE_G2H_EVAL, self.rank, rank))
            self.com_manager.handle_receive_message()
            return
        self._next_epoch_order()
        self._send_batch()
        self.com_manager.handle_receive_message()

    def send_message(self, message: Message) -> None:
        super().send_message(self._stream.stamp(message))

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_H2G_COMPONENT, self._on_component)
        self.register_message_receive_handler(MSG_TYPE_H2G_EVAL_COMP, self._on_eval_component)

    def _next_epoch_order(self):
        n = len(self.dataset.train_y)
        self._order = self._order_rng.permutation(n)[: self.steps * self.bs] \
            .reshape(self.steps, self.bs)
        self._epoch_losses: list[float] = []

    def _send_batch(self):
        idx = self._order[self.step]
        device_call(self.party.set_batch, self.dataset.train_parts[0][idx],
                    self.dataset.train_y[idx])
        for rank in range(1, self.size):
            m = Message(MSG_TYPE_G2H_BATCH, self.rank, rank)
            m.add_params(KEY_STEP, self.step)
            m.add_params(KEY_EPOCH, self.epoch)
            m.add_params(KEY_IDX, idx.astype(np.int64))
            self.send_message(m)

    def _fit(self) -> np.ndarray:
        # the hosts in rank order: the same float sum as the in-process form
        self.party.receive_components([device_tensor(self._components[r], self.device)
                                       for r in range(1, self.size)])
        self.party.fit()
        return host_array(self.party.send_gradients())

    def _on_component(self, msg: Message):
        if int(msg.get(KEY_STEP)) != self.step:
            raise RuntimeError(f"VFL component for step {msg.get(KEY_STEP)} arrived at the "
                               f"guest in step {self.step}")
        self._components[msg.get_sender_id()] = np.asarray(msg.get(KEY_U))
        if len(self._components) < self.size - 1:
            return
        common = device_call(self._fit)
        self._components.clear()
        self._epoch_losses.append(self.party.loss)
        for rank in range(1, self.size):
            m = Message(MSG_TYPE_G2H_GRAD, self.rank, rank)
            m.add_params(KEY_U, common)
            self.send_message(m)
        self.step += 1
        if self.step < self.steps:
            self._send_batch()
            return
        self.losses.append(float(np.mean(self._epoch_losses)))
        self.epoch += 1
        self.step = 0
        self._maybe_checkpoint()
        if self.epoch < self.epochs:
            self._next_epoch_order()
            self._send_batch()
            return
        for rank in range(1, self.size):      # training done: the distributed evaluation
            self.send_message(Message(MSG_TYPE_G2H_EVAL, self.rank, rank))

    def _maybe_checkpoint(self):
        if self._ckpt_path is None:
            return
        from fedml_tpu_torch.utils.checkpoint import save_checkpoint

        for rank in range(1, self.size):
            m = Message(MSG_TYPE_G2H_CKPT, self.rank, rank)
            # each host's file records the guest epoch it pairs with
            m.add_params(KEY_EPOCH, self.epoch)
            self.send_message(m)
        device_call(save_checkpoint, self._ckpt_path,
                    {"params": self.party.params, "opt": self.party.opt_state},
                    round_idx=self.epoch, extra={"losses": list(self.losses)})

    def _evaluate(self) -> dict:
        d = self.dataset
        x = torch.from_numpy(np.ascontiguousarray(d.test_parts[0])).to(self.device)
        with torch.no_grad():
            u = host_array(party_component(self.party.params, x))
        u = u + sum(self._eval_components[r] for r in range(1, self.size))
        pred = (u[:, 0] > 0).astype(np.float32)
        loss = bce_with_logits(torch.from_numpy(u[:, 0]), torch.from_numpy(np.asarray(d.test_y)))
        return {"Train/Loss": self.losses[-1], "Test/Acc": float((pred == d.test_y).mean()),
                "Test/Loss": float(loss)}

    def _on_eval_component(self, msg: Message):
        self._eval_components[msg.get_sender_id()] = np.asarray(msg.get(KEY_U))
        if len(self._eval_components) < self.size - 1:
            return
        self.history.append(device_call(self._evaluate))
        for rank in range(1, self.size):
            self.send_message(Message(MSG_TYPE_G2H_FINISH, self.rank, rank))
        self.finish()


def init_parties(dataset, hidden_dim: int, lr: float, seed: int,
                 device: torch.device) -> tuple:
    """(guest, {rank: host}) from ``build_protocol_vfl``'s init of ``seed``."""
    params = [init_party_params(init_generator(seed, 3, p), d, hidden_dim, p == 0, device)
              for p, d in enumerate(dataset.party_dims)]
    return (VFLGuestParty(params[0], lr),
            {p: VFLHostParty(params[p], lr) for p in range(1, dataset.num_parties)})


def run_vfl_edge(dataset, hidden_dim: int = 16, lr: float = 0.01, batch_size: int = 64,
                 epochs: int = 10, seed: int = 0, wire_roundtrip: bool = True,
                 comm_factory=None, straggler_deadline_sec=None, checkpoint_dir=None,
                 resume: bool = False, config=None,
                 device: Optional[Union[str, torch.device]] = None) -> VFLGuestManager:
    """The guest (rank 0) and one host per other party on threads over the
    local transport (or ``comm_factory``'s). The init is
    ``build_protocol_vfl(seed)``'s and the schedule ``VFLAPI.fit(epochs,
    seed)``'s. Returns the guest manager: the parties hold the final
    parameters, ``history[-1]`` the final metrics. ``config`` (a
    FedConfig) stacks the reliable and chaos layers it asks for over every
    rank's transport: with no deadline fallback, a lossy wire must be
    recovered by retransmission. Runs on the GPU unless ``device`` says
    otherwise."""
    from fedml_tpu_torch.comm.reliable import wire_wrap_factory
    from fedml_tpu_torch.distributed.base_framework import warn_strict_barrier
    from fedml_tpu_torch.distributed.fedavg_edge import release_wire

    warn_strict_barrier(types.SimpleNamespace(straggler_deadline_sec=straggler_deadline_sec),
                        __name__)
    dev = default_device(device)
    guest, hosts = device_call(init_parties, dataset, hidden_dim, lr, seed, dev)
    size = dataset.num_parties
    args = types.SimpleNamespace(batch_size=batch_size, epochs=epochs, seed=seed)
    guest_ckpt = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        guest_ckpt = os.path.join(checkpoint_dir, "vfl_guest.ckpt")

    def make(rank, comm):
        if rank == 0:
            return VFLGuestManager(args, comm, rank, size, guest, dataset, ckpt_path=guest_ckpt,
                                   resume_from=guest_ckpt if (resume and guest_ckpt) else None)
        state = (os.path.join(checkpoint_dir, f"vfl_host_{rank}.state")
                 if checkpoint_dir is not None else None)
        return VFLHostManager(args, comm, rank, size, hosts[rank], dataset.train_parts[rank],
                              dataset.test_parts[rank], state_path=state, resume=resume)

    kw, wrap = {}, None
    if config is not None:
        from fedml_tpu_torch.core.config import check_ported

        check_ported(config)
        wrap = wire_wrap_factory(config)
        kw = dict(inbox_cap=config.wire_inbox_cap, wrap=wrap)
    managers = run_ranks(make, size, wire_roundtrip=wire_roundtrip, comm_factory=comm_factory,
                         **kw)
    if wrap is not None:
        release_wire([m.com_manager for m in managers])
    return managers[0]
