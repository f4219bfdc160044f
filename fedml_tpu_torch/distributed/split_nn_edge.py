"""Message-driven SplitNN for remote clients (counterpart of
``fedml_tpu/distributed/split_nn_edge.py``; the reference's
fedml_api/distributed/split_nn/: message_define.py:1-25,
client_manager.py:17-87, server_manager.py:16-46).

The per-batch protocol: a client sends its cut activations, labels and
mask (MSG 2), the server trains its stage on them and sends back the
activations' gradient (MSG 1); validation mode and its end are signalled
(MSG 3, 4); the relay token passes client to client (MSG 6); the last
client ends the protocol (MSG 5). A client's epoch walks its batches in
order, the trailing partial batch with its padding rows masked out. The
server handles each client's messages in the client's order
(``base_framework.OrderedStream``) and, in the strict ring, a client's only
once the previous client's turn has ended there: a wire that resends a
dropped message late would otherwise have the server train on validation
activations or validate a next client's batches.

The reference keeps the autograd tape across the wire; as in the JAX
package, a client recomputes its stage's forward when the gradient arrives
and backpropagates it then (one extra client-stage forward, no state held
between messages). Both of the client's passes run in eval mode, so the
gradient is that of the activations it sent; a stage with dropout or
BatchNorm belongs to ``algorithms/split_nn.py``'s fused step. Each client
holds its own lower-stage state dict and runs it through the client
bundle's one module (``functional_call``); the server stage trains in its
bundle's module. Both stages step eagerly, on the edge runtime's one
device thread (``fedavg_edge.device_call``). The initial weights are
``algorithms/split_nn.SplitNNAPI``'s draws (:func:`init_stages`).

With ``straggler_deadline_sec`` the server owns the ring (no reference
counterpart: its ring stalls on a dead client): a client reports the end
of its turn (MSG 7) instead of passing the token, a client that sends no
activations within the deadline is marked dead and the ring re-forms
around it, and the server's FINISHED (MSG 8) ends every rank. In that mode
``max_turns`` stops the ring after k turns and ``checkpoint_dir`` /
``resume_from`` save the server stage, its optimizer state, the ring
position and the validation history at each turn's end, so a resumed ring
goes on at the next position.
"""

from __future__ import annotations

import logging
import os
import types
from typing import Optional, Union

import numpy as np
import torch
from torch.func import functional_call

from fedml_tpu_torch import default_device
from fedml_tpu_torch.comm import ClientManager, Message, ServerManager
from fedml_tpu_torch.comm.local import run_ranks
from fedml_tpu_torch.core.config import check_ported
from fedml_tpu_torch.core.rng import init_generator
from fedml_tpu_torch.core.tasks import get_task
from fedml_tpu_torch.distributed.base_framework import (MSG_TYPE_LOCAL_ROUND_DEADLINE,
                                                        OrderedStream, RoundDeadlineTimer,
                                                        require_injectable)
from fedml_tpu_torch.distributed.fedavg_edge import device_call, device_tensor, release_wire
from fedml_tpu_torch.parallel.local import make_optimizer

log = logging.getLogger(__name__)

# message_define.py:1-25
MSG_TYPE_S2C_GRADS = 1
MSG_TYPE_C2S_SEND_ACTS = 2
MSG_TYPE_C2S_VALIDATION_MODE = 3
MSG_TYPE_C2S_VALIDATION_OVER = 4
MSG_TYPE_C2S_PROTOCOL_FINISHED = 5
MSG_TYPE_C2C_SEMAPHORE = 6
# the server-managed ring's additions
MSG_TYPE_C2S_TURN_DONE = 7
MSG_TYPE_S2C_FINISHED = 8

MSG_ARG_KEY_ACTS = "activations"
MSG_ARG_KEY_LABELS = "labels"
MSG_ARG_KEY_MASK = "mask"
MSG_ARG_KEY_GRADS = "activation_grads"
#: on a VALIDATION_OVER, whether it ends its client's turn
MSG_ARG_KEY_TURN_END = "turn_end"


class SplitNNClientTrainer:
    """A client's stage (the reference's split_nn/client.py:4-42): its own
    state dict and optimizer state over the client bundle's module."""

    def __init__(self, client_bundle, config, x, y, mask, n_batches, test_x, test_y,
                 device: Optional[Union[str, torch.device]] = None):
        self.bundle = client_bundle
        self.device = default_device(device)
        self.variables: Optional[dict] = None       # set by init()
        self.tx = make_optimizer(config.client_optimizer, config.lr, config.momentum, config.wd)
        self.opt_state = None
        self.x, self.y, self.mask = x, y, mask
        self.test_x, self.test_y = test_x, test_y
        self.n_batches = int(n_batches)
        self.batch_size = config.batch_size
        self.batch_idx = 0
        self.phase = "train"
        self._last_x: Optional[torch.Tensor] = None
        self._params = [k for k, _ in client_bundle.module.named_parameters()]

    def init(self, variables: dict) -> None:
        self.variables = variables
        self.opt_state = self.tx.init([variables[k] for k in self._params])

    def train_mode(self):
        self.phase = "train"
        self.batch_idx = 0

    def eval_mode(self):
        self.phase = "validation"
        self.batch_idx = 0

    @property
    def n_eval_batches(self) -> int:
        return self.test_x.shape[0] // self.batch_size

    def forward_pass(self) -> tuple:
        bs = self.batch_size
        if self.phase == "train":
            i = self.batch_idx % self.n_batches
            bx, by = self.x[i * bs:(i + 1) * bs], self.y[i * bs:(i + 1) * bs]
            bm = self.mask[i * bs:(i + 1) * bs]
        else:
            i = self.batch_idx % max(self.n_eval_batches, 1)
            bx, by = self.test_x[i * bs:(i + 1) * bs], self.test_y[i * bs:(i + 1) * bs]
            bm = np.ones((bx.shape[0],), np.float32)   # the eval rows are all real
        self.batch_idx += 1
        acts = device_call(self._fwd, bx)
        return acts, np.asarray(by), np.asarray(bm, np.float32)

    @torch.no_grad()
    def _fwd(self, bx) -> np.ndarray:
        self._last_x = device_tensor(bx, self.device)
        return self.bundle.apply_eval(self.variables, self._last_x).cpu().numpy()

    def backward_pass(self, grads) -> None:
        device_call(self._bwd, grads)

    def _bwd(self, grads) -> None:
        leaves = {k: self.variables[k].detach().requires_grad_(True) for k in self._params}
        module = self.bundle.module
        module.eval()
        acts = functional_call(module, {**self.variables, **leaves}, (self._last_x,))
        g = torch.autograd.grad(acts, list(leaves.values()), device_tensor(grads, self.device))
        params = [self.variables[k] for k in self._params]
        updates, _ = self.tx.update(list(g), self.opt_state, params)
        with torch.no_grad():
            torch._foreach_add_(params, updates)


class SplitNNServerTrainer:
    """The server's stage (the reference's split_nn/server.py:7-73): the
    server bundle's module holds its state."""

    def __init__(self, server_bundle, config, task, max_rank: int,
                 device: Optional[Union[str, torch.device]] = None):
        self.bundle = server_bundle
        self.task = task
        self.device = default_device(device)
        self.tx = make_optimizer(config.client_optimizer, config.lr, config.momentum, config.wd)
        self.opt = None
        self.MAX_RANK = max_rank
        self.active_node = 1
        self.phase = "train"
        self.epoch = 0
        self.total = 0.0
        self.correct = 0.0
        self.val_history: list[float] = []

    def init(self, variables: dict) -> None:
        self.variables = variables
        self.opt = self.tx(self.bundle.module.parameters())
        self.opt.zero_grad(set_to_none=False)

    @property
    def variables(self) -> dict:
        """A copy of the server stage's state dict (its module holds it)."""
        return {k: v.detach().clone() for k, v in self.bundle.module.state_dict().items()}

    @variables.setter
    def variables(self, state: dict) -> None:
        with torch.no_grad():
            self.bundle.module.load_state_dict(state)

    @property
    def opt_state(self) -> list:
        return self.opt.tensors()

    @opt_state.setter
    def opt_state(self, tensors: list) -> None:
        torch._foreach_copy_(self.opt.tensors(), [t.to(self.device) for t in tensors])

    def train_mode(self):
        self.phase = "train"
        self.total = self.correct = 0.0

    def eval_mode(self):
        self.phase = "validation"
        self.total = self.correct = 0.0

    def forward_backward(self, acts, labels, mask) -> Optional[np.ndarray]:
        g, total, correct = device_call(self._forward_backward, acts, labels, mask)
        self.total += total
        self.correct += correct
        return g

    def _forward_backward(self, acts, labels, mask) -> tuple:
        dev, module = self.device, self.bundle.module
        a, y, m = (device_tensor(v, dev) for v in (acts, labels, mask))
        if self.phase != "train":
            with torch.no_grad():
                logits = self.bundle.apply_eval(module, a)
            correct = ((logits.argmax(-1) == y.long()) * m).sum()
            return None, float(m.sum()), float(correct)
        module.train()
        self.opt.zero_grad(set_to_none=False)
        a.requires_grad_(True)
        logits = module(a)
        self.task.loss(logits, y, m).backward()
        self.opt.step()
        correct = ((logits.detach().argmax(-1) == y.long()) * m).sum()
        return a.grad.cpu().numpy(), float(m.sum()), float(correct)

    def validation_over(self):
        acc = self.correct / max(self.total, 1.0)
        self.val_history.append(acc)
        log.info("splitnn_edge epoch %d val_acc %.4f", self.epoch, acc)
        self.epoch += 1
        self.active_node = (self.active_node % self.MAX_RANK) + 1
        self.train_mode()


class SplitNNEdgeServerManager(ServerManager):
    """Strict mode: a passive compute peer (the reference's shape). Managed
    mode (``deadline`` set): the server owns the relay ring, clients report
    TURN_DONE, and a client that sends no activations within the deadline
    is marked dead and skipped."""

    def __init__(self, args, comm, rank, size, trainer: SplitNNServerTrainer,
                 deadline: Optional[float] = None, max_turns: Optional[int] = None):
        super().__init__(args, comm, rank, size)
        self.trainer = trainer
        self.deadline = deadline
        self._alive = {r: True for r in range(1, size)}
        trainer.ring_alive = self._alive      # surfaced on the returned trainer
        self._ring = list(range(1, size))
        self._pos = -1
        self._activity = 0
        self._timer = None
        #: stop (checkpointing) after k turns
        self._max_turns = max_turns
        self._turns_done = 0
        # the clients' messages in their order, and in strict mode the
        # turn-holder's only (``_gate``)
        self._stream = OrderedStream()
        self._holder = 1
        self._pending: dict[int, list] = {}
        # the server's state is its stage, its optimizer state, the ring
        # position and the validation history; a client's stage stays with
        # it (one turn each: a finished client's weights are not needed)
        self._ckpt_path = None
        if getattr(args, "checkpoint_dir", None):
            os.makedirs(args.checkpoint_dir, exist_ok=True)
            self._ckpt_path = os.path.join(args.checkpoint_dir, "splitnn_server.ckpt")
        resume = getattr(args, "resume_from", None)
        if resume:
            from fedml_tpu_torch.utils.checkpoint import load_checkpoint

            state = load_checkpoint(resume)

            def restore():
                trainer.variables = state["variables"]["vars"]
                trainer.opt_state = state["variables"]["opt"]

            device_call(restore)
            self._pos = int(state["round_idx"])
            trainer.epoch = int(state["extra"]["epoch"])
            trainer.val_history.extend(state["extra"]["val_history"])
            log.info("splitnn ring resumed after position %d", self._pos)
        if deadline is not None:
            require_injectable(comm)
            self._timer = RoundDeadlineTimer(comm, float(deadline), rank, "pos")

    def run(self):
        self.register_message_receive_handlers()
        if self.deadline is not None:
            self._advance()                  # hand the first turn out
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self):
        for msg_type, handler in (
                (MSG_TYPE_C2S_SEND_ACTS, self.handle_message_acts),
                (MSG_TYPE_C2S_VALIDATION_MODE,
                 lambda m: None if self._zombie(m) else self.trainer.eval_mode()),
                (MSG_TYPE_C2S_VALIDATION_OVER,
                 lambda m: None if self._zombie(m) else self._validation_over(m)),
                (MSG_TYPE_C2S_PROTOCOL_FINISHED, self.handle_finish),
                (MSG_TYPE_C2S_TURN_DONE, self._on_turn_done)):
            if msg_type != MSG_TYPE_C2S_TURN_DONE or self.deadline is not None:
                self.register_message_receive_handler(
                    msg_type, self._stream.wrap(lambda m, h=handler: self._gate(m, h)))
        if self.deadline is not None:
            self.register_message_receive_handler(MSG_TYPE_LOCAL_ROUND_DEADLINE,
                                                  self._on_deadline)

    # -- the order of the clients' messages -------------------------------------

    def _gate(self, msg: Message, handler) -> None:
        """Strict mode: only the turn-holder's messages are handled; a next
        client's that overtook the holder's last ones wait for its turn
        (each client's own come in its order, ``OrderedStream``). The
        managed ring hands the turn out itself and drops a zombie's."""
        sender = msg.get_sender_id()
        # the last client's PROTOCOL_FINISHED follows its own turn's end
        early = sender != self._holder and msg.get_type() != MSG_TYPE_C2S_PROTOCOL_FINISHED
        if self.deadline is None and (early or self._pending.get(sender)):
            self._pending.setdefault(sender, []).append((handler, msg))
            return
        handler(msg)

    def _validation_over(self, msg: Message) -> None:
        self.trainer.validation_over()
        if self.deadline is None and msg.get(MSG_ARG_KEY_TURN_END):
            self._holder = self._holder % (self.size - 1) + 1
            for handler, m in self._pending.pop(self._holder, []):
                self._gate(m, handler)

    # -- the managed ring -------------------------------------------------------

    def _zombie(self, msg: Message) -> bool:
        """Managed mode: a protocol message from any rank but the live
        turn-holder (a skipped client that woke up) must not touch the
        server's phase or train on its batches."""
        if self.deadline is None:
            return False
        s = msg.get_sender_id()
        return (self._pos >= len(self._ring) or self._ring[self._pos] != s
                or not self._alive.get(s, False))

    def _advance(self):
        """Hand the turn to the next live client, or finish the ring."""
        while True:
            self._pos += 1
            if self._pos >= len(self._ring):
                self._finish_all()
                return
            nxt = self._ring[self._pos]
            if not self._alive[nxt]:
                continue
            self._activity = 0
            try:
                self.send_message(Message(MSG_TYPE_C2C_SEMAPHORE, self.rank, nxt))
            except Exception as e:
                log.warning("splitnn ring: the turn to rank %d failed (%s)", nxt, e)
                self._alive[nxt] = False
                continue
            self._timer.arm(self._pos)
            return

    def _maybe_checkpoint(self):
        if self._ckpt_path is None:
            return
        from fedml_tpu_torch.utils.checkpoint import save_checkpoint

        t = self.trainer
        device_call(lambda: save_checkpoint(
            self._ckpt_path, {"vars": t.variables, "opt": t.opt_state}, round_idx=self._pos,
            extra={"epoch": int(t.epoch), "val_history": [float(v) for v in t.val_history]}))

    def _on_turn_done(self, msg: Message):
        if self._zombie(msg):
            return                           # a late report of a skipped client
        self._timer.cancel()
        self._turns_done += 1
        self._maybe_checkpoint()
        if self._max_turns is not None and self._turns_done >= self._max_turns:
            self._finish_all()
            return
        self._advance()

    def _on_deadline(self, msg: Message):
        if int(msg.get("pos")) != self._pos:
            return                           # a stale timer
        if self._activity > 0:
            # slow but alive: another window
            self._activity = 0
            self._timer.arm(self._pos)
            return
        dead = self._ring[self._pos]
        log.warning("splitnn ring: rank %d silent past the %.1fs deadline; skipping it and "
                    "re-forming the ring", dead, self.deadline)
        self._alive[dead] = False
        self.trainer.train_mode()            # drop a half-done validation
        self._advance()

    def _finish_all(self):
        if self._timer is not None:
            self._timer.cancel()
        # FINISHED to every rank, the dead-marked too: an in-process "dead"
        # client is a live thread that must still end
        for r in range(1, self.size):
            try:
                self.send_message(Message(MSG_TYPE_S2C_FINISHED, self.rank, r))
            except Exception as e:
                log.debug("FINISHED to rank %d failed (%s)", r, e)
        self.finish()

    # -- the compute peer -------------------------------------------------------

    def handle_message_acts(self, msg: Message):
        if self._zombie(msg):
            return     # a skipped client's late batch: no gradient back, it waits
        self._activity += 1
        grads = self.trainer.forward_backward(msg.get(MSG_ARG_KEY_ACTS),
                                              msg.get(MSG_ARG_KEY_LABELS),
                                              msg.get(MSG_ARG_KEY_MASK))
        if self.trainer.phase != "train":
            return
        out = Message(MSG_TYPE_S2C_GRADS, self.rank, msg.get_sender_id())
        out.add_params(MSG_ARG_KEY_GRADS, grads)
        try:
            self.send_message(out)
        except Exception as e:
            if self.deadline is None:
                raise
            dead = msg.get_sender_id()
            log.warning("splitnn ring: the gradient to rank %d failed (%s)", dead, e)
            self._alive[dead] = False
            if self._ring[self._pos] == dead:
                self._timer.cancel()
                self.trainer.train_mode()
                self._advance()

    def handle_finish(self, msg: Message):
        self.finish()


class SplitNNEdgeClientManager(ClientManager):
    """The reference's client_manager.py:8-87: the relay ring with the
    per-batch exchange."""

    def __init__(self, args, comm, rank, size, trainer: SplitNNClientTrainer,
                 epochs_per_turn: int, turns: int, managed: bool = False):
        super().__init__(args, comm, rank, size)
        self.trainer = trainer
        self.epochs_per_turn = epochs_per_turn    # MAX_EPOCH_PER_NODE
        self.turns = turns
        self.turn_idx = 0
        self.epoch_in_turn = 0
        self.MAX_RANK = size - 1
        self.node_right = 1 if rank == self.MAX_RANK else rank + 1
        self.SERVER_RANK = 0
        #: managed mode: wait for the server's token, report TURN_DONE, end on
        #: its FINISHED
        self.managed = managed
        self._stream = OrderedStream()

    def send_message(self, message: Message) -> None:
        if message.get_receiver_id() == self.SERVER_RANK:
            message = self._stream.stamp(message)
        super().send_message(message)

    def run(self):
        self.register_message_receive_handlers()
        if self.rank == 1 and not self.managed:
            self.run_forward_pass()
        self.com_manager.handle_receive_message()

    def register_message_receive_handlers(self):
        self.register_message_receive_handler(MSG_TYPE_C2C_SEMAPHORE, self.handle_semaphore)
        self.register_message_receive_handler(MSG_TYPE_S2C_GRADS, self.handle_gradients)
        if self.managed:
            self.register_message_receive_handler(MSG_TYPE_S2C_FINISHED, lambda m: self.finish())

    def handle_semaphore(self, msg: Message):
        self.trainer.train_mode()
        self.run_forward_pass()

    def run_forward_pass(self):
        acts, labels, mask = self.trainer.forward_pass()
        m = Message(MSG_TYPE_C2S_SEND_ACTS, self.rank, self.SERVER_RANK)
        m.add_params(MSG_ARG_KEY_ACTS, acts)
        m.add_params(MSG_ARG_KEY_LABELS, labels)
        m.add_params(MSG_ARG_KEY_MASK, mask)
        self.send_message(m)

    def handle_gradients(self, msg: Message):
        self.trainer.backward_pass(msg.get(MSG_ARG_KEY_GRADS))
        if self.trainer.batch_idx >= self.trainer.n_batches:
            self.epoch_in_turn += 1
            self.run_eval()
        else:
            self.run_forward_pass()

    def run_eval(self):
        self.send_message(Message(MSG_TYPE_C2S_VALIDATION_MODE, self.rank, self.SERVER_RANK))
        self.trainer.eval_mode()
        for _ in range(self.trainer.n_eval_batches):
            self.run_forward_pass()
        over = Message(MSG_TYPE_C2S_VALIDATION_OVER, self.rank, self.SERVER_RANK)
        over.add_params(MSG_ARG_KEY_TURN_END, self.epoch_in_turn >= self.epochs_per_turn)
        self.send_message(over)
        if self.epoch_in_turn < self.epochs_per_turn:
            self.trainer.train_mode()
            self.run_forward_pass()
            return
        self.epoch_in_turn = 0
        self.turn_idx += 1
        if self.managed:
            # the turn goes back to the ring's owner; wait for the next
            # token or FINISHED
            self.send_message(Message(MSG_TYPE_C2S_TURN_DONE, self.rank, self.SERVER_RANK))
            return
        if self.turn_idx >= self.turns:
            if self.rank == self.MAX_RANK:
                # the last client of the last turn ends the protocol
                self.send_message(Message(MSG_TYPE_C2S_PROTOCOL_FINISHED, self.rank,
                                          self.SERVER_RANK))
            else:
                self.send_message(Message(MSG_TYPE_C2C_SEMAPHORE, self.rank, self.node_right))
            self.finish()
            return
        self.send_message(Message(MSG_TYPE_C2C_SEMAPHORE, self.rank, self.node_right))


def init_stages(client_bundle, server_bundle, n_clients: int, seed: int,
                device: torch.device) -> tuple:
    """(each client's stage state dict, the server stage's) from
    ``SplitNNAPI``'s draws of ``seed``; the server's is left in its
    module."""
    clients = [client_bundle.init(init_generator(seed, 1, k), device) for k in range(n_clients)]
    return clients, server_bundle.init(init_generator(seed, 2), device)


def run_splitnn_edge(dataset, config, client_bundle, server_bundle, wire_roundtrip: bool = True,
                     comm_factory=None, max_turns: Optional[int] = None,
                     device: Optional[Union[str, torch.device]] = None) -> SplitNNServerTrainer:
    """The server and one manager per client on threads over the local
    transport (or ``comm_factory``'s, e.g. gRPC loopback). Each client
    takes ``config.epochs`` epochs a turn and the ring runs one cycle, the
    reference's defaults. Returns the server trainer (``val_history``, the
    final ``variables``). ``config.straggler_deadline_sec`` makes the ring
    server-managed (a silent client is skipped, its data unseen), where
    ``max_turns`` and the checkpoint fields apply (module note). The
    reliable and chaos layers ``config`` asks for stack over every rank's
    transport. Runs on the GPU unless ``device`` says otherwise."""
    from fedml_tpu_torch.comm.reliable import wire_wrap_factory

    check_ported(config)
    dev = default_device(device)
    deadline = getattr(config, "straggler_deadline_sec", None)
    task = get_task(dataset.task, dataset.class_num)
    n_clients = dataset.num_clients
    size = n_clients + 1
    bs = config.batch_size
    # the per-batch protocol has no mask channel for validation: the real
    # test rows only, cut to whole batches
    real = dataset.test_mask > 0
    test_x, test_y = dataset.test_x[real], dataset.test_y[real]
    n_test = (test_x.shape[0] // bs) * bs
    client_vars, server_vars = device_call(init_stages, client_bundle, server_bundle, n_clients,
                                           config.seed, dev)
    server_trainer = SplitNNServerTrainer(server_bundle, config, task, max_rank=n_clients,
                                          device=dev)
    device_call(server_trainer.init, server_vars)

    def make(rank, comm):
        if rank == 0:
            return SplitNNEdgeServerManager(config, comm, rank, size, server_trainer,
                                            deadline=deadline, max_turns=max_turns)
        k = rank - 1
        x, y, m, count = dataset.client_slice_cached(k)
        n_real = int(count[0])
        # ceil: a trailing partial batch trains with its padding rows masked
        # out (the padding sits at the end of each client's arrays)
        n_batches = min(max(-(-n_real // bs), 1), x.shape[1] // bs)
        trainer = SplitNNClientTrainer(
            client_bundle, config, x[0][:n_batches * bs], y[0][:n_batches * bs],
            m[0][:n_batches * bs].astype(np.float32), n_batches, test_x[:n_test],
            test_y[:n_test], device=dev)
        device_call(trainer.init, client_vars[k])
        return SplitNNEdgeClientManager(types.SimpleNamespace(), comm, rank, size, trainer,
                                        epochs_per_turn=config.epochs, turns=1,
                                        managed=deadline is not None)

    wrap = wire_wrap_factory(config)
    managers = run_ranks(make, size, wire_roundtrip=wire_roundtrip, comm_factory=comm_factory,
                         wrap=wrap, inbox_cap=config.wire_inbox_cap)
    if wrap is not None:
        release_wire([m.com_manager for m in managers])
    return server_trainer
