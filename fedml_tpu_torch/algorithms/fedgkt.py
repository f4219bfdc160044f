"""FedGKT: group knowledge transfer, features and logits exchanged instead
of weights (counterpart of ``fedml_tpu/algorithms/fedgkt.py``; reference
fedml_api/distributed/fedgkt/).

Every round, every client trains its own edge net (its state persists
across rounds) with CE + kl_w * KL to the server's per-sample logits
(kl_w = 0 in round 0, ``alpha_distill`` after), then runs an eval-mode pass
over its whole padded record axis that extracts its feature maps and
logits. The server then trains its net on the union of the clients'
features ``[C * n_pad, H, W, 16]`` with CE + alpha * KL to the client
logits, and recomputes its logits for every client record. Logits travel
per SAMPLE and are permuted together with x and y inside each epoch
(``fedgkt.py:17-24`` of the JAX package).

As in the JAX package's scans, an epoch's order is a permutation of the
padded axis stable-sorted so the real records lead; only the live steps
(``ceil(real / batch)``) run, which equals the reference's frozen padding
steps. Each step is one program: on CUDA a replay of one captured graph per
step shape (``parallel/capture.py``), one for the client step (each
client's state is copied into the edge net's static parameters, buffers
and optimizer state before its steps, and back after) and one for the
server step. A batch is gathered from the union feature tensor into the
step's static inputs; no permuted copy of the union is kept. The
extraction, logits and evaluation passes run eagerly in eval mode.

The JAX package draws its orders from threefry keys (``fold_in(round_key,
1)`` split over the clients, then over the epochs; ``fold_in(round_key,
2)`` split over the server epochs). The port draws them from
``core/rng`` generators, or takes them from ``order_hook(round, client)`` /
``server_order_hook(round)``, which the parity tests use to inject the
reference's.

``server_mesh`` (a 1-D ``('batch',)`` mesh,
``parallel/dataparallel.batch_mesh``; the reference's ``nn.DataParallel``
server) makes each server step data parallel: every rank runs the same
rounds, and in a server step takes its rows of the batch, with BatchNorm
synchronized over the mesh, each rank's loss weighted by its share of the
batch's real records before the backward
(``parallel/dataparallel.count_share``) and the gradients all-reduced, so
the step differentiates the global mean, as the JAX package's sharded
server phase does. A mesh with a process group steps eagerly: its collectives
stay outside captured graphs.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch import default_device
from fedml_tpu_torch.core import optim
from fedml_tpu_torch.core.config import FedConfig, check_ported
from fedml_tpu_torch.core.pytree import tree_stack
from fedml_tpu_torch.core.rng import client_generator, init_generator, server_generator
from fedml_tpu_torch.core.tasks import int_cross_entropy
from fedml_tpu_torch.data import FedDataset
from fedml_tpu_torch.models.gkt import GKTPair, create_gkt_pair, gkt_blocks_from_names
from fedml_tpu_torch.models.norm import sync_batch_norm
from fedml_tpu_torch.parallel.capture import CapturedStep
from fedml_tpu_torch.parallel.collectives import all_reduce_sum_
from fedml_tpu_torch.parallel.dataparallel import count_share
from fedml_tpu_torch.parallel.local import clip_grads_, module_state, real_first
from fedml_tpu_torch.parallel.mesh import bound_axes

log = logging.getLogger(__name__)

#: records a call of the eval-mode passes (extraction, server logits,
#: evaluation) takes; eval-mode outputs do not depend on it
EVAL_BATCH = 1024


def kl_distill(student_logits, teacher_logits, mask, temperature: float) -> torch.Tensor:
    """Masked batch-mean ``T^2 * KL(softmax(teacher/T) + 1e-7 ||
    log_softmax(student/T))`` (reference utils.KL_Loss), in f32."""
    T = temperature
    s = F.log_softmax(student_logits.to(torch.float32) / T, dim=-1)
    t = F.softmax(teacher_logits.to(torch.float32) / T, dim=-1) + 1e-7
    per = (T * T) * (t * (torch.log(t) - s)).sum(-1)
    m = mask.to(torch.float32)
    return (per * m).sum() / torch.clamp(m.sum(), min=1.0)


def masked_ce(logits, labels, mask) -> torch.Tensor:
    m = mask.to(torch.float32)
    return (int_cross_entropy(logits, labels) * m).sum() / torch.clamp(m.sum(), min=1.0)


def _gkt_optimizer(name: str, lr: float, wd: float) -> optim.Transform:
    """The reference's GKT optimizers: SGD with nesterov momentum 0.9 (after
    ``wd`` decay when set), else weight decay 1e-4 and amsgrad."""
    if name.lower() == "sgd":
        rule = optim.sgd(lr, 0.9, nesterov=True)
        return optim.chain(optim.add_decayed_weights(wd), rule) if wd else rule
    return optim.chain(optim.add_decayed_weights(1e-4), optim.amsgrad(lr))


class FedGKTAPI:
    """Standalone-simulation FedGKT: every client takes part every round."""

    def __init__(self, dataset: FedDataset, config: FedConfig, pair: Optional[GKTPair] = None,
                 client_blocks: Optional[int] = None,
                 server_blocks_per_stage: Optional[int] = None, server_mesh=None,
                 device: Optional[Union[str, torch.device]] = None,
                 order_hook: Optional[Callable] = None,
                 server_order_hook: Optional[Callable] = None):
        check_ported(config)
        if client_blocks is None or server_blocks_per_stage is None:
            derived = gkt_blocks_from_names(config.model_client, config.model_server)
            client_blocks = derived[0] if client_blocks is None else client_blocks
            if server_blocks_per_stage is None:
                server_blocks_per_stage = derived[1]
        self.dataset, self.config, self.server_mesh = dataset, config, server_mesh
        self.device = server_mesh.device if server_mesh is not None else default_device(device)
        self.order_hook, self.server_order_hook = order_hook, server_order_hook
        dtype = torch.bfloat16 if config.dtype == "bfloat16" else torch.float32
        self.pair = pair or create_gkt_pair(dataset.class_num, tuple(dataset.train_x.shape[2:]),
                                            client_blocks, server_blocks_per_stage, dtype)
        self.C = dataset.num_clients
        self.n_pad = int(dataset.train_x.shape[1])
        if self.n_pad % config.batch_size:
            raise ValueError("n_pad must be a multiple of batch_size")
        cm, sm = self.pair.client.module, self.pair.server.module
        self.client_vars = tree_stack([self.pair.client.init(init_generator(config.seed, 1, i),
                                                             self.device)
                                       for i in range(self.C)])
        self.server_vars = self.pair.server.init(init_generator(config.seed, 2), self.device)
        self._copt = _gkt_optimizer(config.client_optimizer, config.lr, config.wd)(cm.parameters())
        self._sopt = _gkt_optimizer(config.client_optimizer, config.lr, config.wd)(sm.parameters())
        for opt in (self._copt, self._sopt):
            opt.zero_grad(set_to_none=False)
        #: each client's optimizer state, stacked [C, ...] (``opt.tensors()`` order)
        self.client_opt = [t.unsqueeze(0).repeat(self.C, *([1] * t.dim()))
                           for t in self._copt.initial]
        x = torch.from_numpy(np.ascontiguousarray(dataset.train_x))
        self._x = (x.to(dtype) if x.is_floating_point() else x).to(self.device)
        self._y = torch.from_numpy(np.ascontiguousarray(dataset.train_y)).to(self.device)
        self._mask = torch.from_numpy(np.ascontiguousarray(dataset.train_mask)).to(self.device)
        K = dataset.class_num
        self._feats = torch.empty((self.C, self.n_pad) + self.pair.feature_shape, dtype=dtype,
                                  device=self.device)
        self._clogits = torch.zeros((self.C, self.n_pad, K), device=self.device)
        self.server_logits = torch.zeros((self.C, self.n_pad, K), device=self.device)
        self._test = None
        self.programs: dict = {}
        self._program_at: dict = {}
        self.history: list[dict] = []

    # -- state ---------------------------------------------------------------

    @property
    def server_vars(self) -> dict:
        """A copy of the server net's state dict (the net holds it)."""
        return {k: v.detach().clone() for k, v in self.pair.server.module.state_dict().items()}

    @server_vars.setter
    def server_vars(self, state: dict) -> None:
        self.pair.server.module.load_state_dict(state)

    def _client_tensors(self) -> list:
        """The edge net's state tensors in ``client_vars`` order, then the
        bound optimizer's."""
        sd = self.pair.client.module.state_dict(keep_vars=True)
        return [sd[k] for k in self.client_vars] + self._copt.tensors()

    @torch.no_grad()
    def _load_client(self, i: int) -> None:
        torch._foreach_copy_(self._client_tensors(),
                             [v[i] for v in self.client_vars.values()]
                             + [t[i] for t in self.client_opt])

    @torch.no_grad()
    def _store_client(self, i: int) -> None:
        torch._foreach_copy_([v[i] for v in self.client_vars.values()]
                             + [t[i] for t in self.client_opt], self._client_tensors())

    # -- the step programs ---------------------------------------------------

    def program(self, kind: str) -> CapturedStep:
        """The step program of ``kind`` ("client" or "server"), built at its
        first use; its static inputs are (bx, by, bm, teacher logits) and,
        for the client, the KL weight (a 0-dim tensor)."""
        half = self.pair.client if kind == "client" else self.pair.server
        module, opt = half.module, self._copt if kind == "client" else self._sopt
        # a captured step replays the addresses its capture saw: a program is
        # reused only while the net's tensors stay where they were when it
        # was made (``ModelBundle.init`` moves them through the CPU)
        where = tuple(t.data_ptr() for t in module_state(module, opt))
        prog = self.programs.get(kind)
        if prog is not None and self._program_at.get(kind) == where:
            return prog
        self._program_at[kind] = where
        c, bs, dev = self.config, self.config.batch_size, self.device
        src = self._x if kind == "client" else self._feats
        K = self.dataset.class_num
        inputs = [torch.empty((bs,) + tuple(src.shape[2:]), dtype=src.dtype, device=dev),
                  torch.empty((bs,), dtype=self._y.dtype, device=dev),
                  torch.empty((bs,), dtype=self._mask.dtype, device=dev),
                  torch.zeros((bs, K), device=dev)]
        T, clip = c.temperature, c.grad_clip
        if kind == "client":
            inputs.append(torch.zeros((), device=dev))
        mesh = self.server_mesh if kind == "server" else None
        line = mesh.line(mesh.axis_names[0]) if mesh is not None else None
        rows = mesh.block(bs, mesh.axis_names[0]) if mesh is not None else slice(None)

        def step(bx, by, bm, bt, kl_w=c.alpha_distill):
            module.train()
            opt.zero_grad(set_to_none=False)
            bx, by, bm, bt = bx[rows], by[rows], bm[rows], bt[rows]
            with contextlib.ExitStack() as ctx:
                if mesh is not None:
                    ctx.enter_context(bound_axes(mesh))
                    ctx.enter_context(sync_batch_norm(mesh.axis_names[0]))
                out = module(bx)
                logits = out[0] if kind == "client" else out
                loss = masked_ce(logits, by, bm) + kl_w * kl_distill(logits, bt, bm, T)
                if line is not None:
                    loss = loss * count_share(line, bm.sum())
                loss.backward()
            loss = loss.detach()
            if line is not None:
                loss = loss.reshape(1)
                all_reduce_sum_(line, [p.grad for p in opt.params if p.grad is not None] + [loss])
                loss = loss[0]
            if clip and kind == "client":
                clip_grads_(opt.params, clip)
            opt.step()
            return loss

        prog = self.programs[kind] = CapturedStep(
            step, inputs, lambda: module_state(module, opt),
            capture=line is None or line.group is None)
        return prog

    # -- the orders ----------------------------------------------------------

    def _client_orders(self, round_idx: int, i: int) -> list:
        if self.order_hook is not None:
            return list(self.order_hook(round_idx, i))
        g = client_generator(self.config.seed, round_idx, i)
        return [torch.randperm(self.n_pad, generator=g) for _ in range(self.config.epochs)]

    def _server_orders(self, round_idx: int) -> list:
        if self.server_order_hook is not None:
            return list(self.server_order_hook(round_idx))
        g = server_generator(self.config.seed, round_idx)
        return [torch.randperm(self.C * self.n_pad, generator=g)
                for _ in range(max(self.config.epochs_server, 1))]

    def round_steps(self) -> tuple:
        """(client steps, server steps) a round: the live steps of every
        client's epochs, and of the server's over the union's real records."""
        bs, c = self.config.batch_size, self.config
        counts = np.asarray(self.dataset.train_counts, np.int64)
        client = int((-(-counts // bs)).sum()) * c.epochs
        return client, -(-int(counts.sum()) // bs) * max(c.epochs_server, 1)

    # -- the phases ----------------------------------------------------------

    @torch.no_grad()
    def _eval_pass(self, module, x: torch.Tensor, outs: Sequence[torch.Tensor]) -> None:
        """Eval-mode forward of ``x`` in batches of EVAL_BATCH, each output
        written into the matching rows of ``outs``."""
        module.eval()
        for s in range(0, x.shape[0], EVAL_BATCH):
            got = module(x[s:s + EVAL_BATCH])
            for dst, val in zip(outs, got if isinstance(got, tuple) else (got,)):
                dst[s:s + EVAL_BATCH].copy_(val)

    def train_client(self, round_idx: int, i: int, x, y, m, count: int, teacher,
                     clogits_out: torch.Tensor, feats_out: torch.Tensor) -> torch.Tensor:
        """Client ``i``'s step of a round, from the state loaded into the edge
        net: its distillation epochs on its records ``x, y, m`` (``count``
        real) toward ``teacher`` (the server's logits of its records), then
        the extraction pass over its whole record axis into ``clogits_out``
        and ``feats_out``; returns its mean loss over the last epoch. The
        simulation's client phase runs it for every client, the edge's
        client for its own."""
        bs = self.config.batch_size
        prog = self.program("client")
        bx, by, bm, bt, klw = prog.inputs
        klw.fill_(0.0 if round_idx == 0 else self.config.alpha_distill)
        steps = -(-int(count) // bs)
        total = torch.zeros((), device=self.device)
        for perm in self._client_orders(round_idx, i):
            order = real_first(perm.to(self.device), m)
            total = torch.zeros((), device=self.device)
            for s in range(steps):
                idx = order[s * bs:(s + 1) * bs]
                for src, dst in zip((x, y, m, teacher), (bx, by, bm, bt)):
                    torch.index_select(src, 0, idx, out=dst)
                total = total + prog()
        self._eval_pass(self.pair.client.module, x, (clogits_out, feats_out))
        return total / max(steps, 1)

    def client_phase(self, round_idx: int) -> torch.Tensor:
        """Every client's distillation training and extraction pass; returns
        each client's mean loss over its last epoch, [C]."""
        counts = self.dataset.train_counts
        losses = []
        for i in range(self.C):
            self._load_client(i)
            losses.append(self.train_client(round_idx, i, self._x[i], self._y[i], self._mask[i],
                                            int(counts[i]), self.server_logits[i],
                                            self._clogits[i], self._feats[i]))
            self._store_client(i)
        return torch.stack(losses)

    def server_phase(self, round_idx: int, feats: Optional[torch.Tensor] = None,
                     y: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                     clogits: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The server's training on the union of the client features, then
        its logits for every client record; returns its mean loss over the
        last epoch. The union is the client phase's (``[C, n_pad, ...]``)
        unless the edge's server passes the uploaded one, whose mask then
        gives the real records (a dead client's slot masked out)."""
        bs = self.config.batch_size
        N = self.C * self.n_pad
        feats = self._feats if feats is None else feats
        clogits = self._clogits if clogits is None else clogits
        fx, fy = feats.view((N,) + self.pair.feature_shape), (self._y if y is None else y).view(N)
        fm, fl = (self._mask if mask is None else mask).view(N), clogits.view(N, -1)
        real = (np.asarray(self.dataset.train_counts).sum() if mask is None
                else float(mask.sum()))
        steps = -(-int(real) // bs)
        prog = self.program("server")
        total = torch.zeros((), device=self.device)
        for perm in self._server_orders(round_idx):
            order = real_first(perm.to(self.device), fm)
            total = torch.zeros((), device=self.device)
            for s in range(steps):
                idx = order[s * bs:(s + 1) * bs]
                for src, dst in zip((fx, fy, fm, fl), prog.inputs):
                    torch.index_select(src, 0, idx, out=dst)
                total = total + prog()
        self._eval_pass(self.pair.server.module, fx, (self.server_logits.view(N, -1),))
        return total / max(steps, 1)

    def run_round(self, round_idx: int) -> tuple:
        """One round: ``(client losses [C], server loss)``, device tensors."""
        return self.client_phase(round_idx), self.server_phase(round_idx)

    # -- evaluation ----------------------------------------------------------

    def _build_test_shards(self) -> tuple:
        """Per-client test shards ``[C, per, ...]`` (numpy): the global pool
        split evenly over the clients, padded with masked copies of its
        first record (the reference has each client extract its own test
        set's features)."""
        d, C = self.dataset, self.C
        n = len(d.test_x)
        per = -(-n // C)
        pad = per * C - n
        xi = np.concatenate([d.test_x, np.repeat(d.test_x[:1], pad, axis=0)], axis=0)
        yi = np.concatenate([d.test_y, np.repeat(d.test_y[:1], pad, axis=0)], axis=0)
        mi = np.concatenate([d.test_mask, np.zeros(pad, np.float32)])
        return (xi.reshape((C, per) + xi.shape[1:]), yi.reshape((C, per) + yi.shape[1:]),
                mi.reshape((C, per)))

    @torch.no_grad()
    def evaluate(self) -> dict:
        """Each client's test shard through its own edge net and the server
        net: sums of correct predictions, CE and records."""
        if self._test is None:
            self._test = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                               for a in self._build_test_shards())
        tx, ty, tm = self._test
        sums = {"correct": 0.0, "loss_sum": 0.0, "count": 0.0}
        cm, sm = self.pair.client.module, self.pair.server.module
        cm.eval()
        sm.eval()
        for i in range(self.C):
            self._load_client(i)
            logits = sm(cm(tx[i])[1])
            m = tm[i].to(torch.float32)
            sums["correct"] += float(((logits.argmax(-1) == ty[i].long()).float() * m).sum())
            sums["loss_sum"] += float((int_cross_entropy(logits, ty[i]) * m).sum())
            sums["count"] += float(m.sum())
        return sums

    def train(self) -> dict:
        """``comm_round`` rounds with the periodic evaluation; returns the
        last evaluation's record (also appended to ``history``)."""
        cfg = self.config
        last: dict = {}
        for rnd in range(cfg.comm_round):
            closs, sloss = self.run_round(rnd)
            if rnd % cfg.frequency_of_the_test == 0 or rnd == cfg.comm_round - 1:
                sums = self.evaluate()
                count = max(sums["count"], 1.0)
                last = {"round": rnd, "Test/Acc": sums["correct"] / count,
                        "Test/Loss": sums["loss_sum"] / count,
                        "Train/ClientLoss": float(closs.mean()),
                        "Train/ServerLoss": float(sloss)}
                self.history.append(last)
                log.info("GKT round %d: test acc %.4f", rnd, last["Test/Acc"])
        return last
