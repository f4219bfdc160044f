"""One rank of the multi-rank mesh cases of ``tests/test_torch_sequence_parallel.py``,
``test_torch_tensor_parallel.py``, ``test_torch_pipeline.py`` and
``test_torch_dataparallel.py``: a spawned child that imports torch and the
port only (never JAX), joins a gloo process group through a ``file://``
store, runs every case of its spec in order and sends back numpy."""

from __future__ import annotations

import numpy as np


def _t(a):
    import torch

    return torch.from_numpy(np.array(a))


def _np(state: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


def _lm(spec: dict, **kw):
    from fedml_tpu_torch.models.moe import MoeTransformerLM
    from fedml_tpu_torch.models.transformer import TransformerLM

    cls = MoeTransformerLM if spec.get("moe") else TransformerLM
    module = cls(**spec["model"], **kw)
    module.load_state_dict({k: _t(v) for k, v in spec["init"].items()})
    return module


def _batch(spec: dict) -> tuple:
    return tuple(_t(spec[k]) for k in ("x", "y", "m"))


def case_attn(spec: dict, world: int) -> dict:
    """Ring or Ulysses attention over the ``'sp'`` axis (``spec["sp"]``
    ranks) of an ``('x', 'sp')`` mesh of every rank, each ``x`` row one
    ring over the same sequence: this rank's output shard and the gradients
    of sum(out^2) wrt its q/k/v shards."""
    from fedml_tpu_torch.parallel.mesh import bound_axes, named_mesh
    from fedml_tpu_torch.parallel.sequence import sequence_attention

    sp = spec["sp"]
    mesh = named_mesh(("x", "sp"), (world // sp, sp), "cpu")
    cols = mesh.block(spec["q"].shape[2], "sp")
    q, k, v = (_t(spec[n])[:, :, cols].requires_grad_(True) for n in ("q", "k", "v"))
    with bound_axes(mesh):
        out = sequence_attention(q, k, v, axis_name="sp", axis_size=sp, mode=spec["mode"],
                                 causal=True, impl="xla")
        (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


def case_sp_step(spec: dict, world: int) -> dict:
    from fedml_tpu_torch.parallel.local import make_optimizer
    from fedml_tpu_torch.parallel.sequence import make_sp_lm_train_step, sp_mesh

    n_dp, n_sp = spec["mesh"]
    module = _lm(spec, ring_axis="sp", ring_size=n_sp, sp_mode=spec["mode"])
    step = make_sp_lm_train_step(module, sp_mesh(n_dp, n_sp, "cpu"), attn_impl="xla")
    opt = make_optimizer("sgd", spec["lr"])(module.parameters())
    loss = step(opt, *_batch(spec))
    return {"loss": float(loss), "state": _np(module.state_dict())}


def case_tp_step(spec: dict, world: int) -> dict:
    from fedml_tpu_torch.parallel import tensor as tp
    from fedml_tpu_torch.parallel.local import make_optimizer

    n_dp, n_model = spec["mesh"]
    ep = bool(spec.get("moe"))
    mesh = (tp.ep_mesh if ep else tp.tp_mesh)(n_dp, n_model, "cpu")
    twin = (tp.shard_params_ep if ep else tp.shard_params_tp)(_lm(spec), mesh)
    shapes = {k: tuple(v.shape) for k, v in twin.state_dict().items()}
    opt = make_optimizer("sgd", spec["lr"], spec.get("momentum", 0.0))(twin.parameters())
    loss = tp.make_tp_lm_train_step(twin, mesh, xent_impl="xla")(opt, *_batch(spec))
    return {"loss": float(loss), "state": _np(tp.gather_params(twin, mesh)), "shapes": shapes}


def case_pp_step(spec: dict, world: int) -> dict:
    from fedml_tpu_torch.parallel import pipeline as pp
    from fedml_tpu_torch.parallel.local import make_optimizer

    module = _lm(spec)
    if len(spec["mesh"]) == 3:
        mesh = pp.pp3d_mesh(*spec["mesh"], device="cpu")
        step = pp.make_pp_sp_lm_train_step(module, mesh, n_micro=spec["n_micro"],
                                           attn_impl="xla", sp_mode=spec["mode"],
                                           xent_impl="xla")
    else:
        mesh = pp.pp_mesh(*spec["mesh"], device="cpu")
        step = pp.make_pp_lm_train_step(module, mesh, n_micro=spec["n_micro"], attn_impl="xla",
                                        xent_impl="xla")
    params = pp.place_pp_params(pp.stack_pipeline_params(module.state_dict(), module.layers),
                                mesh)
    opt = make_optimizer("sgd", spec["lr"], spec.get("momentum", 0.0))(
        pp.pipeline_parameters(params))
    loss = step(params, opt, *_batch(spec))
    return {"loss": float(loss), "stage": mesh.coord("pp"),
            "outer": _np(params["outer"]), "blocks": _np(params["blocks"])}


def case_pp_errors(spec: dict, world: int) -> dict:
    """The pipeline's refusals, as messages: layers that do not split over
    the stages, dropout, and a batch that does not split into n_micro."""
    from fedml_tpu_torch.models.transformer import TransformerLM
    from fedml_tpu_torch.parallel import pipeline as pp

    mesh = pp.pp_mesh(1, world, "cpu")
    msgs = {}
    for name, kw in (("layers", dict(layers=world + 1)), ("dropout", dict(dropout=0.1))):
        try:
            pp.make_pp_lm_train_step(TransformerLM(31, dim=16, heads=2, max_len=8, **{
                "layers": world, **kw}), mesh)
        except ValueError as e:
            msgs[name] = str(e)
    module = TransformerLM(31, dim=16, heads=2, layers=world, max_len=8)
    step = pp.make_pp_lm_train_step(module, mesh, n_micro=3)
    params = pp.place_pp_params(pp.stack_pipeline_params(module.state_dict(), world), mesh)
    x = _t(np.zeros((4, 8), np.int64))
    try:
        step(params, None, x, x, x.float())
    except ValueError as e:
        msgs["n_micro"] = str(e)
    return msgs


def _resnet(spec: dict, **kw):
    from fedml_tpu_torch.models import create_model

    bundle = create_model("resnet20", 10, input_shape=(8, 8, 3), **kw)
    bundle.module.load_state_dict({k: _t(v) for k, v in spec["init"].items()})
    return bundle


def case_dp_step(spec: dict, world: int) -> dict:
    from fedml_tpu_torch.core.tasks import get_task
    from fedml_tpu_torch.parallel.dataparallel import batch_mesh, make_dp_train_step, place_batch
    from fedml_tpu_torch.parallel.local import make_optimizer

    bundle = _resnet(spec, bn_impl=spec["bn_impl"])
    mesh = batch_mesh(world, device="cpu")
    step = make_dp_train_step(bundle, get_task("classification", 10),
                              make_optimizer("sgd", spec["lr"], spec["momentum"]), mesh,
                              grad_clip=spec.get("grad_clip"))
    loss = step(*place_batch(mesh, spec["x"], spec["y"], spec["m"]))
    return {"loss": float(loss), "state": _np(bundle.module.state_dict())}


def case_bn_axis(spec: dict, world: int) -> dict:
    """A resnet20 built with ``bn_axis='batch'`` run on this rank's rows in
    train mode under the bound mesh: its BN statistics."""
    from fedml_tpu_torch.parallel.dataparallel import batch_mesh, place_batch
    from fedml_tpu_torch.parallel.mesh import bound_axes

    bundle = _resnet(spec, bn_axis="batch")
    mesh = batch_mesh(world, device="cpu")
    with bound_axes(mesh):
        bundle.apply_train(bundle.module, place_batch(mesh, spec["x"]))
    return {"state": _np(bundle.module.state_dict())}


def case_stream_centralized(spec: dict, world: int) -> dict:
    from fedml_tpu_torch.algorithms.centralized import StreamingCentralizedTrainer
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.parallel.dataparallel import batch_mesh

    ds = make_synthetic_classification(**spec["data"])
    tr = StreamingCentralizedTrainer(
        ds, FedConfig(**spec["run"]),
        create_model("lr", ds.class_num, input_shape=ds.train_x.shape[2:]),
        mesh=batch_mesh(world, device="cpu"))
    tr.variables = {k: _t(v) for k, v in spec["init"].items()}
    hist = tr.train()
    return {"history": hist, "state": _np(tr.variables)}


def case_gkt(spec: dict, world: int) -> dict:
    """One FedGKT round with the server data parallel over every rank,
    from the state and orders of ``spec``."""
    import torch

    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models.gkt import create_gkt_pair
    from fedml_tpu_torch.parallel.dataparallel import batch_mesh

    ds = make_synthetic_classification(**spec["data"])
    api = FedGKTAPI(ds, FedConfig(**spec["run"]),
                    create_gkt_pair(ds.class_num, tuple(ds.train_x.shape[2:]), client_blocks=1,
                                    server_blocks_per_stage=1, bn_impl=spec["bn_impl"]),
                    server_mesh=batch_mesh(world, device="cpu"),
                    order_hook=lambda r, i: [_t(o) for o in spec["client_orders"][i]],
                    server_order_hook=lambda r: [_t(o) for o in spec["server_orders"]])
    st = spec["state"]
    api.client_vars = {k: _t(v) for k, v in st["client_vars"].items()}
    api.server_vars = {k: _t(v) for k, v in st["server_vars"].items()}
    api.client_opt = [_t(v) for v in st["client_opt"]]
    torch._foreach_copy_(api._sopt.tensors(), [_t(v) for v in st["server_opt"]])
    api.server_logits = _t(st["server_logits"])
    closs, sloss = api.run_round(0)
    return {"closs": closs.numpy(), "sloss": float(sloss), "server_vars": _np(api.server_vars),
            "server_logits": api.server_logits.numpy()}


CASES = {"attn": case_attn, "sp_step": case_sp_step, "tp_step": case_tp_step,
         "pp_step": case_pp_step, "pp_errors": case_pp_errors, "dp_step": case_dp_step,
         "bn_axis": case_bn_axis, "stream_centralized": case_stream_centralized,
         "gkt": case_gkt}


def run_rank(rank: int, world: int, store: str, cases: list, out) -> None:
    """``cases``: ``(name, kind, spec)`` triples, run in order on a gloo
    group of ``world`` ranks. Puts ``(rank, {name: result})`` on ``out``, a
    case that raised giving its traceback as a string, or ``(rank, error)``
    when the group could not start."""
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        from fedml_tpu_torch.parallel.mesh import init_multihost

        init_multihost(f"file://{store}", world, rank, device="cpu", timeout_s=60)
        results = {}
        for name, kind, spec in cases:
            try:
                results[name] = CASES[kind](spec, world)
            except Exception as e:      # reported to the parent, which fails that case
                results[name] = f"{e!r}\n{traceback.format_exc()}"
        out.put((rank, results))
    except Exception as e:
        out.put((rank, f"{e!r}\n{traceback.format_exc()}"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


#: seconds the parent waits for every rank's report
JOIN_S = 240


class Spawn:
    """``cases`` running on ``world`` spawned gloo ranks, started at
    construction; :meth:`results` waits for them (so the parent can compute
    its references meanwhile) and returns ``{name: [rank 0's result, ...]}``.
    A rank that fails to report, or whose group could not start, raises
    ``AssertionError``."""

    def __init__(self, world: int, cases: list, store_dir):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.world, self.names = world, [name for name, _, _ in cases]
        self.out = ctx.Queue()
        store = str(store_dir / f"store-{world}")
        self.procs = [ctx.Process(target=run_rank, args=(r, world, store, cases, self.out))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._results = None

    def results(self) -> dict:
        import queue

        if self._results is not None:
            return self._results
        got = {}
        try:
            for _ in range(self.world):
                rank, res = self.out.get(timeout=JOIN_S)
                assert isinstance(res, dict), f"rank {rank} failed: {res}"
                got[rank] = res
        except queue.Empty:
            raise AssertionError(f"a rank did not report within {JOIN_S} s") from None
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        self._results = {n: [got[r][n] for r in range(self.world)] for n in self.names}
        return self._results


def result(spawned: Spawn, name: str) -> list:
    """The per-rank results of one case; a case that raised on a rank
    fails with that rank's traceback."""
    per_rank = spawned.results()[name]
    for r, res in enumerate(per_rank):
        assert not isinstance(res, str), f"{name} failed on rank {r}: {res}"
    return per_rank
