"""FedNAS and its DARTS search space: the port against the JAX package.

The JAX side is built small, because its flax tracing and XLA compile are
the cost (~25 s for one first-order round at this size on the CPU): the
search net at ``channels=2, layers=3, steps=1, multiplier=1`` has one
normal cell (layer 0) and two reduction cells, so every primitive runs at
stride 1 and at stride 2; the clients are 2, each 2 batches of 4 at 8 x 8.
Both sides start from the port's initial weights converted to flax by path
(``models/convert.torch_to_flax``; the JAX constructor's flax init, ~20 s
of eager tracing, returns them instead), JAX's alphas are converted the
other way, and JAX's per-client, per-epoch orders are injected
(``tests/torch_jax_refs.py``). f32 throughout, rtol 1e-4 / atol 1e-5
unless a case says otherwise.

- Each primitive (``ReLUConvBN``, ``DilConv``, ``SepConv``,
  ``FactorizedReduce``, ``MixedOp``) on 8 x 8 and 7 x 7 inputs at stride 1
  and 2, where flax's SAME padding is asymmetric ((0, 1), (1, 2), (3, 4)) or
  symmetric: the train-mode output, the updated BN statistics, and the
  gradients of ``sum(sin(y) * w)`` by the input and every weight (atol
  1e-5 of the largest entry: weight gradients reach ~30); the 3x3
  max and avg pools and the zero op at both strides.
- The search net's and the discrete net's (every primitive in its
  genotype, ``none`` included) train-mode logits and BN statistics and
  eval-mode logits, under ``bn_impl`` "xla" and "pallas" (K1/K2's plain
  versions on the CPU).
- ``derive_genotype`` equal to JAX's on random alphas and on tied ones.
- The depthwise convs' ``_GroupedConv`` equal to ``F.conv2d`` to the second
  derivative, with no per-group loop in it.
- One first-order ``FedNASAPI`` round (each client's 2 search steps, then
  the weighted means) under both ``bn_impl``s: variables and alphas, the
  loss rtol 1e-5, the derived genotype equal. The unrolled architect's
  step and round: ``tests/test_torch_fednas_unrolled.py``.
- A ``CrossSiloFedNASAPI`` round on two gloo ranks equal to the simulation
  round (rtol 1e-5 / atol 1e-6, tests/test_torch_crosssilo.py's).
- ``--unrolled`` is live: ``FedConfig(unrolled=1)`` and the launcher's flag
  select the unrolled architect, and ``batch_size=1`` is refused there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algorithms.fednas import FedNASAPI as JaxFedNASAPI
from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.rng import round_key
from fedml_tpu.data.synthetic import make_synthetic_classification as jax_synthetic
from fedml_tpu.models import darts as jd
from fedml_tpu_torch.algorithms.fednas import CrossSiloFedNASAPI, FedNASAPI
from fedml_tpu_torch.core.config import FedConfig
from fedml_tpu_torch.data.synthetic import make_synthetic_classification
from fedml_tpu_torch.models import darts as td
from fedml_tpu_torch.models.convert import (alphas_to_flax, alphas_to_torch, flax_to_torch,
                                            torch_to_flax)
from test_torch_crosssilo import _spawn_ranks
from torch_jax_refs import assert_vars_close, jax_orders_np, order_hook

SIZE = dict(channels=2, layers=3, steps=1, multiplier=1)
DATA = dict(name="nas", input_shape=(8, 8, 3), classes=3, num_clients=2, records_per_client=8,
            partition_method="homo", batch_size=4, seed=0)
RUN = dict(model="lr", client_num_in_total=2, client_num_per_round=2, comm_round=1, epochs=1,
           batch_size=4, lr=0.05, seed=1, frequency_of_the_test=1)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bn_name(bn_impl: str):
    return "BatchNorm" if bn_impl == "pallas" else None


def _close(got: torch.Tensor, want, msg: str = "", **tol) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=msg,
                               **(tol or TOL))


def _close_grad(got: torch.Tensor, want, msg: str = "") -> None:
    """A gradient: rtol 1e-4, atol 1e-5 of its largest entry (weight
    gradients here reach ~30, sums of hundreds of f32 terms)."""
    want = np.asarray(want)
    _close(got, want, msg, rtol=1e-4, atol=1e-5 * max(1.0, float(np.abs(want).max())))


# -- the primitives ----------------------------------------------------------------------

C = 4
PRIMITIVES = {
    "relu_conv_bn 3x3 s2": (lambda: jd.ReLUConvBN(6, 3, 2), lambda: td.ReLUConvBN(C, 6, 3, 2)),
    "dil_conv 3x3 s2": (lambda: jd.DilConv(C, 3, 2, 2), lambda: td.DilConv(C, C, 3, 2, 2)),
    "dil_conv 5x5 s2": (lambda: jd.DilConv(C, 5, 2, 2), lambda: td.DilConv(C, C, 5, 2, 2)),
    "dil_conv 3x3 s1": (lambda: jd.DilConv(C, 3, 1, 2), lambda: td.DilConv(C, C, 3, 1, 2)),
    "sep_conv 3x3 s2": (lambda: jd.SepConv(C, 3, 2), lambda: td.SepConv(C, C, 3, 2)),
    "sep_conv 5x5 s2": (lambda: jd.SepConv(6, 5, 2), lambda: td.SepConv(C, 6, 5, 2)),
    "sep_conv 5x5 s1": (lambda: jd.SepConv(C, 5, 1), lambda: td.SepConv(C, C, 5, 1)),
    "factorized_reduce": (lambda: jd.FactorizedReduce(6), lambda: td.FactorizedReduce(C, 6)),
    "mixed_op s1": (lambda: jd.MixedOp(C, 1), lambda: td.MixedOp(C, 1)),
    "mixed_op s2": (lambda: jd.MixedOp(C, 2), lambda: td.MixedOp(C, 2)),
}


def _primitive_outputs(jmod, x, w, mixed):
    """JAX: the train-mode output, new batch stats, and the gradients of
    ``sum(sin(y) * w)`` by x and the params, in one jitted program."""
    weights = jnp.asarray(np.linspace(-1.0, 1.0, len(jd.PRIMITIVES)), jnp.float32)
    extra = (weights,) if mixed else ()
    variables = jmod.init(jax.random.key(0), x, *extra, train=False)

    def f(params, x):
        y, upd = jmod.apply({**variables, "params": params}, x, *extra, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(jnp.sin(y) * w), (y, upd)

    (_, (y, upd)), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        variables["params"], x)
    return variables, y, upd, grads, np.asarray(weights)


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_primitive_matches_jax(name, size):
    jmake, tmake = PRIMITIVES[name]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, size, size, C)).astype(np.float32)
    jmod, tmod = jmake(), tmake()
    mixed = name.startswith("mixed")
    stride = 2 if name.endswith("s2") or name == "factorized_reduce" else 1
    out_hw = -(-size // stride)
    w = rng.normal(size=(4, out_hw, out_hw, getattr(jmod, "c_out", C))).astype(np.float32)
    variables, y, upd, (gp, gx), weights = _primitive_outputs(jmod, x, w, mixed)
    tmod.load_state_dict(flax_to_torch(jax.tree.map(np.asarray, variables)))
    tmod.train()
    xt = torch.tensor(x, requires_grad=True)
    yt = tmod(xt, torch.tensor(weights)) if mixed else tmod(xt)
    params = dict(tmod.named_parameters())
    grads = torch.autograd.grad((torch.sin(yt) * torch.tensor(w)).sum(),
                                [xt] + list(params.values()))
    _close(yt, y, f"{name} y")
    _close_grad(grads[0], gx, f"{name} dx")
    want_p = flax_to_torch({"params": jax.tree.map(np.asarray, gp)})
    for (k, _), g in zip(params.items(), grads[1:]):
        _close_grad(g, want_p[k], f"{name} d{k}")
    want_s = flax_to_torch({"batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    state = tmod.state_dict()
    for k, v in want_s.items():
        _close(state[k], v, f"{name} {k}")


@pytest.mark.parametrize("stride,dilation,size", [(1, 1, 5), (2, 1, 6), (2, 2, 8), (1, 2, 7)])
def test_grouped_conv_is_twice_differentiable_without_a_loop_over_groups(stride, dilation, size):
    """``_GroupedConv`` (the depthwise convs) equals ``F.conv2d`` to the
    second derivative (f64 gradcheck and gradgradcheck), and its second
    derivative runs no per-group slice, which PyTorch's grouped-conv double
    backward takes for every channel."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(size)
    x = torch.randn(1, 3, size, size, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(3, 1, 3, 3, dtype=torch.float64, generator=g, requires_grad=True)

    def conv(x, w):
        return td._GroupedConv.apply(x, w, stride, dilation, 3)

    torch.testing.assert_close(conv(x, w), torch.nn.functional.conv2d(
        x, w, None, stride, 0, dilation, 3), rtol=0, atol=0)
    assert torch.autograd.gradcheck(conv, (x, w))
    assert torch.autograd.gradgradcheck(conv, (x, w))
    # in f32 (PyTorch's f64 CPU transposed conv slices groups itself)
    x32, w32 = (t.detach().float().requires_grad_(True) for t in (x, w))
    first = torch.autograd.grad(torch.sin(conv(x32, w32)).sum(), [x32, w32], create_graph=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.autograd.grad(sum((t * t).sum() for t in first), [x32, w32])
    ops = {e.key: e.count for e in prof.key_averages()}
    assert "aten::narrow" not in ops and ops["aten::convolution"] <= 3, ops


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [8, 7])
def test_pools_and_zero_match_jax(stride, size):
    x = np.random.default_rng(4).normal(size=(2, size, size, 3)).astype(np.float32)
    xt = torch.tensor(x)
    for tf, jf in ((td._max_pool_3x3, jd._max_pool_3x3), (td._avg_pool_3x3, jd._avg_pool_3x3),
                   (td._zero, jd._zero)):
        want = np.asarray(jf(jnp.asarray(x), stride))
        got = tf(xt, stride)
        assert tuple(got.shape) == want.shape
        _close(got, want, tf.__name__, rtol=1e-6, atol=1e-6)
    nan = torch.full((1, 4, 4, 1), float("nan"))
    assert torch.isnan(td._zero(nan, stride)).all()       # x * 0.0: NaN stays NaN


def test_same_pads_are_flax_s():
    """(before, after) of flax's SAME at the DARTS shapes (the padding
    table of models/darts.py's note): asymmetric at stride 2 on an even size."""
    assert td.same_pads(32, 3, 2) == (0, 1)
    assert td.same_pads(32, 5, 2) == (1, 2) == td.same_pads(32, 2 * 2 + 1, 2)
    assert td.same_pads(32, 2 * 4 + 1, 2) == (3, 4)
    assert td.same_pads(32, 3, 1) == (1, 1) and td.same_pads(7, 3, 2) == (1, 1)


# -- the nets ----------------------------------------------------------------------------

GENOTYPE = td.Genotype(
    normal=(("sep_conv_3x3", 0), ("max_pool_3x3", 1), ("dil_conv_5x5", 0), ("none", 2)),
    normal_concat=(2, 3),
    reduce=(("avg_pool_3x3", 0), ("skip_connect", 1), ("sep_conv_5x5", 2), ("dil_conv_3x3", 0)),
    reduce_concat=(2, 3))


def _net_outputs(jmod, variables, x, *extra):
    """JAX: train-mode logits and stats, eval-mode logits, one program."""
    def f(v, x):
        y, upd = jmod.apply(v, x, *extra, train=True, mutable=["batch_stats"])
        return y, upd["batch_stats"], jmod.apply(v, x, *extra, train=False)

    return jax.jit(f)(variables, x)


@pytest.mark.parametrize("bn_impl", ["xla", "pallas"])
@pytest.mark.parametrize("net", ["search", "discrete"])
def test_net_forward_matches_jax(net, bn_impl):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 8, 8, 3)).astype(np.float32)
    if net == "search":
        tmod = td.DartsSearchNetwork(**SIZE, output_dim=3, bn_impl=bn_impl)
        jmod = jd.DartsSearchNetwork(**SIZE, output_dim=3)
        alphas = {k: rng.normal(size=(td.num_edges(SIZE["steps"]), 8)).astype(np.float32)
                  for k in ("normal", "reduce")}
        targs, jargs = (alphas_to_torch(alphas),), (jax.tree.map(jnp.asarray, alphas),)
    else:
        tmod = td.DartsNetwork(GENOTYPE, channels=2, layers=3, output_dim=3, bn_impl=bn_impl)
        jmod = jd.DartsNetwork(genotype=GENOTYPE, channels=2, layers=3, output_dim=3)
        targs = jargs = ()
    tmod.reset_parameters(torch.Generator().manual_seed(0))
    variables = torch_to_flax(tmod.state_dict(), bn_name=_bn_name(bn_impl))
    y, stats, ev = _net_outputs(jmod, variables, x, *jargs)
    _close(tmod.train()(torch.tensor(x), *targs), y, "train logits")
    assert_vars_close(tmod.state_dict(), {"params": variables["params"], "batch_stats": stats},
                      msg="stats", bn_name=_bn_name(bn_impl), **TOL)
    tmod.load_state_dict(flax_to_torch(variables, bn_name=None if bn_impl == "xla"
                                       else "PallasBatchNorm"))
    with torch.no_grad():
        _close(tmod.eval()(torch.tensor(x), *targs), ev, "eval logits")


def test_search_net_has_jax_s_bn_widths_and_affine_free_bns():
    """929 BNs at the launcher's full width (one of 48, 228 of 16, 350 of
    32, 350 of 64: the JAX net's batch_stats), all affine-free but the
    stem's, whose gamma/beta alone are parameters."""
    net = td.DartsSearchNetwork(16, 8, 4, 4, bn_impl="pallas")
    bns = [m for m in net.modules() if isinstance(m, td.PallasBatchNorm)]
    widths = sorted(m.mean.numel() for m in bns)
    assert len(bns) == 929 and [widths.count(c) for c in (16, 32, 48, 64)] == [228, 350, 1, 350]
    affine = [k for k in dict(net.named_parameters()) if "BatchNorm" in k]
    assert affine == ["PallasBatchNorm_0.scale", "PallasBatchNorm_0.bias"]


@pytest.mark.parametrize("steps,multiplier", [(4, 4), (2, 2)])
def test_derive_genotype_matches_jax(steps, multiplier):
    rng = np.random.default_rng(6)
    k = td.num_edges(steps)
    cases = [{n: rng.normal(size=(k, 8)).astype(np.float32) for n in ("normal", "reduce")},
             {n: np.zeros((k, 8), np.float32) for n in ("normal", "reduce")}]
    tied = rng.normal(size=(k, 8)).astype(np.float32)
    tied[:, 2:5] = tied[:, 2:3]                 # three ops tied on every edge
    tied[1] = tied[0]                            # two edges tied
    cases.append({"normal": tied, "reduce": tied[::-1].copy()})
    for alphas in cases:
        want = jd.derive_genotype(jax.tree.map(jnp.asarray, alphas), steps, multiplier)
        assert td.derive_genotype(alphas_to_torch(alphas), steps, multiplier) == want


# -- the round ---------------------------------------------------------------------------

def jax_round(unrolled: bool, data: dict = DATA, run: dict = RUN, size: dict = SIZE) -> dict:
    """JAX's ``FedNASAPI`` search round 0 from the port's initial weights:
    its init, its round's outputs, the derived genotype."""
    port = FedNASAPI(make_synthetic_classification(**data), FedConfig(**run), **size,
                     device="cpu")
    init = torch_to_flax(port.variables)
    ds = jax_synthetic(**data)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jd.DartsSearchNetwork, "init", lambda self, *a, **kw: init)
        japi = JaxFedNASAPI(ds, JaxFedConfig(**run, unrolled=int(unrolled)), **size)
    assert japi.unrolled == unrolled
    sampled = np.arange(run["client_num_per_round"])
    cx, cy, cm, counts = ds.client_slice(sampled)
    alphas0 = jax.tree.map(np.asarray, japi.alphas)
    v, a, loss = japi._search_round(japi.variables, japi.alphas, cx, cy, cm,
                                    jnp.asarray(counts, jnp.float32),
                                    round_key(japi.root_key, 0))
    return {"init": {k: t.clone() for k, t in port.variables.items()}, "alphas0": alphas0,
            "variables": jax.tree.map(np.asarray, v), "alphas": jax.tree.map(np.asarray, a),
            "loss": float(loss), "n_pad": ds.train_x.shape[1],
            "genotype": jd.derive_genotype(a, size["steps"], size["multiplier"])}


def port_round(ref: dict, bn_impl: str, unrolled: bool, api_cls=FedNASAPI, run: dict = RUN,
               data: dict = DATA, size: dict = SIZE, **kw):
    """The port's round 0 from the same state and orders as ``ref``."""
    api = api_cls(make_synthetic_classification(**data), FedConfig(**run, unrolled=int(unrolled)),
                  **size, bn_impl=bn_impl, device="cpu",
                  order_hook=order_hook(run["seed"], run["epochs"], run["client_num_per_round"],
                                        ref["n_pad"]), **kw)
    rename = "PallasBatchNorm" if bn_impl == "pallas" else None
    api.variables = flax_to_torch(torch_to_flax(ref["init"]), bn_name=rename)
    api.alphas = alphas_to_torch(ref["alphas0"])
    loss = float(api.run_round(0))
    return api, loss


def assert_round_matches(api, loss, ref, bn_impl, tol=TOL):
    assert_vars_close(api.variables, ref["variables"], msg="variables",
                      bn_name=_bn_name(bn_impl), **tol)
    for k, v in alphas_to_flax(api.alphas).items():
        np.testing.assert_allclose(v, ref["alphas"][k], err_msg=f"alphas {k}", **tol)
    np.testing.assert_allclose(loss, ref["loss"], rtol=1e-5)
    assert td.derive_genotype(api.alphas, api.steps_cfg, api.multiplier) == ref["genotype"]


@pytest.fixture(scope="module")
def first_order():
    return jax_round(unrolled=False)


@pytest.mark.parametrize("bn_impl", ["xla", "pallas"])
def test_first_order_round_matches_jax(first_order, bn_impl):
    api, loss = port_round(first_order, bn_impl, unrolled=False)
    assert not api.unrolled
    assert_round_matches(api, loss, first_order, bn_impl)
    # the alphas moved, by adam's first steps (~arch_lr each)
    moved = np.abs(alphas_to_flax(api.alphas)["reduce"] - first_order["alphas0"]["reduce"])
    assert 1e-5 < moved.max() < 1e-3


def test_search_step_leaves_the_alpha_step_s_statistics_out():
    """The alpha step's forward moves no running statistic: one step's
    statistics equal those of a weight step alone (the same forward at the
    step's new alphas), as JAX discards the alpha step's."""
    api = FedNASAPI(make_synthetic_classification(**DATA), FedConfig(**RUN), **SIZE,
                    device="cpu")
    prog = api.program()
    ds = api.dataset
    for src, dst in zip((ds.train_x[0, :4], ds.train_y[0, :4], ds.train_mask[0, :4]),
                        prog.inputs):
        dst.copy_(torch.from_numpy(src))
    api._load(api.variables, api.alphas)
    prog()
    after = {k: v.clone() for k, v in api.module.state_dict().items() if k.endswith(".mean")}
    api.module.load_state_dict(api.variables)
    with torch.no_grad():
        api.module.train()(prog.inputs[0], api._alphas)
    for k, v in api.module.state_dict().items():
        if k.endswith(".mean"):
            torch.testing.assert_close(v, after[k], rtol=0, atol=0)


def test_two_gloo_ranks_equal_the_simulation(tmp_path):
    """``CrossSiloFedNASAPI`` on two gloo ranks (one client each) ends its
    round with the same state on both, equal to ``FedNASAPI``'s round from
    the same state and orders within rtol 1e-5 / atol 1e-6."""
    sim = FedNASAPI(make_synthetic_classification(**DATA), FedConfig(**RUN), **SIZE,
                    device="cpu", order_hook=order_hook(RUN["seed"], 1, 2, 8))
    init = {**{k: v.numpy().copy() for k, v in sim.variables.items()},
            **{f"alphas.{k}": v.numpy().copy() for k, v in sim.alphas.items()}}
    loss = float(sim.run_round(0))
    orders = {(0, j, 8): jax_orders_np(RUN["seed"], 1, 0, 2, 8)[j] for j in range(2)}
    spec = dict(data=DATA, run=RUN, model="fednas", init=init, orders=orders, rounds=1,
                fednas=SIZE)
    (l0, v0), (l1, v1) = _spawn_ranks(2, spec, tmp_path)
    assert l0 == l1 and all(np.array_equal(v0[k], v1[k]) for k in v0)
    np.testing.assert_allclose(l0, [loss], rtol=1e-5)
    want = {**sim.variables, **{f"alphas.{k}": v for k, v in sim.alphas.items()}}
    assert set(v0) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(v0[k], v.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_crosssilo_refuses_a_cohort_the_mesh_does_not_divide():
    from fedml_tpu_torch.parallel.mesh import ClientMesh

    mesh = ClientMesh(world_size=2, rank=0, group=None, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="multiple of the mesh"):
        CrossSiloFedNASAPI(make_synthetic_classification(**{**DATA, "num_clients": 3}),
                           FedConfig(**{**RUN, "client_num_in_total": 3,
                                        "client_num_per_round": 3}), mesh=mesh, **SIZE)


def test_unrolled_flag_is_live(monkeypatch, capsys):
    """``unrolled`` is no refused field any more: the config's flag picks
    the unrolled architect (the constructor's argument overrides it), the
    launcher's ``--unrolled 1`` reaches ``FedNASAPI``, and batch size 1 is
    refused (the batch splits in halves)."""
    import json

    from fedml_tpu_torch.core.config import unported_fields
    from fedml_tpu_torch.experiments.run import main

    assert not unported_fields(FedConfig(unrolled=1))
    ds = make_synthetic_classification(**DATA)
    assert FedNASAPI(ds, FedConfig(**RUN, unrolled=1), **SIZE, device="cpu").unrolled
    assert not FedNASAPI(ds, FedConfig(**RUN, unrolled=1), **SIZE, device="cpu",
                         unrolled=False).unrolled
    with pytest.raises(ValueError, match="batch_size"):
        FedNASAPI(ds, FedConfig(**{**RUN, "batch_size": 1}, unrolled=1), **SIZE, device="cpu")
    seen = []
    monkeypatch.setattr(FedNASAPI, "train",
                        lambda self: seen.append(self) or {"round": 0, "Test/Acc": 0.5})
    main(("--algorithm fednas --dataset cifar10 --client_num_in_total 2 "
          "--client_num_per_round 2 --batch_size 64 --ci 1 --unrolled 1").split(), device="cpu")
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(seen) == 1 and seen[0].unrolled and last["algorithm"] == "fednas"
    # the launcher's --ci size of the search net (the JAX launcher's)
    assert (seen[0].steps_cfg, seen[0].multiplier, len(seen[0].module._cells)) == (2, 2, 2)
