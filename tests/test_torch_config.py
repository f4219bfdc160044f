"""The port's FedConfig and argparse bridge against the JAX package's.

- ``add_args()`` has JAX's option strings, defaults, choices and types (a
  ``0|1`` flag parses as JAX's does), and ``config_from_args`` gives JAX's
  ``to_dict()`` on the same argv lines, the ``--ci`` shrink included.
- The dataclass has JAX's 107 fields and defaults, and the same checks
  raise on the same bad values.
- Every field is ported, XLA-only (accepted and ignored) or unported; each
  unported one, set away from its default, raises ``NotImplementedError``
  at ``FedAvgAPI`` construction naming the field and its ROADMAP item (the
  gateway's two: item 11b's gateway); the edge runtime's 24 fields (the
  transports, the reliable wire, chaos and FedBuff) are live.
- FedGKT's five fields are live: each, set away from its default, changes
  what ``FedGKTAPI`` builds or computes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fedml_tpu.core.config import FedConfig as JaxFedConfig
from fedml_tpu.core.config import add_args as jax_add_args
from fedml_tpu.core.config import config_from_args as jax_config_from_args
from fedml_tpu_torch.algorithms.centralized import CentralizedTrainer
from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
from fedml_tpu_torch.core.config import (UNPORTED_FIELDS, XLA_ONLY_FIELDS, FedConfig, add_args,
                                         config_from_args, unported_fields)
from fedml_tpu_torch.data.synthetic import make_synthetic_classification

BASE = dict(model="lr", dataset="tiny", client_num_in_total=4, client_num_per_round=2,
            comm_round=1, batch_size=4, frequency_of_the_test=1)

#: a value away from the default for each unported field, with the fields it
#: needs to pass the JAX package's own checks
NON_DEFAULT = {
    "gateway_max_tenants": {"gateway_max_tenants": 2},
    "gateway_tenant_workers": {"gateway_tenant_workers": 2},
    "rounds_per_step": {"rounds_per_step": 2}, "trace_dir": {"trace_dir": "traces"},
    "trace_buffer_events": {"trace_buffer_events": 10},
    "trace_sample_rate": {"trace_sample_rate": 0.5}, "sketch_alpha": {"sketch_alpha": 0.05},
    "cost_attribution": {"cost_attribution": True}, "pulse_path": {"pulse_path": "pulse.jsonl"},
    "pulse_prometheus_dir": {"pulse_path": "pulse.jsonl", "pulse_prometheus_dir": "prom"},
    "health_loss_limit": {"health_loss_limit": 10.0},
    "health_stall_sec": {"health_stall_sec": 5.0},
    "health_stale_spike": {"health_stale_spike": 2}, "health_skew": {"health_skew": 2.0},
    "health_version_lag": {"health_version_lag": 2.0},
    "health_update_norm": {"health_update_norm": 1.0}, "health_drift": {"health_drift": 0.5},
    "health_escalate": {"health_escalate": True}, "lens": {"lens": "on"},
    "lens_topk": {"lens_topk": 3}, "flight_dir": {"flight_dir": "flight"},
    "flight_window": {"flight_window": 4}, "flight_on": {"flight_on": "manual"},
    "trace_device_sampler": {"trace_device_sampler": False},
}

#: the edge runtime's fields (distributed/fedavg_edge.py), live: a value away from
#: the default for each, with the fields it needs
EDGE_LIVE = {
    "backend": {"backend": "grpc"}, "rank": {"rank": 1, "world_size": 2},
    "world_size": {"world_size": 2}, "grpc_ipconfig_path": {"grpc_ipconfig_path": "ip.csv"},
    "grpc_base_port": {"grpc_base_port": 50100}, "wire_codec": {"wire_codec": "q8"},
    "wire_delta": {"wire_delta": True}, "wire_inbox_cap": {"wire_inbox_cap": 4},
    "is_mobile": {"is_mobile": 1}, "straggler_deadline_sec": {"straggler_deadline_sec": 5.0},
    # the reliable wire, chaos injection and FedBuff (comm/reliable.py,
    # comm/chaos.py, distributed/fedbuff_edge.py)
    "wire_reliable": {"wire_reliable": True},
    "wire_retry_base_s": {"wire_retry_base_s": 0.1}, "wire_retry_max": {"wire_retry_max": 5},
    "chaos_seed": {"chaos_seed": 1},
    "chaos_drop": {"chaos_drop": 0.1, "wire_reliable": True},
    "chaos_dup": {"chaos_dup": 0.1, "wire_reliable": True},
    "chaos_delay_ms": {"chaos_delay_ms": 5.0},
    "chaos_reorder": {"chaos_reorder": 0.1, "wire_reliable": True},
    "chaos_crash_rank": {"chaos_crash_rank": 1, "chaos_crash_after": 3},
    "chaos_crash_after": {"chaos_crash_rank": 1, "chaos_crash_after": 3},
    "chaos_crash_restart_s": {"chaos_crash_rank": 1, "chaos_crash_after": 3,
                              "chaos_crash_restart_s": 1.0},
    "buffer_k": {"buffer_k": 2}, "buffer_staleness_alpha": {"buffer_staleness_alpha": 1.0},
    "buffer_mode": {"buffer_mode": "deterministic"},
}

#: the federation gateway's quotas (ROADMAP §1, 11b's gateway, after item 12)
GATEWAY = {"gateway_max_tenants", "gateway_tenant_workers"}

ARGV = [
    [],
    "--dataset cifar10 --model resnet56 --client_num_in_total 32 --client_num_per_round 8 "
    "--batch_size 64 --lr 0.1 --momentum 0.9 --comm_round 3 --frequency_of_the_test 1",
    "--ci 1 --comm_round 9 --epochs 3 --dtype bfloat16 --pack_lanes 2",
    "--wire_delta 1 --wire_codec topk:0.1 --wire_reliable 1 --chaos_drop 0.2",
    "--rank 1 --world_size 3 --device_data off --stream_aggregate deterministic "
    "--cohort_chunk 4 --host_pipeline_depth 2 --cohort_policy speed",
    "--checkpoint_dir ck --checkpoint_frequency 2 --resume_from ck/latest.ckpt "
    "--profile_dir prof --run_name r --health_escalate 1 --trace_device_sampler 0",
]


def _actions(parser) -> dict:
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_add_args_matches_jax():
    want, got = _actions(jax_add_args()), _actions(add_args())
    assert set(got) == set(want)
    for dest, a in want.items():
        b = got[dest]
        assert (b.option_strings, b.default, b.choices) == (a.option_strings, a.default,
                                                            a.choices), dest
        if a.type is b.type:
            continue
        # JAX's 0|1 flags are lambdas: the port's must parse the same way
        assert all(b.type(s) == a.type(s) for s in ("0", "1", "2")), dest


def test_fields_and_defaults_match_jax():
    assert [f.name for f in dataclasses.fields(FedConfig)] == \
        [f.name for f in dataclasses.fields(JaxFedConfig)]
    assert len(dataclasses.fields(FedConfig)) == 107
    assert FedConfig().to_dict() == JaxFedConfig().to_dict()


@pytest.mark.parametrize("argv", ARGV, ids=lambda a: " ".join(a.split()[:2]) if a else "empty")
def test_config_from_args_matches_jax(argv):
    argv = argv.split() if isinstance(argv, str) else argv
    got = config_from_args(add_args().parse_args(argv)).to_dict()
    want = jax_config_from_args(jax_add_args().parse_args(argv)).to_dict()
    assert got == want


def test_config_yaml_overrides_flags(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("lr: 0.25\ncomm_round: 7\n")
    argv = ["--lr", "0.1", "--config_yaml", str(path)]
    got = config_from_args(add_args().parse_args(argv))
    assert got.to_dict() == jax_config_from_args(jax_add_args().parse_args(argv)).to_dict()
    assert (got.lr, got.comm_round) == (0.25, 7)


@pytest.mark.parametrize("bad", [
    {"client_num_per_round": 20}, {"partition_method": "dirichlet"}, {"dtype": "float16"},
    {"wire_codec": "zip"}, {"wire_codec": "topk:0.1"}, {"chaos_drop": 0.1},
    {"rank": 0}, {"chaos_crash_rank": 1}, {"checkpoint_frequency": 0}, {"flight_on": "boom"},
    {"pulse_prometheus_dir": "p"}, {"cohort_chunk": 2}, {"lens": "maybe"},
])
def test_checks_match_jax(bad):
    with pytest.raises(ValueError):
        JaxFedConfig(**bad)
    with pytest.raises(ValueError):
        FedConfig(**bad)


def test_every_field_is_ported_xla_only_or_unported():
    names = {f.name for f in dataclasses.fields(FedConfig)}
    assert set(UNPORTED_FIELDS) <= names and set(XLA_ONLY_FIELDS) <= names
    assert not set(UNPORTED_FIELDS) & set(XLA_ONLY_FIELDS)
    assert set(NON_DEFAULT) == set(UNPORTED_FIELDS)
    assert unported_fields(FedConfig()) == {}
    # 4a's super-step, the gateway's two quotas and item 12's 21 fields
    assert len(UNPORTED_FIELDS) == 24 and GATEWAY < set(UNPORTED_FIELDS)


def _ds():
    return make_synthetic_classification("tiny", (6,), 3, 4, records_per_client=8,
                                         partition_method="homo", batch_size=4, seed=0)


@pytest.mark.parametrize("field", sorted(UNPORTED_FIELDS))
def test_unported_field_raises_at_construction(field):
    values = NON_DEFAULT[field]
    JaxFedConfig(**BASE, **values)          # a value the JAX package takes
    cfg = FedConfig(**BASE, **values)
    assert field in unported_fields(cfg)
    item = "ROADMAP §1 item 11b's gateway" if field in GATEWAY else "ROADMAP"
    with pytest.raises(NotImplementedError, match=rf"{field}=.*{item}"):
        FedAvgAPI(_ds(), cfg, device="cpu")


@pytest.mark.parametrize("field", sorted(EDGE_LIVE))
def test_edge_field_is_live(field):
    """The edge runtime's fields pass JAX's checks and the port's: no entry
    point refuses them (the simulation ignores them, as the JAX package's
    does; ``distributed/fedavg_edge.py``, ``fedbuff_edge.py`` and the wire
    layers read them)."""
    values = EDGE_LIVE[field]
    JaxFedConfig(**BASE, **values)
    cfg = FedConfig(**BASE, **values)
    assert field not in UNPORTED_FIELDS and unported_fields(cfg) == {}
    FedAvgAPI(_ds(), cfg, device="cpu")


def test_other_entry_points_check_too():
    cfg = FedConfig(**BASE, rounds_per_step=2)
    for build in (lambda: CrossSiloFedAvgAPI(_ds(), cfg, device="cpu"),
                  lambda: CentralizedTrainer(_ds(), cfg, device="cpu")):
        with pytest.raises(NotImplementedError, match="rounds_per_step"):
            build()


def test_unrolled_is_live():
    """FedNAS's ``unrolled`` is ported: no entry point refuses it (only
    FedNAS reads it, as in the JAX package)."""
    cfg = FedConfig(**BASE, unrolled=1)
    assert "unrolled" not in UNPORTED_FIELDS and unported_fields(cfg) == {}
    FedAvgAPI(_ds(), cfg, device="cpu")


def test_xla_only_fields_are_accepted_and_change_nothing():
    ds = _ds()
    plain = FedAvgAPI(ds, FedConfig(**BASE), device="cpu")
    xla = FedAvgAPI(ds, FedConfig(**BASE, donate=False, scan_unroll=4, cohort_vmap_width=2,
                                  mesh_shape=(8,)), device="cpu")
    assert plain.run_round(0) == xla.run_round(0)
    for k, v in plain.variables.items():
        np.testing.assert_array_equal(xla.variables[k].numpy(), v.numpy())


#: FedGKT's fields, each away from its default
GKT_FIELDS = {"temperature": 2.0, "alpha_distill": 0.5, "model_client": "resnet4",
              "model_server": "resnet32_server", "epochs_server": 2}


@pytest.fixture
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("field", sorted(GKT_FIELDS))
def test_gkt_field_takes_effect(field, one_torch_thread):
    from fedml_tpu_torch.algorithms.fedgkt import FedGKTAPI

    ds = make_synthetic_classification("gkt", (8, 8, 3), 3, 2, records_per_client=4,
                                       partition_method="homo", batch_size=4, seed=0)
    base = dict(BASE, client_num_in_total=2, client_num_per_round=2)
    cfgs = [FedConfig(**base), FedConfig(**base, **{field: GKT_FIELDS[field]})]
    assert unported_fields(cfgs[1]) == {}
    # the depth fields build from the names; the others train at CI depth
    depth = {} if field.startswith("model_") else dict(client_blocks=1, server_blocks_per_stage=1)
    apis = [FedGKTAPI(ds, c, device="cpu", **depth) for c in cfgs]
    blocks = [sum(n.count(".") == 0 and n.startswith("BasicBlock")
                  for n, _ in half.module.named_modules())
              for a in apis for half in (a.pair.client, a.pair.server)]
    if field == "model_client":          # resnet8 -> 3 blocks, resnet4 -> 1
        assert blocks[0::2] == [3, 1] and blocks[1] == blocks[3]
    elif field == "model_server":        # resnet56_server -> 2 x 9 blocks, resnet32 -> 2 x 5
        assert blocks[1::2] == [18, 10] and blocks[0] == blocks[2]
    elif field == "epochs_server":       # twice the server steps, the same client steps
        (c0, s0), (c1, s1) = (a.round_steps() for a in apis)
        assert (c1, s1) == (c0, 2 * s0) and len(apis[1]._server_orders(0)) == 2
    else:                                # the server's distillation term in round 0
        apis[1].client_vars = {k: v.clone() for k, v in apis[0].client_vars.items()}
        apis[1].server_vars = apis[0].server_vars
        losses = [float(a.run_round(0)[1]) for a in apis]
        assert np.isfinite(losses).all() and losses[0] != losses[1]
