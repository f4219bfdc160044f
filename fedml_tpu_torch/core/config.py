"""Typed configuration (counterpart of ``fedml_tpu/core/config.py``).

Every field of the JAX package's ``FedConfig``, with its name, type,
default and checks, and the same argparse bridge (:func:`add_args`,
:func:`config_from_args`), so a JAX launch line parses unchanged.

A field whose feature the port lacks is not ignored: :func:`unported_fields`
names each such field that is set away from its default, with the ROADMAP
item that ports it, and every API constructor and ``run_experiment`` raise
``NotImplementedError`` through :func:`check_ported`. The one exception is
:data:`XLA_ONLY_FIELDS`: fields that only tune how XLA compiles or lays out
the JAX program and change no result; the port accepts and ignores them.

Optimizer names are checked where they are built, as in the JAX package:
``parallel/local.make_optimizer`` and ``algorithms/fedopt.make_server_optimizer``
raise ``ValueError`` for an unknown name, so an API given one fails when it
is constructed.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

try:
    import yaml
except ImportError:  # pragma: no cover
    yaml = None


@dataclass
class FedConfig:
    # model / data
    model: str = "lr"
    dataset: str = "mnist"
    data_dir: str = "./data"
    partition_method: str = "hetero"     # homo | hetero | hetero-fix | given
    partition_alpha: float = 0.5
    class_num: Optional[int] = None      # when set, checked against the dataset's

    # federation topology
    client_num_in_total: int = 10
    client_num_per_round: int = 10
    comm_round: int = 10
    group_num: int = 1
    group_comm_round: int = 1

    # local training
    batch_size: int = 32
    client_optimizer: str = "sgd"    # sgd | adam (amsgrad) | adamw | adagrad | yogi
    lr: float = 0.03
    wd: float = 0.0
    momentum: float = 0.0
    epochs: int = 1
    grad_clip: Optional[float] = None

    # server optimizer (FedOpt): sgd (FedAvgM with server_momentum > 0) |
    # adam | adagrad | yogi
    server_optimizer: str = "sgd"
    server_lr: float = 1.0
    server_momentum: float = 0.0

    # FedProx: each local step adds (mu / 2) ||w - w_global||^2 to the loss
    fedprox_mu: float = 0.1

    # robustness
    norm_bound: Optional[float] = None
    stddev: Optional[float] = None
    attack_type: Optional[str] = None
    poison_frac: float = 0.0

    # FedNAS
    unrolled: int = 0

    # FedGKT
    temperature: float = 3.0
    alpha_distill: float = 1.0
    model_client: str = "resnet8"
    model_server: str = "resnet56_server"
    epochs_server: int = 1

    # the edge runtime (distributed/fedavg_edge.py, fedbuff_edge.py):
    # transports, ranks, the wire codec and delta uploads, inbox caps, the
    # reliable wire (comm/reliable.py) and chaos injection (comm/chaos.py);
    # the gateway's quotas are refused (item 11b's gateway)
    backend: str = "mesh"            # mesh | inproc | grpc | mqtt
    rank: Optional[int] = None
    world_size: Optional[int] = None
    grpc_ipconfig_path: Optional[str] = None
    grpc_base_port: int = 50000
    wire_codec: str = "raw"          # raw | q8 | topk:<ratio>
    wire_delta: bool = False
    wire_reliable: bool = False
    wire_retry_base_s: float = 0.05
    wire_retry_max: int = 10
    wire_inbox_cap: int = 0
    gateway_max_tenants: int = 8
    gateway_tenant_workers: int = 0
    chaos_seed: int = 0
    chaos_drop: float = 0.0
    chaos_dup: float = 0.0
    chaos_delay_ms: float = 0.0
    chaos_reorder: float = 0.0
    chaos_crash_rank: Optional[int] = None
    chaos_crash_after: Optional[int] = None
    chaos_crash_restart_s: Optional[float] = None
    frequency_of_the_test: int = 5
    # the reference's JSON-list wire for mobile clients: accepted and, as in
    # the JAX package, without effect (the frames are binary)
    is_mobile: int = 0
    seed: int = 0
    ci: int = 0                      # CI fast path: at most 2 rounds of 1 epoch

    mesh_shape: tuple = ()
    dtype: str = "float32"           # compute dtype: float32 | bfloat16
    donate: bool = True
    # return each round's loss as a 0-dim device tensor (no host sync)
    async_rounds: bool = False
    # "off" ships each round's cohort from host memory; otherwise the whole
    # stacked client dataset is placed on the device once ("auto": when its
    # bytes per rank fit device_data_max_bytes)
    device_data: str = "auto"
    device_data_max_bytes: int = 6_000_000_000
    # the host round's record axis and the cross-silo grouped schedule:
    # cut to the live cohort's (a group's) largest count rounded up to
    # bucket_quantum_batches batches (0 = off), in up to bucket_groups groups
    bucket_quantum_batches: int = 8
    bucket_groups: int = 1
    # client packing (parallel/packed.py): the cohort runs in up to
    # pack_lanes lanes, each lane's clients back to back; packed_conv is the
    # lane-stacked twin's conv lowering (off | grouped | blockdiag,
    # ops/packed_conv.py); "auto" (fedplan) is not ported
    pack_lanes: int = 0
    packed_conv: str = "off"
    # the cross-silo super-step (rounds folded into one program): not ported
    rounds_per_step: int = 1
    scan_unroll: int = 1
    # the host round pipeline (data/pipeline.CohortPrefetcher): this many
    # future rounds (streamed: chunks) materialized, cast and copied to the
    # device on background threads (0 = serial); workers fan materialization
    # out over a cohort's clients (0 = auto)
    host_pipeline_depth: int = 0
    host_pipeline_workers: int = 0
    # cohort selection (data/sched.py): uniform | speed | fair
    cohort_policy: str = "uniform"
    # fedbuff (asynchronous buffered aggregation, algorithms/fedbuff.py)
    buffer_k: int = 4
    buffer_staleness_alpha: float = 0.5
    buffer_mode: str = "arrival"
    # streamed host rounds (device_data off): the cohort trains in
    # sub-cohort chunks of cohort_chunk clients (0 = one chunk), each folded
    # into one f32 model-shaped accumulator as it finishes
    stream_aggregate: str = "off"
    cohort_chunk: int = 0
    # the JAX package's chunked vmap of the cohort; the port trains client
    # by client (or in packed lanes) whatever it says
    cohort_vmap_width: int = 0

    # observability: train()'s metrics logger (JSONL in memory, wandb when
    # installed) and, when profile_dir is set, a torch.profiler trace
    run_name: str = "fedml_tpu"
    enable_wandb: bool = False
    trace_dir: Optional[str] = None
    trace_buffer_events: int = 65536
    trace_sample_rate: float = 1.0
    sketch_alpha: float = 0.01
    cost_attribution: bool = False
    pulse_path: Optional[str] = None
    pulse_prometheus_dir: Optional[str] = None
    health_loss_limit: float = 0.0
    health_stall_sec: Optional[float] = None
    health_stale_spike: int = 8
    health_skew: float = 4.0
    health_version_lag: float = 0.0
    health_update_norm: float = 0.0
    health_drift: float = 0.0
    health_escalate: bool = False
    lens: str = "off"
    lens_topk: int = 5
    flight_dir: Optional[str] = None
    flight_window: int = 8
    flight_on: str = "escalate,quarantine,peer_dead,manual"
    trace_device_sampler: bool = True

    # checkpoint / resume: train() writes <checkpoint_dir>/latest.ckpt every
    # checkpoint_frequency rounds and after the last; resume_from restores
    checkpoint_dir: Optional[str] = None
    checkpoint_frequency: int = 10
    resume_from: Optional[str] = None

    # elastic rounds: each sampled client fails a round with this
    # probability and aggregates with weight 0
    failure_prob: float = 0.0
    # the edge server aggregates the uploads in by this many seconds after
    # a broadcast and marks the missing workers dead (None: wait for all);
    # the simulation paradigms ignore it, as the JAX package's do
    straggler_deadline_sec: Optional[float] = None

    profile_dir: Optional[str] = None

    def __post_init__(self):
        if self.client_num_per_round > self.client_num_in_total:
            raise ValueError(
                f"client_num_per_round ({self.client_num_per_round}) > "
                f"client_num_in_total ({self.client_num_in_total})")
        if self.partition_method not in ("homo", "hetero", "hetero-fix", "given"):
            raise ValueError(f"unknown partition_method {self.partition_method!r}")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"dtype must be float32|bfloat16, got {self.dtype!r}")
        if self.device_data not in ("auto", "on", "off"):
            raise ValueError(f"device_data must be auto|on|off, got {self.device_data!r}")
        if self.bucket_groups < 1:
            raise ValueError(f"bucket_groups must be >= 1, got {self.bucket_groups}")
        if self.pack_lanes < 0:
            raise ValueError(f"pack_lanes must be >= 0, got {self.pack_lanes}")
        if self.packed_conv not in ("off", "blockdiag", "grouped", "auto"):
            raise ValueError(f"packed_conv must be off|blockdiag|grouped|auto, got "
                             f"{self.packed_conv!r}")
        if self.packed_conv == "auto":
            raise NotImplementedError("packed_conv='auto' is not ported: fedplan scores XLA "
                                      "HLO, which has no CUDA counterpart (ROADMAP §1 item 12)")
        if self.cohort_policy not in ("uniform", "speed", "fair"):
            raise ValueError(f"cohort_policy must be uniform|speed|fair, got "
                             f"{self.cohort_policy!r}")
        if self.stream_aggregate not in ("off", "deterministic", "arrival"):
            raise ValueError(f"stream_aggregate must be off|deterministic|arrival, got "
                             f"{self.stream_aggregate!r}")
        if self.wire_retry_base_s <= 0:
            raise ValueError(f"wire_retry_base_s must be > 0, got {self.wire_retry_base_s}")
        if self.wire_retry_max < 1:
            raise ValueError(f"wire_retry_max must be >= 1, got {self.wire_retry_max}")
        if self.wire_inbox_cap < 0:
            raise ValueError(f"wire_inbox_cap must be >= 0 (0 = unbounded), got "
                             f"{self.wire_inbox_cap}")
        if self.gateway_max_tenants < 1:
            raise ValueError(f"gateway_max_tenants must be >= 1, got {self.gateway_max_tenants}")
        if self.gateway_tenant_workers < 0:
            raise ValueError(f"gateway_tenant_workers must be >= 0 (0 = unlimited), got "
                             f"{self.gateway_tenant_workers}")
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}: a version emits "
                             "every buffer_k folded contributions")
        if self.buffer_staleness_alpha < 0.0:
            raise ValueError(f"buffer_staleness_alpha must be >= 0, got "
                             f"{self.buffer_staleness_alpha} (0 = no staleness decay)")
        if self.buffer_mode not in ("deterministic", "arrival"):
            raise ValueError(f"buffer_mode must be deterministic|arrival, got "
                             f"{self.buffer_mode!r}")
        if self.cohort_chunk < 0:
            raise ValueError(f"cohort_chunk must be >= 0, got {self.cohort_chunk}")
        if self.cohort_chunk > 0 and self.stream_aggregate == "off":
            raise ValueError("cohort_chunk > 0 needs stream_aggregate: sub-cohort chunks only "
                             "exist to be folded into the streaming accumulator; set "
                             "stream_aggregate='deterministic' (or 'arrival')")
        if self.rounds_per_step < 1:
            raise ValueError(f"rounds_per_step must be >= 1, got {self.rounds_per_step}")
        if self.host_pipeline_depth < 0:
            raise ValueError(f"host_pipeline_depth must be >= 0, got "
                             f"{self.host_pipeline_depth}")
        if self.host_pipeline_workers < 0:
            raise ValueError(f"host_pipeline_workers must be >= 0, got "
                             f"{self.host_pipeline_workers}")
        if self.trace_buffer_events < 1:
            raise ValueError(f"trace_buffer_events must be >= 1, got {self.trace_buffer_events}")
        if not 0.0 <= self.trace_sample_rate <= 1.0:
            raise ValueError(f"trace_sample_rate must be in [0, 1], got "
                             f"{self.trace_sample_rate}")
        if not 0.0 < self.sketch_alpha < 0.5:
            raise ValueError(f"sketch_alpha must be in (0, 0.5), got {self.sketch_alpha}")
        if self.pulse_prometheus_dir and not self.pulse_path:
            raise ValueError("pulse_prometheus_dir requires pulse_path: the Prometheus mirror "
                             "re-renders the pulse snapshots")
        for name in ("health_loss_limit", "health_stale_spike", "health_skew",
                     "health_version_lag", "health_update_norm", "health_drift"):
            if getattr(self, name) < 0:
                raise ValueError(f"{name} must be >= 0, got {getattr(self, name)}")
        if self.health_stall_sec is not None and self.health_stall_sec <= 0:
            raise ValueError(f"health_stall_sec must be > 0, got {self.health_stall_sec}")
        if self.flight_window < 1:
            raise ValueError(f"flight_window must be >= 1, got {self.flight_window}")
        allowed = {"escalate", "quarantine", "peer_dead", "manual"}
        toks = {t.strip() for t in (self.flight_on or "").split(",") if t.strip()}
        if toks - allowed:
            raise ValueError(f"flight_on has unknown trigger(s) {sorted(toks - allowed)}; "
                             f"allowed: {sorted(allowed)}")
        if self.checkpoint_frequency < 1:
            raise ValueError(f"checkpoint_frequency must be >= 1, got "
                             f"{self.checkpoint_frequency}")
        if not 0.0 <= self.failure_prob < 1.0:
            raise ValueError(f"failure_prob must be in [0, 1), got {self.failure_prob}")
        if self.straggler_deadline_sec is not None and self.straggler_deadline_sec <= 0:
            raise ValueError(f"straggler_deadline_sec must be > 0 (got "
                             f"{self.straggler_deadline_sec})")
        if self.rank is not None:
            if self.world_size is None or self.world_size < 2:
                raise ValueError("--rank requires --world_size >= 2 (1 server + >=1 worker)")
            if not 0 <= self.rank < self.world_size:
                raise ValueError(f"rank {self.rank} out of range for world_size "
                                 f"{self.world_size}")
        for name in ("chaos_drop", "chaos_dup", "chaos_reorder"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if self.chaos_delay_ms < 0:
            raise ValueError(f"chaos_delay_ms must be >= 0, got {self.chaos_delay_ms}")
        if (self.chaos_drop or self.chaos_dup or self.chaos_reorder) and not self.wire_reliable:
            raise ValueError("chaos drop/dup/reorder need wire_reliable=True")
        if (self.chaos_crash_rank is None) != (self.chaos_crash_after is None):
            raise ValueError("chaos_crash_rank and chaos_crash_after must be set together")
        if self.chaos_crash_restart_s is not None:
            if self.chaos_crash_rank is None:
                raise ValueError("chaos_crash_restart_s needs chaos_crash_rank/"
                                 "chaos_crash_after")
            if self.chaos_crash_restart_s <= 0:
                raise ValueError(f"chaos_crash_restart_s must be > 0, got "
                                 f"{self.chaos_crash_restart_s}")
        if self.lens not in ("off", "on"):
            raise ValueError(f"lens must be 'off' or 'on', got {self.lens!r}")
        if self.lens_topk < 1:
            raise ValueError(f"lens_topk must be >= 1, got {self.lens_topk}")
        from fedml_tpu_torch.core.compression import parse_codec

        parse_codec(self.wire_codec)   # raises on an unknown codec spec
        if self.wire_codec.startswith("topk") and not self.wire_delta:
            raise ValueError("wire_codec='topk:..' sparsifies uploads destructively unless they "
                             "are error-feedback deltas; set wire_delta=True")
        if self.ci:
            # CI fast path (reference fedavg_api.py:157-162)
            self.comm_round = min(self.comm_round, 2)
            self.epochs = min(self.epochs, 1)

    def replace(self, **kw) -> "FedConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FedConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


#: Fields that only tune how XLA compiles or lays out the JAX program (buffer
#: donation, scan unrolling, the chunked vmap of a cohort, the TPU device
#: mesh) and change no result: the port accepts and ignores them.
XLA_ONLY_FIELDS = ("donate", "scan_unroll", "cohort_vmap_width", "mesh_shape")

#: the federation gateway and its flow control, which import the
#: observability layer; the other edge protocols (item 11c) read no field of
#: their own
_GATEWAY = "ROADMAP §1 item 11b's gateway, after item 12 (the federation gateway)"
_OBS = "ROADMAP §1 item 12 (observability: tracing, pulse plane, health, fedlens, flight)"
#: field -> the ROADMAP item that ports its feature; set away from its
#: default, each raises (check_ported)
UNPORTED_FIELDS = {
    **{name: _GATEWAY for name in ("gateway_max_tenants", "gateway_tenant_workers")},
    "rounds_per_step": "ROADMAP §1 item 4a (the cross-silo super-step)",
    **{name: _OBS for name in (
        "trace_dir", "trace_buffer_events", "trace_sample_rate", "sketch_alpha",
        "cost_attribution", "pulse_path", "pulse_prometheus_dir", "health_loss_limit",
        "health_stall_sec", "health_stale_spike", "health_skew", "health_version_lag",
        "health_update_norm", "health_drift", "health_escalate", "lens", "lens_topk",
        "flight_dir", "flight_window", "flight_on", "trace_device_sampler")},
}

DEFAULTS = {f.name: f.default for f in dataclasses.fields(FedConfig)}


def unported_fields(config: FedConfig) -> dict[str, str]:
    """``{field: ROADMAP item}`` of every field set away from its default
    whose feature the port lacks."""
    return {name: item for name, item in UNPORTED_FIELDS.items()
            if getattr(config, name) != DEFAULTS[name]}


def check_ported(config: FedConfig) -> None:
    """Raise ``NotImplementedError`` naming every field of ``config`` that
    asks for a feature the port lacks (``unported_fields``)."""
    bad = unported_fields(config)
    if bad:
        raise NotImplementedError("not ported yet: " + "; ".join(
            f"{name}={getattr(config, name)!r} ({item})" for name, item in bad.items()))


def _flag(s: str) -> bool:
    return bool(int(s))


def add_args(parser: Optional[argparse.ArgumentParser] = None) -> argparse.ArgumentParser:
    """The JAX package's argparse bridge: the same flags, types and
    defaults (the reference's flag names, main_fedavg.py:48-120)."""
    p = parser or argparse.ArgumentParser(description="fedml_tpu_torch experiment")
    d = FedConfig()
    for name, typ in (("model", str), ("dataset", str), ("data_dir", str),
                      ("partition_method", str), ("partition_alpha", float),
                      ("client_num_in_total", int), ("client_num_per_round", int),
                      ("comm_round", int), ("group_num", int), ("group_comm_round", int),
                      ("unrolled", int), ("batch_size", int), ("client_optimizer", str),
                      ("lr", float), ("wd", float), ("momentum", float), ("epochs", int),
                      ("server_optimizer", str), ("server_lr", float),
                      ("server_momentum", float), ("fedprox_mu", float)):
        p.add_argument(f"--{name}", type=typ, default=getattr(d, name))
    p.add_argument("--norm_bound", type=float, default=None)
    p.add_argument("--stddev", type=float, default=None)
    for name, typ in (("temperature", float), ("alpha_distill", float), ("model_client", str),
                      ("model_server", str), ("epochs_server", int), ("backend", str)):
        p.add_argument(f"--{name}", type=typ, default=getattr(d, name))
    p.add_argument("--rank", type=int, default=None,
                   help="start only this rank as its own process (0 = server)")
    p.add_argument("--world_size", type=int, default=None,
                   help="total ranks (1 server + N workers) for --rank mode")
    p.add_argument("--grpc_ipconfig_path", type=str, default=None,
                   help="rank->IP csv; default loopback")
    for name, typ in (("grpc_base_port", int), ("frequency_of_the_test", int),
                      ("is_mobile", int), ("seed", int), ("ci", int), ("dtype", str)):
        p.add_argument(f"--{name}", type=typ, default=getattr(d, name))
    p.add_argument("--device_data", type=str, default=d.device_data,
                   choices=("auto", "on", "off"))
    for name in ("device_data_max_bytes", "bucket_quantum_batches", "bucket_groups",
                 "rounds_per_step", "pack_lanes"):
        p.add_argument(f"--{name}", type=int, default=getattr(d, name))
    p.add_argument("--packed_conv", type=str, default=d.packed_conv,
                   choices=("off", "blockdiag", "grouped", "auto"))
    p.add_argument("--host_pipeline_depth", type=int, default=d.host_pipeline_depth,
                   help="prefetch this many future rounds' cohorts on background threads "
                        "(host round paths; 0 = serial)")
    p.add_argument("--host_pipeline_workers", type=int, default=d.host_pipeline_workers,
                   help="threads fanning one cohort's materialization out over its clients "
                        "(0 = auto)")
    p.add_argument("--cohort_policy", type=str, default=d.cohort_policy,
                   choices=("uniform", "speed", "fair"))
    p.add_argument("--stream_aggregate", type=str, default=d.stream_aggregate,
                   choices=("off", "deterministic", "arrival"))
    p.add_argument("--buffer_k", type=int, default=d.buffer_k)
    p.add_argument("--buffer_staleness_alpha", type=float, default=d.buffer_staleness_alpha)
    p.add_argument("--buffer_mode", type=str, default=d.buffer_mode,
                   choices=("deterministic", "arrival"))
    p.add_argument("--cohort_chunk", type=int, default=d.cohort_chunk,
                   help="stream the host round in sub-cohorts of this many clients "
                        "(0 = whole cohort; requires --stream_aggregate)")
    p.add_argument("--scan_unroll", type=int, default=d.scan_unroll)
    p.add_argument("--cohort_vmap_width", type=int, default=d.cohort_vmap_width)
    p.add_argument("--wire_codec", type=str, default=d.wire_codec)
    for name in ("wire_delta", "wire_reliable"):
        p.add_argument(f"--{name}", type=_flag, default=getattr(d, name))
    p.add_argument("--wire_retry_base_s", type=float, default=d.wire_retry_base_s)
    for name in ("wire_retry_max", "wire_inbox_cap", "gateway_max_tenants",
                 "gateway_tenant_workers", "chaos_seed"):
        p.add_argument(f"--{name}", type=int, default=getattr(d, name))
    for name in ("chaos_drop", "chaos_dup", "chaos_delay_ms", "chaos_reorder"):
        p.add_argument(f"--{name}", type=float, default=getattr(d, name))
    p.add_argument("--chaos_crash_rank", type=int, default=None)
    p.add_argument("--chaos_crash_after", type=int, default=None)
    p.add_argument("--chaos_crash_restart_s", type=float, default=None)
    p.add_argument("--trace_dir", type=str, default=None)
    p.add_argument("--trace_buffer_events", type=int, default=d.trace_buffer_events)
    p.add_argument("--trace_sample_rate", type=float, default=d.trace_sample_rate)
    p.add_argument("--sketch_alpha", type=float, default=d.sketch_alpha)
    p.add_argument("--pulse_path", type=str, default=None)
    p.add_argument("--pulse_prometheus_dir", type=str, default=None)
    p.add_argument("--health_loss_limit", type=float, default=d.health_loss_limit)
    p.add_argument("--health_stall_sec", type=float, default=None)
    p.add_argument("--health_stale_spike", type=int, default=d.health_stale_spike)
    for name in ("health_skew", "health_version_lag", "health_update_norm", "health_drift"):
        p.add_argument(f"--{name}", type=float, default=getattr(d, name))
    p.add_argument("--health_escalate", type=_flag, default=d.health_escalate)
    p.add_argument("--lens", type=str, choices=("off", "on"), default=d.lens)
    p.add_argument("--lens_topk", type=int, default=d.lens_topk)
    p.add_argument("--flight_dir", type=str, default=None)
    p.add_argument("--flight_window", type=int, default=d.flight_window)
    p.add_argument("--flight_on", type=str, default=d.flight_on)
    p.add_argument("--trace_device_sampler", type=_flag, default=d.trace_device_sampler)
    p.add_argument("--cost_attribution", type=_flag, default=d.cost_attribution)
    p.add_argument("--run_name", type=str, default=d.run_name)
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--checkpoint_frequency", type=int, default=d.checkpoint_frequency)
    p.add_argument("--resume_from", type=str, default=None)
    p.add_argument("--failure_prob", type=float, default=d.failure_prob)
    p.add_argument("--straggler_deadline_sec", type=float, default=None)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of train() here")
    p.add_argument("--config_yaml", type=str, default=None, help="optional YAML overriding flags")
    return p


def config_from_args(args: argparse.Namespace) -> FedConfig:
    d = vars(args).copy()
    yaml_path = d.pop("config_yaml", None)
    cfg = FedConfig.from_dict(d)
    if yaml_path:
        if yaml is None:
            raise RuntimeError("pyyaml not available but --config_yaml was passed")
        base = cfg.to_dict()
        with open(yaml_path) as f:
            base.update(yaml.safe_load(f) or {})
        cfg = FedConfig.from_dict(base)
    return cfg
