#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every kernel
on that path against its plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure raises and the script exits non-zero):

1. Build every CUDA kernel from ``fedml_tpu_torch/ops/csrc`` with nvcc, one
   process per source, all started together.
2. Hold K1 (BN forward) and K2 (BN backward) against their plain versions
   on the card: ResNet-56's BN shapes at batch 64, unpacked and folded over
   the packed schedule's two lanes ([rows, 2*C]), a ragged row count,
   scalar-load channel counts (C = 7, 300) and shapes past the kernels'
   on-chip capacity (planned C = 64, C = 16, then C = 64 again, and 10^6
   rows); K2 also at one row and fewer rows than the card holds blocks; f32
   and bf16, ReLU on and off, both bit-identical over two calls; then a
   small CifarResNet forward and backward through the kernels against the
   same model on the CPU, and two steps of ResNet-56 through them at batch
   512.
3. Time each kernel at the main path's shapes with CUDA events, beside its
   plain version, ``F.batch_norm`` (+ReLU) as a library yardstick, and its
   byte/operation bound: the unpacked shapes, then the folded ones.
4. Train 2 rounds of FedAvg (ResNet-56, ``bn_impl="pallas"``, bf16, 32
   non-IID synthetic CIFAR-10-shaped clients, 8 per round, batch 64, lr 0.1,
   momentum 0.9), evaluate, and check the loss and the kernel launch counts.
4b. The same 2 rounds under the packing schedule of ``bench.py``'s flagship
   (``pack_lanes=2``, ``packed_conv="off"``): the cohort in two lanes folded
   into the channel axis, 57 K1 and 57 K2 per executed packed step, none in
   ``evaluate_global``; then a small f32 packed round on the card against the
   same round unpacked; one bf16 packed step of ResNet-56 at batch 64 against
   the two lanes' plain bf16 and f32 steps (logits, gradients, BN statistics);
   a control (round 0 unpacked and packed with the plain BN, a change of
   summation order only); the grouped conv timed against two ungrouped
   convs and one lane's; and a profile of 5 packed steps.
4c. The zoo on the same federation and widths: 2 packed rounds of FedOpt
   with server adam (server_lr 0.01; bench.py's adaptive arm), one packed
   round each of FedProx (mu 0.01), FedNova (momentum 0.9) and FedAGC
   (clipping 1e-2), one plain round of FedAvg with client adam (amsgrad, lr
   1e-3): finite losses, 57 K1 + 57 K2 per executed packed or live step,
   FedOpt's server state on the card and nonzero, small f32 FedOpt-adam and
   client-adam rounds packed against unpacked, the server step's time, a
   profile of 5 packed FedOpt steps and one of 5 client-adam steps.
4d. The cross-silo paradigm (``CrossSiloFedAvgAPI``, one rank) in
   ``bench.py``'s cross-silo configuration: the 32 flagship silos, every
   one every round, data resident; arms (a) the packed mesh (2 lanes), (b)
   the grouped schedule (``bucket_groups=6``), (c) resident-sharded, (d)
   FedOpt with server adam on (a), (e) (a) at 8 and 16 silos and the fit
   T(c) = a + b*c. Each: a warm-up round, then 2 timed rounds (1 for (d))
   ending in a sync, real and padded images/s, 57 K1 + 57 K2 and one
   replay per executed step, finite losses, a 5-step profile; FedOpt's
   server state on the card and nonzero; a small f32 packed and resident
   mesh round against the simulation round (relative norm 1e-5); one
   packed mesh round at 8 silos under a world-size-1 NCCL process group
   (``file://`` store in a temporary directory) bit-identical to the
   group-less round, its all-reduce profiled and timed.
4e. The cross-device paradigm. (a) The flagship's host round
   (``device_data="off"``) streamed in chunks of 4 clients (2 a round),
   packed in 2 lanes, bf16 through K1/K2: the pipeline off, at depth 2, and
   at depth 2 under the speed policy with the population's count prior
   (its cohorts equal to the CPU ``plan_cohort``'s); a warm-up round, then
   2 timed rounds ending in a sync; rounds/s, real images/s, the stage rows,
   ``stream_stats``; 57 K1 + 57 K2 and one replay a packed step; the
   pipelined rounds bit-identical to the serial ones. Then f32 ResNet-56 on
   6 small clients: the unchunked streamed round equal to the batch host
   round bit for bit, chunked against unchunked within rtol 1e-6 / atol
   1e-7 (plain) and 1e-5 / 1e-6 (packed), and chunks of 4 and 1 clients
   (a capture mid-round under a running prefetcher) pipelined equal to
   serial. (b) bench.py's r05 basis row: ``lr`` on the 342,477-client
   stackoverflow LR task, 50 a round, bf16, the pipeline off against depth
   2 (3 warm-up rounds, prime, 3 timed). (c) bench.py's fedsched arms on a
   million clients: 50 a round batched, 1,000 a round streamed in chunks of
   250 at 4 lanes, uniform and speed. (b) and (c) run no TPU kernel. The
   phase runs after phase 12 (see ``main``).
5. Hold K3 (lanes 3x3 conv, also the dgrad), K4 (its wgrad) and K7 (K3's
   probe variants) against their plain versions at the lanes path's conv
   shapes at batch 64, 1 and 3 and five ragged shapes (the last takes the
   CUDA-core K3 in bf16: its tensor-core stage does not fit), f32 and bf16, K3,
   K4 and K7's kernel mode bit-identical over two calls and K7's kernel mode
   equal to K3, its patches and copy modes exact; then a small lanes
   CifarResNet on the card against the same model on the CPU.
6. Time K3 and K4 at those shapes in bf16 beside their plain versions,
   ``F.conv2d`` / ``torch.nn.grad.conv2d_weight`` and their bounds.
7. The K7 probe (the counterpart of ``tools/lanes_probe.py``): per-call
   times of the library conv, K3, its patch build, one copy, K4, forward +
   dgrad and forward + wgrad at the probe shapes, and K3's device time split
   into the mma loop with its W2 staging (kernel - copy), the tap gather
   (patches - copy) and staging plus copy-out (copy), each mode beside its
   bound.
8. Train the same 2 rounds with ``conv_impl="lanes", bn_impl="xla"`` and
   check the loss and the launch counts (72 K3 and 36 K4 per live step, 36
   K3 per eval batch, no BN kernel).

9. Hold K6 (flash attention) and K5 (fused cross-entropy) against their
   plain versions: K6 at path (B)'s and path (A)'s shapes, causal and not,
   a shifted query window, ragged T at each head dim, 4 merged K/V chunks
   with a fully future one, f32 and bf16, and in bf16 every Tq, Tk at the
   tensor-core kernel's tile edges (63, 64, 65, 129) and the diagonal
   mid-tile, each bf16 case bit-identical over two calls; K5 at 16384 x 10004, vocab 90,
   1003 and a ragged N, f32 and bf16 logits, int32 and int64 labels; then
   a small TransformerLM through both on the card against the CPU.
10. Time K6 and K5 at path (B)'s shapes beside their plain versions,
   ``F.scaled_dot_product_attention`` / ``F.cross_entropy`` and bounds
   (K6's: the largest of its bytes, its tensor-core FLOPs and one
   exponential per live score at 16 per clock per SM and the card's
   ``nvidia-smi clocks.max.sm``); device time both from the profiler and
   from CUDA events behind a primed queue (``queued_device_ms``).
11. Path (A): 2 FedAvg rounds of ``transformer`` (dim 256, 8 heads, 4
   layers, bf16) on the synthetic fed_shakespeare federation (100 clients,
   10 a round, batch 4, sequences of 80); 4 K6 per live step and per eval
   batch, no other kernel.
12. Path (B): 5 steps of the one-card LM step (``transformer_nwp``
   widths, vocab 10004, T = 8192, batch 2, bf16, remat, SGD lr 0.1) on one
   fixed batch; 8 K6 and 1 K5 per step, the loss falls; tokens/s, ms/step
   and peak memory.

Every live step of phases 4, 4b, 4c, 4d, 4e, 8 and 11 is a replay of the step
captured as one CUDA graph (``parallel/capture.py``): each round checks one
replay a live (or executed packed) step and the kernels' launch counts, to
which a replay adds the launches its capture recorded. Each of those phases
but 4d and 4e (in 4c the FedOpt-adam packed run and the client-adam plain
run; 4d's arms take their steps from the same trainers; 4e's are neither
re-run eagerly nor profiled) then runs
one client's first 12 live steps (or one packed cohort) through the eager
step (``capture=False``) twice and captured once: when the eager runs
repeat bit for bit, the captured run must too, else it may be no farther
from the first eager run than the second is, and the tensors one eager
step already changes name the op. Then 5 steps of each arm are profiled
(wall and device ms per step, busy share, GPU activities, the host's
launch calls, K1 and K2 by name: 57 a step on the BN paths), the captured
graph's kernel nodes are read through libcuda's graph API (57 K1 + 57 K2
nodes, all cooperative, on the BN paths; 72 K3 and 36 cooperative K4 on
the lanes path; 4 K6 on path (A)), and the grid-barrier words of each
capturing stream must be back at zero. Phases 4 and 4b also run their
rounds again from the same weights through the eager step, for real
images/s both ways. Phase 12 profiles one more (eager) step.

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. A fuller record goes to
``results/chip_smoke.json``. f32 comparisons run with TF32 off.
"""

from __future__ import annotations

import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
EPS = 1e-5

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores (the work of K1/K2 is elementwise f32) and bf16
# FLOP/s on the tensor cores (the least time of a bf16 conv, K3/K4).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# exponentials per clock per SM on the special-function units (K6's third
# bound: one exp per live score)
EXP_PER_CLOCK_PER_SM = 16

# ResNet-56 train-mode BNs per local step at batch 64, by (rows, C, relu):
# stage 1 (32x32x16): stem + 9 first-of-block BNs with ReLU, 9 without;
# stages 2 and 3: 9 with ReLU, 9 second-of-block + 1 projection without.
MAIN_PATH_BNS = {
    (65536, 16, True): 10, (65536, 16, False): 9,
    (16384, 32, True): 9, (16384, 32, False): 10,
    (4096, 64, True): 9, (4096, 64, False): 10,
}
BNS_PER_STEP = sum(MAIN_PATH_BNS.values())      # 57
# the packed flagship (pack_lanes=2): the same BNs, each over both lanes'
# channels, [rows, 2*C]
PACK_LANES = 2
PACKED_BNS = {(n, PACK_LANES * C, relu): k for (n, C, relu), k in MAIN_PATH_BNS.items()}
FOLDED_SHAPES = sorted({(n, C) for n, C, _ in PACKED_BNS}, reverse=True)
# K1 and K2 checks: the path's shapes and a ragged row count; C = 7 and C =
# 300 (scalar loads; two columns a thread at 300 in bf16); shapes past the
# on-chip capacity, whose second pass reads rows again from device memory.
# K2 alone also at one row, 37 rows and fewer rows than the card holds
# blocks: K1, as the TPU kernel, takes var = E[x^2] - mean^2, which at a row
# or two misses the plain two-pass variance by more than its tolerance, so
# it is checked at >= 4,096 rows.
CHECK_SHAPES = [(65536, 16), (16384, 32), (4096, 64), *FOLDED_SHAPES,
                (12347, 24)]   # last: ragged
SCALAR_SHAPES = [(8_191, 7), (4_096, 300)]
REREAD_SHAPE = (1_000_000, 16)
# A plan sets its kernel's shared-memory limit, and a plan past its on-chip
# rows asks for more at C = 64 than at C = 16: a C = 64 plan, a new C = 16
# plan, then the C = 64 shape again, which must still launch.
K2_PLAN_ORDER = [(100_003, 64), (200_003, 16), (100_003, 64)]
# past the rows a block keeps on chip: K2 (x and g on chip) at all of
# these, K1 (x alone, twice the rows) at 10^6 x 16 and 100,003 x 64
REREAD_SHAPES = {REREAD_SHAPE, *K2_PLAN_ORDER}
K1_REREAD_SHAPES = {REREAD_SHAPE, K2_PLAN_ORDER[0]}
K1_SHAPES = [*CHECK_SHAPES, *SCALAR_SHAPES, *K2_PLAN_ORDER, REREAD_SHAPE]
BN_CHECK_SHAPES = [*CHECK_SHAPES, (1, 16), (200, 64), (1000, 300), (37, 7), *SCALAR_SHAPES,
                   *K2_PLAN_ORDER, REREAD_SHAPE]
# ResNet-56 on the BN kernels at this batch: its C = 32 and C = 16 layers
# keep a block's full budget of rows on chip, at two sizes of shared memory
BN_BIG_BATCH = 512

# ResNet-56 lanes (conv_impl="lanes") K3 calls per local step at batch 64,
# by (Ci, Co, H, W): stage 1's 18 convs forward and as dgrad; stage 2
# block 0's 16->32 conv at 32x32 (before the subsample) and its dgrad
# 32->16; stage 2's 17 other convs at 16x16 forward and as dgrad.
CONV_CALLS = {(16, 16, 32, 32): 36, (16, 32, 32, 32): 1, (32, 16, 32, 32): 1,
              (32, 32, 16, 16): 34}
WGRAD_CALLS = {(16, 16, 32, 32): 18, (16, 32, 32, 32): 1, (32, 32, 16, 16): 17}
CONV_PER_STEP = sum(CONV_CALLS.values())       # 72
WGRAD_PER_STEP = sum(WGRAD_CALLS.values())     # 36
CONV_BATCH = 64
# ragged (N, Ci, Co, H, W): one row tile; several with a partial last one;
# rows wider than a block's 256 threads; 3 channels on rows so wide that the
# bf16 K3's tensor-core stage (Ci padded to 16) does not fit even at one row,
# so that it runs the CUDA-core kernel
CONV_RAGGED = [(3, 12, 20, 10, 14), (3, 20, 12, 10, 14), (3, 20, 12, 37, 13), (1, 8, 8, 3, 300),
               (1, 3, 8, 2, 1200)]
PROBE_SHAPES = [(16, 16, 32, 32), (32, 32, 16, 16)]
EVAL_BATCH = 256      # make_eval_fn's default batch

# The transformer LM paths. (B): q, k, v [B, H, T, D] of the one-card LM
# step (transformer_nwp widths: 8 heads of 32; T = 8192, batch 2) and its
# K5 rows (B*T of vocab 10004); with remat each of the 4 blocks runs K6
# twice per step. (A): FedAvg of `transformer` at batch 4, sequences of 80.
LM_BATCH, LM_SEQ = 2, 8192
ATTN_B = (LM_BATCH, 8, LM_SEQ, LM_SEQ, 32)
ATTN_A = (4, 8, 80, 80, 32)
XENT_B = (LM_BATCH * LM_SEQ, 10004)
LM_K6_PER_STEP = 8

# K3 (and K7 "kernel") against its plain version: f32, the sum over 9*Ci
# terms runs in another order (up to ~1e-6 at |y| ~ 2); bf16 outputs: both
# round an f32 value that differs in its last bits, so one bf16 ulp may
# flip. K4 sums N*H*W products per entry in another order: relative 1e-4
# of the largest entry. K7 "patches" and "copy" move values and are exact.
CONV_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
WGRAD_RTOL = 1e-4

# Tolerances of the kernel-vs-plain comparison. f32: the kernel sums in a
# different order (per-thread f32, f64 combination, E[x^2] - mean^2) than
# the plain two-pass version. bf16 outputs: both round an f32 value that
# differs in its last bits, so one bf16 ulp (2^-7 relative) may flip.
TOL = {
    "float32": {"y": (1e-5, 1e-4), "stat": (1e-4, 1e-5), "dx": (1e-4, 1e-4), "dgb": (1e-4, 1e-3)},
    "bfloat16": {"y": (1e-2, 1e-2), "stat": (1e-4, 1e-5), "dx": (1e-2, 1e-2), "dgb": (1e-4, 1e-3)},
}


def log(msg: str) -> None:
    print(msg, flush=True)


def assert_close(name, got, want, rtol, atol) -> float:
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} of {bad.numel()} elements outside rtol={rtol} "
            f"atol={atol}; first at {i}: got {got.flatten()[i].item()}, "
            f"want {want.flatten()[i].item()}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite values")
    return float(err.max())


def _same_bits(name, first, second) -> None:
    """Two calls of a deterministic kernel on the same inputs must agree
    bit for bit (a tensor or a tuple of tensors)."""
    import torch

    firsts = first if isinstance(first, tuple) else (first,)
    seconds = second if isinstance(second, tuple) else (second,)
    if not all(torch.equal(a, b) for a, b in zip(firsts, seconds)):
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def cuda_time_ms(fn, iters: int = 40, repeats: int = 5, warmup: int = 5) -> float:
    """Median over ``repeats`` of the mean ms per call over ``iters``
    back-to-back calls, by CUDA events: what a caller waits per call,
    host launch cost included where it exceeds the device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))


# torch.profiler loses the first device records of a window, in two ways
# (on the H100): now and then whatever ran in the first milliseconds of
# the window, and late in a long process the first few records of every
# window, whatever idle, sync or spin came first. So a window opens
# with ``SENTINELS`` short spins (``torch.cuda._sleep`` of
# ``SENTINEL_CYCLES``) and ``PROFILE_PAD_S`` of idle before the work; no
# count includes the sentinels, and a window whose work still lost records
# is profiled again, at most ``PROFILE_ATTEMPTS`` times
# (tools/torch_profile_window.py counts lost windows, plain and as here).
SENTINELS = 16
SENTINEL_CYCLES = 2_000
PROFILE_PAD_S = 0.01
PROFILE_ATTEMPTS = 5
# the host calls whose every launch makes at least one device record
KERNEL_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch)")
# profile windows opened, sentinel records lost in them (all, and the most
# in one window), and windows whose work lost records and were profiled
# again
PROFILE_TALLY = {"windows": 0, "sentinel_records_lost": 0, "most_sentinel_records_lost": 0,
                 "profiled_again": 0}


def _launches(events) -> list:
    """The kernel and graph launch calls among a profile's ``events``, in
    the order the host made them."""
    from torch.autograd import DeviceType

    return sorted((e for e in events if e.device_type == DeviceType.CPU
                   and KERNEL_LAUNCH.match(e.name)), key=lambda e: e.time_range.start)


def lost_device_records(events) -> int:
    """Kernel and graph launches in a profile's ``events`` that left no
    device record: the device records of a launch carry its correlation id."""
    from torch.autograd import DeviceType

    recorded = {e.id for e in events if e.device_type == DeviceType.CUDA}
    return sum(e.id not in recorded for e in _launches(events))


def profile_window(fn, sentinels: int = SENTINELS, pad_s: float = PROFILE_PAD_S) -> tuple:
    """``fn()`` under torch.profiler (host and CUDA activity), in a window
    that opens after a sync with ``sentinels`` sentinel launches, a sync
    and ``pad_s`` of idle, and ends with a sync. Returns ``(profile,
    events, sentinel records lost)``: ``events`` are the profile's without
    the sentinels' launches and records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(sentinels):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
        time.sleep(pad_s)
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    if not sentinels:
        return prof, events, 0
    ids = {e.id for e in _launches(events)[:sentinels]}
    dropped = [e for e in events if e.id in ids and (e.device_type == DeviceType.CUDA
                                                     or KERNEL_LAUNCH.match(e.name))]
    recorded = [e for e in dropped if e.device_type == DeviceType.CUDA]
    if any("spin" not in e.name for e in recorded):
        raise AssertionError("the profile window's first launches are not all its sentinels: "
                             f"{sorted({e.name for e in recorded})}")
    keep = {id(e) for e in dropped}
    return prof, [e for e in events if id(e) not in keep], sentinels - len(recorded)


def profiled(fn, what: str) -> tuple:
    """``fn()`` in a ``profile_window``. A window whose work lost device
    records (``lost_device_records``) is profiled again; after
    ``PROFILE_ATTEMPTS`` such windows this raises. Returns ``(profile,
    events)`` as ``profile_window`` does."""
    for _ in range(PROFILE_ATTEMPTS):
        prof, events, sentinel_lost = profile_window(fn)
        PROFILE_TALLY["windows"] += 1
        PROFILE_TALLY["sentinel_records_lost"] += sentinel_lost
        PROFILE_TALLY["most_sentinel_records_lost"] = max(
            PROFILE_TALLY["most_sentinel_records_lost"], sentinel_lost)
        lost = lost_device_records(events)
        if not lost:
            return prof, events
        PROFILE_TALLY["profiled_again"] += 1
        from torch.autograd import DeviceType
        launches = _launches(events)
        recorded = {e.id for e in events if e.device_type == DeviceType.CUDA}
        t0 = launches[0].time_range.start
        detail = [(i, e.name, e.time_range.start - t0) for i, e in enumerate(launches)
                  if e.id not in recorded][:8]
        log(f"[profile] {what}: {sentinel_lost} of {SENTINELS} sentinel records lost, and "
            f"{lost} launches' device records of the work (index, call, us after its first "
            f"launch): {detail} of {len(launches)} launches; profiling again")
    raise AssertionError(f"{what}: the profiler lost device records in {PROFILE_ATTEMPTS} "
                         "windows")


def device_ms(fn, iters: int = 20):
    """Device time per call: the summed durations of every GPU kernel and
    copy the profiler traces over ``iters`` calls (no host time), from a
    window that lost no device record (``profiled``). None when every
    window lost records, or when the calls launched nothing."""
    from torch.autograd import DeviceType

    fn()

    def calls():
        for _ in range(iters):
            fn()

    try:
        _, events = profiled(calls, "device_ms")
    except AssertionError:
        return None
    total_us = sum(e.time_range.elapsed_us() for e in events if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 / iters if total_us > 0 else None


def queued_device_ms(fn, sm_clock_mhz: float, iters: int = 10, repeats: int = 3) -> float:
    """Device time per call without the profiler: a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues
    ``iters`` calls between two CUDA events, so the events time the calls
    back to back with no host gap. The spin lasts 3x the host's enqueue
    time of those calls (at least 20 ms); a host that outran it raises."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin_s = max(3 * host_s, 0.02)
    runs = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_s * sm_clock_mhz * 1e6))
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if enqueue_s >= spin_s:
            raise AssertionError(f"queued timing: the host took {enqueue_s:.4f} s to enqueue, "
                                 f"longer than the {spin_s:.4f} s spin")
        runs.append(start.elapsed_time(end) / iters)
    return float(np.median(runs))


def bn_bound(n: int, C: int, elt: int, relu: bool, backward: bool) -> tuple[float, float]:
    """(bytes, flops) the function must move and do: each input read once,
    each output written once. K1 reads x and writes y (plus gamma, beta in
    and mean, rstd, var out); K2 reads x, dy, y (ReLU mask only) and
    gamma, mean, rstd, and writes dx, dgamma, dbeta."""
    if backward:
        nbytes = (3 + (1 if relu else 0)) * n * C * elt + 6 * C * 4
        flops = 14 * n * C
    else:
        nbytes = 2 * n * C * elt + 5 * C * 4
        flops = 8 * n * C
    return nbytes, flops


def bound_ms(nbytes: float, flops: float, peak_flops: float = PEAK_F32_FLOPS
             ) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def conv_bound(kind: str, n: int, ci: int, co: int, hw: int, elt: int = 2
               ) -> tuple[float, float]:
    """(bytes, flops) of one call, each input read once and each output
    written once: K3 reads x and W2 and writes y; K4 reads x and dY and
    writes the f32 dW2; K7 "patches" reads the min(Co, Ci) channels its rows
    come from and "copy" its Co channels, and both write [N, Co, HW]."""
    flops = 2 * n * hw * co * 9 * ci
    if kind == "conv_fwd":
        return elt * (n * ci * hw + co * 9 * ci + n * co * hw), flops
    if kind == "conv_wgrad":
        return elt * (n * ci * hw + n * co * hw) + 4 * co * 9 * ci, flops
    return elt * (n * min(co, ci) * hw + n * co * hw), 0


def phase_build():
    from fedml_tpu_torch.ops import build

    t0 = time.perf_counter()
    info = build.build()
    total = time.perf_counter() - t0
    for name, rec in info.items():
        log(f"[build] {name}: {rec['seconds']:.2f} s")
        for line in rec["log"].splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels built in {total:.2f} s")
    return {"seconds": total, "per_source": {k: v["seconds"] for k, v in info.items()}}


def phase_check():
    """Each kernel against its plain version on the same card tensors."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    err = {"bn_fwd": 0.0, "bn_bwd": 0.0}
    cases = []
    for n, C in BN_CHECK_SHAPES:
        x_np = (rng.normal(size=(n, C)) * 1.5 + 0.3).astype(np.float32)
        dy_np = rng.normal(size=(n, C)).astype(np.float32)
        g = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
        b = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[str(dtype).split(".")[1]]
            x = torch.tensor(x_np, device=dev).to(dtype)
            dy = torch.tensor(dy_np, device=dev).to(dtype)
            for relu in (True, False):
                tag = f"[{n}x{C} {str(dtype).split('.')[1]} relu={relu}]"
                y_p, m_p, r_p, v_p = bn.bn_relu_fwd_plain(x, g, b, EPS, relu)
                e_y = fplan = None
                if (n, C) in K1_SHAPES:
                    got = bn.bn_fwd_cuda(x, g, b, EPS, relu)
                    _same_bits(f"K1 {tag}", got, bn.bn_fwd_cuda(x, g, b, EPS, relu))
                    y_k, m_k, r_k, v_k = got
                    e_y = assert_close(f"K1 y {tag}", y_k, y_p, *tol["y"])
                    assert_close(f"K1 mean {tag}", m_k, m_p, *tol["stat"])
                    assert_close(f"K1 var {tag}", v_k, v_p, *tol["stat"])
                    assert_close(f"K1 rstd {tag}", r_k, r_p, *tol["stat"])
                    if y_k.dtype != x.dtype:
                        raise AssertionError(f"K1 y dtype {y_k.dtype} != {x.dtype}")
                    err["bn_fwd"] = max(err["bn_fwd"], e_y)
                    fplan = bn.fwd_plan(x)
                    if (n, C) in K1_REREAD_SHAPES and not fplan["rows_per_block"] > fplan["cap"]:
                        raise AssertionError(f"K1 {tag} was meant to exceed the on-chip rows: "
                                             f"{fplan}")
                # K2 on the plain forward's outputs, so only the backward differs
                dx_k, dg_k, db_k = bn.bn_bwd_cuda(x, y_p, dy, g, m_p, r_p, relu)
                _same_bits(f"K2 {tag}", (dx_k, dg_k, db_k),
                           bn.bn_bwd_cuda(x, y_p, dy, g, m_p, r_p, relu))
                dx_p, dg_p, db_p = bn.bn_relu_bwd_plain(x, y_p, dy, g, m_p, r_p, relu)
                e_dx = assert_close(f"K2 dx {tag}", dx_k, dx_p, *tol["dx"])
                e_dg = assert_close(f"K2 dgamma {tag}", dg_k, dg_p, *tol["dgb"])
                e_db = assert_close(f"K2 dbeta {tag}", db_k, db_p, *tol["dgb"])
                err["bn_bwd"] = max(err["bn_bwd"], e_dx)
                plan = bn.bwd_plan(x, relu)
                if (n, C) in REREAD_SHAPES and not plan["rows_per_block"] > plan["cap"]:
                    raise AssertionError(f"K2 {tag} was meant to exceed the on-chip rows: {plan}")
                cases.append({"case": tag, "y": e_y, "dx": e_dx, "dgamma": e_dg, "dbeta": e_db,
                              "k1_plan": fplan, "k2_plan": plan})

                def shown(p):
                    return (f"{p['blocks']} blocks x {p['threads']} threads, loads of {p['V']}, "
                            f"{min(p['cap'], p['rows_per_block'])} of {p['rows_per_block']} "
                            f"rows a block on chip")

                k1 = ("K1 not checked" if e_y is None
                      else f"K1 y {e_y:.3g}, repeat bit-identical, {shown(fplan)}")
                log(f"[check] {tag}: max|err| {k1}; K2 dx {e_dx:.3g}, dgamma {e_dg:.3g}, "
                    f"dbeta {e_db:.3g}, repeat bit-identical, {shown(plan)}")
    torch.cuda.synchronize()

    # a small CifarResNet through the kernels on the card vs its plain
    # path on the CPU, same weights and inputs (f32, TF32 off)
    from fedml_tpu_torch.models.resnet import CifarResNet

    torch.manual_seed(SEED)
    cpu = CifarResNet(1, 10, widths=(16, 32, 64), bn_impl="pallas")
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    gpu = CifarResNet(1, 10, widths=(16, 32, 64), bn_impl="pallas")
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    xs = torch.tensor(rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    before = dict(bn.LAUNCHES)
    out_c, out_g = cpu(xs), gpu(xs.to(dev))
    out_c.square().sum().backward()
    out_g.square().sum().backward()
    torch.cuda.synchronize()
    if bn.LAUNCHES["bn_fwd"] - before["bn_fwd"] != 9 or bn.LAUNCHES["bn_bwd"] - before["bn_bwd"] != 9:
        raise AssertionError(f"small model did not run its 9 BNs through the kernels: {bn.LAUNCHES}")
    # relative L2 error per tensor, 1e-3 (with a 1e-4 per-element floor
    # under the norm for tensors near zero): f32 convs on cuDNN and on the
    # CPU sum in other orders, and BN's backward amplifies that noise
    worst = 0.0
    pairs = [("logits", out_g.detach(), out_c.detach())]
    pairs += [(k, p.grad, cpu.get_parameter(k).grad) for k, p in gpu.named_parameters()]
    pairs += [(k, v, cpu.get_buffer(k)) for k, v in gpu.named_buffers()]
    for name, a, ref in pairs:
        rel = float((a.cpu() - ref).norm() / (ref.norm() + 1e-4 * ref.numel() ** 0.5))
        worst = max(worst, rel)
        if not rel < 1e-3:
            raise AssertionError(f"small model {name}: relative L2 error {rel:.3g} >= 1e-3")
    log(f"[check] small CifarResNet GPU kernels vs CPU plain: worst relative L2 error {worst:.3g}")

    # ResNet-56 in bf16 through the kernels at a large batch, two steps: the
    # second launches the plans the first made, after every later plan
    big = CifarResNet(9, 10, dtype=torch.bfloat16, bn_impl="pallas")
    big.reset_parameters(torch.Generator().manual_seed(SEED))
    big.to(dev)
    xb = torch.tensor(rng.normal(size=(BN_BIG_BATCH, 32, 32, 3)).astype(np.float32), device=dev)
    bn.reset_launches()
    losses = []
    for _ in range(2):
        big.zero_grad(set_to_none=True)
        loss = big(xb).float().square().mean()
        loss.backward()
        losses.append(float(loss))
    torch.cuda.synchronize()
    if bn.LAUNCHES != {"bn_fwd": 2 * BNS_PER_STEP, "bn_bwd": 2 * BNS_PER_STEP}:
        raise AssertionError(f"ResNet-56 at batch {BN_BIG_BATCH} did not run its BNs through "
                             f"the kernels: {bn.LAUNCHES}")
    if not (np.isfinite(losses).all()
            and all(bool(torch.isfinite(p.grad).all()) for p in big.parameters())):
        raise AssertionError(f"ResNet-56 at batch {BN_BIG_BATCH}: non-finite loss or gradient")
    log(f"[check] ResNet-56 BN path at batch {BN_BIG_BATCH}: 2 steps through K1/K2, "
        f"finite losses {losses[0]:.4f}, {losses[1]:.4f} and gradients")
    cases.append({"case": f"[ResNet-56 bf16 batch {BN_BIG_BATCH}, 2 steps]", "losses": losses})
    return err, cases, worst


def phase_time(bns: dict = MAIN_PATH_BNS, label: str = "unpacked"):
    """Per-call times at one path's BN shapes in bf16, and the per-step
    totals over ResNet-56's 57 BNs."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import batchnorm as bn

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    rows = []
    for (n, C, relu), count in bns.items():
        x = torch.tensor(rng.normal(size=(n, C)).astype(np.float32), device=dev).to(torch.bfloat16)
        dy = torch.tensor(rng.normal(size=(n, C)).astype(np.float32), device=dev).to(torch.bfloat16)
        g = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
        b = torch.tensor(rng.normal(size=C).astype(np.float32), device=dev)
        y, mean, rstd, _ = bn.bn_fwd_cuda(x, g, b, EPS, relu)

        def lib_fwd():
            out = F.batch_norm(x, None, None, g, b, training=True, eps=EPS)
            return torch.relu(out) if relu else out

        xl = x.detach().requires_grad_(True)
        gl, bl = g.detach().requires_grad_(True), b.detach().requires_grad_(True)
        out_l = F.batch_norm(xl, None, None, gl, bl, training=True, eps=EPS)
        out_l = torch.relu(out_l) if relu else out_l

        variants = {
            "bn_fwd": {"": lambda: bn.bn_fwd_cuda(x, g, b, EPS, relu),
                       "plain_": lambda: bn.bn_relu_fwd_plain(x, g, b, EPS, relu),
                       "library_": lib_fwd},
            "bn_bwd": {"": lambda: bn.bn_bwd_cuda(x, y, dy, g, mean, rstd, relu),
                       "plain_": lambda: bn.bn_relu_bwd_plain(x, y, dy, g, mean, rstd, relu),
                       "library_": lambda: torch.autograd.grad(
                           out_l, (xl, gl, bl), dy, retain_graph=True)},
        }
        for kern, fns in variants.items():
            rec = {}
            for prefix, fn in fns.items():
                rec[f"{prefix}ms"] = cuda_time_ms(fn)
                rec[f"{prefix}device_ms"] = device_ms(fn)
            nbytes, flops = bn_bound(n, C, 2, relu, kern == "bn_bwd")
            rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
            rec.update(kernel=kern, rows=n, C=C, relu=relu, calls_per_step=count)
            rows.append(rec)
            us = {k: ("n/m" if v is None else f"{v * 1e3:.1f}") for k, v in rec.items()
                  if k.endswith("ms") and k != "bound_ms"}
            log(f"[time] {kern} {n}x{C} bf16 relu={relu}: kernel {us['ms']} us "
                f"(device {us['device_ms']}), plain {us['plain_ms']} (device "
                f"{us['plain_device_ms']}), library {us['library_ms']} (device "
                f"{us['library_device_ms']}), bound {rec['bound_ms'] * 1e3:.2f} us "
                f"({rec['bound_by']}); {count}/step")
    torch.cuda.synchronize()
    for kern in ("bn_fwd", "bn_bwd"):
        mine = [r for r in rows if r["kernel"] == kern]
        total = {k: (None if any(r[k] is None for r in mine)
                     else sum(r[k] * r["calls_per_step"] for r in mine))
                 for k in ("ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
                           "library_device_ms", "bound_ms")}
        ms = {k: "n/m" if v is None else f"{v:.4f}" for k, v in total.items()}
        log(f"[time] {kern} per {label} step ({BNS_PER_STEP} calls, bf16): events {ms['ms']} ms, device "
            f"{ms['device_ms']}; plain {ms['plain_ms']} (device {ms['plain_device_ms']}); "
            f"F.batch_norm {ms['library_ms']} (device {ms['library_device_ms']}); bound "
            f"{ms['bound_ms']}")
    return rows


def _conv_inputs(rng, n, ci, co, h, w, dtype, dev):
    """Activations, a W2 at lecun scale and a cotangent, rounded to dtype."""
    import torch

    def t(a):
        return torch.tensor(a.astype(np.float32), device=dev).to(dtype)

    return (t(rng.normal(size=(n, ci, h * w))),
            t(rng.normal(size=(co, 9 * ci)) / np.sqrt(9 * ci)),
            t(rng.normal(size=(n, co, h * w))))


def phase_check_conv():
    """K3, K4 and K7 against their plain versions on the same card tensors,
    then a small lanes CifarResNet on the card against the CPU."""
    import torch

    from fedml_tpu_torch.ops import conv_lanes as cl

    rng = np.random.default_rng(SEED + 2)
    dev = torch.device("cuda")
    err = {"conv_fwd": 0.0, "conv_wgrad": 0.0, "conv_variant": 0.0}
    cases = []
    # the path's shapes at batch 64, and at 1 and 3 images (fewer items
    # than the bf16 K4 has blocks), then the ragged ones
    shapes = [(nb, *s) for nb in (CONV_BATCH, 1, 3) for s in CONV_CALLS] + CONV_RAGGED
    for n, ci, co, h, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            tag = f"[{n}x{ci}->{co} @{h}x{w} {dname}]"
            x, w2, dy = _conv_inputs(rng, n, ci, co, h, w, dtype, dev)
            y_k = cl.conv_fwd_cuda(x, w2, h, w)
            e_y = assert_close(f"K3 {tag}", y_k, cl.conv_fwd_plain(x, w2, h, w), *CONV_TOL[dname])
            _same_bits(f"K3 {tag}", y_k, cl.conv_fwd_cuda(x, w2, h, w))
            dw_p = cl.conv_wgrad_plain(x, dy, h, w)
            scale = float(dw_p.abs().max())
            dw_k = cl.conv_wgrad_cuda(x, dy, h, w)
            e_w = assert_close(f"K4 {tag}", dw_k, dw_p, WGRAD_RTOL, WGRAD_RTOL * scale)
            _same_bits(f"K4 {tag}", dw_k, cl.conv_wgrad_cuda(x, dy, h, w))
            rec = {"case": tag, "conv_fwd": e_y, "conv_wgrad": e_w, "dw2_max": scale}
            for mode in cl.VARIANT_MODES:
                if mode == "copy" and co > ci:
                    continue
                got = cl.conv_variant_cuda(mode, x, w2, h, w)
                want = cl.conv_variant_plain(mode, x, w2, h, w)
                if mode == "kernel":
                    rec[f"conv_variant_{mode}"] = assert_close(
                        f"K7 {mode} {tag}", got, want, *CONV_TOL[dname])
                    _same_bits(f"K7 {mode} {tag}", got, cl.conv_variant_cuda(mode, x, w2, h, w))
                    if not torch.equal(got, y_k):
                        raise AssertionError(f"K7 kernel {tag} is not K3's output bit for bit")
                elif not torch.equal(got, want):
                    raise AssertionError(f"K7 {mode} {tag} is not bit-exact")
                else:
                    rec[f"conv_variant_{mode}"] = 0.0
                err["conv_variant"] = max(err["conv_variant"], rec[f"conv_variant_{mode}"])
            err["conv_fwd"] = max(err["conv_fwd"], e_y)
            err["conv_wgrad"] = max(err["conv_wgrad"], e_w)
            cases.append(rec)
            log(f"[check] {tag}: max|err| K3 {e_y:.3g}, K4 {e_w:.3g} (max|dW2| {scale:.3g}; "
                f"K3, K4 and K7 kernel repeats bit-identical, K7 kernel = K3), "
                f"K7 {', '.join(f'{k[13:]} {v:.3g}' for k, v in rec.items() if k.startswith('conv_variant'))}")
    torch.cuda.synchronize()

    # a small lanes CifarResNet: stages 1-2 (widths 16, 32) on the lanes
    # layout, 4 kernel-routed 3x3 convs -> 4 forward + 4 dgrad K3, 4 K4
    from fedml_tpu_torch.models.resnet import CifarResNet

    cpu = CifarResNet(1, 10, widths=(16, 32, 64), conv_impl="lanes")
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    gpu = CifarResNet(1, 10, widths=(16, 32, 64), conv_impl="lanes")
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    xs = torch.tensor(rng.normal(size=(8, 32, 32, 3)).astype(np.float32))
    before = dict(cl.LAUNCHES)
    out_c, out_g = cpu(xs), gpu(xs.to(dev))
    out_c.square().sum().backward()
    out_g.square().sum().backward()
    torch.cuda.synchronize()
    ran = {k: cl.LAUNCHES[k] - before[k] for k in cl.LAUNCHES}
    if ran != {"conv_fwd": 8, "conv_wgrad": 4, "conv_variant": 0}:
        raise AssertionError(f"small lanes model did not run its 4 convs through K3/K4: {ran}")
    # relative L2 per tensor, 1e-3 as for the BN model above
    worst = 0.0
    pairs = [("logits", out_g.detach(), out_c.detach())]
    pairs += [(k, p.grad, cpu.get_parameter(k).grad) for k, p in gpu.named_parameters()]
    pairs += [(k, v, cpu.get_buffer(k)) for k, v in gpu.named_buffers()]
    for name, a, ref in pairs:
        rel = float((a.cpu() - ref).norm() / (ref.norm() + 1e-4 * ref.numel() ** 0.5))
        worst = max(worst, rel)
        if not rel < 1e-3:
            raise AssertionError(f"small lanes model {name}: relative L2 error {rel:.3g} >= 1e-3")
    log(f"[check] small lanes CifarResNet GPU kernels vs CPU plain: worst relative L2 "
        f"error {worst:.3g}")
    return err, cases, worst


def _time_fns(fns: dict) -> dict:
    """Events and profiler device ms per call for each ``prefix: fn``."""
    rec = {}
    for prefix, fn in fns.items():
        rec[f"{prefix}ms"] = cuda_time_ms(fn)
        rec[f"{prefix}device_ms"] = device_ms(fn)
    return rec


def phase_time_conv():
    """Per-call K3 and K4 times at the lanes path's shapes, batch 64, bf16."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import conv_lanes as cl

    rng = np.random.default_rng(SEED + 3)
    dev = torch.device("cuda")
    rows = []
    for kern, calls in (("conv_fwd", CONV_CALLS), ("conv_wgrad", WGRAD_CALLS)):
        for (ci, co, h, w), count in calls.items():
            n = CONV_BATCH
            x, w2, dy = _conv_inputs(rng, n, ci, co, h, w, torch.bfloat16, dev)
            x4, dy4 = x.view(n, ci, h, w), dy.view(n, co, h, w)
            w4 = cl._w2_inv(w2, ci, co)
            if kern == "conv_fwd":
                fns = {"": lambda: cl.conv_fwd_cuda(x, w2, h, w),
                       "plain_": lambda: cl.conv_fwd_plain(x, w2, h, w),
                       "library_": lambda: F.conv2d(x4, w4, padding=1)}
            else:
                fns = {"": lambda: cl.conv_wgrad_cuda(x, dy, h, w),
                       "plain_": lambda: cl.conv_wgrad_plain(x, dy, h, w),
                       "library_": lambda: torch.nn.grad.conv2d_weight(
                           x4, (co, ci, 3, 3), dy4, padding=1)}
            rec = _time_fns(fns)
            nbytes, flops = conv_bound(kern, n, ci, co, h * w)
            rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
            rec.update(kernel=kern, n=n, ci=ci, co=co, h=h, w=w, calls_per_step=count)
            rows.append(rec)
            us = {k: ("n/m" if v is None else f"{v * 1e3:.1f}") for k, v in rec.items()
                  if k.endswith("ms") and k != "bound_ms"}
            log(f"[time] {kern} {n}x{ci}->{co} @{h}x{w} bf16: kernel {us['ms']} us (device "
                f"{us['device_ms']}), plain {us['plain_ms']} (device {us['plain_device_ms']}), "
                f"library {us['library_ms']} (device {us['library_device_ms']}), bound "
                f"{rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']}); {count}/step")
    torch.cuda.synchronize()
    return rows


def phase_probe():
    """The K7 probe: per-call times of the conv's parts at the probe shapes
    (batch 64, bf16), counterpart of tools/lanes_probe.py main(). Back-to-
    back calls timed by CUDA events replace the TPU's two-point scan."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import conv_lanes as cl

    rng = np.random.default_rng(SEED + 4)
    dev = torch.device("cuda")
    cl.reset_launches()
    rows = []
    for ci, co, h, w in PROBE_SHAPES:
        n = CONV_BATCH
        x, w2, dy = _conv_inputs(rng, n, ci, co, h, w, torch.bfloat16, dev)
        wk = cl._w2_inv(w2, ci, co)
        xg, wg = x.detach().requires_grad_(True), wk.detach().requires_grad_(True)
        fns = {
            "library": lambda: F.conv2d(x.view(n, ci, h, w), wk, padding=1),
            "kernel": lambda: cl.conv_fwd_cuda(x, w2, h, w),
            "patches": lambda: cl.conv_variant_cuda("patches", x, w2, h, w),
            "copy": lambda: cl.conv_variant_cuda("copy", x, w2, h, w),
            "wgrad": lambda: cl.conv_wgrad_cuda(x, dy, h, w),
            "f+dgrad": lambda: torch.autograd.grad(cl.conv3x3_lanes(xg, wk, h, w), xg, dy),
            "f+wgrad": lambda: torch.autograd.grad(cl.conv3x3_lanes(x, wg, h, w), wg, dy),
        }
        rec = {name: cuda_time_ms(fn) for name, fn in fns.items()}
        modes = ("kernel", "patches", "copy")
        for mode in modes:
            rec[f"{mode}_device_ms"] = device_ms(fns[mode])
            if mode != "kernel":
                rec[f"{mode}_plain_ms"] = cuda_time_ms(
                    lambda m=mode: cl.conv_variant_plain(m, x, w2, h, w))
            nbytes, flops = conv_bound("conv_fwd" if mode == "kernel" else mode, n, ci, co, h * w)
            rec[f"{mode}_bound_ms"], _ = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        dms = [rec[f"{m}_device_ms"] for m in modes]
        # the three modes stage the same rows and copy out through the same
        # tile; kernel fills it from the mma loop (whose ldmatrix reads take
        # the taps as offsets: no gather of its own), patches by gathering
        # the patch rows, copy from the centre tap
        rec["split_device_ms"] = None if None in dms else {
            "mma loop and W2 (kernel - copy)": dms[0] - dms[2],
            "tap gather (patches - copy)": dms[1] - dms[2],
            "stage and copy-out (copy)": dms[2]}
        rec.update(n=n, ci=ci, co=co, h=h, w=w)
        rows.append(rec)
        log(f"[probe] c{ci}-{co}@{h}x{w} bf16 batch {n}, us/call (events): " + ", ".join(
            f"{k} {rec[k] * 1e3:.1f}" for k in fns))
        shown = [f"{m} " + ("n/m" if d is None else f"{d * 1e3:.2f}")
                 + f" (bound {rec[m + '_bound_ms'] * 1e3:.2f})" for m, d in zip(modes, dms)]
        split = ("not measured" if rec["split_device_ms"] is None else ", ".join(
            f"{k} {v * 1e3:.2f}" for k, v in rec["split_device_ms"].items()))
        log(f"[probe] c{ci}-{co}@{h}x{w} device us/call: {', '.join(shown)}; split: {split}")
    torch.cuda.synchronize()
    launches = dict(cl.LAUNCHES)
    if launches["conv_variant"] == 0:
        raise AssertionError("the probe launched no K7")
    return rows, launches


def kernel_family(name: str) -> str:
    low = name.lower()
    if "flash_fwd_" in name:
        return "attention kernel (K6)"
    if "xent_kernel" in name:
        return "cross-entropy kernel (K5)"
    if "conv_fwd_" in name or "conv_wgrad_" in name:
        return "lanes conv kernels (K3/K4)"
    if any(f"::{k}" in name or name.startswith(k) for k in
           ("bn_fwd_onepass", "bn_bwd_onepass")):
        return "bn kernels (K1/K2)"
    if any(k in low for k in ("conv", "xmma", "cudnn", "implicit", "wgrad", "dgrad", "gemm",
                              "nchw", "nhwc")):
        return "library convolution / gemm"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer (foreach)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other elementwise / reductions"


def api_trainer(api):
    """The trainer an API's rounds run: the packed lane program (the
    simulation round's, or the cross-silo packed mesh round's) or the plain
    local trainer."""
    pm = getattr(api, "_packed_mesh", None)
    if pm is not None:
        return pm["round_fn"].lanes
    return api._packed_train if api._packed_train is not None else api._local_train


def train_block(api) -> tuple:
    """``(rows, tx, ty, tm)``: the clients an API keeps on the card and
    their stacked train tensors: the whole federation (simulation), the
    rank's block (cross-silo packed mesh, in plan order; resident) or the
    rank's block of the grouped schedule's last group (its largest
    clients)."""
    if getattr(api, "_packed_mesh", None) is not None:
        return (api._packed_mesh["rows"],) + tuple(api._packed_mesh["data"])
    if getattr(api, "_dev_sharded", None) is not None:
        return tuple(api._dev_sharded)
    if getattr(api, "_dev_groups", None) is not None:
        rows, _, *data = api._dev_groups[-1]
        return (rows, *data)
    return (np.arange(api.dataset.num_clients), *api._dev_train)


def client_run(api, trainer=None, client: int = 0, steps: int = 5):
    """``(run, live steps)``: ``run()`` trains one client's first ``steps``
    batches of real records from ``api.variables`` through ``trainer`` (the
    API's own by default) and returns its LocalResult."""
    import torch

    trainer = trainer or api._local_train
    rows, tx, ty, tm = train_block(api)
    count = min(int(api.dataset.train_counts[rows[client]]), steps * api.config.batch_size)

    def run():
        return trainer(api.variables, tx[client], ty[client], tm[client], count,
                       torch.Generator().manual_seed(1))

    return run, -(-count // api.config.batch_size)


def cohort_run(api, trainer=None, steps: int = 5):
    """``(run, executed packed steps, real images)``: ``run()`` trains the
    first ``lanes`` clients, one a lane, each on its first ``steps``
    batches, through the packed ``trainer`` (the API's own by default) and
    returns its PackedResult."""
    from fedml_tpu_torch.parallel.packed import executed_steps, plan_packing

    trainer = trainer or api_trainer(api)
    c = api.config
    clients = np.arange(c.pack_lanes)
    rows, tx, ty, tm = train_block(api)
    counts = np.minimum(api.dataset.train_counts[rows[clients]],
                        steps * c.batch_size).astype(np.float32)
    plan = plan_packing(counts, c.batch_size, 1, c.pack_lanes)
    orders = api._round_orders(0, c.pack_lanes)

    def run():
        return trainer(api.variables, tx, ty, tm, clients, counts, orders, plan)

    return run, len(executed_steps(plan.live)), float(counts.sum())


def step_profile(api, client: int = 0, steps: int = 5, trainer=None) -> dict:
    """The first ``steps`` live steps of one client's local training (its
    first ``steps`` batches of real records) through ``trainer`` (the API's
    own by default), as tools/torch_step_profile.py profiles a whole
    client: wall ms per step (unprofiled, ending in a sync), device ms per
    step by kernel family under torch.profiler, the busy share = device time
    over the unprofiled wall, and the host's launch calls. Few steps keep
    the profiler's post-processing (~3,300 events a step) short. The rounds
    before it have warmed the path up."""
    run, steps = client_run(api, trainer, client, steps)
    return {"client": client, **_profile(lambda: float(run().train_loss), steps)}


def packed_step_profile(api, steps: int = 5, trainer=None) -> dict:
    """``steps`` packed steps of the first ``lanes`` clients, one a lane
    (each client's first ``steps`` batches), through the packed ``trainer``
    (the round's by default): per step as ``step_profile``, and per real
    image."""
    run, steps, real = cohort_run(api, trainer, steps)
    prof = _profile(lambda: float(run().train_loss), steps)
    return {"clients": list(range(api.config.pack_lanes)), "lanes": api.config.pack_lanes,
            "real_images": real,
            "gpu_activities_per_real_image": prof["gpu_activities_per_step"] * steps / real,
            "device_ms_per_real_image": prof["device_ms_per_step"] * steps / real,
            "wall_ms_per_real_image": prof["wall_ms_per_step"] * steps / real, **prof}


# the host calls that put work on the card (CUDA runtime and libcuda API
# names, as torch.profiler records them)
HOST_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy|"
                         r"Memset)")
# kernels counted by name in a profile: K1 and K2
NAMED_KERNELS = ("bn_fwd_onepass", "bn_bwd_onepass")


def _profile(run, steps: int) -> dict:
    """Profile one call of ``run`` (``steps`` training steps), then time an
    unprofiled call: per-step wall, device time by kernel family, busy share,
    GPU activities, host launch calls, K1 and K2 by name, and the host
    operators that launched the most device time."""
    import torch
    from torch.autograd import DeviceType

    prof, events = profiled(run, f"{steps} steps")
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by_family, n, launches, graphs, named = {}, 0, 0, 0, dict.fromkeys(NAMED_KERNELS, 0)
    for e in events:
        if e.device_type == DeviceType.CUDA:
            n += 1
            fam = kernel_family(e.name)
            by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
            for k in named:
                named[k] += k in e.name
        elif HOST_LAUNCH.match(e.name):
            launches += 1
            graphs += e.name.startswith(("cudaGraphLaunch", "cuGraphLaunch"))
    total = sum(by_family.values())
    # the host-side operators that launched the most device time, and those
    # that took the most host time themselves
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    top = sorted((e for e in ops if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    host = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]
    return {"live_steps": steps, "wall_ms_per_step": wall_s / steps * 1e3,
            "device_ms_per_step": total, "device_busy_share": total * steps / (wall_s * 1e3),
            "gpu_activities_per_step": n / steps,
            # CUDA runtime and libcuda calls that enqueue work (kernels,
            # graphs, copies, fills) as the profiler sees them, and of them
            # the graph launches
            "host_launches_per_step": launches / steps, "graph_launches_per_step": graphs / steps,
            "kernels_by_name": named,
            "device_ms_per_step_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
            "top_ops": [{"name": e.key, "device_ms_per_step": e.self_device_time_total / 1e3 / steps,
                         "calls_per_step": e.count / steps} for e in top],
            "top_host_ops": [{"name": e.key, "host_ms_per_step": e.self_cpu_time_total / 1e3 / steps,
                              "calls_per_step": e.count / steps} for e in host]}


# -- the captured step: eager against captured --------------------------------

# live steps of one client (or of each lane's client) in the eager-against-
# captured gate
GATE_STEPS = 12
# CUgraphNodeType CU_GRAPH_NODE_TYPE_KERNEL and CUkernelNodeAttrID
# CU_KERNEL_NODE_ATTRIBUTE_COOPERATIVE (cuda.h)
_CU_GRAPH_NODE_TYPE_KERNEL = 0
_CU_KERNEL_NODE_ATTRIBUTE_COOPERATIVE = 2
# the cooperative kernels: K1, K2 and the bf16 K4
COOPERATIVE_KERNELS = ("bn_fwd_onepass", "bn_bwd_onepass", "conv_wgrad_mma")
# the port's kernels as a graph's nodes are counted: K1, K2, the bf16 K4,
# the bf16 K3 (and the CUDA-core one), the bf16 K6
GRAPH_KERNELS = (*COOPERATIVE_KERNELS, "conv_fwd_mma", "conv_fwd_kernel", "flash_fwd_")
# each path's step graph: its kernel nodes, and K1/K2 by name a step
BN_GRAPH = {"bn_fwd_onepass": BNS_PER_STEP, "bn_bwd_onepass": BNS_PER_STEP}


def trainer_programs(trainer) -> list:
    """The step programs (``parallel/capture.CapturedStep``) of a plain or
    packed trainer."""
    if hasattr(trainer, "lanes"):
        return [p for lanes in trainer.lanes.values() for p in lanes.programs.values()]
    return list(trainer.programs.values())


def step_programs(api) -> list:
    """The step programs of the API's trainer."""
    return trainer_programs(api_trainer(api))


def one_step_profile(prog) -> dict:
    """One turn of a trainer's step loop under the profiler: the gathers
    into the step's static inputs, the step (a graph replay, or the eager
    body), the loss sum. Returns the host's launch calls, the graph
    launches, the GPU activities and K1 and K2 by name. The step trains
    the module from wherever it stands; every client reloads it."""
    import torch
    from torch.autograd import DeviceType

    src = [t.clone() for t in prog.inputs]
    idx = torch.arange(src[0].shape[0], device=src[0].device)
    total = torch.zeros((), device=src[0].device)

    def turn():
        nonlocal total
        for a, b in zip(src, prog.inputs):
            torch.index_select(a, 0, idx, out=b)
        out = prog()
        total = total + (out if out.dim() == 0 else out.sum())

    _, events = profiled(turn, "one turn of the step loop")
    rec = {"host_launches": 0, "graph_launches": 0, "gpu_activities": 0,
           "kernels_by_name": dict.fromkeys(NAMED_KERNELS, 0)}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            rec["gpu_activities"] += 1
            for k in NAMED_KERNELS:
                rec["kernels_by_name"][k] += k in e.name
        elif HOST_LAUNCH.match(e.name):
            rec["host_launches"] += 1
            rec["graph_launches"] += e.name.startswith(("cudaGraphLaunch", "cuGraphLaunch"))
    return rec


def replays(api) -> int:
    return sum(p.replays for p in step_programs(api))


def eager_trainer(api):
    """The API's trainer built again with ``capture=False``: the same step
    body, run eagerly."""
    from fedml_tpu_torch.parallel.local import make_local_train_fn
    from fedml_tpu_torch.parallel.packed import make_packed_cohort_train

    kw = dict(api._local_train_kwargs(), capture=False)
    if api._packed_train is None:
        return make_local_train_fn(api.bundle, api.task, **kw)
    hooks = api._packing_hooks()
    return make_packed_cohort_train(api.bundle, api.task, int(api.dataset.train_x.shape[1]),
                                    client_transform=hooks.get("client_transform"),
                                    reduce_extras=hooks.get("reduce_extras"), **kw)


def _outcome(res) -> dict:
    """A trainer's result as named tensors: its variables and losses."""
    out = {f"variables/{k}": v for k, v in res.variables.items()}
    out["train_loss"] = res.train_loss
    if getattr(res, "first_loss", None) is not None:
        out["first_loss"] = res.first_loss
    return out


def _distance(a: dict, b: dict) -> tuple[float, list]:
    """The largest absolute difference over every tensor, and the names of
    the tensors whose bits differ."""
    import torch

    names = [k for k in a if not torch.equal(a[k], b[k])]
    worst = max((float((a[k].double() - b[k].double()).abs().max()) for k in names),
                default=0.0)
    return worst, names


def capture_gate(api, eager, tag: str, packed: bool) -> dict:
    """One client's first GATE_STEPS live steps (or one packed cohort's),
    eager twice, then captured. Eager runs that repeat bit for bit make the
    captured run's bits the gate; else the captured run may be no farther
    from the first eager run than the second is, and the tensors that one
    eager step already changes between two runs name the op that differs."""
    import torch

    def runner(trainer, steps=GATE_STEPS):
        if packed:
            run, n, _ = cohort_run(api, trainer, steps)
        else:
            run, n = client_run(api, trainer, 0, steps)
        return run, n

    run_e, steps = runner(eager)
    run_c, _ = runner(None)
    e1, e2 = _outcome(run_e()), _outcome(run_e())
    r0 = replays(api)
    c = _outcome(run_c())
    torch.cuda.synchronize()
    if replays(api) - r0 != steps:
        raise AssertionError(f"{tag} the captured run replayed {replays(api) - r0} times for "
                             f"{steps} live steps")
    d_ee, diff_ee = _distance(e1, e2)
    d_ce, diff_ce = _distance(c, e1)
    rec = {"steps": steps, "eager_vs_eager": d_ee, "eager_vs_eager_tensors": len(diff_ee),
           "captured_vs_eager": d_ce, "captured_vs_eager_tensors": len(diff_ce),
           "tensors": len(e1)}
    if not diff_ee:
        if diff_ce:
            raise AssertionError(f"{tag} the eager runs repeat bit for bit and the captured run "
                                 f"differs by up to {d_ce:.3g} in {len(diff_ce)} tensors: "
                                 f"{diff_ce[:6]}")
        rec["verdict"] = "bit-identical"
    else:
        one_e, _ = runner(eager, 1)
        _, ops = _distance(_outcome(one_e()), _outcome(one_e()))
        rec["eager_differs_after_one_step_in"] = ops
        if d_ce > d_ee:
            raise AssertionError(f"{tag} captured run {d_ce:.3g} from eager, farther than the "
                                 f"eager runs from each other ({d_ee:.3g}); one eager step "
                                 f"already differs in {ops[:6]}")
        rec["verdict"] = f"within the eager runs' distance; one eager step differs in {ops[:6]}"
    log(f"{tag} eager vs captured over {steps} live steps: {rec['verdict']} (eager-eager "
        f"{d_ee:.3g} in {len(diff_ee)} of {len(e1)} tensors, captured-eager {d_ce:.3g} in "
        f"{len(diff_ce)})")
    return rec


def _cu(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} failed: CUresult {code}")


def graph_kernel_nodes(graph) -> dict:
    """The kernel nodes of a captured graph, read through libcuda's graph API:
    each kernel's node count and how many of those nodes are cooperative."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p
    g = vp(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    _cu(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (vp * n.value)()
    _cu(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    by_name: dict = {}
    kernel_nodes = 0
    for node in nodes:
        kind = ctypes.c_int()
        _cu(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != _CU_GRAPH_NODE_TYPE_KERNEL:
            continue
        kernel_nodes += 1
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56
        params = (ctypes.c_uint64 * 16)()
        _cu(cu.cuGraphKernelNodeGetParams_v2(vp(node), params), "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params[0]:
            _cu(cu.cuFuncGetName(ctypes.byref(name), vp(params[0])), "cuFuncGetName")
        else:
            _cu(cu.cuKernelGetName(ctypes.byref(name), vp(params[7])), "cuKernelGetName")
        attr = (ctypes.c_int * 16)()
        _cu(cu.cuGraphKernelNodeGetAttribute(vp(node), _CU_KERNEL_NODE_ATTRIBUTE_COOPERATIVE,
                                             attr), "cuGraphKernelNodeGetAttribute")
        key = next((k for k in GRAPH_KERNELS if k in name.value.decode()), "other")
        rec = by_name.setdefault(key, {"nodes": 0, "cooperative": 0})
        rec["nodes"] += 1
        rec["cooperative"] += bool(attr[0])
    return {"nodes": n.value, "kernel_nodes": kernel_nodes, "by_name": by_name}


def capture_arms(api, tag: str, smi: str, packed: bool = False, graph_kernels=None,
                 named_per_step: int = 0) -> dict:
    """The phase's path on one client (or one packed cohort), eager and
    captured: the gate, both profiles (wall, device, busy share, host
    launches per step), the captured graph's kernel nodes against
    ``graph_kernels`` (name -> nodes; K1, K2 and K4's all cooperative), K1
    and K2 by name in each profile against ``named_per_step`` a step, and
    the grid-barrier words of every capturing stream, zero after the
    replays."""
    import torch

    from fedml_tpu_torch.ops.grid_barrier import barrier_words

    eager = eager_trainer(api)
    gate = capture_gate(api, eager, tag, packed)
    prof_fn = packed_step_profile if packed else step_profile
    profiles = {"eager": prof_fn(api, trainer=eager), "captured": prof_fn(api)}
    for arm, prof in profiles.items():
        extra = (f" ({prof['gpu_activities_per_real_image']:.2f} GPU activities per real image)"
                 if packed else "")
        log(f"{tag} {arm} step: wall {prof['wall_ms_per_step']:.2f} ms, device "
            f"{prof['device_ms_per_step']:.3f} ms (busy share {prof['device_busy_share']:.3f}), "
            f"{prof['gpu_activities_per_step']:.0f} GPU activities{extra}, "
            f"{prof['host_launches_per_step']:.1f} host launches "
            f"({prof['graph_launches_per_step']:.1f} graph launches); K1/K2 by name "
            f"{prof['kernels_by_name']} over {prof['live_steps']} steps; device ms by family "
            + ", ".join(f"{k} {v:.3f}" for k, v in prof["device_ms_per_step_by_family"].items())
            + f"; {smi}")
        for k, v in prof["kernels_by_name"].items():
            if v != named_per_step * prof["live_steps"]:
                raise AssertionError(f"{tag} {arm}: the profile counts {v} {k} kernels over "
                                     f"{prof['live_steps']} steps; expected {named_per_step} a step")
    if profiles["captured"]["graph_launches_per_step"] != 1.0:
        raise AssertionError(f"{tag} the captured step made "
                             f"{profiles['captured']['graph_launches_per_step']} graph launches")
    progs = step_programs(api)
    # one turn of the step loop each way: the host's launches a step, and
    # the profiler's count of K1 and K2 in one replayed step
    one = {"eager": one_step_profile(trainer_programs(eager)[0]),
           "captured": one_step_profile(progs[0])}
    log(f"{tag} one turn of the step loop: " + "; ".join(
        f"{arm} {r['host_launches']} host launches ({r['graph_launches']} graph), "
        f"{r['gpu_activities']} GPU activities, {r['kernels_by_name']}" for arm, r in one.items()))
    for arm, r in one.items():
        if any(v != named_per_step for v in r["kernels_by_name"].values()) or \
                r["graph_launches"] != (arm == "captured"):
            raise AssertionError(f"{tag} one {arm} step: {r}; expected {named_per_step} of each "
                                 f"of K1 and K2 and {int(arm == 'captured')} graph launch")
    nodes = [graph_kernel_nodes(p.graph) for p in progs]
    for rec in nodes:
        got = {k: v["nodes"] for k, v in rec["by_name"].items() if k != "other"}
        want = {k: v for k, v in (graph_kernels or {}).items() if v}
        if got != want:
            raise AssertionError(f"{tag} the captured graph holds kernel nodes {got}; expected "
                                 f"{want}")
        for k in COOPERATIVE_KERNELS:
            if k in rec["by_name"] and rec["by_name"][k]["cooperative"] != rec["by_name"][k]["nodes"]:
                raise AssertionError(f"{tag} {k}: {rec['by_name'][k]} cooperative nodes")
    words = [int(barrier_words(p.stream.device, p.stream.cuda_stream)[0]) for p in progs]
    if any(words):
        raise AssertionError(f"{tag} grid-barrier arrival words {words} after the replays")
    log(f"{tag} captured graph(s): {nodes}; warm-up launches (not counted) "
        f"{[p.warmup_launches for p in progs]}; launches a replay adds "
        f"{[p.launches_per_step for p in progs]}; barrier arrival words {words}")
    torch.cuda.synchronize()
    return {"gate": gate, "profiles": profiles, "one_step": one, "graph_nodes": nodes,
            "launches_per_replay": [p.launches_per_step for p in progs],
            "warmup_launches": [p.warmup_launches for p in progs], "replays": replays(api)}


def eager_rounds(api, init: dict, tag: str, smi: str, captured: tuple) -> dict:
    """The phase's rounds again from the same initial variables, through
    the eager step (``capture=False``), for real images/s beside the
    captured rounds': the same launch counts, and the losses side by
    side."""
    packed = api._packed_train is not None
    name = "_packed_train" if packed else "_local_train"
    kept = getattr(api, name)
    setattr(api, name, eager_trainer(api))
    api.variables = {k: v.clone() for k, v in init.items()}
    api.server_state = api.init_server_state()
    try:
        rounds, metrics, _eval_s, trained, _launches = run_rounds(api, f"{tag} eager", smi)
    finally:
        setattr(api, name, kept)
    c_rounds, _, _, c_trained, _ = captured
    if trained != c_trained:
        raise AssertionError(f"{tag} eager rounds launched {trained}; the captured {c_trained}")
    e_s = sum(r["seconds"] for r in rounds)
    c_s = sum(r["seconds"] for r in c_rounds)
    real = sum(r["real_images"] for r in rounds)
    rec = {"rounds": rounds, "eval": metrics, "real_images_per_s": real / e_s,
           "captured_real_images_per_s": real / c_s,
           "loss_eager_minus_captured": [r["loss"] - c["loss"] for r, c in zip(rounds, c_rounds)]}
    log(f"{tag} real images/s: captured {real / c_s:.1f}, eager {real / e_s:.1f} "
        f"({e_s / c_s:.3f}x the captured rounds' wall); losses eager - captured "
        f"{rec['loss_eager_minus_captured']}; {smi}")
    return rec


@functools.lru_cache(maxsize=1)
def flagship_data():
    """The flagship's federation, made once for every phase that trains on
    it (phases 4, 4b, 4c and 8; the APIs only read it)."""
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    return make_synthetic_classification(
        "cifar10-bench", (32, 32, 3), 10, 32, records_per_client=1562,
        partition_method="hetero", partition_alpha=0.5, batch_size=64, seed=SEED)


def flagship_api(bn_impl: str = "pallas", conv_impl: str = "xla", api_cls=None, ds=None,
                 mesh=None, **config):
    """bench.py's flagship cut to 2 rounds: ResNet-56 FedAvg (or
    ``api_cls``) on 32 non-IID synthetic CIFAR-10-shaped clients, 8 a
    round, batch 64, bf16; ``config`` overrides FedConfig fields, ``mesh``
    is a cross-silo API's client mesh."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.models import create_model

    ds = ds or flagship_data()
    base = dict(model="resnet56", dataset="cifar10", client_num_in_total=32,
                client_num_per_round=8, comm_round=2, batch_size=64, epochs=1, lr=0.1,
                momentum=0.9, dtype="bfloat16", frequency_of_the_test=10_000, seed=SEED,
                async_rounds=True)
    cfg = FedConfig(**{**base, **config})
    bundle = create_model("resnet56", 10, input_shape=ds.train_x.shape[2:],
                          dtype=torch.bfloat16, bn_impl=bn_impl, conv_impl=conv_impl)
    return (api_cls or FedAvgAPI)(ds, cfg, bundle, **({"mesh": mesh} if mesh else {}))


def run_rounds(api, tag: str, smi: str, replayed: Optional[int] = None) -> tuple:
    """The configured rounds (one sync each), then evaluate_global. Returns
    (rounds, metrics, eval seconds, launches after the rounds, launches
    after the evaluation); the counters are set to 0 just before. With
    ``replayed``, the rounds must have replayed the captured step that many
    times: once a live (or executed packed) step."""
    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.ops import conv_lanes as cl

    bn.reset_launches()
    cl.reset_launches()
    r0 = replays(api)
    rounds = []
    for r in range(api.config.comm_round):
        t = time.perf_counter()
        loss = float(api.run_round(r))        # one sync per round
        dt = time.perf_counter() - t
        real, executed = api.round_counts(r)
        rounds.append({"round": r, "loss": loss, "seconds": dt, "real_images": real,
                       "executed_images": executed, "real_images_per_s": real / dt})
        log(f"{tag} round {r}: loss {loss:.4f}, {dt:.2f} s, {real} real images "
            f"({executed} executed), {real / dt:.1f} real images/s")
        if not np.isfinite(loss):
            raise AssertionError(f"round {r} loss is not finite: {loss}")
    trained = {**bn.LAUNCHES, **cl.LAUNCHES}
    if replayed is not None and replays(api) - r0 != replayed:
        raise AssertionError(f"{tag} the rounds replayed the captured step "
                             f"{replays(api) - r0} times; expected {replayed}, one a step")
    t = time.perf_counter()
    metrics = api.evaluate_global()
    eval_s = time.perf_counter() - t
    launches = {**bn.LAUNCHES, **cl.LAUNCHES}
    log(f"{tag} evaluate_global: {metrics} in {eval_s:.2f} s; launches {launches}")
    train_s = sum(r["seconds"] for r in rounds)
    log(f"{tag} {len(rounds)} rounds in {train_s:.2f} s: {len(rounds) / train_s:.4f} rounds/s, "
        f"{sum(r['real_images'] for r in rounds) / train_s:.1f} real images/s; {smi}")
    if not (np.isfinite(metrics["loss"]) and 0.0 <= metrics["acc"] <= 1.0):
        raise AssertionError(f"evaluate_global gave {metrics}")
    return rounds, metrics, eval_s, trained, launches


def phase_train(smi: str, bn_impl: str = "pallas", conv_impl: str = "xla"):
    """2 FedAvg rounds of the flagship in one configuration; checks the
    kernels' launch counts over the rounds and over evaluate_global."""
    import torch

    tag = f"[train {conv_impl}/{bn_impl}]"
    t0 = time.perf_counter()
    api = flagship_api(bn_impl, conv_impl)
    ds, cfg = api.dataset, api.config
    torch.cuda.synchronize()
    log(f"{tag} set-up (data {ds.train_x.shape}, model, placement) {time.perf_counter() - t0:.1f} s")

    steps = sum(api.round_counts(r)[1] // cfg.batch_size for r in range(cfg.comm_round))
    init = {k: v.clone() for k, v in api.variables.items()}
    captured = run_rounds(api, tag, smi, replayed=steps)
    rounds, metrics, eval_s, trained, launches = captured
    train_s = sum(r["seconds"] for r in rounds)
    # per live step: the BN path runs 57 K1 + 57 K2; the lanes path 72 K3
    # (36 forward + 36 dgrad) and 36 K4, and 36 K3 per eval batch
    eval_batches = -(-ds.test_x.shape[0] // EVAL_BATCH)
    per_step = ({"bn_fwd": BNS_PER_STEP, "bn_bwd": BNS_PER_STEP} if bn_impl == "pallas"
                else {"conv_fwd": CONV_PER_STEP, "conv_wgrad": WGRAD_PER_STEP})
    per_eval = {"conv_fwd": CONV_PER_STEP // 2} if conv_impl == "lanes" else {}
    for k in trained:
        want = per_step.get(k, 0) * steps
        if trained[k] != want:
            raise AssertionError(f"{tag} {k} launched {trained[k]} times over the rounds; "
                                 f"expected {per_step.get(k, 0)} x {steps} live steps = {want}")
        want_eval = per_eval.get(k, 0) * eval_batches
        if launches[k] - trained[k] != want_eval:
            raise AssertionError(f"{tag} {k} launched {launches[k] - trained[k]} times in "
                                 f"evaluate_global; expected {want_eval}")
    bn_path = bn_impl == "pallas"
    arms = capture_arms(api, tag, smi, graph_kernels=BN_GRAPH if bn_path else
                        {"conv_fwd_mma": CONV_PER_STEP, "conv_wgrad_mma": WGRAD_PER_STEP},
                        named_per_step=BNS_PER_STEP if bn_path else 0)
    # the eager arm's rounds: phase 4 only (the lanes path's would add ~40 s)
    eager = eager_rounds(api, init, tag, smi, captured) if bn_path else None
    return {"bn_impl": bn_impl, "conv_impl": conv_impl, "rounds": rounds, "eval": metrics,
            "step_profile": arms["profiles"]["captured"], "capture": arms, "eager_rounds": eager,
            "eval_s": eval_s, "steps": steps, "eval_batches": eval_batches,
            "launches_train": trained, "launches": launches,
            "rounds_per_s": len(rounds) / train_s,
            "real_images_per_s": sum(r["real_images"] for r in rounds) / train_s}


def phase_train_packed(smi: str):
    """The flagship's 2 rounds under the packing schedule (pack_lanes=2):
    57 K1 and 57 K2 per executed packed step and none in evaluate_global;
    a small f32 packed round on the card against the same round unpacked;
    the flagship's bf16 step against its plain steps; the summation-order
    control; the conv timing; a profile of 5 packed steps."""
    import torch

    from fedml_tpu_torch.parallel.packed import executed_steps

    tag = "[train packed]"
    t0 = time.perf_counter()
    api = flagship_api(pack_lanes=PACK_LANES, packed_conv="off")
    torch.cuda.synchronize()
    log(f"{tag} set-up {time.perf_counter() - t0:.1f} s; {api.packed_status()}")
    if not api.packed_status()["scheduled"]:
        raise AssertionError(f"{tag} the packed schedule does not apply: {api.packed_status()}")
    plans = [api._packed_plan(api.sample(r)) for r in range(api.config.comm_round)]
    per_round = [{"lanes": pl.n_lanes, "T": pl.T, "executed_steps": len(executed_steps(pl.live)),
                  "lane_steps": pl.live.sum(1).astype(int).tolist()} for pl in plans]
    log(f"{tag} plans: {per_round}")
    steps = sum(r["executed_steps"] for r in per_round)
    init = {k: v.clone() for k, v in api.variables.items()}
    captured = run_rounds(api, tag, smi, replayed=steps)
    rounds, metrics, eval_s, trained, launches = captured
    train_s = sum(r["seconds"] for r in rounds)
    for k in ("bn_fwd", "bn_bwd"):
        if trained[k] != BNS_PER_STEP * steps:
            raise AssertionError(f"{tag} {k} launched {trained[k]} times over the rounds; "
                                 f"expected {BNS_PER_STEP} x {steps} packed steps")
        if launches[k] != trained[k]:
            raise AssertionError(f"{tag} {k} launched {launches[k] - trained[k]} times in "
                                 f"evaluate_global; expected 0")
    if any(trained[k] for k in ("conv_fwd", "conv_wgrad")):
        raise AssertionError(f"{tag} the packed path launched a lanes conv kernel: {trained}")
    replay = packed_replay_check()
    bf16_check = packed_bf16_step_check()
    control = order_control()
    conv_timing = packed_conv_timing()
    arms = capture_arms(api, tag, smi, packed=True, graph_kernels=BN_GRAPH,
                        named_per_step=BNS_PER_STEP)
    eager = eager_rounds(api, init, tag, smi, captured)
    return {"pack_lanes": PACK_LANES, "plans": per_round, "rounds": rounds, "eval": metrics,
            "step_profile": arms["profiles"]["captured"], "capture": arms,
            "eager_rounds": eager, "replay_check": replay, "bf16_step_check": bf16_check,
            "order_control": control, "conv_timing": conv_timing,
            "eval_s": eval_s, "steps": steps,
            "launches_train": trained, "launches": launches,
            "rounds_per_s": len(rounds) / train_s,
            "real_images_per_s": sum(r["real_images"] for r in rounds) / train_s}


def packed_replay_check(api_cls=None, tag: str = "[train packed]", **extra) -> dict:
    """One f32 round of a small CifarResNet (widths 8/16/16, 8x8 images, 4
    clients, 3 a round, 2 epochs) on the card, packed in two lanes against
    unpacked, from the same weights and orders: the CPU test's tolerance
    (variables rtol 1e-4 / atol 1e-5, loss rtol 1e-5). ``api_cls`` (FedAvg
    by default) and ``extra`` config fields pick the algorithm."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import ModelBundle
    from fedml_tpu_torch.models.resnet import CifarResNet

    ds = make_synthetic_classification(
        "packed-check", (8, 8, 3), 10, 4, records_per_client=16, test_records=40,
        partition_method="hetero", partition_alpha=0.5, batch_size=8, seed=SEED)
    apis = []
    for lanes in (PACK_LANES, 0):
        cfg = FedConfig(**{**dict(model="cifar-small", client_num_in_total=4,
                                  client_num_per_round=3, comm_round=1, batch_size=8, epochs=2,
                                  lr=0.05, momentum=0.9, seed=SEED, device_data="on",
                                  pack_lanes=lanes), **extra})
        bundle = ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16),
                                                        bn_impl="pallas"), (8, 8, 3))
        apis.append((api_cls or FedAvgAPI)(ds, cfg, bundle))
    packed, plain = apis
    packed.variables = {k: v.clone() for k, v in plain.variables.items()}
    plan = packed._packed_plan(packed.sample(0))
    if plan.k_max < 2 or plan.live.min() > 0:
        raise AssertionError("the replay check's cohort should put two clients in a lane and "
                             "give a lane dead steps")
    loss_p, loss_u = packed.run_round(0), plain.run_round(0)
    if not abs(loss_p - loss_u) <= 1e-5 * abs(loss_u):
        raise AssertionError(f"packed round loss {loss_p} != unpacked {loss_u} at rtol 1e-5")
    worst = 0.0
    for k, v in plain.variables.items():
        worst = max(worst, assert_close(f"packed replay {k}", packed.variables[k], v, 1e-4, 1e-5))
    log(f"{tag} f32 replay on the card: loss {loss_p:.7f} vs {loss_u:.7f} unpacked, "
        f"variables within {worst:.3g} (rtol 1e-4, atol 1e-5)")
    return {"loss_packed": loss_p, "loss_unpacked": loss_u, "max_abs_err": worst}


# The packed flagship's bf16 step against its plain steps. Both bf16 steps
# round in their own order (the grouped conv, the folded BN sums), so
# neither is the other's reference: each is held against the exact step
# (f32, TF32 off) on the same inputs, and the packed step's relative L2
# distance from it may be at most this multiple of the plain bf16 step's,
# per lane and quantity (logits, gradients, BN running statistics). A
# fault of the packed path (lanes' channels mixed, a wrong cast) gives an
# error of order one, far above bf16's own.
PACKED_BF16_RATIO = 2.0
# ResNet-56's 3x3 convs at batch 64, one per stage, (C, H = W): the packed
# path's grouped conv over two lanes against two ungrouped convs and one
PACKED_CONV_SHAPES = ((16, 32), (32, 16), (64, 8))


def _rel(a, b) -> float:
    return float((a - b).norm() / b.norm())


def packed_bf16_step_check() -> dict:
    """One train step of the lane-stacked ResNet-56 (bf16, the BN kernels,
    batch 64) over two lanes of different weights and batches (lane 1 with
    24 padding records) against each lane's plain step in bf16 and in f32
    on the same inputs: logits, per-lane gradients and BN running
    statistics within PACKED_BF16_RATIO x the plain bf16 step's error."""
    import torch

    from fedml_tpu_torch.core.tasks import classification_loss
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.packed_conv import unstack_variables

    dev = torch.device("cuda")
    L, bs = PACK_LANES, 64
    rng = np.random.default_rng(SEED + 11)
    x = torch.tensor(rng.normal(size=(L, bs, 32, 32, 3)).astype(np.float32), device=dev)
    y = torch.tensor(rng.integers(0, 10, size=(L, bs)), device=dev)
    m = torch.ones(L, bs, device=dev)
    m[1, bs - 24:] = 0.0
    def model(dtype):
        return create_model("resnet56", 10, dtype=dtype, bn_impl="pallas").module.to(dev)

    weights = [create_model("resnet56", 10, bn_impl="pallas").init(100 + lane, device=dev)
               for lane in range(L)]

    names = [k for k, _ in model(torch.float32).named_parameters()]
    stats = [k for k, _ in model(torch.float32).named_buffers()]

    def record(logits, loss, grads: dict, buffers: dict) -> dict:
        def flat(ts):
            return torch.cat([t.detach().float().reshape(-1) for t in ts])
        return {"logits": logits.detach().float(), "loss": loss.detach().float().view(1),
                "grads": flat(grads[k] for k in names), "bn_stats": flat(buffers[k] for k in stats)}

    plain = {}
    for dtype in (torch.float32, torch.bfloat16):
        for lane in range(L):
            mod = model(dtype)
            mod.load_state_dict(weights[lane])
            mod.train()
            logits = mod(x[lane])
            loss = classification_loss(logits, y[lane], m[lane])
            loss.backward()
            plain[dtype, lane] = record(logits, loss, {k: p.grad for k, p in mod.named_parameters()},
                                        dict(mod.named_buffers()))
    twin = model(torch.bfloat16).lane_stacked(L)
    twin.load_state_dict({k: torch.cat([w[k] for w in weights]) for k in weights[0]})
    twin.train()
    logits = twin(x)
    losses = torch.stack([classification_loss(logits[lane], y[lane], m[lane]) for lane in range(L)])
    losses.sum().backward()
    grads = {k: p.grad for k, p in twin.named_parameters()}
    buffers = dict(twin.named_buffers())
    out, worst = {}, 0.0
    for lane in range(L):
        got = record(logits[lane], losses[lane], unstack_variables(grads, lane, L),
                     unstack_variables(buffers, lane, L))
        ref, pl = plain[torch.float32, lane], plain[torch.bfloat16, lane]
        for q in ref:
            if not bool(torch.isfinite(got[q]).all()):
                raise AssertionError(f"packed bf16 step: lane {lane} {q} is not finite")
            rec = {"plain_vs_f32": _rel(pl[q], ref[q]), "packed_vs_f32": _rel(got[q], ref[q]),
                   "packed_vs_plain": _rel(got[q], pl[q])}
            out[f"lane{lane}/{q}"] = rec
            if q == "loss":     # one number: reported, held through the logits
                continue
            ratio = rec["packed_vs_f32"] / rec["plain_vs_f32"]
            worst = max(worst, ratio)
            if not ratio <= PACKED_BF16_RATIO:
                raise AssertionError(
                    f"packed bf16 step: lane {lane} {q} lies {rec['packed_vs_f32']:.3g} from the "
                    f"f32 step, {ratio:.2f}x the plain bf16 step's {rec['plain_vs_f32']:.3g} "
                    f"(limit {PACKED_BF16_RATIO}x)")
    log("[train packed] bf16 step at the flagship's shapes, relative L2 from the f32 step, "
        "plain bf16 / packed bf16 (packed vs plain): " + "; ".join(
            f"{k} {v['plain_vs_f32']:.3g} / {v['packed_vs_f32']:.3g} ({v['packed_vs_plain']:.3g})"
            for k, v in out.items()) + f"; worst ratio {worst:.3f} (limit {PACKED_BF16_RATIO})")
    return {"quantities": out, "worst_ratio": worst, "limit": PACKED_BF16_RATIO}


def order_control() -> dict:
    """Round 0 of the flagship, unpacked and packed, with the plain BN
    (``bn_impl="xla"``) in place of K1/K2: from the same weights, data and
    orders as phases 4 and 4b, a change of summation order only. Their
    losses beside phase 4's and 4b's show how far bf16 rounding alone moves
    a round's loss."""
    out = {}
    for lanes in (0, PACK_LANES):
        api = flagship_api("xla", pack_lanes=lanes)
        out["packed" if lanes else "unpacked"] = float(api.run_round(0))
    log(f"[train packed] control, round 0 with the plain BN: unpacked {out['unpacked']:.4f}, "
        f"packed {out['packed']:.4f}")
    return out


def packed_conv_timing() -> list:
    """Forward and backward (input and weight gradients) of one 3x3 conv a
    stage, bf16, batch 64, channels last: two lanes as the packed path runs
    them (one groups=2 conv over [N, H, W, 2C]), as two ungrouped convs, and
    one lane alone; CUDA events and device ms per call."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 12)
    rows = []

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32), device=dev,
                            dtype=torch.bfloat16)

    for C, hw in PACKED_CONV_SHAPES:
        n = 64
        xs = [t(n, hw, hw, C).permute(0, 3, 1, 2).requires_grad_() for _ in range(PACK_LANES)]
        ws = [t(C, C, 3, 3).requires_grad_() for _ in range(PACK_LANES)]
        gys = [t(n, hw, hw, C).permute(0, 3, 1, 2) for _ in range(PACK_LANES)]
        xg = torch.cat([x.detach() for x in xs], 1).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        wg = torch.cat([w.detach() for w in ws]).requires_grad_()
        gyg = torch.cat(gys, 1).contiguous(memory_format=torch.channels_last)

        def grouped():
            F.conv2d(xg, wg, padding=1, groups=PACK_LANES).backward(gyg)

        def split():
            for x, w, gy in zip(xs, ws, gys):
                F.conv2d(x, w, padding=1).backward(gy)

        def one():
            F.conv2d(xs[0], ws[0], padding=1).backward(gys[0])

        rec = {"C": C, "hw": hw, "n": n, **_time_fns({"grouped_": grouped, "split_": split,
                                                       "one_lane_": one})}
        rows.append(rec)
        log(f"[time] conv fwd+bwd {n}x{C}@{hw}x{hw} bf16, device ms (events): grouped x2 "
            f"{rec['grouped_device_ms']} ({rec['grouped_ms']:.4f}), split x2 "
            f"{rec['split_device_ms']} ({rec['split_ms']:.4f}), one lane "
            f"{rec['one_lane_device_ms']} ({rec['one_lane_ms']:.4f})")
    return rows


# The zoo phase's FedOpt server lr: 0.01, as
# tests/test_algorithms.py::test_fedadam_runs. The bench arm keeps
# FedConfig's default of 1.0: an Adam step of 1.0 on every weight each
# round is a divergence test, not a smoke test.
ZOO_SERVER_LR = 0.01


def server_step_timing(api) -> dict:
    """FedOpt's server step on ResNet-56's parameters (the round's one
    step after the aggregate), on a copy of the server state."""
    import copy

    import torch

    update = api.crosssilo_hooks()["server_update"]
    state = copy.deepcopy(api.server_state)
    agg = {k: v * 0.999 if v.is_floating_point() else v for k, v in api.variables.items()}

    def fn():
        return update(api.variables, agg, None, 1.0, state, None)

    from fedml_tpu_torch.core.pytree import split_params

    rec = {"ms": cuda_time_ms(fn, iters=10), "device_ms": device_ms(fn, iters=5),
           "params": sum(v.numel() for v in split_params(api.variables)[0].values())}
    torch.cuda.synchronize()
    return rec


def phase_train_zoo(smi: str):
    """The algorithms of the hook contract on the packed flagship (FedOpt
    with server adam is bench.py's adaptive arm, bench.py:262-280) and
    FedAvg with client adam on the plain one, on the flagship's federation
    and widths (ResNet-56, ``bn_impl="pallas"``, bf16, 32 clients, 8 a
    round, batch 64): finite losses, 57 K1 + 57 K2 per executed packed or
    live step (the hooks add no BN launch) and none in ``evaluate_global``;
    FedOpt's server state after its rounds on the card and nonzero, its
    step count the rounds; small f32 FedOpt-adam and client-adam rounds
    packed against unpacked on the card; FedOpt's server step timed;
    profiles of 5 packed FedOpt steps and of 5 client-adam steps."""
    import torch

    from fedml_tpu_torch.algorithms.fedagc import FedAGCAPI
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.algorithms.fednova import FedNovaAPI
    from fedml_tpu_torch.algorithms.fedopt import FedOptAPI
    from fedml_tpu_torch.algorithms.fedprox import FedProxAPI
    from fedml_tpu_torch.core.optim import state_tensors
    from fedml_tpu_torch.parallel.packed import executed_steps

    runs = (   # (label, algorithm, FedConfig overrides, rounds); "packed": pack_lanes=2
        ("fedopt-adam", FedOptAPI,
         dict(server_optimizer="adam", server_lr=ZOO_SERVER_LR, packed=True), 2),
        ("fedprox", FedProxAPI, dict(fedprox_mu=0.01, packed=True), 1),
        ("fednova", FedNovaAPI, dict(packed=True), 1),     # momentum 0.9, the flagship's
        ("fedagc", FedAGCAPI, dict(packed=True), 1),       # clipping 1e-2, the default
        # amsgrad at Adam's customary 1e-3 (the flagship's 0.1 is an SGD step)
        ("fedavg-client-adam", FedAvgAPI, dict(client_optimizer="adam", lr=1e-3), 1),
    )
    ds = flagship_data()
    out, launches = {}, {"bn_fwd": 0, "bn_bwd": 0}
    for label, cls, overrides, n_rounds in runs:
        tag = f"[zoo {label}]"
        cfg = dict(overrides)
        packed = cfg.pop("packed", False)
        if packed:
            cfg.update(pack_lanes=PACK_LANES, packed_conv="off")
        t0 = time.perf_counter()
        api = flagship_api(api_cls=cls, ds=ds, comm_round=n_rounds, **cfg)
        torch.cuda.synchronize()
        status = api.packed_status()
        log(f"{tag} set-up {time.perf_counter() - t0:.1f} s; {status}")
        if status["scheduled"] != packed:
            raise AssertionError(f"{tag} packed_status {status}; expected scheduled={packed}")
        if packed:
            steps = sum(len(executed_steps(api._packed_plan(api.sample(r)).live))
                        for r in range(n_rounds))
        else:
            steps = sum(api.round_counts(r)[1] // api.config.batch_size for r in range(n_rounds))
        rounds, metrics, eval_s, trained, after_eval = run_rounds(api, tag, smi,
                                                                 replayed=steps)
        for k in launches:
            if trained[k] != BNS_PER_STEP * steps or after_eval[k] != trained[k]:
                raise AssertionError(f"{tag} {k} launched {trained[k]} times over the rounds and "
                                     f"{after_eval[k] - trained[k]} in evaluate_global; expected "
                                     f"{BNS_PER_STEP} x {steps} steps and 0")
            launches[k] += after_eval[k]
        if any(trained[k] for k in ("conv_fwd", "conv_wgrad")):
            raise AssertionError(f"{tag} launched a lanes conv kernel: {trained}")
        train_s = sum(r["seconds"] for r in rounds)
        rec = {"algorithm": cls.__name__, "config": overrides, "packed": packed, "steps": steps,
               "rounds": rounds, "eval": metrics, "eval_s": eval_s, "launches": after_eval,
               "rounds_per_s": len(rounds) / train_s,
               "real_images_per_s": sum(r["real_images"] for r in rounds) / train_s}
        if cls is FedOptAPI:
            tensors, counts = state_tensors(api.server_state["opt"])
            if not all(t.is_cuda for t in tensors + counts):
                raise AssertionError(f"{tag} the server state is not on the card")
            if not any(bool(t.abs().max() > 0) for t in tensors) or \
                    any(int(c) != n_rounds for c in counts):
                raise AssertionError(f"{tag} server state zero, or its count is not {n_rounds}: "
                                     f"counts {[int(c) for c in counts]}")
            rec["server_state_abs_max"] = max(float(t.abs().max()) for t in tensors)
            rec["server_step"] = server_step_timing(api)
            log(f"{tag} server state on the card, |max| {rec['server_state_abs_max']:.4g}, "
                f"count {[int(c) for c in counts]}; server step {rec['server_step']['ms']:.3f} ms "
                f"(device {rec['server_step']['device_ms']}) over "
                f"{rec['server_step']['params']} parameters; {smi}")
        if cls is FedOptAPI or not packed:     # eager and captured, profiled
            rec["capture"] = capture_arms(api, tag, smi, packed=packed, graph_kernels=BN_GRAPH,
                                          named_per_step=BNS_PER_STEP)
            rec["step_profile"] = rec["capture"]["profiles"]["captured"]
        out[label] = rec
        del api
    out["replay_check"] = packed_replay_check(FedOptAPI, "[zoo fedopt-adam]",
                                              server_optimizer="adam", server_lr=ZOO_SERVER_LR)
    # the lane program's per-lane adam state (moments, [L] step count) on
    # the card: a lane's second client starts from fresh state
    out["client_adam_replay_check"] = packed_replay_check(
        None, "[zoo client adam]", client_optimizer="adam", lr=0.01)
    out["launches"] = launches
    return out


# -- phase 4d: the cross-silo paradigm ------------------------------------------

# bench.py's cross-silo configuration (bench.py:101-131): full
# participation, resident data, the grouped schedule's bucket_groups=6, the
# packed mesh's 2 lanes; and the weak-scaling points (bench.py:980-1008)
CROSSSILO_BUCKET_GROUPS = 6
WEAK_SCALING_SILOS = (8, 16)


@functools.lru_cache(maxsize=None)
def silo_data(silos: int):
    """``silos`` silos of the flagship's records each (1562, hetero, seed 0);
    32 is the flagship's federation."""
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification

    if silos == 32:
        return flagship_data()
    return make_synthetic_classification(
        "cifar10-bench", (32, 32, 3), 10, silos, records_per_client=1562,
        partition_method="hetero", partition_alpha=0.5, batch_size=64, seed=SEED)


def crosssilo_api(ds, api_cls=None, mesh=None, **config):
    """The flagship under the cross-silo paradigm (``CrossSiloFedAvgAPI`` or
    ``api_cls``) on one rank (``mesh``, or the process group's): every silo
    every round, the data resident."""
    from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI

    base = dict(client_num_in_total=ds.num_clients, client_num_per_round=ds.num_clients,
                device_data="on", bucket_groups=CROSSSILO_BUCKET_GROUPS, rounds_per_step=1)
    return flagship_api(api_cls=api_cls or CrossSiloFedAvgAPI, ds=ds, mesh=mesh,
                        **{**base, **config})


def crosssilo_steps(api) -> int:
    """The steps one round of a cross-silo API executes on this rank: the
    packed mesh's steps where one of its lanes is live, else every client's
    live steps."""
    from fedml_tpu_torch.parallel.packed import executed_steps, rank_plan

    pm = api._packed_mesh
    if pm is not None:
        return len(executed_steps(rank_plan(pm["plan"], api.mesh.world_size,
                                            api.mesh.rank).live))
    return api.round_counts(0)[1] // api.config.batch_size


def crosssilo_arm(api, tag: str, smi: str, timed: int = 2) -> dict:
    """One warm-up round, then ``timed`` rounds ending in a host sync: real
    and padded images/s, rounds/s, K1 and K2 launches (57 + 57 a step) and
    one replay a step over the timed rounds, finite losses; then a profile of
    5 steps (packed: of two silos' first 5 batches in the two lanes)."""
    import torch

    from fedml_tpu_torch.ops import batchnorm as bn

    t = time.perf_counter()
    warm = float(api.run_round(0))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    steps = crosssilo_steps(api) * timed
    bn.reset_launches()
    r0 = sum(p.replays for p in step_programs(api))
    t = time.perf_counter()
    losses = [api.run_round(r) for r in range(1, timed + 1)]
    losses = [float(x) for x in losses]          # the host sync
    dt = time.perf_counter() - t
    launches = dict(bn.LAUNCHES)
    replayed = sum(p.replays for p in step_programs(api)) - r0
    counts = [api.round_counts(r) for r in range(1, timed + 1)]
    real, padded = sum(c[0] for c in counts), sum(c[1] for c in counts)
    rec = {"schedule": ("packed mesh" if api._packed_mesh is not None else
                        "grouped" if api._group_plan is not None else "resident"),
           "silos": api.dataset.num_clients, "warmup_round_s": warm_s, "warmup_loss": warm,
           "losses": losses, "seconds": dt, "round_s": dt / timed, "rounds_per_s": timed / dt,
           "real_images": real, "padded_images": padded, "real_images_per_s": real / dt,
           "padded_images_per_s": padded / dt, "steps": steps, "replays": replayed,
           "launches": launches}
    if api._group_plan is not None:
        rec["groups"] = [(len(i), int(b)) for i, b in api._group_plan]
    if api._packed_mesh is not None:
        rec["plan"] = {"lanes": api._packed_mesh["plan"].n_lanes, "T": api._packed_mesh["plan"].T}
    log(f"{tag} {rec['schedule']}, {rec['silos']} silos: warm-up round {warm_s:.2f} s; "
        f"{timed} rounds in {dt:.3f} s: {rec['rounds_per_s']:.4f} rounds/s, "
        f"{rec['real_images_per_s']:.1f} real images/s ({rec['padded_images_per_s']:.1f} "
        f"padded), losses {losses}; {steps} steps, {replayed} replays, launches {launches}; {smi}")
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f"{tag} a loss is not finite: {[warm] + losses}")
    for k in ("bn_fwd", "bn_bwd"):
        if launches[k] != BNS_PER_STEP * steps:
            raise AssertionError(f"{tag} {k} launched {launches[k]} times over {timed} rounds; "
                                 f"expected {BNS_PER_STEP} x {steps} steps")
    if replayed != steps:
        raise AssertionError(f"{tag} {replayed} replays for {steps} steps")
    prof = packed_step_profile(api) if api._packed_mesh is not None else step_profile(api)
    for k, v in prof["kernels_by_name"].items():
        if v != BNS_PER_STEP * prof["live_steps"]:
            raise AssertionError(f"{tag} the profile counts {v} {k} over {prof['live_steps']} "
                                 f"steps; expected {BNS_PER_STEP} a step")
    log(f"{tag} 5-step profile: wall {prof['wall_ms_per_step']:.2f} ms, device "
        f"{prof['device_ms_per_step']:.3f} ms a step (busy {prof['device_busy_share']:.3f}), "
        f"{prof['host_launches_per_step']:.1f} host launches a step; {smi}")
    rec["step_profile"] = prof
    return rec


def small_crosssilo_check() -> dict:
    """The small CifarResNet (widths 8/16/16, 8x8 images, 4 silos, 2
    epochs) in f32 on the card: one packed mesh round and one resident
    mesh round against the simulation round from the same weights and
    orders, by the relative global norm of the parameters' difference
    (bound 1e-5, tests/test_crosssilo.py:40)."""
    from fedml_tpu_torch.algorithms.fedavg import CrossSiloFedAvgAPI, FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.core.pytree import split_params, tree_global_norm, tree_sub
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import ModelBundle
    from fedml_tpu_torch.models.resnet import CifarResNet

    ds = make_synthetic_classification(
        "xsilo-check", (8, 8, 3), 10, 4, records_per_client=16, test_records=40,
        partition_method="hetero", partition_alpha=0.5, batch_size=8, seed=SEED)
    base = dict(model="cifar-small", client_num_in_total=4, client_num_per_round=4,
                comm_round=1, batch_size=8, epochs=2, lr=0.05, momentum=0.9, seed=SEED,
                device_data="on")

    def bundle():
        return ModelBundle("cifar-small", CifarResNet(1, 10, widths=(8, 16, 16),
                                                      bn_impl="pallas"), (8, 8, 3))

    sim = FedAvgAPI(ds, FedConfig(**base), bundle())
    init = {k: v.clone() for k, v in sim.variables.items()}
    loss_sim = float(sim.run_round(0))
    want = split_params(sim.variables)[0]
    out = {"loss_simulation": loss_sim}
    for label, kw in (("packed", dict(pack_lanes=PACK_LANES)), ("resident", {})):
        cs = CrossSiloFedAvgAPI(ds, FedConfig(**base, **kw), bundle())
        cs.variables = {k: v.clone() for k, v in init.items()}
        loss = float(cs.run_round(0))
        rel = float(tree_global_norm(tree_sub(split_params(cs.variables)[0], want))
                    / tree_global_norm(want))
        out[label] = {"loss": loss, "rel_norm": rel}
        if not rel < 1e-5 or not abs(loss - loss_sim) <= 1e-5 * abs(loss_sim):
            raise AssertionError(f"[crosssilo] f32 {label} mesh round {rel:.3g} (relative norm) "
                                 f"from the simulation round, loss {loss} vs {loss_sim}")
    log(f"[crosssilo] f32 mesh rounds on the card against the simulation round: {out}")
    return out


def nccl_one_rank_check(ds, smi: str) -> dict:
    """One packed mesh round of ``ds`` under a world-size-1 NCCL process
    group (a ``file://`` store in a temporary directory, no network) against
    the same round without a group, from the same weights: bit for bit. The
    round's all-reduce (its flat buffer) profiled under the group (the
    host's ``nccl:all_reduce`` record, the device's NCCL records) and timed
    by CUDA events, with the group and without one."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType

    from fedml_tpu_torch.parallel.crosssilo import all_reduce_flat
    from fedml_tpu_torch.parallel.mesh import ClientMesh, client_mesh, init_multihost

    plain = crosssilo_api(ds, pack_lanes=PACK_LANES)
    init = {k: v.clone() for k, v in plain.variables.items()}
    loss_plain = float(plain.run_round(0))
    want = {k: v.clone() for k, v in plain.variables.items()}
    del plain
    tmp = tempfile.mkdtemp(prefix="nccl-store-")
    try:
        init_multihost(f"file://{tmp}/store", 1, 0, timeout_s=120)
        mesh = client_mesh()
        if mesh.group is None or mesh.world_size != 1:
            raise AssertionError(f"[crosssilo nccl] the mesh has no one-rank group: {mesh}")
        api = crosssilo_api(ds, mesh=mesh, pack_lanes=PACK_LANES)
        api.variables = {k: v.clone() for k, v in init.items()}
        loss = float(api.run_round(0))
        differ = [k for k, v in want.items() if not torch.equal(api.variables[k], v)]
        if differ or loss != loss_plain:
            raise AssertionError(f"[crosssilo nccl] the NCCL round differs from the group-less "
                                 f"round: loss {loss} vs {loss_plain}, tensors {differ[:6]}")
        buf = [v.float() for v in api.variables.values()]
        _, events = profiled(lambda: all_reduce_flat(mesh, buf), "one-rank NCCL all-reduce")
        host = sorted({e.name for e in events if e.device_type == DeviceType.CPU
                       and ("nccl" in e.name.lower() or "allreduce" in e.name.replace("_", ""))})
        device = sorted({e.name for e in events if e.device_type == DeviceType.CUDA
                         and "nccl" in e.name.lower()})
        if not any("allreduce" in n.replace("_", "") for n in host):
            raise AssertionError(f"[crosssilo nccl] the profile holds no NCCL all-reduce: {host}")
        # the round's tail collective, timed: the flat buffer's assembly and
        # the one call, under the group and without one
        tail_ms = {"nccl": cuda_time_ms(lambda: all_reduce_flat(mesh, buf), iters=20),
                   "no_group": cuda_time_ms(lambda: all_reduce_flat(
                       ClientMesh(1, 0, None, mesh.device), buf), iters=20)}
        backend = dist.get_backend()
        del api
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"silos": ds.num_clients, "backend": backend, "loss": loss, "bit_identical": True,
           "host_nccl_records": host, "device_nccl_kernels": device,
           "buffer_floats": sum(b.numel() for b in buf), "all_reduce_flat_ms": tail_ms}
    log(f"[crosssilo nccl] one packed mesh round under a world-size-1 {backend} group equals "
        f"the group-less round bit for bit (loss {loss}); its all-reduce of "
        f"{rec['buffer_floats']} floats: host {host}, device kernels {device}; "
        f"all_reduce_flat {tail_ms['nccl']:.4f} ms under the group, {tail_ms['no_group']:.4f} "
        f"ms without; {smi}")
    return rec


def phase_train_crosssilo(smi: str) -> dict:
    """Phase 4d: bench.py's cross-silo configuration on one rank, arms (a)
    packed mesh, (b) grouped, (c) resident, (d) FedOpt-adam on (a), (e) (a)
    at 8 and 16 silos with the fit T(c) = a + b*c; the f32 gate, the
    world-size-1 NCCL gate, FedOpt's server state on the card."""
    import gc

    import torch

    from fedml_tpu_torch.algorithms.fedopt import CrossSiloFedOptAPI
    from fedml_tpu_torch.core.optim import state_tensors

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out, launches = {"arms": {}}, {"bn_fwd": 0, "bn_bwd": 0}
    arms = (("a-packed", None, dict(pack_lanes=PACK_LANES), 2),
            ("b-grouped", None, dict(pack_lanes=0), 2),
            ("c-resident", None, dict(pack_lanes=0, bucket_groups=1), 2),
            ("d-fedopt-adam", CrossSiloFedOptAPI,
             dict(pack_lanes=PACK_LANES, server_optimizer="adam", server_lr=ZOO_SERVER_LR), 1))
    expect = {"a-packed": "packed mesh", "b-grouped": "grouped", "c-resident": "resident",
              "d-fedopt-adam": "packed mesh"}
    for label, cls, cfg, timed in arms:
        tag = f"[crosssilo {label}]"
        t0 = time.perf_counter()
        api = crosssilo_api(silo_data(32), cls, **cfg)
        torch.cuda.synchronize()
        log(f"{tag} set-up {time.perf_counter() - t0:.1f} s")
        rec = crosssilo_arm(api, tag, smi, timed)
        if rec["schedule"] != expect[label]:
            raise AssertionError(f"{tag} ran the {rec['schedule']} schedule")
        if cls is CrossSiloFedOptAPI:
            tensors, counts = state_tensors(api.server_state["opt"])
            if not all(t.is_cuda for t in tensors + counts) or \
                    not any(bool(t.abs().max() > 0) for t in tensors):
                raise AssertionError(f"{tag} the server state is not on the card, or zero")
            rec["server_state_abs_max"] = max(float(t.abs().max()) for t in tensors)
            rec["server_state_count"] = [int(c) for c in counts]
            log(f"{tag} server state on the card, |max| {rec['server_state_abs_max']:.4g}, "
                f"count {rec['server_state_count']}")
        for k in launches:
            launches[k] += rec["launches"][k]
        out["arms"][label] = rec
        del api
        free()
    scaling = {32: out["arms"]["a-packed"]}
    for silos in WEAK_SCALING_SILOS:
        api = crosssilo_api(silo_data(silos), pack_lanes=PACK_LANES)
        scaling[silos] = rec = crosssilo_arm(api, f"[crosssilo e-{silos}-silos]", smi)
        for k in launches:
            launches[k] += rec["launches"][k]
        out["arms"][f"e-packed-{silos}"] = rec
        del api
        free()
    T = {c: r["round_s"] for c, r in scaling.items()}
    b = (T[32] - T[8]) / (32 - 8)
    a = T[8] - b * 8
    out["weak_scaling"] = {"round_s": T, "fit_overhead_ms": a * 1e3, "fit_per_silo_ms": b * 1e3,
                           "midpoint_pred_s": a + b * 16,
                           "midpoint_err": abs(a + b * 16 - T[16]) / T[16]}
    log(f"[crosssilo e] T(c) {T}; fit a + b*c through 8 and 32: a {a * 1e3:.1f} ms, b "
        f"{b * 1e3:.2f} ms a silo; at 16 predicted {a + b * 16:.4f} s against {T[16]:.4f} s; "
        f"{smi}")
    out["f32_check"] = small_crosssilo_check()
    out["nccl_one_rank"] = nccl_one_rank_check(silo_data(WEAK_SCALING_SILOS[0]), smi)
    free()
    out["launches"] = launches
    return out


# -- phase 4e: the cross-device paradigm ----------------------------------------

# arm (a): the flagship's host round streamed in sub-cohort chunks of 4
# clients (2 a round), packed in 2 lanes, with the pipeline off and at depth
# 2, and a scheduled arm (speed policy under the population's count prior)
XDEV_CHUNK, XDEV_DEPTH = 4, 2
XDEV_WARM, XDEV_TIMED = 1, 2
# arm (b), bench.py's r05 basis row (bench.py:284-391): stackoverflow LR at
# its 342,477 clients, 50 a round; arm (c), bench.py's fedsched arms
# (bench.py:394-): a million clients, 1,000 a round in 250-client chunks
R05_CLIENTS, R05_COHORT, R05_ROUNDS = 342_477, 50, 3
SCHED_CLIENTS, SCHED_COHORT, SCHED_CHUNK, SCHED_LANES, SCHED_ROUNDS = \
    1_000_000, 1_000, 250, 4, 3
# the f32 chunked-against-unchunked tolerances (tests/test_fedsched.py:35
# and :337)
STREAM_TOL = {"plain": (1e-6, 1e-7), "packed": (1e-5, 1e-6)}


def _rounds(api, first: int, n: int, sync: bool = True) -> tuple:
    """Rounds ``first .. first + n - 1``; ``(losses, seconds)``, the
    seconds ending in a host sync."""
    import torch

    t = time.perf_counter()
    losses = [api.run_round(r) for r in range(first, first + n)]
    losses = [float(x) for x in losses]            # the host sync
    if sync:
        torch.cuda.synchronize()
    return losses, time.perf_counter() - t


def stream_steps(api, rounds) -> int:
    """The packed steps the streamed rounds execute: each chunk's plan's
    steps where some lane is live."""
    from fedml_tpu_torch.parallel.packed import executed_steps, plan_packing

    c = api.config
    total = 0
    for r in rounds:
        sampled, _ = api._round_plan(r)
        counts = np.asarray(api.dataset.train_counts, np.float64)[sampled]
        for start, size in api._stream_chunk_spec(len(sampled)):
            plan = plan_packing(counts[start:start + size], c.batch_size, c.epochs, c.pack_lanes)
            total += 0 if plan is None else len(executed_steps(plan.live))
    return total


def crossdevice_flagship_arm(label: str, smi: str, init: Optional[dict] = None,
                             **config) -> dict:
    """One arm of (a): the flagship's host round, streamed and packed, warm-up
    rounds, then timed rounds ending in a sync; K1/K2 at exactly 57 a packed
    step and one replay a step over the timed rounds; the stage rows."""
    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.utils.metrics import round_stats

    tag = f"[crossdevice a {label}]"
    c = dict(device_data="off", stream_aggregate="deterministic", cohort_chunk=XDEV_CHUNK,
             pack_lanes=PACK_LANES, comm_round=XDEV_WARM + XDEV_TIMED, **config)
    api = flagship_api(**c)
    if config.get("cohort_policy", "uniform") != "uniform":
        from fedml_tpu_torch.data.sched import plan_cohort, snapshot_from_counts

        snap = snapshot_from_counts(api.dataset.train_counts)
        api.set_cohort_profiler(snap)
        cfg = api.config
        for r in range(cfg.comm_round):
            want = plan_cohort(r, cfg.client_num_in_total, cfg.client_num_per_round, cfg.seed,
                               cfg.cohort_policy, snap)
            if not np.array_equal(api.sample(r), want):
                raise AssertionError(f"{tag} round {r}: cohort {api.sample(r)} is not the "
                                     f"CPU plan_cohort's {want}")
    if init is not None:
        api.variables = {k: v.clone() for k, v in init.items()}
    if not api.packed_status()["scheduled"] or api._dev_train is not None:
        raise AssertionError(f"{tag} not a streamed packed host round: {api.packed_status()}")
    warm, warm_s = _rounds(api, 0, XDEV_WARM)
    api._stage_rows.clear()
    timed = range(XDEV_WARM, XDEV_WARM + XDEV_TIMED)
    steps = stream_steps(api, timed)
    bn.reset_launches()
    r0 = sum(p.replays for p in trainer_programs(api._stream_packed))
    losses, dt = _rounds(api, XDEV_WARM, XDEV_TIMED)
    launches = dict(bn.LAUNCHES)
    replayed = sum(p.replays for p in trainer_programs(api._stream_packed)) - r0
    real = sum(api.round_counts(r)[0] for r in timed)
    rec = {"arm": label, "config": {k: v for k, v in c.items() if k != "comm_round"},
           "cohorts": [api.sample(r).tolist() for r in timed],
           "warmup_losses": warm, "warmup_s": warm_s, "losses": losses, "seconds": dt,
           "rounds_per_s": XDEV_TIMED / dt, "real_images": real, "real_images_per_s": real / dt,
           "steps": steps, "replays": replayed, "launches": launches,
           "stage": round_stats(api._stage_rows, api.config.host_pipeline_depth),
           "stream_stats": dict(api.stream_stats)}
    log(f"{tag} {XDEV_TIMED} rounds in {dt:.3f} s: {rec['rounds_per_s']:.4f} rounds/s, "
        f"{rec['real_images_per_s']:.1f} real images/s, losses {losses}; {steps} packed steps, "
        f"{replayed} replays, launches {launches}; stages {rec['stage']}; stream "
        f"{rec['stream_stats']}; {smi}")
    if not all(np.isfinite(warm + losses)):
        raise AssertionError(f"{tag} a loss is not finite: {warm + losses}")
    for k in ("bn_fwd", "bn_bwd"):
        if launches[k] != BNS_PER_STEP * steps:
            raise AssertionError(f"{tag} {k} launched {launches[k]} times; expected "
                                 f"{BNS_PER_STEP} x {steps} executed packed steps")
    if replayed != steps:
        raise AssertionError(f"{tag} {replayed} replays for {steps} packed steps")
    rec["variables"] = {k: v.clone() for k, v in api.variables.items()}
    api.close()
    return rec


def crossdevice_f32_gates(smi: str) -> dict:
    """ResNet-56 at full width in f32 through K1/K2 on a small host-fed
    federation (6 CIFAR-shaped clients of 64 records, batch 16, all six a
    round), from one set of weights: two unchunked streamed rounds (no
    packing) against two batch host rounds, bit for bit; one chunked round
    against one unchunked, plain and packed, at STREAM_TOL (a deep net
    carries one round's fold-order difference into the next many times
    over, so the tolerance holds a round, as tests/test_fedsched.py's does
    for ``lr`` over three); and two rounds in chunks of 4 and 1 clients
    (round 0's second chunk captures its one-lane step while the prefetcher
    builds round 1) at depth 2 against depth 0, bit for bit. cuDNN runs
    its deterministic algorithms here (restored after): its default f32
    wgrad may sum in a run-dependent order, which would part any two
    rounds of this unstable small federation, whatever the fold did."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import create_model

    ds = make_synthetic_classification("xdev-gate", (32, 32, 3), 10, 6, records_per_client=64,
                                       partition_method="hetero", partition_alpha=0.5,
                                       batch_size=16, seed=SEED)
    base = dict(model="resnet56", client_num_in_total=6, client_num_per_round=6,
                batch_size=16, epochs=1, lr=0.1, momentum=0.9, seed=SEED,
                frequency_of_the_test=10_000, device_data="off")
    init = None

    def run(rounds: int = 1, **config):
        nonlocal init
        api = FedAvgAPI(ds, FedConfig(**{**base, "comm_round": rounds, **config}),
                        create_model("resnet56", 10, input_shape=(32, 32, 3), bn_impl="pallas"))
        if init is None:
            init = {k: v.clone() for k, v in api.variables.items()}
        api.variables = {k: v.clone() for k, v in init.items()}
        losses = [float(api.run_round(r)) for r in range(api.config.comm_round)]
        out = (losses, {k: v.clone() for k, v in api.variables.items()}, api.stream_stats)
        api.close()
        return out

    def same(a, b, what):
        if a[0] != b[0] or any(not torch.equal(a[1][k], b[1][k]) for k in a[1]):
            bad = [k for k in a[1] if not torch.equal(a[1][k], b[1][k])]
            raise AssertionError(f"[crossdevice gates] {what}: losses {a[0]} vs {b[0]}, "
                                 f"tensors differ {bad[:6]}")

    def close(a, b, what, tol):
        rtol, atol = tol
        np.testing.assert_allclose(a[0], b[0], rtol=rtol, atol=atol, err_msg=what)
        return max(assert_close(f"{what} {k}", a[1][k], b[1][k], rtol, atol) for k in a[1])

    stream = dict(stream_aggregate="deterministic")
    mid = dict(stream, pack_lanes=PACK_LANES, cohort_chunk=4, client_num_per_round=5)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = run(2)
        same(batch, run(2), "two batch host rounds")
        same(batch, run(2, **stream), "the unchunked streamed rounds against the batch host rounds")
        unchunked = run(**stream)
        err = {"plain": close(run(**stream, cohort_chunk=3), unchunked,
                              "chunked against unchunked (plain)", STREAM_TOL["plain"])}
        packed_one = run(**stream, pack_lanes=PACK_LANES)
        err["packed"] = close(run(**stream, pack_lanes=PACK_LANES, cohort_chunk=3), packed_one,
                              "chunked against unchunked (packed)", STREAM_TOL["packed"])
        serial = run(2, **mid)
        same(serial, run(2, **mid, host_pipeline_depth=XDEV_DEPTH),
             "chunks of 4 and 1 at depth 2 against depth 0")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[crossdevice gates] f32 ResNet-56 on the card: unchunked stream == batch host round "
        f"bit for bit; chunked vs unchunked max |err| {err} (tolerances {STREAM_TOL}); chunks "
        f"4+1 pipelined == serial bit for bit; {smi}")
    return {"stream_equals_batch": True, "pipelined_equals_serial": True,
            "chunked_max_abs_err": err, "tolerance": STREAM_TOL, "losses_batch": batch[0],
            "losses_unchunked": unchunked[0], "losses_packed": packed_one[0],
            "losses_chunks_4_1": serial[0]}


def r05_basis_arm(smi: str) -> dict:
    """(b) bench.py's r05 basis row: ``lr`` on the 342,477-client
    stackoverflow LR task, 50 a round, bf16, async rounds, the pipeline off
    against depth 2: 3 warm-up rounds, ``prime(1, wait=True)``, 3 timed
    rounds. No TPU kernel runs on this path."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.crossdevice import load_stackoverflow_lr_full
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.utils.metrics import round_stats

    t0 = time.perf_counter()
    ds = load_stackoverflow_lr_full(client_num_in_total=R05_CLIENTS, batch_size=10)
    setup_s = time.perf_counter() - t0

    def measure(depth: int) -> dict:
        cfg = FedConfig(model="lr", dataset="stackoverflow_lr", client_num_in_total=R05_CLIENTS,
                        client_num_per_round=R05_COHORT, comm_round=R05_ROUNDS, batch_size=10,
                        epochs=1, lr=0.05, seed=SEED, frequency_of_the_test=10_000,
                        dtype="bfloat16", async_rounds=True, host_pipeline_depth=depth)
        api = FedAvgAPI(ds, cfg, create_model("lr", ds.class_num,
                                              input_shape=ds.train_x.shape[2:]))
        warm, _ = _rounds(api, 1, R05_ROUNDS)
        api._stage_rows.clear()
        ds.materialized_rows = 0
        pf = api._host_prefetcher()
        if pf is not None:
            pf.prime(1, wait=True)
        r0 = replays(api)
        losses, dt = _rounds(api, 1, R05_ROUNDS)
        real = sum(api.round_counts(r)[0] for r in range(1, R05_ROUNDS + 1))
        row = {"depth": depth, "rounds_per_s": R05_ROUNDS / dt,
               "clients_per_s": R05_ROUNDS * R05_COHORT / dt, "examples_per_s": real / dt,
               "seconds": dt, "materialized_rows": int(ds.materialized_rows),
               "replays": replays(api) - r0, "losses": losses, "warmup_losses": warm,
               "stage": round_stats(api._stage_rows, depth),
               "on_card": all(v.is_cuda for v in api.variables.values())}
        api.close()
        if not (row["on_card"] and row["replays"] > 0 and np.isfinite(warm + losses).all()):
            raise AssertionError(f"[crossdevice b] depth {depth}: {row}")
        return row

    off, on = measure(0), measure(XDEV_DEPTH)
    rec = {"clients_total": R05_CLIENTS, "clients_per_round": R05_COHORT,
           "dataset_setup_s": setup_s, "off": off, "on": on,
           "speedup": on["rounds_per_s"] / off["rounds_per_s"]}
    for row in (off, on):
        log(f"[crossdevice b] r05 basis (lr, no TPU kernel on this path), depth "
            f"{row['depth']}: {row['rounds_per_s']:.4f} rounds/s, {row['clients_per_s']:.2f} "
            f"clients/s, {row['examples_per_s']:.1f} examples/s, {row['materialized_rows']} "
            f"materialized rows, stages {row['stage']}; {smi}")
    log(f"[crossdevice b] pipeline speed-up {rec['speedup']:.3f}x; {smi}")
    return rec


def fedsched_arms(smi: str) -> dict:
    """(c) bench.py's fedsched arms on a million-client synthetic
    federation: ``cohort50_batch``, ``streamed_uniform`` (1,000 a round in
    chunks of 250, 4 lanes) and ``streamed_speed`` (the same under the
    population's count prior). 3 warm-up rounds, then 3 timed rounds. No
    TPU kernel runs on this path."""
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.crossdevice import make_synthetic_crossdevice
    from fedml_tpu_torch.data.sched import snapshot_from_counts
    from fedml_tpu_torch.models import create_model

    t0 = time.perf_counter()
    ds = make_synthetic_crossdevice("xdev-sched", 1024, 32, SCHED_CLIENTS, batch_size=8,
                                    mean_records=12.0, max_records=96, seed=SEED)
    setup_s = time.perf_counter() - t0

    def measure(label, cohort, policy="uniform", streaming=False, snapshot=None) -> dict:
        cfg = FedConfig(model="lr", dataset="xdev-sched", client_num_in_total=SCHED_CLIENTS,
                        client_num_per_round=cohort, comm_round=SCHED_ROUNDS, batch_size=8,
                        epochs=1, lr=0.1, seed=SEED, frequency_of_the_test=10_000,
                        async_rounds=True, cohort_policy=policy,
                        stream_aggregate="deterministic" if streaming else "off",
                        cohort_chunk=SCHED_CHUNK if streaming else 0,
                        pack_lanes=SCHED_LANES if streaming else 0)
        api = FedAvgAPI(ds, cfg, create_model("lr", ds.class_num, input_shape=(1024,)))
        if snapshot is not None:
            api.set_cohort_profiler(snapshot)
        warm, _ = _rounds(api, 1, SCHED_ROUNDS)
        trainer = api._stream_packed if streaming else api._local_train
        r0 = sum(p.replays for p in trainer_programs(trainer))
        losses, dt = _rounds(api, 1, SCHED_ROUNDS)
        real = sum(api.round_counts(r)[0] for r in range(1, SCHED_ROUNDS + 1))
        row = {"arm": label, "clients_per_round": cohort, "policy": policy,
               "rounds_per_s": SCHED_ROUNDS / dt, "clients_per_s": SCHED_ROUNDS * cohort / dt,
               "examples_per_s": real / dt, "seconds": dt, "losses": losses,
               "replays": sum(p.replays for p in trainer_programs(trainer)) - r0,
               "stream": None if api.stream_stats is None else dict(api.stream_stats)}
        api.close()
        if not (row["replays"] > 0 and np.isfinite(warm + losses).all()):
            raise AssertionError(f"[crossdevice c] {label}: {row}")
        log(f"[crossdevice c] {label} (lr, no TPU kernel on this path): "
            f"{row['clients_per_s']:.2f} clients/s, {row['examples_per_s']:.1f} examples/s, "
            f"{row['rounds_per_s']:.4f} rounds/s; stream {row['stream']}; {smi}")
        return row

    basis = measure("cohort50_batch", 50)
    uniform = measure("streamed_uniform", SCHED_COHORT, streaming=True)
    speed = measure("streamed_speed", SCHED_COHORT, "speed", True,
                    snapshot_from_counts(ds.train_counts, 1.0))
    model_bytes = (1024 * 32 + 32) * 4 + 8
    for row in (uniform, speed):
        if row["stream"]["accumulator_bytes"] != model_bytes or row["stream"]["chunks"] != 4:
            raise AssertionError(f"[crossdevice c] {row['arm']}: stream {row['stream']}, "
                                 f"expected 4 chunks and {model_bytes} accumulator bytes")
    return {"clients_total": SCHED_CLIENTS, "dataset_setup_s": setup_s,
            "arms": [basis, uniform, speed],
            "policy_uplift_clients_per_s": speed["clients_per_s"] / uniform["clients_per_s"],
            "accumulator_bytes": model_bytes}


def phase_train_crossdevice(smi: str) -> dict:
    """Phase 4e: (a) the flagship's streamed and packed host round through
    K1/K2, the pipeline at depth 0 and 2 and the speed policy at depth 2,
    with the f32 gates; (b) bench.py's r05 basis row; (c) its fedsched
    arms."""
    import gc

    import torch

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"arms": {}}
    launches = {"bn_fwd": 0, "bn_bwd": 0}
    serial = crossdevice_flagship_arm("depth-0", smi)
    free()
    piped = crossdevice_flagship_arm(f"depth-{XDEV_DEPTH}", smi, init=None,
                                     host_pipeline_depth=XDEV_DEPTH)
    free()
    differ = [k for k in serial["variables"]
              if not torch.equal(serial["variables"][k], piped["variables"][k])]
    if differ or serial["losses"] != piped["losses"]:
        raise AssertionError(f"[crossdevice a] the pipelined rounds differ from the serial ones: "
                             f"losses {piped['losses']} vs {serial['losses']}, tensors "
                             f"{differ[:6]}")
    speed = crossdevice_flagship_arm(f"speed-depth-{XDEV_DEPTH}", smi,
                                     host_pipeline_depth=XDEV_DEPTH, cohort_policy="speed")
    free()
    for rec in (serial, piped, speed):
        rec.pop("variables")
        for k in launches:
            launches[k] += rec["launches"][k]
        out["arms"][rec["arm"]] = rec
    out["pipeline_speedup"] = piped["rounds_per_s"] / serial["rounds_per_s"]
    log(f"[crossdevice a] the pipelined rounds equal the serial rounds bit for bit; pipeline "
        f"speed-up {out['pipeline_speedup']:.3f}x; {smi}")
    out["f32_gates"] = crossdevice_f32_gates(smi)
    free()
    out["r05_basis"] = r05_basis_arm(smi)
    free()
    out["fedsched"] = fedsched_arms(smi)
    free()
    out["launches"] = launches
    return out


def attention_bound(b: int, h: int, tq: int, tk: int, d: int, causal: bool, elt: int = 2
                    ) -> tuple[float, float, int]:
    """(bytes, flops, live scores) of one K6 call at offsets 0: q, k, v
    read once, the f32 o, m, l written once; 2 FLOPs per multiply-add of
    q.k and of p.v over the live (query, key) pairs, each of which also
    takes one exponential."""
    live = b * h * (int(np.clip(np.arange(tq) + 1, 0, tk).sum()) if causal else tq * tk)
    nbytes = elt * b * h * (tq + 2 * tk) * d + 4 * b * h * tq * (d + 2)
    return nbytes, 4 * live * d, live


def exp_ms(n_exp: int, sm_clock_mhz: float, n_sm: int) -> float:
    """Least time of ``n_exp`` f32 exponentials on the special-function
    units: 16 per clock per SM (Hopper's MUFU rate) at the SM clock."""
    return n_exp / (EXP_PER_CLOCK_PER_SM * n_sm * sm_clock_mhz * 1e6) * 1e3


def xent_bound(n: int, v: int, elt: int = 4, label_bytes: int = 8) -> tuple[float, float]:
    """(bytes, flops) of one K5 call: the logits and labels read once, the
    f32 losses written once; max, subtract, exp and add per logit."""
    return elt * n * v + (label_bytes + 4) * n, 4 * n * v


def _close_partial(name, got, want) -> float:
    """K6's (o, m, l) against the plain version's. Both sum in f32 in other
    orders over up to Tk terms: m within 1e-5; l rtol 1e-5; o compared
    after dividing both by the plain l (its scale: o's row is a sum of l's
    worth of v rows), atol 2e-5."""
    import torch

    (o, m, l), (po, pm, pl) = got, want
    assert_close(f"{name} m", m, pm, 0.0, 1e-5)
    assert_close(f"{name} l", l, pl, 1e-5, 1e-5)
    den = torch.where(pl == 0, torch.ones_like(pl), pl)[..., None]
    return assert_close(f"{name} o/l", o / den, po / den, 0.0, 2e-5)


def phase_check_lm():
    """K6 and K5 against their plain versions on the same card tensors, then
    a small TransformerLM through both kernels on the card against the same
    model on the CPU."""
    import torch

    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import xent as xe

    rng = np.random.default_rng(SEED + 5)
    dev = torch.device("cuda")
    err = {"attention": 0.0, "xent": 0.0}
    cases = []

    def qkv(b, h, tq, tk, d, dtype):
        return [torch.tensor(rng.normal(size=s).astype(np.float32), device=dev).to(dtype)
                for s in ((b, h, tq, d), (b, h, tk, d), (b, h, tk, d))]

    # (B, H, Tq, Tk, D, q_offset, k_offset, causal): path (B), path (A), a
    # shifted query window, ragged T at each head dim, one non-causal case
    shapes = [ATTN_B + (0, 0, True), ATTN_B + (0, 0, False), ATTN_A + (0, 0, True),
              (2, 2, 32, 64, 32, 32, 0, True), (2, 2, 37, 37, 16, 0, 0, True),
              (1, 3, 300, 300, 64, 0, 0, True), (2, 2, 300, 37, 128, 263, 0, True),
              (2, 2, 64, 64, 128, 0, 0, False)]
    cases_by_dtype = [(s, dt) for s in shapes for dt in (torch.float32, torch.bfloat16)]
    # the bf16 kernel's tiles (64 query rows, 64 keys): every Tq, Tk at a
    # tile edge, the diagonal mid-tile by a query or key offset, D = 16 and
    # 128 at T = 300, a non-causal ragged case
    edges = (63, 64, 65, 129)
    tiles = [(2, 2, tq, tk, 32, 0, 0, True) for tq in edges for tk in edges]
    tiles += [(2, 2, 64, 129, 32, 29, 0, True), (2, 2, 129, 129, 64, 0, 37, True),
              (2, 2, 300, 300, 16, 0, 0, True), (2, 2, 300, 300, 128, 0, 0, True),
              (2, 2, 65, 129, 32, 0, 0, False)]
    cases_by_dtype += [(s, torch.bfloat16) for s in tiles]
    for (b, h, tq, tk, d, qo, ko, causal), dtype in cases_by_dtype:
        tag = (f"[{b},{h},{tq},{tk},{d}] offsets {qo},{ko} causal={causal} "
               f"{str(dtype).split('.')[1]}")
        q, k, v = qkv(b, h, tq, tk, d, dtype)
        args = (qo, ko, causal, d ** -0.5)
        got = att.block_partial_cuda(q, k, v, *args)
        e = _close_partial(f"K6 {tag}", got, att.block_partial_plain(q, k, v, *args))
        if dtype == torch.bfloat16:
            _same_bits(f"K6 {tag}", got, att.block_partial_cuda(q, k, v, *args))
        err["attention"] = max(err["attention"], e)
        cases.append({"case": f"K6 {tag}", "o_over_l": e})
        log(f"[check] K6 {tag}: max|err| o/l {e:.3g}"
            + ("; repeat bit-identical" if dtype == torch.bfloat16 else ""))
        del q, k, v, got
    # 4 K/V chunks with nonzero k_offset merged by merge_partials; the query
    # rows 0..15 see nothing of chunks 1-3, and chunk 3 of rows 0..47
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(2, 2, 64, 64, 32, dtype)
        got = want = None
        for i in range(4):
            sl = slice(16 * i, 16 * (i + 1))
            args = (q, k[:, :, sl].contiguous(), v[:, :, sl].contiguous(), 0, 16 * i, True,
                    32 ** -0.5)
            pg, pw = att.block_partial_cuda(*args), att.block_partial_plain(*args)
            got = pg if got is None else att.merge_partials(got, pg)
            want = pw if want is None else att.merge_partials(want, pw)
        dead = att.block_partial_cuda(q[:, :, :16].contiguous(), k[:, :, 48:].contiguous(),
                                      v[:, :, 48:].contiguous(), 0, 48, True, 32 ** -0.5)
        if not (bool((dead[1] == att.NEG_INF).all()) and bool((dead[2] == 0).all())
                and bool((dead[0] == 0).all())):
            raise AssertionError("K6: a fully future chunk must give m=-1e30, l=0, o=0")
        e = assert_close(f"K6 4-chunk merge {dtype}", att.normalize_partial(*got),
                         att.normalize_partial(*want), 0.0, 2e-5)
        err["attention"] = max(err["attention"], e)
        cases.append({"case": f"K6 4-chunk merge {dtype}", "out": e})
        log(f"[check] K6 4 chunks merged, {dtype}: max|err| {e:.3g}; dead chunk exact")
    torch.cuda.synchronize()

    # K5: the LM path's rows, the char vocab, an odd vocab, ragged N
    for n, v in ((XENT_B[0], XENT_B[1]), (4 * 80, 90), (100, 1003), (37, 33)):
        for dtype in (torch.float32, torch.bfloat16):
            tag = f"[{n}x{v} {str(dtype).split('.')[1]}]"
            lg = torch.tensor((rng.normal(size=(n, v)) * 3).astype(np.float32), device=dev).to(dtype)
            lb = torch.tensor(rng.integers(0, v, n), device=dev)
            # f32 sums over V terms in other orders: 2e-5 absolute at losses ~10
            e = assert_close(f"K5 {tag}", xe.xent_cuda(lg, lb), xe.xent_plain(lg, lb), 0.0, 2e-5)
            e32 = assert_close(f"K5 int32 labels {tag}", xe.xent_cuda(lg, lb.int()),
                               xe.xent_plain(lg, lb), 0.0, 2e-5)
            err["xent"] = max(err["xent"], e, e32)
            cases.append({"case": f"K5 {tag}", "loss": max(e, e32)})
            log(f"[check] K5 {tag}: max|err| {max(e, e32):.3g}")
    torch.cuda.synchronize()

    # a small TransformerLM (head dim 32, remat) on the card through K6/K5
    # vs the CPU's plain path, same weights and tokens (f32, TF32 off)
    from fedml_tpu_torch.models.transformer import TransformerLM

    kw = dict(vocab_size=97, dim=64, heads=2, layers=2, max_len=64, remat=True,
              attn_impl="pallas")
    cpu = TransformerLM(**kw)
    cpu.reset_parameters(torch.Generator().manual_seed(SEED))
    gpu = TransformerLM(**kw)
    gpu.load_state_dict(cpu.state_dict())
    gpu.to(dev)
    x = torch.tensor(rng.integers(0, 97, (3, 40)))
    y = torch.tensor(rng.integers(0, 97, (3, 40)))
    att.reset_launches()
    xe.reset_launches()
    losses = []
    for m, dv in ((cpu, "cpu"), (gpu, dev)):
        logits = m(x.to(dv))
        loss = xe.masked_cross_entropy(logits, y.to(dv), impl="pallas").mean()
        loss.backward()
        losses.append((logits.detach().cpu(), loss.detach().cpu()))
    torch.cuda.synchronize()
    ran = (att.LAUNCHES["attention"], xe.LAUNCHES["xent"])
    if ran != (4, 1):
        raise AssertionError(f"small LM: expected 4 K6 (2 blocks, forward + remat) and 1 K5 "
                             f"launches on the card, got {ran}")
    worst = 0.0
    pairs = [("logits", losses[1][0], losses[0][0]), ("loss", losses[1][1], losses[0][1])]
    pairs += [(k, p.grad, cpu.get_parameter(k).grad) for k, p in gpu.named_parameters()]
    for name, a, ref in pairs:
        rel = float((a.cpu() - ref).norm() / (ref.norm() + 1e-4 * ref.numel() ** 0.5))
        worst = max(worst, rel)
        if not rel < 1e-4:
            raise AssertionError(f"small LM {name}: relative L2 error {rel:.3g} >= 1e-4")
    log(f"[check] small TransformerLM GPU kernels vs CPU plain: worst relative L2 error "
        f"{worst:.3g}")
    return err, cases, worst


def phase_time_lm(sm_clock_mhz: float):
    """K6 and K5 at path (B)'s shapes (bf16 q, k, v [2, 8, 8192, 32] causal;
    f32 logits [16384, 10004]) beside their plain versions, the library
    yardsticks and their bounds. K6's bound is the largest of its bytes,
    its tensor-core FLOPs and its exponentials at ``sm_clock_mhz``."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import xent as xe

    rng = np.random.default_rng(SEED + 6)
    dev = torch.device("cuda")
    slow = dict(iters=5, repeats=3, warmup=2)
    b, h, tq, tk, d = ATTN_B
    q, k, v = (torch.tensor(rng.normal(size=(b, h, tq, d)).astype(np.float32), device=dev)
               .to(torch.bfloat16) for _ in range(3))
    sc = d ** -0.5
    fns = {"": lambda: att.block_partial_cuda(q, k, v, 0, 0, True, sc),
           "plain_": lambda: att.block_partial_plain(q, k, v, 0, 0, True, sc),
           "library_": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)}
    rows = []
    rec = {}
    for prefix, fn in fns.items():
        rec[f"{prefix}ms"] = cuda_time_ms(fn, **(slow if prefix == "plain_" else {}))
        rec[f"{prefix}device_ms"] = device_ms(fn, iters=5)
        rec[f"{prefix}queued_ms"] = queued_device_ms(
            fn, sm_clock_mhz, **(dict(iters=2, repeats=1) if prefix == "plain_" else {}))
    nbytes, flops, live = attention_bound(b, h, tq, tk, d, True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    terms = {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "tensor-core FLOPs": flops / PEAK_BF16_FLOPS * 1e3,
             "exponentials": exp_ms(live, sm_clock_mhz, n_sm)}
    rec["bound_ms"] = max(terms.values())
    rec["bound_by"] = "bytes" if terms["bytes"] == rec["bound_ms"] else "operations"
    rec.update(kernel="attention", shape=[b, h, tq, tk, d], dtype="bfloat16", causal=True,
               calls_per_step=LM_K6_PER_STEP, gflop=flops / 1e9, live_scores=live,
               bound_parts=terms, sm_clock_mhz=sm_clock_mhz, n_sm=n_sm)
    log(f"[time] attention bound terms at {sm_clock_mhz:.0f} MHz x {n_sm} SMs: "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in terms.items()))
    rows.append(rec)
    del q, k, v
    n, vv = XENT_B
    lg = torch.tensor(rng.normal(size=(n, vv)).astype(np.float32), device=dev)
    lb = torch.tensor(rng.integers(0, vv, n), device=dev)
    fns = {"": lambda: xe.xent_cuda(lg, lb), "plain_": lambda: xe.xent_plain(lg, lb),
           "library_": lambda: F.cross_entropy(lg, lb, reduction="none")}
    rec = {}
    for prefix, fn in fns.items():
        rec[f"{prefix}ms"] = cuda_time_ms(fn, iters=20)
        rec[f"{prefix}device_ms"] = device_ms(fn)
        rec[f"{prefix}queued_ms"] = queued_device_ms(fn, sm_clock_mhz, iters=20)
    nbytes, flops = xent_bound(n, vv)
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    rec.update(kernel="xent", shape=[n, vv], dtype="float32", calls_per_step=1)
    rows.append(rec)
    for rec in rows:
        us = {k: ("n/m" if val is None else f"{val:.4f}") for k, val in rec.items()
              if k.endswith("ms") and k != "bound_ms"}
        log(f"[time] {rec['kernel']} {rec['shape']} {rec['dtype']}: kernel {us['ms']} ms "
            f"(device {us['device_ms']}, queued {us['queued_ms']}), plain {us['plain_ms']} "
            f"(device {us['plain_device_ms']}, queued {us['plain_queued_ms']}), library "
            f"{us['library_ms']} (device {us['library_device_ms']}, queued "
            f"{us['library_queued_ms']}), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    torch.cuda.synchronize()
    return rows


def phase_train_lm_fedavg(smi: str):
    """Path (A): 2 FedAvg rounds of the registered ``transformer`` (dim 256,
    8 heads, 4 layers, bf16 compute, f32 parameters) on the synthetic
    fed_shakespeare federation (100 clients, vocab 90, sequences of 80),
    10 clients a round, batch 4, SGD lr 0.1 momentum 0.9; then
    evaluate_global. Checks 4 K6 per live step and per eval batch, and no
    other kernel."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.shakespeare import load_fed_shakespeare
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.ops import conv_lanes as cl
    from fedml_tpu_torch.ops import xent as xe

    tag = "[train transformer/fed_shakespeare]"
    t0 = time.perf_counter()
    ds = load_fed_shakespeare(data_dir=str(ROOT / "data" / "fed_shakespeare" / "datasets"),
                              client_num_in_total=100, batch_size=4, seed=SEED)
    cfg = FedConfig(model="transformer", dataset="fed_shakespeare", client_num_in_total=100,
                    client_num_per_round=10, comm_round=2, batch_size=4, epochs=1, lr=0.1,
                    momentum=0.9, dtype="bfloat16", frequency_of_the_test=10_000, seed=SEED,
                    async_rounds=True)
    bundle = create_model("transformer", ds.class_num, input_shape=ds.train_x.shape[2:],
                          dtype=torch.bfloat16, attn_impl="auto")
    api = FedAvgAPI(ds, cfg, bundle)
    torch.cuda.synchronize()
    seq_len = ds.train_x.shape[2]
    log(f"{tag} set-up (data {ds.train_x.shape}, {ds.name}, model, placement) "
        f"{time.perf_counter() - t0:.1f} s")
    steps = sum(api.round_counts(r)[1] // cfg.batch_size for r in range(cfg.comm_round))
    mods = (att, xe, bn, cl)
    for mod in mods:
        mod.reset_launches()
    r0 = replays(api)
    rounds = []
    for r in range(cfg.comm_round):
        t = time.perf_counter()
        loss = float(api.run_round(r))
        dt = time.perf_counter() - t
        real, executed = api.round_counts(r)
        rounds.append({"round": r, "loss": loss, "seconds": dt, "real_sequences": real,
                       "executed_sequences": executed, "real_tokens_per_s": real * seq_len / dt})
        log(f"{tag} round {r}: loss {loss:.4f}, {dt:.2f} s, {real} real sequences "
            f"({executed} executed), {real * seq_len / dt:.1f} real tokens/s")
        if not np.isfinite(loss):
            raise AssertionError(f"round {r} loss is not finite: {loss}")
    trained = {k: val for mod in mods for k, val in mod.LAUNCHES.items()}
    if replays(api) - r0 != steps:
        raise AssertionError(f"{tag} the rounds replayed the captured step "
                             f"{replays(api) - r0} times for {steps} live steps")
    t = time.perf_counter()
    metrics = api.evaluate_global()
    eval_s = time.perf_counter() - t
    launches = {k: val for mod in mods for k, val in mod.LAUNCHES.items()}
    train_s = sum(r["seconds"] for r in rounds)
    tokens = sum(r["real_sequences"] for r in rounds) * seq_len
    log(f"{tag} evaluate_global: {metrics} in {eval_s:.2f} s; launches {launches}")
    log(f"{tag} {len(rounds)} rounds in {train_s:.2f} s: {len(rounds) / train_s:.4f} rounds/s, "
        f"{tokens / train_s:.1f} real tokens/s over {steps} live steps; {smi}")
    if not (np.isfinite(metrics["loss"]) and 0.0 <= metrics["acc"] <= 1.0):
        raise AssertionError(f"evaluate_global gave {metrics}")
    eval_batches = -(-ds.test_x.shape[0] // EVAL_BATCH)
    layers = bundle.module.layers
    for k in trained:
        want = layers * steps if k == "attention" else 0
        if trained[k] != want:
            raise AssertionError(f"{tag} {k} launched {trained[k]} times over the rounds; "
                                 f"expected {want}")
        want_eval = layers * eval_batches if k == "attention" else 0
        if launches[k] - trained[k] != want_eval:
            raise AssertionError(f"{tag} {k} launched {launches[k] - trained[k]} times in "
                                 f"evaluate_global; expected {want_eval}")
    arms = capture_arms(api, tag, smi, graph_kernels={"flash_fwd_": layers})
    return {"rounds": rounds, "eval": metrics, "eval_s": eval_s, "steps": steps,
            "eval_batches": eval_batches, "launches_train": trained, "launches": launches,
            "rounds_per_s": len(rounds) / train_s, "real_tokens_per_s": tokens / train_s,
            "step_profile": arms["profiles"]["captured"], "capture": arms}


def phase_train_lm_step(smi: str, steps: int = 5):
    """Path (B): the one-card LM train step (make_sp_lm_train_step on a 1x1
    mesh) of ``transformer_nwp`` at its widths (vocab 10004, dim 256, 8
    heads, 4 layers), T = 8192, batch 2, bf16, remat, attn_impl="pallas",
    SGD lr 0.1, ``steps`` steps on one fixed batch cut from a synthetic
    token stream. Checks 8 K6 and 1 K5 per step and a falling loss, then
    profiles one more step."""
    import torch
    from torch.autograd import DeviceType

    from fedml_tpu_torch.data.shakespeare import _synthetic_nwp
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import attention as att
    from fedml_tpu_torch.ops import xent as xe
    from fedml_tpu_torch.parallel.local import make_optimizer
    from fedml_tpu_torch.parallel.sequence import make_sp_lm_train_step, sp_mesh

    tag = "[lm step T=8192]"
    dev = torch.device("cuda")
    b, vocab = LM_BATCH, XENT_B[1]
    t0 = time.perf_counter()
    ds = _synthetic_nwp("lm-stream", 1, vocab, LM_SEQ, b, SEED)
    x = torch.from_numpy(ds.train_x[0, :b]).to(dev)
    y = torch.from_numpy(ds.train_y[0, :b]).to(dev)
    mask = torch.ones((b, LM_SEQ), dtype=torch.float32, device=dev)
    bundle = create_model("transformer_nwp", vocab, seq_len=LM_SEQ, attn_impl="pallas", remat=True,
                          dtype=torch.bfloat16)
    bundle.init(SEED, dev)
    module = bundle.module
    step = make_sp_lm_train_step(module, sp_mesh(1, 1), attn_impl="pallas")
    opt = make_optimizer("sgd", 0.1)(module.parameters())
    torch.cuda.synchronize()
    log(f"{tag} set-up {time.perf_counter() - t0:.1f} s; batch {tuple(x.shape)}")
    att.reset_launches()
    xe.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(steps):
        t1 = time.perf_counter()
        losses.append(float(step(opt, x, y, mask)))
        secs.append(time.perf_counter() - t1)
    launches = {**att.LAUNCHES, **xe.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    tokens = b * LM_SEQ
    steady = secs[1:] or secs
    ms = float(np.mean(steady)) * 1e3
    log(f"{tag} losses {[round(v, 4) for v in losses]}; ms/step {[round(s * 1e3, 1) for s in secs]}"
        f" (mean of steps 2-{steps}: {ms:.1f}); {tokens / ms * 1e3:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}; {smi}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag} loss must be finite and fall: {losses}")
    want = {"attention": LM_K6_PER_STEP * steps, "xent": steps}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}; expected {want}")
    _, events = profiled(lambda: step(opt, x, y, mask), f"{tag} step")
    by_family, n = {}, 0
    for e in events:
        if e.device_type == DeviceType.CUDA:
            n += 1
            fam = kernel_family(e.name)
            by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3
    total = sum(by_family.values())
    log(f"{tag} profiled step: device {total:.2f} ms (busy share {total / ms:.3f} of the "
        f"unprofiled step), {n} GPU activities; device ms by family "
        + ", ".join(f"{k} {v:.2f}" for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])))
    return {"losses": losses, "seconds": secs, "ms_per_step": ms, "tokens_per_s": tokens / ms * 1e3,
            "peak_memory_bytes": peak, "launches": launches, "device_ms_per_step": total,
            "device_busy_share": total / ms, "gpu_activities_per_step": n,
            "device_ms_per_step_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1]))}


def sm_clock() -> float:
    """The card's maximum SM clock in MHz (``nvidia-smi clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 2
    if not (ROOT / "fedml_tpu_torch" / "ops" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (fedml_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    sm_clock_mhz = sm_clock()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}; max SM clock {sm_clock_mhz:.0f} MHz")

    seconds = {}

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {seconds[name]:.1f} s")
        return out

    build_info = timed("build", phase_build)
    err, cases, model_err = timed("check", phase_check)
    timing = timed("time", phase_time)
    timing_packed = timed("time_packed", phase_time, PACKED_BNS, "packed")
    train = timed("train", phase_train, smi)
    train_packed = timed("train_packed", phase_train_packed, smi)
    zoo = timed("train_zoo", phase_train_zoo, smi)
    crosssilo = timed("train_crosssilo", phase_train_crosssilo, smi)
    conv_err, conv_cases, lanes_model_err = timed("check_conv", phase_check_conv)
    conv_timing = timed("time_conv", phase_time_conv)
    probe, probe_launches = timed("probe", phase_probe)
    train_lanes = timed("train_lanes", phase_train, smi, bn_impl="xla", conv_impl="lanes")
    lm_err, lm_cases, lm_model_err = timed("check_lm", phase_check_lm)
    lm_timing = timed("time_lm", phase_time_lm, sm_clock_mhz)
    train_lm = timed("train_lm_fedavg", phase_train_lm_fedavg, smi)
    lm_step = timed("train_lm_step", phase_train_lm_step, smi)
    # phase 4e runs last: run after phase 4d, it left every later
    # torch.profiler window without its first 17 device records on the card
    # (more than the sentinels absorb; short runs of the same rounds did
    # not), and phase 4e profiles nothing
    crossdevice = timed("train_crossdevice", phase_train_crossdevice, smi)
    err.update(conv_err)
    err.update(lm_err)

    def per_step(rows, key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(v * r["calls_per_step"] for v, r in zip(vals, rows))

    def bn_step(rows, name):
        """One step's calls of a BN kernel at these shapes: per-step sums
        and the step's bound."""
        rows = [r for r in rows if r["kernel"] == name]
        bounds = [bn_bound(r["rows"], r["C"], 2, r["relu"], name == "bn_bwd") for r in rows]
        b_ms, b_by = bound_ms(sum(b[0] * r["calls_per_step"] for b, r in zip(bounds, rows)),
                              sum(b[1] * r["calls_per_step"] for b, r in zip(bounds, rows)))
        return rows, b_ms, b_by

    kernels = []
    for name, replaces in (("bn_fwd", "fedml_tpu/ops/batchnorm.py:36 (_fwd_kernel, pallas_call at :189)"),
                           ("bn_bwd", "fedml_tpu/ops/batchnorm.py:86 (_bwd_kernel, pallas_call at :245)"),
                           ("conv_fwd", "fedml_tpu/ops/conv_lanes.py:121 (_fwd_kernel, pallas_call at :163)"),
                           ("conv_wgrad", "fedml_tpu/ops/conv_lanes.py:130 (_wgrad_kernel, pallas_call at :185)")):
        extra = {}
        if name.startswith("bn"):
            rows, b_ms, b_by = bn_step(timing, name)
            source = "batchnorm.cu"
            # the BN path's 2 rounds, the packed flagship's, the zoo's, the
            # cross-silo arms' and the cross-device flagship arms' timed
            # rounds, each counted from 0 just before it
            by_path = {"fedavg_bn": train["launches"][name],
                       "fedavg_packed": train_packed["launches"][name],
                       "zoo": zoo["launches"][name],
                       "crosssilo": crosssilo["launches"][name],
                       "crossdevice": crossdevice["launches"][name]}
            launches = sum(by_path.values())
            prows, pb_ms, pb_by = bn_step(timing_packed, name)
            extra = {"launches_by_path": by_path, "packed": {
                # one packed step's 57 calls at the folded shapes [rows, 2*C]
                "ms": per_step(prows, "ms"), "device_ms": per_step(prows, "device_ms"),
                "plain_ms": per_step(prows, "plain_ms"),
                "library_ms": per_step(prows, "library_ms"),
                "library_device_ms": per_step(prows, "library_device_ms"),
                "bound_ms": pb_ms, "bound_by": pb_by,
                "per_call": [{k: v for k, v in r.items() if k != "kernel"} for r in prows]}}
        else:
            rows = [r for r in conv_timing if r["kernel"] == name]
            bounds = [conv_bound(name, r["n"], r["ci"], r["co"], r["h"] * r["w"]) for r in rows]
            source, launches = "conv_lanes.cu", train_lanes["launches"][name]
            b_ms, b_by = bound_ms(sum(b[0] * r["calls_per_step"] for b, r in zip(bounds, rows)),
                                  sum(b[1] * r["calls_per_step"] for b, r in zip(bounds, rows)),
                                  PEAK_BF16_FLOPS)
        kernels.append({
            "name": name, "route": "cuda", "source": f"fedml_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err[name],
            # one local step's calls at batch 64, bf16 (57 BNs; 72 K3, 36 K4)
            "ms": per_step(rows, "ms"), "plain_ms": per_step(rows, "plain_ms"), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": per_step(rows, "library_ms"),
            "device_ms": per_step(rows, "device_ms"),
            "plain_device_ms": per_step(rows, "plain_device_ms"),
            "library_device_ms": per_step(rows, "library_device_ms"),
            "per_call": [{k: v for k, v in r.items() if k != "kernel"} for r in rows],
            **extra,
        })
    # K7: one probe pass, a "patches" and a "copy" call at each probe shape;
    # no single library call computes that mix
    modes = [(r, m) for r in probe for m in ("patches", "copy")]
    devs = [r[f"{m}_device_ms"] for r, m in modes]
    kernels.append({
        "name": "conv_variant", "route": "cuda",
        "source": "fedml_tpu_torch/ops/csrc/conv_lanes.cu",
        "replaces": "tools/lanes_probe.py:107 (_variant_kernel, pallas_call at :136)",
        "launches": probe_launches["conv_variant"], "max_abs_err": err["conv_variant"],
        "ms": sum(r[m] for r, m in modes), "plain_ms": sum(r[f"{m}_plain_ms"] for r, m in modes),
        "bound_ms": sum(r[f"{m}_bound_ms"] for r, m in modes), "bound_by": "bytes",
        "library_ms": None, "device_ms": None if None in devs else sum(devs),
        "per_call": probe,
    })
    # K6 and K5: one path (B) step's calls at its shapes (8 K6, 1 K5);
    # K6's launches count both transformer paths, K5's path (B)'s
    k6_launches = {"fedavg_transformer": train_lm["launches"]["attention"],
                   "lm_step": lm_step["launches"]["attention"]}
    for rec, replaces, launches in (
            (lm_timing[0], "fedml_tpu/ops/attention.py:63 (_flash_kernel, pallas_call at :158)",
             sum(k6_launches.values())),
            (lm_timing[1], "fedml_tpu/ops/xent.py:31 (_xent_kernel, pallas_call at :81)",
             lm_step["launches"]["xent"])):
        name, calls = rec["kernel"], rec["calls_per_step"]

        def step_ms(key, rec=rec, calls=calls):
            return None if rec[key] is None else rec[key] * calls

        kernels.append({
            "name": name, "route": "cuda", "source": f"fedml_tpu_torch/ops/csrc/{name}.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err[name],
            "ms": step_ms("ms"), "plain_ms": step_ms("plain_ms"), "bound_ms": step_ms("bound_ms"),
            "bound_by": rec["bound_by"], "library_ms": step_ms("library_ms"),
            "device_ms": step_ms("device_ms"), "plain_device_ms": step_ms("plain_device_ms"),
            "library_device_ms": step_ms("library_device_ms"),
            # device time by CUDA events behind a primed queue (the profiler
            # misses device activity in some windows)
            "queued_ms": step_ms("queued_ms"), "plain_queued_ms": step_ms("plain_queued_ms"),
            "library_queued_ms": step_ms("library_queued_ms"),
            "per_call": {k: v for k, v in rec.items() if k != "kernel"},
            **({"launches_by_path": k6_launches} if name == "attention" else {}),
        })
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "sm_clock_max_mhz": sm_clock_mhz,
        "build": build_info,
        "phase_seconds": seconds,
        "check_cases": cases, "small_model_rel_err": model_err, "timing": timing,
        "timing_packed": timing_packed, "train": train, "train_packed": train_packed,
        "train_zoo": zoo, "train_crosssilo": crosssilo, "train_crossdevice": crossdevice,
        "conv_check_cases": conv_cases,
        "small_lanes_model_rel_err": lanes_model_err, "conv_timing": conv_timing,
        "probe": probe, "probe_launches": probe_launches, "train_lanes": train_lanes,
        "lm_check_cases": lm_cases, "small_lm_rel_err": lm_model_err, "lm_timing": lm_timing,
        "train_lm_fedavg": train_lm, "train_lm_step": lm_step,
        "profile_windows": PROFILE_TALLY, "kernels": kernels}, indent=1))
    log(f"[profile] {PROFILE_TALLY['windows']} profile windows; their sentinels lost "
        f"{PROFILE_TALLY['sentinel_records_lost']} device records (at most "
        f"{PROFILE_TALLY['most_sentinel_records_lost']} in one window); "
        f"{PROFILE_TALLY['profiled_again']} lost records of their work and were profiled "
        f"again; {smi}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
