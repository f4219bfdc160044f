#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every kernel
on that path against its plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure raises and the script exits non-zero):

1. Build every CUDA kernel from ``fedml_tpu_torch/ops/csrc`` with nvcc, one
   process per source, all started together.
2. Hold K1 (BN forward) and K2 (BN backward) against their plain versions
   on the card: ResNet-56's BN shapes at batch 64 plus a ragged row count,
   f32 and bf16, ReLU on and off; then a small CifarResNet forward and
   backward through the kernels against the same model on the CPU.
3. Time each kernel at the main path's shapes with CUDA events, beside its
   plain version, ``F.batch_norm`` (+ReLU) as a library yardstick, and its
   byte/operation bound.
4. Train 2 rounds of FedAvg (ResNet-56, ``bn_impl="pallas"``, bf16, 32
   non-IID synthetic CIFAR-10-shaped clients, 8 per round, batch 64, lr 0.1,
   momentum 0.9), evaluate, and check the loss and the kernel launch counts.
5. Hold K3 (lanes 3x3 conv, also the dgrad), K4 (its wgrad) and K7 (K3's
   probe variants) against their plain versions at the lanes path's conv
   shapes at batch 64 and four ragged shapes, f32 and bf16; then a small
   lanes CifarResNet on the card against the same model on the CPU.
6. Time K3 and K4 at those shapes in bf16 beside their plain versions,
   ``F.conv2d`` / ``torch.nn.grad.conv2d_weight`` and their bounds.
7. The K7 probe (the counterpart of ``tools/lanes_probe.py``): per-call
   times of the library conv, K3, its patch build, one copy, K4, forward +
   dgrad and forward + wgrad at the probe shapes.
8. Train the same 2 rounds with ``conv_impl="lanes", bn_impl="xla"`` and
   check the loss and the launch counts (72 K3 and 36 K4 per live step, 36
   K3 per eval batch, no BN kernel).

Phases 4 and 8 end with a profile of 5 local steps of one client (wall and
device ms per step, device busy share, device time by kernel family).

The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``. A fuller record goes to
``results/chip_smoke.json``. f32 comparisons run with TF32 off.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

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

# ResNet-56 train-mode BNs per local step at batch 64, by (rows, C, relu):
# stage 1 (32x32x16): stem + 9 first-of-block BNs with ReLU, 9 without;
# stages 2 and 3: 9 with ReLU, 9 second-of-block + 1 projection without.
MAIN_PATH_BNS = {
    (65536, 16, True): 10, (65536, 16, False): 9,
    (16384, 32, True): 9, (16384, 32, False): 10,
    (4096, 64, True): 9, (4096, 64, False): 10,
}
BNS_PER_STEP = sum(MAIN_PATH_BNS.values())      # 57
CHECK_SHAPES = [(65536, 16), (16384, 32), (4096, 64), (12347, 24)]   # last: ragged

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
# rows wider than a block's 256 threads
CONV_RAGGED = [(3, 12, 20, 10, 14), (3, 20, 12, 10, 14), (3, 20, 12, 37, 13), (1, 8, 8, 3, 300)]
PROBE_SHAPES = [(16, 16, 32, 32), (32, 32, 16, 16)]
EVAL_BATCH = 256      # make_eval_fn's default batch

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


def device_ms(fn, iters: int = 20, attempts: int = 3):
    """Device time per call: the summed durations of every GPU kernel and
    copy the profiler traces over ``iters`` calls (no host time). The
    profiler now and then records no device activity for a window; such a
    window is profiled again, and after ``attempts`` empty ones the result
    is None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / 1e3 / iters
    return None


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
    for n, C in CHECK_SHAPES:
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
                y_k, m_k, r_k, v_k = bn.bn_fwd_cuda(x, g, b, EPS, relu)
                y_p, m_p, r_p, v_p = bn.bn_relu_fwd_plain(x, g, b, EPS, relu)
                e_y = assert_close(f"K1 y {tag}", y_k, y_p, *tol["y"])
                assert_close(f"K1 mean {tag}", m_k, m_p, *tol["stat"])
                assert_close(f"K1 var {tag}", v_k, v_p, *tol["stat"])
                assert_close(f"K1 rstd {tag}", r_k, r_p, *tol["stat"])
                if y_k.dtype != x.dtype:
                    raise AssertionError(f"K1 y dtype {y_k.dtype} != {x.dtype}")
                # K2 on the plain forward's outputs, so only the backward differs
                dx_k, dg_k, db_k = bn.bn_bwd_cuda(x, y_p, dy, g, m_p, r_p, relu)
                dx_p, dg_p, db_p = bn.bn_relu_bwd_plain(x, y_p, dy, g, m_p, r_p, relu)
                e_dx = assert_close(f"K2 dx {tag}", dx_k, dx_p, *tol["dx"])
                e_dg = assert_close(f"K2 dgamma {tag}", dg_k, dg_p, *tol["dgb"])
                e_db = assert_close(f"K2 dbeta {tag}", db_k, db_p, *tol["dgb"])
                err["bn_fwd"] = max(err["bn_fwd"], e_y)
                err["bn_bwd"] = max(err["bn_bwd"], e_dx)
                cases.append({"case": tag, "y": e_y, "dx": e_dx, "dgamma": e_dg, "dbeta": e_db})
                log(f"[check] {tag}: max|err| y {e_y:.3g}, dx {e_dx:.3g}, "
                    f"dgamma {e_dg:.3g}, dbeta {e_db:.3g}")
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
    return err, cases, worst


def phase_time():
    """Per-call times at the main path's BN shapes in bf16, and the per-step
    totals over ResNet-56's 57 BNs."""
    import torch
    import torch.nn.functional as F

    from fedml_tpu_torch.ops import batchnorm as bn

    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    rows = []
    for (n, C, relu), count in MAIN_PATH_BNS.items():
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
    shapes = [(CONV_BATCH, *s) for s in CONV_CALLS] + CONV_RAGGED
    for n, ci, co, h, w in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            tag = f"[{n}x{ci}->{co} @{h}x{w} {dname}]"
            x, w2, dy = _conv_inputs(rng, n, ci, co, h, w, dtype, dev)
            e_y = assert_close(f"K3 {tag}", cl.conv_fwd_cuda(x, w2, h, w),
                               cl.conv_fwd_plain(x, w2, h, w), *CONV_TOL[dname])
            dw_p = cl.conv_wgrad_plain(x, dy, h, w)
            scale = float(dw_p.abs().max())
            e_w = assert_close(f"K4 {tag}", cl.conv_wgrad_cuda(x, dy, h, w), dw_p,
                               WGRAD_RTOL, WGRAD_RTOL * scale)
            rec = {"case": tag, "conv_fwd": e_y, "conv_wgrad": e_w, "dw2_max": scale}
            for mode in cl.VARIANT_MODES:
                if mode == "copy" and co > ci:
                    continue
                got = cl.conv_variant_cuda(mode, x, w2, h, w)
                want = cl.conv_variant_plain(mode, x, w2, h, w)
                if mode == "kernel":
                    rec[f"conv_variant_{mode}"] = assert_close(
                        f"K7 {mode} {tag}", got, want, *CONV_TOL[dname])
                elif not torch.equal(got, want):
                    raise AssertionError(f"K7 {mode} {tag} is not bit-exact")
                else:
                    rec[f"conv_variant_{mode}"] = 0.0
                err["conv_variant"] = max(err["conv_variant"], rec[f"conv_variant_{mode}"])
            err["conv_fwd"] = max(err["conv_fwd"], e_y)
            err["conv_wgrad"] = max(err["conv_wgrad"], e_w)
            cases.append(rec)
            log(f"[check] {tag}: max|err| K3 {e_y:.3g}, K4 {e_w:.3g} (max|dW2| {scale:.3g}), "
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
        for mode in ("patches", "copy"):
            rec[f"{mode}_device_ms"] = device_ms(fns[mode])
            rec[f"{mode}_plain_ms"] = cuda_time_ms(
                lambda m=mode: cl.conv_variant_plain(m, x, w2, h, w))
            nbytes, flops = conv_bound(mode, n, ci, co, h * w)
            rec[f"{mode}_bound_ms"], _ = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
        rec.update(n=n, ci=ci, co=co, h=h, w=w)
        rows.append(rec)
        log(f"[probe] c{ci}-{co}@{h}x{w} bf16 batch {n}, us/call: " + ", ".join(
            f"{k} {rec[k] * 1e3:.1f}" for k in fns))
    torch.cuda.synchronize()
    launches = dict(cl.LAUNCHES)
    if launches["conv_variant"] == 0:
        raise AssertionError("the probe launched no K7")
    return rows, launches


def kernel_family(name: str) -> str:
    low = name.lower()
    if "conv_fwd_kernel" in name or "conv_wgrad_" in name:
        return "lanes conv kernels (K3/K4)"
    if any(f"::{k}" in name or name.startswith(k) for k in
           ("fwd_partials", "fwd_finalize", "fwd_normalize", "bwd_partials", "bwd_finalize",
            "bwd_dx")):
        return "bn kernels (K1/K2)"
    if any(k in low for k in ("conv", "xmma", "cudnn", "implicit", "wgrad", "dgrad", "gemm",
                              "nchw", "nhwc")):
        return "library convolution / gemm"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer (foreach)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other elementwise / reductions"


def step_profile(api, client: int = 0, steps: int = 5) -> dict:
    """The first ``steps`` live steps of one client's local training (its
    first ``steps`` batches of real records), as tools/torch_step_profile.py
    profiles a whole client: wall ms per step (unprofiled, ending in a
    sync), device ms per step by kernel family under torch.profiler, and
    the busy share = device time over the unprofiled wall. Few steps keep
    the profiler's post-processing (~3,300 events a step) short."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tx, ty, tm = api._dev_train
    count = min(int(api.dataset.train_counts[client]), steps * api.config.batch_size)
    steps = -(-count // api.config.batch_size)

    def run():   # the rounds before it have warmed the path up
        res = api._local_train(api.variables, tx[client], ty[client], tm[client], count,
                               torch.Generator().manual_seed(1))
        float(res.train_loss)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by_family, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n += 1
            fam = kernel_family(e.name)
            by_family[fam] = by_family.get(fam, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    total = sum(by_family.values())
    # the host-side operators that launched the most device time
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:12]
    return {"client": client, "live_steps": steps, "wall_ms_per_step": wall_s / steps * 1e3,
            "device_ms_per_step": total, "device_busy_share": total * steps / (wall_s * 1e3),
            "gpu_activities_per_step": n / steps,
            "device_ms_per_step_by_family": dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
            "top_ops": [{"name": e.key, "device_ms_per_step": e.self_device_time_total / 1e3 / steps,
                         "calls_per_step": e.count / steps} for e in top]}


def phase_train(smi: str, bn_impl: str = "pallas", conv_impl: str = "xla"):
    """2 FedAvg rounds of the flagship in one configuration; checks the
    kernels' launch counts over the rounds and over evaluate_global."""
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import batchnorm as bn
    from fedml_tpu_torch.ops import conv_lanes as cl

    tag = f"[train {conv_impl}/{bn_impl}]"

    t0 = time.perf_counter()
    ds = make_synthetic_classification(
        "cifar10-bench", (32, 32, 3), 10, 32, records_per_client=1562,
        partition_method="hetero", partition_alpha=0.5, batch_size=64, seed=SEED)
    cfg = FedConfig(model="resnet56", dataset="cifar10", client_num_in_total=32,
                    client_num_per_round=8, comm_round=2, batch_size=64, epochs=1, lr=0.1,
                    momentum=0.9, dtype="bfloat16", frequency_of_the_test=10_000, seed=SEED,
                    async_rounds=True)
    bundle = create_model("resnet56", 10, input_shape=ds.train_x.shape[2:],
                          dtype=torch.bfloat16, bn_impl=bn_impl, conv_impl=conv_impl)
    api = FedAvgAPI(ds, cfg, bundle)
    torch.cuda.synchronize()
    log(f"{tag} set-up (data {ds.train_x.shape}, model, placement) {time.perf_counter() - t0:.1f} s")

    steps = sum(api.round_counts(r)[1] // cfg.batch_size for r in range(cfg.comm_round))
    bn.reset_launches()
    cl.reset_launches()
    rounds = []
    for r in range(cfg.comm_round):
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
    prof = step_profile(api)
    log(f"{tag} one client's local step: wall {prof['wall_ms_per_step']:.2f} ms, device "
        f"{prof['device_ms_per_step']:.3f} ms (busy share {prof['device_busy_share']:.3f}), "
        f"{prof['gpu_activities_per_step']:.0f} GPU activities; device ms by family "
        + ", ".join(f"{k} {v:.3f}" for k, v in prof["device_ms_per_step_by_family"].items()))
    return {"bn_impl": bn_impl, "conv_impl": conv_impl, "rounds": rounds, "eval": metrics,
            "step_profile": prof,
            "eval_s": eval_s, "steps": steps, "eval_batches": eval_batches,
            "launches_train": trained, "launches": launches,
            "rounds_per_s": len(rounds) / train_s,
            "real_images_per_s": sum(r["real_images"] for r in rounds) / train_s}


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
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {smi}")

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
    train = timed("train", phase_train, smi)
    conv_err, conv_cases, lanes_model_err = timed("check_conv", phase_check_conv)
    conv_timing = timed("time_conv", phase_time_conv)
    probe, probe_launches = timed("probe", phase_probe)
    train_lanes = timed("train_lanes", phase_train, smi, bn_impl="xla", conv_impl="lanes")
    err.update(conv_err)

    def per_step(rows, key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(v * r["calls_per_step"] for v, r in zip(vals, rows))

    kernels = []
    for name, replaces in (("bn_fwd", "fedml_tpu/ops/batchnorm.py:36 (_fwd_kernel, pallas_call at :189)"),
                           ("bn_bwd", "fedml_tpu/ops/batchnorm.py:86 (_bwd_kernel, pallas_call at :245)"),
                           ("conv_fwd", "fedml_tpu/ops/conv_lanes.py:121 (_fwd_kernel, pallas_call at :163)"),
                           ("conv_wgrad", "fedml_tpu/ops/conv_lanes.py:130 (_wgrad_kernel, pallas_call at :185)")):
        if name.startswith("bn"):
            rows = [r for r in timing if r["kernel"] == name]
            bounds = [bn_bound(r["rows"], r["C"], 2, r["relu"], name == "bn_bwd") for r in rows]
            peak, source, launches = PEAK_F32_FLOPS, "batchnorm.cu", train["launches"][name]
        else:
            rows = [r for r in conv_timing if r["kernel"] == name]
            bounds = [conv_bound(name, r["n"], r["ci"], r["co"], r["h"] * r["w"]) for r in rows]
            peak, source, launches = PEAK_BF16_FLOPS, "conv_lanes.cu", train_lanes["launches"][name]
        b_ms, b_by = bound_ms(sum(b[0] * r["calls_per_step"] for b, r in zip(bounds, rows)),
                              sum(b[1] * r["calls_per_step"] for b, r in zip(bounds, rows)), peak)
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
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "build": build_info,
        "phase_seconds": seconds,
        "check_cases": cases, "small_model_rel_err": model_err, "timing": timing,
        "train": train, "conv_check_cases": conv_cases,
        "small_lanes_model_rel_err": lanes_model_err, "conv_timing": conv_timing,
        "probe": probe, "probe_launches": probe_launches, "train_lanes": train_lanes,
        "kernels": kernels}, indent=1))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
