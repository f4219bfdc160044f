#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and hold every kernel
on that path against its plain PyTorch version.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure raises and the script exits non-zero):

1. Build every CUDA kernel from ``fedml_tpu_torch/ops/csrc`` with nvcc.
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

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores — the work of K1/K2 is elementwise f32.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

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


def device_ms(fn, iters: int = 20):
    """Device time per call: the summed durations of every GPU kernel and
    copy the profiler traces over ``iters`` calls (no host time). None when
    the profiler records no device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    return total_us / 1e3 / iters if total_us > 0 else None


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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


def phase_train(smi: str):
    import torch

    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import batchnorm as bn

    t0 = time.perf_counter()
    ds = make_synthetic_classification(
        "cifar10-bench", (32, 32, 3), 10, 32, records_per_client=1562,
        partition_method="hetero", partition_alpha=0.5, batch_size=64, seed=SEED)
    cfg = FedConfig(model="resnet56", dataset="cifar10", client_num_in_total=32,
                    client_num_per_round=8, comm_round=2, batch_size=64, epochs=1, lr=0.1,
                    momentum=0.9, dtype="bfloat16", frequency_of_the_test=10_000, seed=SEED,
                    async_rounds=True)
    bundle = create_model("resnet56", 10, input_shape=ds.train_x.shape[2:],
                          dtype=torch.bfloat16, bn_impl="pallas")
    api = FedAvgAPI(ds, cfg, bundle)
    torch.cuda.synchronize()
    log(f"[train] set-up (data {ds.train_x.shape}, model, placement) {time.perf_counter() - t0:.1f} s")

    steps = sum(api.round_counts(r)[1] // cfg.batch_size for r in range(cfg.comm_round))
    bn.reset_launches()
    rounds = []
    for r in range(cfg.comm_round):
        t = time.perf_counter()
        loss = float(api.run_round(r))        # one sync per round
        dt = time.perf_counter() - t
        real, executed = api.round_counts(r)
        rounds.append({"round": r, "loss": loss, "seconds": dt, "real_images": real,
                       "executed_images": executed, "real_images_per_s": real / dt})
        log(f"[train] round {r}: loss {loss:.4f}, {dt:.2f} s, {real} real images "
            f"({executed} executed), {real / dt:.1f} real images/s")
        if not np.isfinite(loss):
            raise AssertionError(f"round {r} loss is not finite: {loss}")
    t = time.perf_counter()
    metrics = api.evaluate_global()
    eval_s = time.perf_counter() - t
    launches = dict(bn.LAUNCHES)
    log(f"[train] evaluate_global: {metrics} in {eval_s:.2f} s; launches {launches}")
    train_s = sum(r["seconds"] for r in rounds)
    log(f"[train] {len(rounds)} rounds in {train_s:.2f} s: {len(rounds) / train_s:.4f} rounds/s, "
        f"{sum(r['real_images'] for r in rounds) / train_s:.1f} real images/s; {smi}")
    if not (np.isfinite(metrics["loss"]) and 0.0 <= metrics["acc"] <= 1.0):
        raise AssertionError(f"evaluate_global gave {metrics}")
    want = BNS_PER_STEP * steps
    for k in ("bn_fwd", "bn_bwd"):
        if launches[k] != want:
            raise AssertionError(f"{k} launched {launches[k]} times on the main path; "
                                 f"expected {BNS_PER_STEP} x {steps} live steps = {want}")
    return {"rounds": rounds, "eval": metrics, "eval_s": eval_s, "steps": steps,
            "launches": launches, "rounds_per_s": len(rounds) / train_s}


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

    build_info = phase_build()
    err, cases, model_err = phase_check()
    timing = phase_time()
    train = phase_train(smi)

    kernels = []
    for name, replaces in (("bn_fwd", "fedml_tpu/ops/batchnorm.py:36 (_fwd_kernel, pallas_call at :189)"),
                           ("bn_bwd", "fedml_tpu/ops/batchnorm.py:86 (_bwd_kernel, pallas_call at :245)")):
        rows = [r for r in timing if r["kernel"] == name]

        def per_step(key):
            vals = [r[key] for r in rows]
            return None if None in vals else sum(v * r["calls_per_step"] for v, r in zip(vals, rows))

        bounds = [bn_bound(r["rows"], r["C"], 2, r["relu"], name == "bn_bwd") for r in rows]
        b_ms, b_by = bound_ms(sum(b[0] * r["calls_per_step"] for b, r in zip(bounds, rows)),
                              sum(b[1] * r["calls_per_step"] for b, r in zip(bounds, rows)))
        kernels.append({
            "name": name, "route": "cuda", "source": "fedml_tpu_torch/ops/csrc/batchnorm.cu",
            "replaces": replaces, "launches": train["launches"][name],
            "max_abs_err": err[name],
            # one local step's 57 BN calls at batch 64, bf16
            "ms": per_step("ms"), "plain_ms": per_step("plain_ms"), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": per_step("library_ms"),
            "device_ms": per_step("device_ms"), "plain_device_ms": per_step("plain_device_ms"),
            "library_device_ms": per_step("library_device_ms"),
            "per_call": [{k: v for k, v in r.items() if k != "kernel"} for r in rows],
        })
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "build": build_info,
        "check_cases": cases, "small_model_rel_err": model_err, "timing": timing,
        "train": train, "kernels": kernels}, indent=1))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
