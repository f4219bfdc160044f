#!/usr/bin/env python3
"""Where one client's local training goes on the GPU, for the PyTorch port's
flagship (ResNet-56, bf16, ``bn_impl="pallas"``, batch 64, lr 0.1,
momentum 0.9, the synthetic CIFAR-10-shaped non-IID data of chip_smoke.py).

    python3 tools/torch_step_profile.py [--client 0]

Trains one client once to warm up, then again under ``torch.profiler``, in
a window opened by ``chip_smoke.profiled`` (sentinel launches and idle
before the work, and profiled again if the work lost device records), and
reports: wall time per live step (host clock, ending in a sync, taken on
an unprofiled repeat), the device's busy share (device time over that
wall),
kernels launched per step, and device time by kernel family (the port's
BN kernels K1/K2, convolutions, the optimizer, everything else). Writes the
full record to ``results/torch_step_profile.json``. Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

BN_KERNELS = ("bn_fwd_onepass", "bn_bwd_onepass")


def family(name: str) -> str:
    low = name.lower()
    if any(f"::{k}" in name or name.startswith(k) for k in BN_KERNELS):
        return "bn kernels (K1/K2)"
    if "conv" in low or "xmma" in low or "cudnn" in low or "implicit" in low or "wgrad" in low \
            or "dgrad" in low or "gemm" in low or "nchw" in low or "nhwc" in low:
        return "convolution / gemm"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer (foreach)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other elementwise / reductions"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--client", type=int, default=0)
    args = p.parse_args()

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("torch_step_profile: needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import profiled
    from fedml_tpu_torch.algorithms.fedavg import FedAvgAPI
    from fedml_tpu_torch.core.config import FedConfig
    from fedml_tpu_torch.data.synthetic import make_synthetic_classification
    from fedml_tpu_torch.models import create_model

    ds = make_synthetic_classification(
        "cifar10-bench", (32, 32, 3), 10, 32, records_per_client=1562,
        partition_method="hetero", partition_alpha=0.5, batch_size=64, seed=0)
    cfg = FedConfig(model="resnet56", dataset="cifar10", client_num_in_total=32,
                    client_num_per_round=8, comm_round=1, batch_size=64, epochs=1, lr=0.1,
                    momentum=0.9, dtype="bfloat16", seed=0)
    bundle = create_model("resnet56", 10, input_shape=ds.train_x.shape[2:],
                          dtype=torch.bfloat16, bn_impl="pallas")
    api = FedAvgAPI(ds, cfg, bundle)
    tx, ty, tm = api._dev_train
    c = args.client
    count = int(ds.train_counts[c])
    steps = -(-count // cfg.batch_size)

    def run():
        res = api._local_train(api.variables, tx[c], ty[c], tm[c], count,
                               torch.Generator().manual_seed(1))
        float(res.train_loss)

    run()                                  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    prof, events = profiled(run, "torch_step_profile")
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_unprofiled_s = time.perf_counter() - t0

    intervals, by_family, n_kernels = [], defaultdict(float), 0
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        n_kernels += 1
        intervals.append((e.time_range.start, e.time_range.end))
        by_family[family(e.name)] += e.time_range.elapsed_us()
    intervals.sort()
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    span_us = (intervals[-1][1] - intervals[0][0]) if intervals else 0.0
    dev_total = sum(by_family.values())
    rec = {
        "device": torch.cuda.get_device_name(0), "client": c, "records": count,
        "live_steps": steps, "wall_s": wall_unprofiled_s,
        "ms_per_step": wall_unprofiled_s / steps * 1e3,
        "images_per_s": count / wall_unprofiled_s,
        "gpu_activities": n_kernels, "activities_per_step": n_kernels / steps,
        # device time over the unprofiled wall: the profiler slows the host,
        # so busy time over the profiled span understates the share
        "device_busy_share": dev_total / (wall_unprofiled_s * 1e6),
        "device_busy_share_profiled_span": busy_us / span_us if span_us else None,
        "device_ms_per_step": {k: v / 1e3 / steps for k, v in
                               sorted(by_family.items(), key=lambda kv: -kv[1])},
        "device_ms_per_step_total": dev_total / 1e3 / steps,
    }
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    (out / "torch_step_profile.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec, indent=1))
    top = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
    (out / "torch_step_profile_top.txt").write_text(top)
    print(top[:6000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
