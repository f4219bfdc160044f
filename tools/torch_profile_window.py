#!/usr/bin/env python3
"""How often a torch.profiler window loses device records, plain and as
chip_smoke.py opens it, on the PyTorch port's flagship step (ResNet-56,
bf16, K1/K2, batch 64, client adam: phase 4c's plain arm).

    python3 tools/torch_profile_window.py [--windows 60]

Builds the kernels, trains the first client a few steps through the
captured and the eager trainer, then profiles ``--windows`` single turns of
each step loop (the gathers into the static inputs, the step) in plain
windows and in chip_smoke.py's (``chip_smoke.profile_window``: short spins
that no count includes, then idle, then the work), with no second try. For each of the four kinds it prints the
windows that lost records of the step (kernel or graph launches with no
device record of their correlation id, ``chip_smoke.lost_device_records``),
the records lost, the windows whose K1 or K2 count by name is not 57, and
the windows whose sentinels lost records, beside the card's name and
power limit.
Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--windows", type=int, default=60)
    args = p.parse_args()

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("torch_profile_window: needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.phase_build()
    api = cs.flagship_api(client_optimizer="adam", lr=1e-3, comm_round=1)
    eager = cs.eager_trainer(api)
    for trainer in (None, eager):
        run, _ = cs.client_run(api, trainer=trainer, steps=3)
        float(run().train_loss)
    progs = {"eager": cs.trainer_programs(eager)[0], "captured": cs.step_programs(api)[0]}

    out = {"device": smi, "torch": torch.__version__, "windows": args.windows, "kinds": {}}
    for arm, prog in progs.items():
        src = [t.clone() for t in prog.inputs]
        idx = torch.arange(src[0].shape[0], device=src[0].device)

        def turn():
            for a, b in zip(src, prog.inputs):
                torch.index_select(a, 0, idx, out=b)
            prog()

        # a plain window, and chip_smoke.py's
        for sentinels in (0, cs.SENTINELS):
            pad_s = cs.PROFILE_PAD_S if sentinels else 0.0
            lost_windows, lost_records, off_count, sentinel_lost = 0, [], 0, 0
            for _ in range(args.windows):
                _, events, lost_sentinels = cs.profile_window(turn, sentinels, pad_s)
                sentinel_lost += lost_sentinels > 0
                lost = cs.lost_device_records(events)
                lost_windows += lost > 0
                if lost:
                    lost_records.append(lost)
                named = [sum(k in e.name for e in events if e.device_type == DeviceType.CUDA)
                         for k in cs.NAMED_KERNELS]
                off_count += any(n != cs.BNS_PER_STEP for n in named)
            kind = f"{arm}, {'as chip_smoke.py opens it' if sentinels else 'plain'}"
            out["kinds"][kind] = {"windows_that_lost": lost_windows, "records_lost": lost_records,
                                  "windows_with_k1_or_k2_not_57": off_count,
                                  "windows_whose_sentinels_lost": sentinel_lost}
            print(f"{kind}: {lost_windows} of {args.windows} windows lost records of the step "
                  f"{lost_records}; {off_count} read K1 or K2 other than {cs.BNS_PER_STEP}; "
                  f"sentinels lost records in {sentinel_lost}; {smi}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
