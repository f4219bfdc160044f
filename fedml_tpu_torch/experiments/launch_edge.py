"""Start a multi-process edge federation on this host (counterpart of
``fedml_tpu/experiments/launch_edge.py``; the reference's
run_fedavg_distributed_pytorch.sh:21-23, ``mpirun -np N python3
main_fedavg.py``).

One OS process per rank, rank 0 the server, each

    python -m fedml_tpu_torch.experiments.main_fedavg_edge \\
        --rank R --world_size N <the flags given here>

so the same per-rank entry point deploys across machines: run it on each
host with a shared ``--grpc_ipconfig_path`` csv (the reference's
grpc_ipconfig.csv). Every flag passes to every rank (``--device cpu`` too);
``--result_json`` goes to rank 0 alone, whose standard output is this
process's (the workers' is discarded).

    python -m fedml_tpu_torch.experiments.launch_edge --world_size 3 \\
        --dataset synthetic_1_1 --model lr --comm_round 5 --grpc_base_port 56980
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--world_size" not in argv:
        print("launch_edge: --world_size N is required", file=sys.stderr)
        return 2
    n = int(argv[argv.index("--world_size") + 1])
    if "--rank" in argv:
        print("launch_edge: do not pass --rank; it is assigned per process", file=sys.stderr)
        return 2
    result_json = []
    if "--result_json" in argv:
        i = argv.index("--result_json")
        result_json = argv[i:i + 2]
        del argv[i:i + 2]
    procs = []
    rcs = []
    try:
        for rank in range(n):
            cmd = [sys.executable, "-m", "fedml_tpu_torch.experiments.main_fedavg_edge",
                   "--rank", str(rank), *argv, *(result_json if rank == 0 else [])]
            procs.append(subprocess.Popen(cmd, stdout=None if rank == 0 else subprocess.DEVNULL,
                                          env=os.environ.copy()))
        rcs = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
                p.wait()
    bad = [(r, rc) for r, rc in enumerate(rcs) if rc != 0]
    if bad:
        print(f"launch_edge: ranks failed: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
