"""Unified experiment launcher (counterpart of ``fedml_tpu/experiments/run.py``).

    python -m fedml_tpu_torch.experiments.run --algorithm fedavg \
        --dataset synthetic_1_1 --model lr --comm_round 50

The flags are ``core/config.add_args``'s (the JAX package's), plus
``--algorithm``, ``--result_json`` (the full result dict, history lists
included) and ``--device`` (``cpu`` runs on the CPU; the GPU by default).
The last line printed is one JSON object: the algorithm and each history
series' final value. From Python, ``main(argv, device="cpu")`` runs on the
CPU.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Optional, Sequence, Union

import torch

from fedml_tpu_torch.core.config import add_args, config_from_args
from fedml_tpu_torch.experiments import ALGORITHMS, run_experiment


def main(argv: Optional[Sequence[str]] = None, default_algorithm: str = "fedavg",
         device: Optional[Union[str, torch.device]] = None) -> dict:
    parser = add_args()
    parser.add_argument("--algorithm", type=str, default=default_algorithm,
                        choices=sorted(ALGORITHMS))
    parser.add_argument("--result_json", type=str, default=None,
                        help="write the full result dict (history lists included) to this path")
    parser.add_argument("--device", type=str, default=None,
                        help="cpu runs on the CPU (default: the GPU)")
    ns = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(filename)s[line:%(lineno)d] %(levelname)s %(message)s")
    algorithm, result_json = ns.algorithm, ns.result_json
    device = device if device is not None else ns.device
    del ns.algorithm, ns.result_json, ns.device
    result = run_experiment(config_from_args(ns), algorithm, device=device)
    if result_json:
        with open(result_json, "w") as f:
            json.dump({"algorithm": algorithm, **dict(result)}, f)
    printable = {}
    for k, v in dict(result).items():
        if isinstance(v, list) and v and isinstance(v[-1], (int, float)):
            printable[k] = v[-1]          # a history series -> its final value
        elif isinstance(v, (int, float, str)):
            printable[k] = v
    print(json.dumps({"algorithm": algorithm, **printable}))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
