"""K3/K4 triage across checkouts: the device ms of K3 and K4 a lanes step
(``chip_smoke.phase_time_conv``) at each tree given, each timed by its own
``chip_smoke.py`` and by this checkout's, one process a tree. Needs a card:

    python3 tests/torch_conv_triage.py TREE [TREE ...]

where each TREE is a directory holding a checkout of the repository (for
example ``git archive <commit> | tar -x -C .proof/<name>``). Prints one
record a tree, and all of them as JSON on the last line.
"""

import json
import subprocess
import sys
from pathlib import Path


def conv_triage(trees: list) -> list:
    """K3/K4 device ms a lanes step at each tree (a directory holding a
    checkout of this repository): each tree's own ``phase_time_conv`` on its
    own kernels, and this checkout's ``phase_time_conv`` on them, one process
    a tree, in the order given. Returns the per-tree records."""
    out = []
    here = str(Path(__file__).resolve().parents[1] / "chip_smoke.py")
    code = (
        "import importlib.util, json, sys, torch\n"
        "torch.backends.cudnn.allow_tf32 = False\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke as own\n"
        "spec = importlib.util.spec_from_file_location('head_smoke', sys.argv[1])\n"
        "head = importlib.util.module_from_spec(spec); spec.loader.exec_module(head)\n"
        "own.phase_build()\n"
        "rec = {}\n"
        "for name, mod in (('own', own), ('head', head)):\n"
        "    rows = mod.phase_time_conv()\n"
        "    rec[name] = {k: sum(r['calls_per_step'] * (r.get('device_ms') or 0.0) for r in rows\n"
        "                        if r['kernel'] == k) for k in ('conv_fwd', 'conv_wgrad')}\n"
        "    rec[name + '_events'] = {k: sum(r['calls_per_step'] * r['ms'] for r in rows\n"
        "                                   if r['kernel'] == k) for k in ('conv_fwd', 'conv_wgrad')}\n"
        "print('TRIAGE ' + json.dumps(rec))\n")
    for tree in trees:
        res = subprocess.run([sys.executable, "-c", code, here], cwd=tree, capture_output=True,
                             text=True, timeout=900)
        line = [s for s in res.stdout.splitlines() if s.startswith("TRIAGE ")]
        if res.returncode or not line:
            raise RuntimeError(f"[conv triage] {tree} failed ({res.returncode}): "
                               f"{res.stderr[-3000:]}")
        rec = {"tree": tree, **json.loads(line[0][len("TRIAGE "):])}
        out.append(rec)
        print(f"[conv triage] {rec}", flush=True)
    return out


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    print(json.dumps(conv_triage(sys.argv[1:])))
