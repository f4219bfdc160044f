"""The port stands alone: no module of ``fedml_tpu_torch``, nor
``chip_smoke.py``, the port's tools (``tools/torch_*.py``) or the rank
that ``tests/test_torch_crosssilo.py`` spawns, imports JAX, flax, optax or
the JAX package, and the package's modules import without a GPU, nvcc or
triton. The launcher, the dataset registry with every loader, the
checkpoint and metrics modules load no JAX module at run time either."""

import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "fedml_tpu")
FILES = (sorted((ROOT / "fedml_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "tools").glob("torch_*.py"))
         + [ROOT / "tests" / "torch_crosssilo_ranks.py"])


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_on_a_cpu_only_host():
    for path in sorted((ROOT / "fedml_tpu_torch").rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        importlib.import_module(".".join(parts))


def test_new_modules_are_covered():
    rels = {str(p.relative_to(ROOT)) for p in FILES}
    for mod in ("experiments/__init__.py", "experiments/run.py", "experiments/main_fedavg.py",
                "core/serialization.py", "utils/checkpoint.py", "data/cifar.py",
                "data/mnist.py", "data/femnist.py", "models/cnn.py",
                "algorithms/centralized.py", "algorithms/robust.py",
                "algorithms/hierarchical.py", "algorithms/silo.py", "data/edge_cases.py",
                "experiments/main_fedavg_robust.py", "experiments/main_hierarchical.py",
                "distributed/topology.py", "algorithms/decentralized.py", "parallel/gossip.py",
                "algorithms/turboaggregate.py", "algorithms/streaming_fedavg.py",
                "native/__init__.py", "native/build.py", "experiments/main_decentralized.py",
                "experiments/main_streaming_fedavg.py", "experiments/main_turboaggregate.py",
                "models/gkt.py", "models/segmentation.py", "algorithms/fedgkt.py",
                "algorithms/fedseg.py", "data/segmentation.py", "experiments/main_fedgkt.py",
                "experiments/main_fedseg.py", "experiments/main_crosssilo_fedseg.py",
                "models/darts.py", "algorithms/fednas.py", "models/split.py",
                "algorithms/split_nn.py", "data/vertical.py", "algorithms/vfl.py",
                "experiments/main_fednas.py", "experiments/main_crosssilo_fednas.py",
                "experiments/main_splitnn.py", "experiments/main_vfl.py"):
        assert f"fedml_tpu_torch/{mod}" in rels, mod


def test_the_launcher_loads_no_jax_at_run_time():
    code = (
        "import sys\n"
        "from fedml_tpu_torch.experiments import run\n"
        "from fedml_tpu_torch.data import known_datasets, load_dataset\n"
        "import fedml_tpu_torch.utils.checkpoint, fedml_tpu_torch.algorithms.centralized\n"
        "import fedml_tpu_torch.algorithms.silo, fedml_tpu_torch.algorithms.robust\n"
        "import fedml_tpu_torch.algorithms.hierarchical, fedml_tpu_torch.data.edge_cases\n"
        "import fedml_tpu_torch.algorithms.decentralized, fedml_tpu_torch.native\n"
        "import fedml_tpu_torch.algorithms.streaming_fedavg\n"
        "import fedml_tpu_torch.algorithms.turboaggregate\n"
        "import fedml_tpu_torch.algorithms.fedgkt, fedml_tpu_torch.algorithms.fedseg\n"
        "import fedml_tpu_torch.algorithms.fednas, fedml_tpu_torch.algorithms.split_nn\n"
        "import fedml_tpu_torch.algorithms.vfl, fedml_tpu_torch.data.vertical\n"
        "fedml_tpu_torch.data.vertical.load_vertical('lending_club', 'no-such-dir')\n"
        "known_datasets(); load_dataset('synthetic_1_1', num_clients=3)\n"
        "load_dataset('pascal_voc', num_clients=2)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    out = subprocess.run([sys.executable, "-m", "fedml_tpu_torch.experiments.run", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--resume_from" in out.stdout, out.stderr[-2000:]
