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
         + [ROOT / "tests" / "torch_crosssilo_ranks.py", ROOT / "tests" / "torch_mesh_ranks.py"])


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
                "experiments/main_splitnn.py", "experiments/main_vfl.py",
                "models/mobilenet.py", "models/efficientnet.py", "models/vgg.py",
                "models/resnet_gn.py", "models/rnn.py", "ops/dropout.py",
                "data/stackoverflow.py", "data/imagenet.py", "parallel/collectives.py",
                "parallel/sequence.py", "parallel/tensor.py", "parallel/pipeline.py",
                "parallel/dataparallel.py", "models/moe.py", "comm/__init__.py",
                "comm/message.py", "comm/base.py", "comm/local.py", "comm/managers.py",
                "comm/grpc_backend.py", "comm/mqtt_broker.py", "comm/mqtt_client.py",
                "comm/mqtt_backend.py", "core/compression.py", "core/streaming.py",
                "distributed/base_framework.py", "distributed/fedavg_edge.py",
                "experiments/launch_edge.py", "experiments/main_fedavg_edge.py",
                "comm/reliable.py", "comm/chaos.py", "algorithms/fedbuff.py",
                "distributed/fedbuff_edge.py", "distributed/decentralized_framework.py",
                "distributed/vfl_edge.py", "distributed/split_nn_edge.py",
                "distributed/turboaggregate_edge.py", "distributed/fedgkt_edge.py"):
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
        "import fedml_tpu_torch.parallel.pipeline, fedml_tpu_torch.parallel.tensor\n"
        "import fedml_tpu_torch.parallel.dataparallel, fedml_tpu_torch.models.moe\n"
        "import fedml_tpu_torch.distributed.fedavg_edge, fedml_tpu_torch.comm.mqtt_backend\n"
        "import fedml_tpu_torch.experiments.launch_edge\n"
        "fedml_tpu_torch.data.vertical.load_vertical('lending_club', 'no-such-dir')\n"
        "known_datasets(); load_dataset('synthetic_1_1', num_clients=3)\n"
        "load_dataset('pascal_voc', num_clients=2)\n"
        "load_dataset('stackoverflow_nwp', client_num_in_total=2)\n"
        "load_dataset('gld23k', num_clients=2); load_dataset('imagenet', num_clients=2)\n"
        "from fedml_tpu_torch.models import known_models, create_model\n"
        "[create_model(n, 10) for n in known_models()]\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    out = subprocess.run([sys.executable, "-m", "fedml_tpu_torch.experiments.run", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--resume_from" in out.stdout, out.stderr[-2000:]


def test_chip_smoke_binds_each_top_level_name_once():
    """A later phase's helper or constant that reuses an earlier phase's
    name silently replaces it, and the earlier phase then fails only on the
    card, minutes into a run."""
    import collections

    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = collections.Counter()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names[node.name] += 1
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    assert not [n for n, c in names.items() if c > 1], names.most_common(3)
