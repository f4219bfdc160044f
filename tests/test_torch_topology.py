"""The port's topologies against the JAX package's.

- ``SymmetricTopologyManager``: the port follows networkx's
  ``connected_watts_strogatz_graph`` without networkx; its mixing matrix is
  bit-equal to the JAX package's (built with networkx) at n in {1, 2, 3, 5,
  8, 16, 32}, seeds {0, 1, 7}, ``neighbor_num`` in {2, 4}; the graph alone
  equals networkx's at more shapes, the complete graph and the
  full-degree skip included.
- ``AsymmetricTopologyManager`` bit-equal; in/out neighbour lists and
  weights equal.
- The port's topology module imports no networkx (AST), and imports in a
  process where networkx cannot be imported.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import networkx as nx
import numpy as np
import pytest

from fedml_tpu.distributed.topology import AsymmetricTopologyManager as JaxAsymmetric
from fedml_tpu.distributed.topology import SymmetricTopologyManager as JaxSymmetric
from fedml_tpu_torch.distributed import topology
from fedml_tpu_torch.distributed.topology import (AsymmetricTopologyManager,
                                                  SymmetricTopologyManager,
                                                  connected_watts_strogatz, watts_strogatz)

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("neighbor_num", [2, 4])
@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16, 32])
def test_symmetric_matrix_is_bit_equal_to_jax(n, seed, neighbor_num):
    want = JaxSymmetric(n, neighbor_num=neighbor_num, seed=seed)
    want.generate_topology()
    got = SymmetricTopologyManager(n, neighbor_num=neighbor_num, seed=seed)
    got.generate_topology()
    assert got.topology.dtype == want.topology.dtype
    assert np.array_equal(got.topology, want.topology)
    assert np.array_equal(got.mixing_matrix, want.mixing_matrix)


def _edges(adj) -> set:
    return {(min(u, v), max(u, v)) for u, nbrs in enumerate(adj) for v in nbrs}


@pytest.mark.parametrize("n, k, p", [(4, 2, 0.3), (6, 5, 0.9), (10, 4, 1.0), (12, 6, 0.5),
                                     (9, 8, 0.7), (7, 7, 0.3), (40, 4, 0.3), (5, 3, 0.0)])
def test_watts_strogatz_graph_equals_networkx(n, k, p):
    """The graph of each draw (p = 1.0 and a near-complete k exercise the
    full-degree skip; k = n the complete graph), and the connected
    retries from one generator."""
    import random

    for seed in range(5):
        want = nx.watts_strogatz_graph(n, k, p, seed=seed)
        got = watts_strogatz(n, k, p, random.Random(seed))
        assert _edges(got) == {(min(u, v), max(u, v)) for u, v in want.edges()}
        if k < n:
            want = nx.connected_watts_strogatz_graph(n, k, p, seed=seed)
            got = connected_watts_strogatz(n, k, p, seed)
            assert _edges(got) == {(min(u, v), max(u, v)) for u, v in want.edges()}


def test_connected_gives_up_as_networkx_does():
    # seed 5's first draw of a fully rewired ring of 10 is not connected
    with pytest.raises(nx.NetworkXError):
        nx.connected_watts_strogatz_graph(10, 2, 1.0, tries=1, seed=5)
    with pytest.raises(RuntimeError, match="Maximum number of tries"):
        connected_watts_strogatz(10, 2, 1.0, 5, tries=1)


@pytest.mark.parametrize("args", [(8, 2, 2, 1), (8, 2, 1, 3), (5, 1, 3, 0), (16, 3, 2, 7)])
def test_asymmetric_matrix_is_bit_equal_to_jax(args):
    n, und, out, seed = args
    want = JaxAsymmetric(n, und, out, seed=seed)
    want.generate_topology()
    got = AsymmetricTopologyManager(n, und, out, seed=seed)
    got.generate_topology()
    assert np.array_equal(got.topology, want.topology)


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_neighbour_lists_and_weights_are_jax_s(kind):
    if kind == "symmetric":
        want, got = JaxSymmetric(8, 3, seed=1), SymmetricTopologyManager(8, 3, seed=1)
    else:
        want, got = JaxAsymmetric(8, 2, 2, seed=1), AsymmetricTopologyManager(8, 2, 2, seed=1)
    want.generate_topology()
    got.generate_topology()
    for i in range(8):
        assert got.get_in_neighbor_idx_list(i) == want.get_in_neighbor_idx_list(i)
        assert got.get_out_neighbor_idx_list(i) == want.get_out_neighbor_idx_list(i)
        assert i not in got.get_out_neighbor_idx_list(i)
        assert np.array_equal(got.get_in_neighbor_weights(i), want.get_in_neighbor_weights(i))
        assert np.array_equal(got.get_out_neighbor_weights(i), want.get_out_neighbor_weights(i))
    np.testing.assert_allclose(got.topology.sum(axis=1), np.ones(8), rtol=1e-12)
    if kind == "symmetric":
        assert np.array_equal(got.topology > 0, got.topology.T > 0)


def test_topology_imports_no_networkx():
    tree = ast.parse(Path(topology.__file__).read_text())
    roots = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert "networkx" not in roots
    # and it builds its graph where networkx cannot be imported at all
    code = ("import sys\n"
            "sys.modules['networkx'] = None\n"
            "from fedml_tpu_torch.distributed.topology import SymmetricTopologyManager\n"
            "t = SymmetricTopologyManager(16, 2, seed=0)\n"
            "t.generate_topology()\n"
            "print(repr(t.topology.tobytes().hex()))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    want = JaxSymmetric(16, 2, seed=0)
    want.generate_topology()
    assert out.stdout.strip() == repr(want.topology.tobytes().hex())
