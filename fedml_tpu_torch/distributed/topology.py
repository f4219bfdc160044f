"""Graph topologies for decentralized FL: weighted mixing matrices
(counterpart of ``fedml_tpu/distributed/topology.py``; reference
fedml_core/distributed/topology/).

- :class:`SymmetricTopologyManager`: a ring with ``neighbor_num`` undirected
  neighbours plus Watts-Strogatz rewiring, rows normalized.
- :class:`AsymmetricTopologyManager`: a directed ring plus random out-links,
  rows normalized (out-weights; the PushSum correction handles the column
  sums).

The matrix is the communication pattern: one gossip round is
``new = W @ stacked`` over the node axis (``algorithms/decentralized.py``).

The JAX package builds the symmetric graph with networkx's
``connected_watts_strogatz_graph``. The port carries no networkx: it
follows that algorithm step by step (:func:`connected_watts_strogatz`), one
``random.Random(seed)`` across the connectivity retries, the same draws in
the same order, so its matrix is bit-equal to the JAX package's.
"""

from __future__ import annotations

import random
from collections import deque

import numpy as np


def watts_strogatz(n: int, k: int, p: float, rng: random.Random) -> list[set]:
    """The Watts-Strogatz graph of networkx's ``watts_strogatz_graph`` as
    adjacency sets, drawing from ``rng`` as it does: each node joined to its
    ``k // 2`` nearest ring neighbours on each side, then each ring edge
    ``(u, v)``, by distance and then by node, rewired with probability ``p``
    to ``(u, w)``, ``w`` drawn until it is neither ``u`` nor a neighbour of
    ``u`` (a node of full degree keeps its edge). ``k == n`` is the complete
    graph."""
    if k > n:
        raise ValueError(f"k > n ({k} > {n}): choose a smaller k or a larger n")
    nodes = list(range(n))
    if k == n:
        return [set(nodes) - {u} for u in nodes]
    adj = [set() for _ in nodes]
    rings = [list(zip(nodes, nodes[j:] + nodes[:j])) for j in range(1, k // 2 + 1)]
    for ring in rings:
        for u, v in ring:
            adj[u].add(v)
            adj[v].add(u)
    for ring in rings:
        for u, v in ring:
            if rng.random() < p:
                w = rng.choice(nodes)
                while w == u or w in adj[u]:
                    w = rng.choice(nodes)
                    if len(adj[u]) >= n - 1:
                        break                  # skip this rewiring
                else:
                    adj[u].remove(v)
                    adj[v].remove(u)
                    adj[u].add(w)
                    adj[w].add(u)
    return adj


def is_connected(adj: list[set]) -> bool:
    """Whether every node is reachable from node 0 (breadth first)."""
    if not adj:
        raise ValueError("connectivity is undefined for the null graph")
    seen, todo = {0}, deque([0])
    while todo:
        for v in adj[todo.popleft()] - seen:
            seen.add(v)
            todo.append(v)
    return len(seen) == len(adj)


def connected_watts_strogatz(n: int, k: int, p: float, seed: int, tries: int = 100
                             ) -> list[set]:
    """networkx's ``connected_watts_strogatz_graph(n, k, p, tries, seed)``:
    Watts-Strogatz graphs from one ``random.Random(seed)`` until one is
    connected; raises after ``tries``."""
    rng = random.Random(seed)
    for _ in range(tries):
        adj = watts_strogatz(n, k, p, rng)
        if is_connected(adj):
            return adj
    raise RuntimeError("Maximum number of tries exceeded")


class BaseTopologyManager:
    """Interface of the reference's base_topology_manager.py:4-24."""

    topology: np.ndarray

    def generate_topology(self) -> None:
        raise NotImplementedError

    def get_in_neighbor_weights(self, node_index: int) -> np.ndarray:
        return self.topology[:, node_index]

    def get_out_neighbor_weights(self, node_index: int) -> np.ndarray:
        return self.topology[node_index]

    def get_in_neighbor_idx_list(self, node_index: int) -> list[int]:
        col = self.topology[:, node_index]
        return [i for i in range(len(col)) if col[i] > 0 and i != node_index]

    def get_out_neighbor_idx_list(self, node_index: int) -> list[int]:
        row = self.topology[node_index]
        return [i for i in range(len(row)) if row[i] > 0 and i != node_index]

    @property
    def mixing_matrix(self) -> np.ndarray:
        return self.topology


class SymmetricTopologyManager(BaseTopologyManager):
    """Undirected ring plus Watts-Strogatz shortcuts (rewiring probability
    0.3), self-loops added, uniform row weights."""

    def __init__(self, n: int, neighbor_num: int = 2, seed: int = 0):
        self.n = n
        self.neighbor_num = min(neighbor_num, max(n - 1, 1))
        self.seed = seed
        self.topology = np.zeros((n, n))

    def generate_topology(self) -> None:
        if self.n <= 2:
            # Watts-Strogatz needs k >= 2 edges a node; for one or two nodes
            # the only sensible mixing matrix is the plain average
            self.topology = np.full((self.n, self.n), 1.0 / self.n)
            return
        k = max(self.neighbor_num, 2)
        adj = np.zeros((self.n, self.n))
        for u, nbrs in enumerate(connected_watts_strogatz(self.n, min(k, self.n - 1), 0.3,
                                                          self.seed)):
            adj[u, sorted(nbrs)] = 1.0
        adj = adj + np.eye(self.n)
        adj = np.minimum(adj + adj.T, 1.0)     # symmetrize
        self.topology = adj / adj.sum(axis=1, keepdims=True)


class AsymmetricTopologyManager(BaseTopologyManager):
    """Directed ring plus random out-links; rows normalized (column sums
    vary, which the PushSum correction tracks)."""

    def __init__(self, n: int, undirected_neighbor_num: int = 2,
                 out_directed_neighbor: int = 2, seed: int = 0):
        self.n = n
        self.undirected_neighbor_num = undirected_neighbor_num
        self.out_directed_neighbor = out_directed_neighbor
        self.seed = seed
        self.topology = np.zeros((n, n))

    def generate_topology(self) -> None:
        rng = np.random.default_rng(self.seed)
        n = self.n
        adj = np.eye(n)
        for i in range(n):
            # directed ring links
            for d in range(1, self.undirected_neighbor_num + 1):
                adj[i, (i + d) % n] = 1.0
            # random extra out-links
            extra = rng.choice(n, size=min(self.out_directed_neighbor, n - 1), replace=False)
            for j in extra:
                if j != i:
                    adj[i, j] = 1.0
        self.topology = adj / adj.sum(axis=1, keepdims=True)
