"""Union-find with path compression (counterpart of
``mlamg_tpu/graph/disjoint_sets.py``): a host helper for edge-union
aggregation; bulk work on the device uses label propagation
(:func:`mlamg_torch.graph.components.connected_components`)."""

from __future__ import annotations

import numpy as np


class DisjointSets:
    def __init__(self, n: int):
        self.parent = np.arange(n)
        self.rank = np.zeros(n, dtype=np.int32)
        self.num_sets = n

    def find(self, i: int) -> int:
        root = i
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[i] != root:  # path compression
            self.parent[i], i = root, self.parent[i]
        return root

    def union(self, a: int, b: int) -> bool:
        """Join the sets of a and b (by rank); False if they were one."""
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return False
        if self.rank[ra] < self.rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if self.rank[ra] == self.rank[rb]:
            self.rank[ra] += 1
        self.num_sets -= 1
        return True

    def connected(self, a: int, b: int) -> bool:
        return self.find(a) == self.find(b)

    def labels(self) -> np.ndarray:
        """(n,) canonical root label per element."""
        return np.array([self.find(i) for i in range(len(self.parent))])
