"""Medusa candidate trees (the port's copy of
``qspec_tpu/spec_decode/medusa_tree.py``: plain Python and numpy).

A topology is a tuple of paths in the Medusa-choices format: each path is a
tuple of per-depth candidate indices, e.g.

    ((0,), (1,), (2,), (0, 0), (0, 1), (1, 0), (0, 0, 0))

Path (i1, ..., id) is the node at depth d whose token is head d's
top-(id+1) candidate, a child of the node (i1, ..., i_{d-1}), which must be
in the topology too. Node tokens depend only on the root's hidden state
(the heads do not read each other's proposals), so the whole tree comes from
one top-k per head (``spec_decode/medusa.py:medusa_propose_tree``).

The tree is static: the node order, each node's depth and parent and the
ancestor sets are fixed per topology. One verify pass scores
[prefix | tree] in one rectangle under the tree mask
(``ops/attention.py:tree_slot_mask`` and the attention kernel's tree
option), and acceptance walks the tree from the root: the target's sampled
token either matches a child's proposal (the walk descends and emits it) or
ends the round as the bonus / recovery token. Every emitted token is sampled
from the target conditioned on its accepted prefix, so the transcript is
lossless at any temperature (greedy: equal to AR's).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# 10 nodes for 4 heads: 4 candidates at depth 1, the top-1 spine 4 deep
DEFAULT_TREE: Tuple[Tuple[int, ...], ...] = (
    (0,), (1,), (2,), (3,),
    (0, 0), (0, 1), (1, 0),
    (0, 0, 0), (0, 1, 0),
    (0, 0, 0, 0),
)


@dataclasses.dataclass(frozen=True)
class TreeSpec:
    choices: Tuple[Tuple[int, ...], ...]   # sorted paths
    num_nodes: int                         # T
    max_depth: int                         # D (= heads used)
    depth: Tuple[int, ...]                 # [T] depth of node i (1-based)
    parent: Tuple[int, ...]                # [T] node index of the parent, -1 = root
    head_idx: Tuple[int, ...]              # [T] proposing head (depth - 1)
    cand_idx: Tuple[int, ...]              # [T] which top-k candidate
    ancestors: Tuple[Tuple[bool, ...], ...]  # [T, T] j is an ancestor of i, or i

    @property
    def max_cand(self) -> int:
        return max(self.cand_idx) + 1

    def ancestor_array(self) -> np.ndarray:
        return np.asarray(self.ancestors, bool)


def build_tree(choices=DEFAULT_TREE) -> TreeSpec:
    """The static tree of a Medusa-choices topology: paths sorted by depth,
    then lexicographically, so a parent precedes its children."""
    paths = tuple(sorted(set(tuple(p) for p in choices), key=lambda p: (len(p), p)))
    assert paths and all(len(p) >= 1 for p in paths), "paths must be non-empty"
    index = {p: i for i, p in enumerate(paths)}
    depth, parent, head_idx, cand_idx = [], [], [], []
    for p in paths:
        depth.append(len(p))
        head_idx.append(len(p) - 1)
        cand_idx.append(p[-1])
        if len(p) == 1:
            parent.append(-1)
        else:
            assert p[:-1] in index, f"path {p} has no parent in the topology"
            parent.append(index[p[:-1]])
    T = len(paths)
    anc = np.zeros((T, T), bool)
    for i in range(T):
        anc[i, i] = True
        j = parent[i]
        while j >= 0:
            anc[i, j] = True
            j = parent[j]
    return TreeSpec(choices=paths, num_nodes=T, max_depth=max(depth),
                    depth=tuple(depth), parent=tuple(parent),
                    head_idx=tuple(head_idx), cand_idx=tuple(cand_idx),
                    ancestors=tuple(tuple(bool(x) for x in row) for row in anc))
