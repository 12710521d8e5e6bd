"""L8: phylogenetic trees — Newick I/O, neighbor joining, rooting.

Equivalents of the reference's PhyloTree/TreeUtilities surface
(src/AlignmentTree.cpp:12-188 local copy; libMems PhyloTree.h used by
src/rootTrees.cpp, src/extractBCITrees.cpp) and of
MuscleInterface::CreateTree's NJ guide-tree construction
(src/mauveAligner.cpp:619-622).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


@dataclasses.dataclass
class TreeNode:
    name: str = ""
    length: float = 0.0
    children: List["TreeNode"] = dataclasses.field(default_factory=list)
    parent: Optional["TreeNode"] = None

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self) -> List["TreeNode"]:
        if self.is_leaf:
            return [self]
        return [lf for c in self.children for lf in c.leaves()]

    def leaf_names(self) -> List[str]:
        return [l.name for l in self.leaves()]

    def height(self) -> float:
        """Maximum root-to-leaf branch-length sum (PhyloTree height,
        src/AlignmentTree.cpp:178-188)."""
        if self.is_leaf:
            return 0.0
        return max(c.length + c.height() for c in self.children)

    def clades(self) -> List[frozenset]:
        """Leaf-name sets of every internal edge (for topology comparison)."""
        out = []

        def rec(node) -> Set[str]:
            if node.is_leaf:
                return {node.name}
            s: Set[str] = set()
            for c in node.children:
                s |= rec(c)
            out.append(frozenset(s))
            return s

        rec(self)
        return out


# -- Newick ----------------------------------------------------------------

_TOKEN = re.compile(r"\s*([(),;:])|\s*([^(),;:\s]+)")


def parse_newick(text: str) -> TreeNode:
    """Newick parser (readTree equivalent, src/AlignmentTree.cpp:46-129)."""
    pos = 0
    text = text.strip()

    def error(msg):
        raise ValueError(f"newick parse error at {pos}: {msg}")

    def parse_node() -> TreeNode:
        nonlocal pos
        node = TreeNode()
        if pos < len(text) and text[pos] == "(":
            pos += 1
            while True:
                child = parse_node()
                child.parent = node
                node.children.append(child)
                if pos >= len(text):
                    error("unexpected end")
                if text[pos] == ",":
                    pos += 1
                    continue
                if text[pos] == ")":
                    pos += 1
                    break
                error(f"unexpected char {text[pos]!r}")
        # optional name
        m = re.match(r"[^(),;:]+", text[pos:])
        if m:
            node.name = m.group(0).strip()
            pos += m.end()
        # optional branch length
        if pos < len(text) and text[pos] == ":":
            pos += 1
            m = re.match(r"[-+0-9.eE]+", text[pos:])
            if not m:
                error("expected branch length")
            node.length = float(m.group(0))
            pos += m.end()
        return node

    root = parse_node()
    return root


def write_newick(node: TreeNode, with_lengths: bool = True) -> str:
    """Newick writer (writeTree equivalent, src/AlignmentTree.cpp:132-176)."""

    def rec(n: TreeNode) -> str:
        if n.is_leaf:
            core = n.name
        else:
            core = "(" + ",".join(rec(c) for c in n.children) + ")" + n.name
        if with_lengths and n.parent is not None:
            core += f":{n.length:g}"
        return core

    return rec(node) + ";"


# -- neighbor joining -------------------------------------------------------

def neighbor_joining(dist: np.ndarray, names: Sequence[str]) -> TreeNode:
    """Classic NJ (Saitou-Nei) from a distance matrix — the guide-tree
    construction MuscleInterface::CreateTree performs for the reference
    (src/mauveAligner.cpp:619-622)."""
    n = len(names)
    if n == 1:
        return TreeNode(name=names[0])
    nodes = [TreeNode(name=nm) for nm in names]
    d = np.array(dist, dtype=float)
    active = list(range(n))
    while len(active) > 2:
        m = len(active)
        sub = d[np.ix_(active, active)]
        r = sub.sum(axis=1)
        q = (m - 2) * sub - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        ai, aj = np.unravel_index(np.argmin(q), q.shape)
        if ai > aj:
            ai, aj = aj, ai
        i, j = active[ai], active[aj]
        dij = d[i, j]
        li = 0.5 * dij + (r[ai] - r[aj]) / (2 * (m - 2))
        lj = dij - li
        parent = TreeNode()
        for child, ln in ((nodes[i], li), (nodes[j], lj)):
            child.length = max(ln, 0.0)
            child.parent = parent
            parent.children.append(child)
        # distances to the new node
        dnew = 0.5 * (d[i, active] + d[j, active] - dij)
        d = np.pad(d, ((0, 1), (0, 1)))
        k = d.shape[0] - 1
        d[k, active] = dnew
        d[active, k] = dnew
        d[k, k] = 0.0
        nodes.append(parent)
        active = [x for x in active if x not in (i, j)] + [k]
    i, j = active
    root = TreeNode()
    half = max(d[i, j] / 2, 0.0)
    for child in (nodes[i], nodes[j]):
        child.length = half
        child.parent = root
        root.children.append(child)
    return root


def upgma(dist: np.ndarray, names: Sequence[str]) -> TreeNode:
    """UPGMA (average-linkage) clustering — the guide-tree style of MUSCLE's
    default (UPGMB), more robust than NJ for the coarse coverage distances
    used here; produces a rooted tree whose cherries are min-distance pairs."""
    n = len(names)
    if n == 1:
        return TreeNode(name=names[0])
    d = (np.array(dist, float) + np.array(dist, float).T) / 2
    nodes = {i: TreeNode(name=names[i]) for i in range(n)}
    heights = {i: 0.0 for i in range(n)}
    sizes = {i: 1 for i in range(n)}
    active = list(range(n))
    next_id = n
    dd = {(i, j): d[i, j] for i in range(n) for j in range(n) if i < j}
    while len(active) > 1:
        (i, j), dij = min(
            ((p, v) for p, v in dd.items() if p[0] in active and p[1] in active),
            key=lambda t: (t[1], t[0]),
        )
        parent = TreeNode()
        h = dij / 2
        for child_id in (i, j):
            child = nodes[child_id]
            child.length = max(h - heights[child_id], 0.0)
            child.parent = parent
            parent.children.append(child)
        nodes[next_id] = parent
        heights[next_id] = h
        sizes[next_id] = sizes[i] + sizes[j]
        for k in active:
            if k in (i, j):
                continue
            dik = dd[tuple(sorted((i, k)))]
            djk = dd[tuple(sorted((j, k)))]
            dd[tuple(sorted((next_id, k)))] = (
                dik * sizes[i] + djk * sizes[j]
            ) / (sizes[i] + sizes[j])
        active = [x for x in active if x not in (i, j)] + [next_id]
        next_id += 1
    return nodes[active[0]]


# -- rooting / topology -----------------------------------------------------

def reroot_with_outgroup(root: TreeNode, outgroup_names: Set[str]) -> TreeNode:
    """Root so the outgroup is one child subtree (rootTrees semantics,
    src/rootTrees.cpp:90)."""
    # find the edge whose below-set equals or contains exactly the outgroup
    best = None

    def rec(node: TreeNode) -> Set[str]:
        nonlocal best
        s = (
            {node.name}
            if node.is_leaf
            else {x for c in node.children for x in rec(c)}
        )
        if s == outgroup_names and node.parent is not None:
            best = node
        return s

    all_names = rec(root)
    if best is None or best.parent is None:
        return root
    # reroot at the edge above `best`
    new_root = TreeNode()
    old_parent = best.parent
    half = best.length / 2
    # detach
    old_parent.children = [c for c in old_parent.children if c is not best]
    # invert path from old_parent up to root
    path = []
    node = old_parent
    while node is not None:
        path.append(node)
        node = node.parent
    for up_idx in range(len(path) - 1, 0, -1):
        upper = path[up_idx]
        lower = path[up_idx - 1]
        upper.children = [c for c in upper.children if c is not lower]
        lower.children.append(upper)
        upper.length = lower.length
        upper.parent = lower
    # drop degenerate single-child old root
    node = path[-1]
    sub = path[0]
    new_root.children = [best, sub]
    best.parent = new_root
    best.length = half
    sub.parent = new_root
    sub.length = half
    _prune_unary(new_root)
    return new_root


def _prune_unary(node: TreeNode) -> None:
    for c in list(node.children):
        _prune_unary(c)
    if len(node.children) == 1 and node.parent is not None:
        child = node.children[0]
        child.length += node.length
        child.parent = node.parent
        node.parent.children = [
            child if c is node else c for c in node.parent.children
        ]


def topologies_equal(a: TreeNode, b: TreeNode) -> bool:
    """Unrooted topology equality via split sets (uniquifyTrees semantics,
    src/uniquifyTrees.cpp:195)."""
    la, lb = set(a.leaf_names()), set(b.leaf_names())
    if la != lb:
        return False

    def splits(t: TreeNode) -> Set[frozenset]:
        full = frozenset(t.leaf_names())
        out = set()
        for c in t.clades():
            if 1 < len(c) < len(full) - 1:
                out.add(min(c, full - c, key=lambda s: sorted(s)))
        return out

    return splits(a) == splits(b)
