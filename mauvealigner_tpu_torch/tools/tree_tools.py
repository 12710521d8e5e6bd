"""Phylogenetic tree tools (SURVEY.md §2.2 'Phylogenetic tree tools')."""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Set, Tuple

from mauvealigner_tpu_torch.analysis.tree import (
    TreeNode,
    parse_newick,
    reroot_with_outgroup,
    topologies_equal,
    write_newick,
)


def parse_nexus_trees(text: str) -> Tuple[List[Tuple[str, TreeNode]], Dict[str, str]]:
    """Parse trees (and the taxa translate table) from a NEXUS trees block."""
    translate: Dict[str, str] = {}
    trees: List[Tuple[str, TreeNode]] = []
    m = re.search(r"translate(.*?);", text, re.S | re.I)
    if m:
        for entry in m.group(1).split(","):
            toks = entry.split()
            if len(toks) >= 2:
                translate[toks[0]] = toks[1].rstrip(",;")
    for tm in re.finditer(
        r"tree\s+(\S+)\s*(?:\[[^\]]*\]\s*)*=\s*(?:\[[^\]]*\]\s*)*([^;\[]+);",
        text, re.I,
    ):
        name = tm.group(1)
        newick = tm.group(2).strip() + ";"
        tree = parse_newick(newick)
        if translate:
            for leaf in tree.leaves():
                leaf.name = translate.get(leaf.name, leaf.name)
        trees.append((name, tree))
    return trees, translate


def extract_bci_trees(
    trprobs_text: str, credibility: float = 0.95
) -> List[Tuple[str, float, TreeNode]]:
    """Sample trees above a cumulative Bayesian credibility threshold from a
    MrBayes .trprobs file (extractBCITrees semantics,
    src/extractBCITrees.cpp:197).  Tree comments carry p=... and P=...
    (posterior and cumulative posterior)."""
    out = []
    trees, translate = parse_nexus_trees(trprobs_text)
    probs = re.findall(r"\[\s*&?W?\s*p\s*=\s*([0-9.eE+-]+)[^\]]*\]", trprobs_text)
    cumulative = 0.0
    for i, (name, tree) in enumerate(trees):
        p = float(probs[i]) if i < len(probs) else 0.0
        # standard Bayes credible set: include trees while the cumulative
        # posterior BEFORE this tree is below the threshold (the smallest
        # set reaching it).  The reference instead breaks before pushing
        # the crossing tree (src/extractBCITrees.cpp:258-265), which
        # returns an EMPTY set whenever the first topology alone exceeds
        # the threshold — an evident bug, not replicated.
        if cumulative >= credibility - 1e-9:
            break
        cumulative += p
        out.append((name, p, tree))
    return out


def topology_key(tree: TreeNode) -> str:
    """Canonical ROOTED topology string: children sorted recursively,
    branch lengths dropped — the reference dedups by the written tree
    after sortTaxa (src/extractBCITrees.cpp:294-298), a rooted string
    comparison."""

    def canon(node: TreeNode) -> str:
        if not node.children:
            return node.name
        return "(" + ",".join(sorted(canon(c) for c in node.children)) + ")"

    return canon(tree)


def aggregate_bci_trees(
    texts: Sequence[str],
    bci_threshold: float,
    max_output_trees: int = 0,
    seed: int = 37,
) -> List[Tuple[TreeNode, float]]:
    """Reference extractBCITrees semantics (src/extractBCITrees.cpp:193-368):
    read trees + posteriors from each .trprobs file until the cumulative
    posterior passes the BCI threshold, sum posterior weight per unique
    topology, and — when more unique topologies than max_output_trees —
    subsample by posterior-weighted draws without replacement.  The RNG is
    numpy's (seeded), not the reference's lagged-Fibonacci."""
    buckets: Dict[str, Tuple[TreeNode, float]] = {}
    for text in texts:
        for name, prob, tree in extract_bci_trees(text, bci_threshold):
            key = topology_key(tree)
            if key in buckets:
                buckets[key] = (buckets[key][0], buckets[key][1] + prob)
            else:
                buckets[key] = (tree, prob)
    uniq = sorted(buckets.values(), key=lambda t: -t[1])
    if not max_output_trees or len(uniq) <= max_output_trees:
        return uniq
    import numpy as np

    rng = np.random.default_rng(seed)
    weights = np.array([w for _, w in uniq], np.float64)
    out: List[Tuple[TreeNode, float]] = []
    for _ in range(max_output_trees):
        total = weights.sum()
        if total <= 0:
            break
        dart = rng.uniform(0, total)
        i = int(np.searchsorted(np.cumsum(weights), dart, side="right"))
        i = min(i, len(uniq) - 1)
        out.append(uniq[i])
        weights[i] = 0.0
    return out


def uniquify_trees(trees: Sequence[TreeNode]) -> List[TreeNode]:
    """Deduplicate topologically identical trees (uniquifyTrees,
    src/uniquifyTrees.cpp:215-246): the reference compares the ROOTED
    sorted-children string and emits unique trees in sorted canonical
    order; the original (unrelabeled) trees are kept here."""
    seen: Dict[str, TreeNode] = {}
    for t in trees:
        seen.setdefault(topology_key(t), t)
    return [seen[k] for k in sorted(seen)]


def root_trees(
    trees: Sequence[TreeNode], outgroup: Set[str]
) -> List[TreeNode]:
    """Outgroup-root every tree (rootTrees semantics, src/rootTrees.cpp:90)."""
    return [reroot_with_outgroup(t, outgroup) for t in trees]


def check_for_lgt(
    gene_tree: TreeNode, group_a: Set[str], group_b: Set[str]
) -> bool:
    """True when the gene tree mixes taxa of group_a inside group_b's clade
    or vice versa — the lateral-transfer topology test of checkForLGT
    (src/checkForLGT.cpp:57-92, generalized from its hard-coded taxon
    groups)."""
    leaves = set(gene_tree.leaf_names())
    ga = group_a & leaves
    gb = group_b & leaves
    if not ga or not gb:
        return False
    for clade in gene_tree.clades():
        c = set(clade)
        # group_a is monophyletic when it appears as a rooted clade OR as
        # the complement of one (unrooted split; rooting is arbitrary)
        if c == ga or (leaves - c) == ga:
            return False  # no LGT signal
    return True
