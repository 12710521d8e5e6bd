"""Carry pipeline state from the JAX package into the port.

The aligner has no weights; what moves between the two packages is host
state: genomes, match lists, LCBs, interval lists and options.  Each
function takes the JAX package's object (read by attribute, so this module
imports neither jax nor mauvealigner_tpu) and returns the port's equivalent
with copied arrays.  Device outputs of the JAX package arrive as numpy.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from mauvealigner_tpu_torch.analysis.backbone import HmmParams
from mauvealigner_tpu_torch.analysis.tree import TreeNode
from mauvealigner_tpu_torch.core.interval import Interval, IntervalList
from mauvealigner_tpu_torch.core.match import MatchList
from mauvealigner_tpu_torch.genome.sequence import Contig, Feature, Genome
from mauvealigner_tpu_torch.models.aligner import AlignerOptions
from mauvealigner_tpu_torch.models.lcb import LCB
from mauvealigner_tpu_torch.models.progressive import ProgressiveOptions


def genome(g) -> Genome:
    return Genome(
        np.array(g.seq, dtype=np.uint8),
        contigs=[Contig(c.name, int(c.length), int(c.offset)) for c in g.contigs],
        name=g.name,
        filename=g.filename,
        features=[
            Feature(f.kind, int(f.start), int(f.end), int(f.strand), dict(f.qualifiers))
            for f in g.features
        ],
    )


def genomes(gs) -> List[Genome]:
    return [genome(g) for g in gs]


def match_list(ml) -> MatchList:
    return MatchList(np.array(ml.starts, np.int64), np.array(ml.lengths, np.int64))


def lcb(l) -> LCB:
    return LCB(
        match_indices=np.array(l.match_indices),
        weight=float(l.weight),
        lefts=np.array(l.lefts),
        rights=np.array(l.rights),
        strands=np.array(l.strands),
    )


def lcbs(ls) -> List[LCB]:
    return [lcb(l) for l in ls]


def interval_list(ivl, gs: Optional[List[Genome]] = None) -> IntervalList:
    """gs: the port's genomes for the list (converted from ivl's if None)."""
    return IntervalList(
        genomes=gs if gs is not None else genomes(ivl.genomes),
        intervals=[Interval(np.array(iv.starts, np.int64), np.array(iv.aln, bool))
                   for iv in ivl.intervals],
        seq_filenames=list(ivl.seq_filenames),
        backbone_filename=ivl.backbone_filename,
    )


def aligner_options(o, device) -> AlignerOptions:
    """The JAX package's AlignerOptions on `device`; a mesh has no
    counterpart and raises, closure_genomes are converted, subst is copied
    as float32."""
    if getattr(o, "mesh", None) is not None:
        raise NotImplementedError("mesh-sharded anchoring is not ported yet (ROADMAP A6)")
    kw = {}
    for f in dataclasses.fields(AlignerOptions):
        if f.name == "device" or not hasattr(o, f.name):
            continue
        kw[f.name] = getattr(o, f.name)
    if kw.get("subst") is not None:
        kw["subst"] = np.array(kw["subst"], np.float32)
    if kw.get("closure_genomes") is not None:
        kw["closure_genomes"] = genomes(kw["closure_genomes"])
    return AlignerOptions(device=device, **kw)


def progressive_options(o, device) -> ProgressiveOptions:
    """The JAX package's ProgressiveOptions on `device`; a mesh has no
    counterpart and raises, subst is copied as float32."""
    if getattr(o, "mesh", None) is not None:
        raise NotImplementedError("mesh-sharded alignment is not ported yet (ROADMAP A6)")
    kw = {}
    for f in dataclasses.fields(ProgressiveOptions):
        if f.name == "device" or not hasattr(o, f.name):
            continue
        kw[f.name] = getattr(o, f.name)
    if kw.get("subst") is not None:
        kw["subst"] = np.array(kw["subst"], np.float32)
    return ProgressiveOptions(device=device, **kw)


def tree(node) -> TreeNode:
    """A guide tree (the JAX package's TreeNode), copied node by node with
    parent links."""
    out = TreeNode(name=node.name, length=node.length, children=[tree(c) for c in node.children])
    for c in out.children:
        c.parent = out
    return out


def hmm_params(p) -> HmmParams:
    return HmmParams(
        float(p.go_homologous), float(p.go_unrelated),
        np.array(p.emit_h, np.float64), np.array(p.emit_u, np.float64),
    )
