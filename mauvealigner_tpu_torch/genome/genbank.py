"""Minimal GenBank flat-file reader (gnGBKSource equivalent).

Parses ORIGIN sequence blocks plus CDS/gene features with qualifiers —
the subset the reference tools consume (annotation scan at
src/getOrthologList.cpp:115-120, src/bbAnalyze.cpp feature intersection).
Multi-record files become multi-contig genomes.
"""

from __future__ import annotations

import re
from typing import List, Optional, TextIO, Tuple, Union

import numpy as np

from mauvealigner_tpu_torch.genome.sequence import Contig, Feature, Genome

_FEATURE_KINDS = {"CDS", "gene", "tRNA", "rRNA", "misc_feature", "repeat_region"}
_LOC_RANGE = re.compile(r"[<>]?(\d+)\.\.[<>]?(\d+)")
_LOC_SINGLE = re.compile(r"^[<>]?(\d+)$")


def _parse_location(loc: str) -> Optional[Tuple[int, int, int]]:
    """Return (start, end, strand) in 1-based inclusive local coords.

    Handles complement(...), join(...) (outer span), and simple ranges.
    """
    strand = 1
    s = loc.strip()
    while True:
        if s.startswith("complement(") and s.endswith(")"):
            strand = -strand
            s = s[len("complement(") : -1]
        elif (s.startswith("join(") or s.startswith("order(")) and s.endswith(")"):
            s = s[s.index("(") + 1 : -1]
        else:
            break
    ranges = _LOC_RANGE.findall(s)
    if ranges:
        starts = [int(a) for a, _ in ranges]
        ends = [int(b) for _, b in ranges]
        return min(starts), max(ends), strand
    m = _LOC_SINGLE.match(s)
    if m:
        p = int(m.group(1))
        return p, p, strand
    return None


def read_genbank(path_or_handle: Union[str, TextIO], name: str = "") -> Genome:
    if isinstance(path_or_handle, str):
        with open(path_or_handle) as fh:
            g = read_genbank(fh, name=name or path_or_handle)
            g.filename = path_or_handle
            return g
    fh = path_or_handle

    contigs: List[Contig] = []
    features: List[Feature] = []
    parts: List[bytes] = []
    offset = 0

    locus_name = ""
    in_features = False
    in_origin = False
    seq_chunks: List[str] = []
    pending: Optional[Tuple[str, str]] = None  # (kind, location text)
    pending_quals: dict = {}
    record_features: List[Tuple[str, str, dict]] = []

    def flush_pending():
        nonlocal pending, pending_quals
        if pending is not None:
            record_features.append((pending[0], pending[1], pending_quals))
        pending = None
        pending_quals = {}

    def flush_record():
        nonlocal locus_name, seq_chunks, record_features, offset, in_features, in_origin
        flush_pending()
        seq = "".join(seq_chunks).encode("ascii")
        if seq or record_features:
            contigs.append(Contig(locus_name or f"contig{len(contigs)}", len(seq), offset))
            for kind, loc, quals in record_features:
                parsed = _parse_location(loc)
                if parsed is None:
                    continue
                s, e, st = parsed
                features.append(Feature(kind, offset + s, offset + e, st, quals))
            parts.append(seq)
            offset += len(seq)
        locus_name = ""
        seq_chunks = []
        record_features = []
        in_features = False
        in_origin = False

    qual_key = None
    for line in fh:
        if line.startswith("LOCUS"):
            toks = line.split()
            locus_name = toks[1] if len(toks) > 1 else ""
        elif line.startswith("FEATURES"):
            in_features, in_origin = True, False
        elif line.startswith("ORIGIN"):
            flush_pending()
            in_features, in_origin = False, True
        elif line.startswith("//"):
            flush_record()
        elif in_origin:
            seq_chunks.append(re.sub(r"[^A-Za-z]", "", line))
        elif in_features and line[:1] not in (" ", "\t", "\n", ""):
            # a top-level keyword (CONTIG, BASE COUNT, PRIMARY, ...) ends the
            # FEATURES section; without this its text is misparsed as a
            # location/qualifier continuation of the last pending feature
            flush_pending()
            in_features = False
        elif in_features:
            if len(line) > 5 and line[5] != " " and not line[:5].strip():
                flush_pending()
                kind = line[5:21].strip()
                loc = line[21:].strip()
                if kind in _FEATURE_KINDS:
                    pending = (kind, loc)
                qual_key = None
            elif pending is not None:
                text = line[21:].rstrip("\n")
                stripped = text.strip()
                if stripped.startswith("/"):
                    if "=" in stripped:
                        k, v = stripped[1:].split("=", 1)
                        pending_quals[k] = v.strip('"')
                        qual_key = k
                    else:
                        pending_quals[stripped[1:]] = True
                        qual_key = None
                elif qual_key is not None:
                    # GenBank wraps free-text qualifiers at word boundaries;
                    # only /translation concatenates without a separator
                    joiner = "" if qual_key == "translation" else " "
                    pending_quals[qual_key] = (
                        str(pending_quals[qual_key]) + joiner + stripped.strip('"')
                    )
                elif pending is not None and stripped and "=" not in stripped:
                    # location continuation line
                    pending = (pending[0], pending[1] + stripped)
    flush_record()

    if not contigs:
        raise ValueError("no GenBank records parsed")
    seq_arr = np.frombuffer(b"".join(parts), dtype=np.uint8)
    return Genome(seq_arr, contigs=contigs, name=contigs[0].name, features=features)
