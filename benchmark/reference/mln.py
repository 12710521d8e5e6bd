"""The anchors of a match list file (.mln, the FormatVersion 4 match list):
one line per match, its length and then its signed start in each genome
(negative on the reverse strand, 0 where absent)."""

from __future__ import annotations

import numpy as np


def read_matches(path: str) -> np.ndarray:
    """[m, 1 + n] int64 rows: length, start in genome 0, ..., genome n-1."""
    rows = []
    with open(path) as fh:
        for line in fh:
            if line[:1].isdigit() or line[:1] == "-":
                rows.append(line.split())
    return np.array(rows, np.int64).reshape(len(rows), -1)


def anchor_pair_keys(matches: np.ndarray, len1: int) -> np.ndarray:
    """Every (genome 0 position, signed genome 1 position) pair that a
    two-genome match list claims, as one int64 key each (pair_key)."""
    m = matches[(matches[:, 1] != 0) & (matches[:, 2] != 0)]
    lengths = m[:, 0]
    idx = np.repeat(np.arange(len(m)), lengths)
    off = np.arange(int(lengths.sum())) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    s0, s1, L = m[idx, 1], m[idx, 2], lengths[idx]
    same = np.sign(s0) == np.sign(s1)
    # a match on opposite strands pairs the first base of one with the last
    # of the other; on the same strand (both negative too) offsets agree
    p0 = np.abs(s0) + off
    p1 = np.where(same, np.abs(s1) + off, -(np.abs(s1) + L - 1 - off))
    return pair_key(p0, p1, len1)


def pair_key(p0: np.ndarray, p1_signed: np.ndarray, len1: int) -> np.ndarray:
    return p0.astype(np.int64) * (2 * len1 + 3) + (p1_signed.astype(np.int64) + len1 + 1)


def unanchored_share(matches: np.ndarray, truth: np.ndarray, len1: int) -> float:
    """Share of the truth's homologous position pairs (truth: genome 0
    position -> signed genome 1 position) that no anchor claims.  The full
    anchor search covers nearly all of them at 1% divergence; a search that
    samples its seeds leaves more of them to the gapped closure."""
    p0 = np.flatnonzero(truth[1:]) + 1
    keys = pair_key(p0, truth[p0], len1)
    return float(1.0 - np.isin(keys, anchor_pair_keys(matches, len1)).mean())
