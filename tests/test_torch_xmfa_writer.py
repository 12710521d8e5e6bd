"""The port's XMFA writer against the JAX package's, byte for byte.

`IntervalList.write_xmfa` in the port assembles runs of narrow blocks in
chunks and writes wider blocks row by row; the JAX package writes every row
and every line with its own calls.  Each case is a hand-made interval list
written by both, under the port's own split and with every block forced down
each of its two paths.
"""

import io

import numpy as np
import pytest

from mauvealigner_tpu.core import interval as jax_interval
from mauvealigner_tpu.genome.sequence import Genome as JaxGenome
from mauvealigner_tpu_torch.core import interval
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.utils import timing

IUPAC = np.frombuffer(b"ACGTNRYKMBVDHWSacgtnrykm", np.uint8)
WIDE = interval._BATCH_MAX_COLS + 1  # the narrowest block the port writes row by row


def _genomes(rng, lengths, alphabet=b"ACGT"):
    return [rng.choice(np.frombuffer(alphabet, np.uint8), n) for n in lengths]


def _block(rng, n_seqs, n_cols, cursor, p_absent=0.15, p_reverse=0.5, p_gap=0.2):
    """A block of n_seqs rows whose bases follow `cursor` (advanced in place)."""
    aln = rng.random((n_seqs, n_cols)) >= p_gap
    starts = cursor * np.where(rng.random(n_seqs) < p_reverse, -1, 1)
    starts[rng.random(n_seqs) < p_absent] = 0
    cursor += np.where(starts != 0, aln.sum(1), 0)
    return starts, aln


def _random_blocks(rng, n_seqs, widths, **kw):
    cursor = np.ones(n_seqs, np.int64)
    return [_block(rng, n_seqs, w, cursor, **kw) for w in widths]


def _case(name):
    """(genome byte arrays, file names, [(starts, aln)], backbone file, width)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    names = ["g0.fa", "dir/g1.fa", "genome_two.fasta"]
    genomes = _genomes(rng, [3000, 2500, 2800])
    blocks, backbone, width = [], "", 80
    if name == "no_intervals":
        backbone = "x.xmfa.bbcols"
    elif name == "zero_columns":
        blocks = _random_blocks(rng, 3, [5, 0, 7])
        blocks.insert(0, (np.array([4, 0, -9]), np.zeros((3, 0), bool)))
    elif name == "absent_rows_with_bases":
        blocks = [(np.array([0, 11, 0]), rng.random((3, 40)) < 0.8),
                  (np.array([0, 0, 0]), np.ones((3, 9), bool))]
    elif name == "present_row_without_bases":
        aln = rng.random((3, 12)) < 0.7
        aln[1] = False
        blocks = [(np.array([17, 250, -31]), aln),
                  (np.array([-40, 2600, 0]), np.zeros((3, 3), bool))]
    elif name == "reverse_strands":
        blocks = _random_blocks(rng, 3, [30, 200, 1, 90], p_reverse=1.0, p_absent=0.0)
    elif name.startswith("columns_"):
        n_cols = int(name.split("_")[1])
        blocks = _random_blocks(rng, 3, [n_cols, n_cols, 3])
        blocks[1][1][:, : n_cols // 2] = True  # a run without gaps
    elif name.startswith("width_"):
        width = int(name.split("_")[1])
        blocks = _random_blocks(rng, 3, [1, width - 1, width, width + 1, 3 * width, 250])
    elif name == "iupac_bases":
        genomes = _genomes(rng, [3000, 2500, 2800], IUPAC.tobytes())
        blocks = _random_blocks(rng, 3, [64, 5, 130])
    elif name == "narrow_and_wide":
        backbone = "out.xmfa.bbcols"
        widths = [int(w) for w in rng.integers(1, 60, 200)]
        widths[50:50] = [WIDE, 2 * WIDE + 37]
        widths[150:150] = [3 * WIDE]
        genomes = _genomes(rng, [40_000, 40_000, 40_000], IUPAC.tobytes())
        blocks = _random_blocks(rng, 3, widths)
    elif name == "many_genomes":
        names = [f"/data/long/path/to/sequence_{i:02d}.gbk" for i in range(11)]
        genomes = _genomes(rng, [9000] * 11)
        blocks = _random_blocks(rng, 11, [int(w) for w in rng.integers(0, 130, 120)])
    else:
        raise KeyError(name)
    return genomes, names, blocks, backbone, width


CASES = [
    "no_intervals", "zero_columns", "absent_rows_with_bases", "present_row_without_bases",
    "reverse_strands", "columns_1", "columns_79", "columns_80", "columns_81", "columns_160",
    "width_60", "width_7", "iupac_bases", "narrow_and_wide", "many_genomes",
]
# every case goes to a file but these, which go to a text stream
TO_STREAM = {"no_intervals", "zero_columns", "columns_80", "width_7", "narrow_and_wide"}


def _lists(case):
    genomes, names, blocks, backbone, width = _case(case)
    lists = []
    for mod, G in ((interval, Genome), (jax_interval, JaxGenome)):
        ivs = [mod.Interval(starts, aln) for starts, aln in blocks]
        gs = [G(g, name=f"seq{i}") for i, g in enumerate(genomes)]
        lists.append(mod.IntervalList(gs, ivs, seq_filenames=list(names),
                                      backbone_filename=backbone))
    return lists, width


def _written(ivl, case, width, path):
    if case in TO_STREAM:
        buf = io.StringIO()
        ivl.write_xmfa(buf, width=width)
        return buf.getvalue()
    ivl.write_xmfa(str(path), width=width)
    return path.read_text()


@pytest.mark.parametrize("split", ["as_is", "all_rows", "all_batched"])
@pytest.mark.parametrize("case", CASES)
def test_xmfa_writer_bytes_equal_jax(case, split, tmp_path, monkeypatch):
    max_cols = {"as_is": interval._BATCH_MAX_COLS, "all_rows": -1, "all_batched": 1 << 30}
    monkeypatch.setattr(interval, "_BATCH_MAX_COLS", max_cols[split])
    if case == "narrow_and_wide":
        monkeypatch.setattr(interval, "_BATCH_BYTES", 4096)  # several chunks
    (port, ref), width = _lists(case)
    got = _written(port, case, width, tmp_path / "port.xmfa")
    want = _written(ref, case, width, tmp_path / "jax.xmfa")
    assert got == want
    assert got.count("\n=\n") == len(port.intervals)


def test_xmfa_writer_counters():
    (port, _), width = _lists("narrow_and_wide")
    timing.GLOBAL.reset()
    port.write_xmfa(io.StringIO(), width=width)
    counters = dict(timing.GLOBAL.counters)
    timing.GLOBAL.reset()
    rows = sum(iv.n_seqs for iv in port.intervals)
    wide_rows = sum(iv.n_seqs for iv in port.intervals if iv.n_cols >= WIDE)
    assert wide_rows == 9  # three wide blocks of three rows take the per-row path
    assert counters == {"xmfa_rows": rows, "xmfa_rows_batched": rows - wide_rows}
