"""The `drafts` traffic shape, the inputs every cell had before it, and
the sharded pair search as the harness records and breaks it: the
`pair_mums` recorder, the `sketch` control and the `placement` fault
reaching parallel.sort_contigs_sharded."""

import contextlib
import hashlib
import json
import os

import numpy as np
import pytest

from benchmark import capture, control, spec
from benchmark.reference import mln
from benchmark.traffic import generate

HERE = os.path.dirname(os.path.abspath(__file__))
FROZEN = json.load(open(os.path.join(HERE, "inputs_sha256.json")))
DRAFTS = {"shape": "drafts", "drafts": {"count": 4, "sub": 0.01, "indel": 0.0005,
                                        "contigs": 12, "revcomp": 0.4}}
CELL3 = "pairwise_ecoli.draft184"
CELL3_LENGTH = 1_000_000  # as test_portbench_faults.py runs cell 3


def _shas(inputs):
    return [hashlib.sha256(open(f, "rb").read()).hexdigest() for f in inputs.files]


def _drafts(count, **changes):
    return {"shape": "drafts", "drafts": {**DRAFTS["drafts"], "count": count, **changes}}


@pytest.mark.parametrize("cell,run", [(c, k) for c, runs in FROZEN["cells"].items()
                                      for k in range(len(runs))])
def test_every_cell_keeps_its_inputs(tmp_path, cell, run):
    want = FROZEN["cells"][cell][run]
    c = spec.cell(cell)
    inputs = generate.make_inputs(c["config_data"], c["traffic_data"], want["seed"],
                                  str(tmp_path), want["genome_length"])
    assert _shas(inputs) == want["sha256"]


@pytest.mark.parametrize("seed", sorted(FROZEN["draft_shape"]["sha256"]))
def test_the_draft_shape_keeps_its_files(tmp_path, seed):
    frozen = FROZEN["draft_shape"]
    inputs = generate.make_inputs(frozen["config"], frozen["traffic"], int(seed), str(tmp_path))
    assert _shas(inputs) == frozen["sha256"][seed]
    assert inputs.drafts == [inputs.draft]


def test_each_draft_keeps_its_truth(tmp_path):
    inputs = generate.make_inputs({"genome_length": 100_000}, _drafts(3, sub=0.0, indel=0.0),
                                  2**40 + 3, str(tmp_path))
    ref = inputs.genomes[0]
    assert [os.path.basename(f) for f in inputs.files] == ["ref.fa", "draft0.fa", "draft1.fa",
                                                           "draft2.fa"]
    assert inputs.draft is inputs.drafts[0] and len(inputs.truths) == 3
    for k, draft in enumerate(inputs.drafts):
        flat = np.concatenate(draft.seqs)
        assert np.array_equal(inputs.genomes[k + 1], flat)
        assert inputs.truths[k] is draft.truth
        p = draft.truth[1:]
        assert (p != 0).all()
        assert np.array_equal(ref[p > 0], flat[p[p > 0] - 1])
        assert np.array_equal(ref[p < 0], generate.COMP[flat[-p[p < 0] - 1]])
        assert sorted(draft.true_rank.tolist()) == list(range(12))
    # independent descendants: no two drafts are cut or shuffled alike
    assert len({tuple(d.true_rank.tolist()) for d in inputs.drafts}) == 3


def test_a_drafts_bases_do_not_depend_on_the_count(tmp_path):
    seed = 2**33 + 9
    four = generate.make_inputs({"genome_length": 60_000}, _drafts(4), seed, str(tmp_path / "a"))
    six = generate.make_inputs({"genome_length": 60_000}, _drafts(6), seed, str(tmp_path / "b"))
    assert _shas(four) == _shas(six)[:5]
    for a, b in zip(four.drafts, six.drafts):
        assert np.array_equal(a.truth, b.truth) and a.names == b.names


def _genomes(inputs):
    from mauvealigner_tpu_torch.tools.common import load_genome

    return [load_genome(f) for f in inputs.files]


def test_pair_mums_records_each_draft_in_the_order_handed(tmp_path):
    """Four shards, and drafts whose lengths give two seed weights, handed
    in turns (the program searches each weight's group in one call): each
    draft's rows equal a one-draft search on one shard."""
    from mauvealigner_tpu_torch.parallel import find_pair_mums_sharded, make_mesh, sharded
    from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed
    from mauvealigner_tpu_torch.tools.common import load_genome

    inputs = generate.make_inputs({"genome_length": 64_000}, _drafts(2), 2**35 + 1,
                                  str(tmp_path))
    ref, *whole = _genomes(inputs)
    parts = []
    for k, d in enumerate(inputs.drafts):
        # contigs in file order up to 24 kbp: the pair averages under 2**15.5
        # bases, the whole draft's over it
        ends = np.cumsum([len(x) for x in d.seqs])
        path = str(tmp_path / f"part{k}.fa")
        generate.write_fasta(path, list(zip(d.names, d.seqs))[:max(1, int((ends <= 24_000).sum()))])
        parts.append(load_genome(path))
    drafts = [parts[0], whole[0], parts[1], whole[1]]
    weights = [default_mer_size(int(np.mean([len(ref), len(d)]))) for d in drafts]
    assert weights[0] == weights[2] != weights[1] == weights[3]
    captured: dict = {}
    with capture.recording(["pair_mums"], captured):
        sharded.sort_contigs_sharded(ref, drafts, make_mesh(4, "cpu"), device="cpu")
    rows = captured["pair_anchors"]
    assert len(rows) == len(drafts)
    assert captured["work.anchors"] == sum(len(r) for r in rows)
    for d, w, got in zip(drafts, weights, rows):
        (ml,) = find_pair_mums_sharded(ref, [d], get_seed(w, 0), make_mesh(1, "cpu"),
                                       device="cpu")
        assert len(ml) > 0
        assert np.array_equal(got, np.concatenate([ml.lengths[:, None], ml.starts], 1))


@pytest.fixture(scope="module")
def cell3_pair(tmp_path_factory):
    """Cell 3's inputs at its test length, as the program loads them."""
    cell = spec.cell(CELL3)
    inputs = generate.make_inputs(cell["config_data"], cell["traffic_data"], 2**32 + 17,
                                  str(tmp_path_factory.mktemp("cell3")), CELL3_LENGTH)
    return inputs, _genomes(inputs)


def _sharded_sort(genomes, ctx):
    from mauvealigner_tpu_torch.parallel import make_mesh, sort_contigs_sharded

    captured: dict = {}
    with ctx, capture.recording(["pair_mums"], captured):
        (sorted_draft,) = sort_contigs_sharded(genomes[0], genomes[1:], make_mesh(4, "cpu"),
                                               device="cpu")
    return sorted_draft, captured


def test_the_sketch_control_reaches_the_sharded_search(cell3_pair):
    inputs, genomes = cell3_pair
    limit = spec.cell(CELL3)["workload"]["limits"]["anchor_miss"]

    def miss(captured):
        return mln.unanchored_share(captured["pair_anchors"][0], inputs.draft.truth,
                                    len(inputs.genomes[1]))

    _, sound = _sharded_sort(genomes, contextlib.nullcontext())
    _, sketched = _sharded_sort(genomes, control.sketch())
    assert miss(sound) <= limit < miss(sketched)
    assert sketched["work.anchors"] < sound["work.anchors"]


def test_the_placement_fault_reaches_the_sharded_sort(cell3_pair):
    _, genomes = cell3_pair
    (_, sound), _ = _sharded_sort(genomes, contextlib.nullcontext())
    (_, broken), _ = _sharded_sort(genomes, control.fault("placement"))
    sound, broken = dict(sound), dict(broken)
    placed = [name for name, strand in sound.items() if strand != 0]
    assert len(placed) > 100
    assert all(broken[name] == -sound[name] for name in placed)
