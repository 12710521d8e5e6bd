"""Column-identity oracle for the port: both cases of test_column_oracle.py
(the collinear --emit-aln chain and the --emit-lcbs run with an inversion)
through the port's MauveAligner on the CPU and its pair_position_maps,
against the same native/reference_pipeline output, position for position.

The oracle binary is compiled into this module's own temporary directory:
test_column_oracle.py builds native/reference_pipeline in place, and the
two files may run in parallel workers."""

import json
import subprocess

import numpy as np
import pytest
import torch

from mauvealigner_tpu_torch.analysis.score_alignment import pair_position_maps
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.models.aligner import AlignerOptions, MauveAligner
from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed
from mauvealigner_tpu_torch.utils import simulate
from test_column_oracle import SRC, _ref_map, _ref_map_lcbs

torch.set_num_threads(1)

SIZE = 150_000


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    binary = str(tmp_path_factory.mktemp("oracle") / "reference_pipeline")
    subprocess.run(["g++", "-O3", "-std=c++17", SRC, "-o", binary], check=True)
    return binary


def _pair(rng, invert: bool):
    anc = simulate.random_genome(rng, SIZE, name="a")
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005, name="b")
    if invert:
        codes = der.codes.copy()
        codes[60_000:95_000] = (3 - np.minimum(codes[60_000:95_000], 3))[::-1]
        der = Genome.from_codes(codes, name="b")
    return anc, der


def _run_oracle(binary, tmp_path, anc, der, pattern, flag):
    fa, fb, fo = (str(tmp_path / x) for x in ("a.raw", "b.raw", "out.tsv"))
    anc.codes.astype(np.uint8).tofile(fa)
    der.codes.astype(np.uint8).tofile(fb)
    out = subprocess.run([binary, pattern, fa, fb, flag, fo], check=True,
                         capture_output=True, text=True)
    return fo, out.stdout


def test_column_identity_collinear_pairwise(rng, oracle, tmp_path):
    anc, der = _pair(rng, invert=False)
    weight = default_mer_size((len(anc) + len(der)) // 2)
    fo, _ = _run_oracle(oracle, tmp_path, anc, der, get_seed(weight, 0).pattern, "--emit-aln")
    ref = _ref_map(fo, len(anc))
    res = MauveAligner(AlignerOptions(
        seed_size=weight, collinear=True, recursive=False, lcb_extension=False,
        use_sml_cache=False, device="cpu",
    )).align([anc, der])
    got = pair_position_maps(res.interval_list, [len(anc), len(der)])[(0, 1)]
    span = np.nonzero(ref)[0]
    assert len(span) > SIZE // 2, "oracle chain covers too little"
    lo, hi = span[0], span[-1]
    mism = np.nonzero(ref[lo : hi + 1] != got[lo : hi + 1])[0]
    assert len(mism) == 0, f"{len(mism)} of {hi - lo + 1} columns differ from the C++ oracle"


def test_column_identity_lcbs_with_inversion(rng, oracle, tmp_path):
    anc, der = _pair(rng, invert=True)
    weight = default_mer_size((len(anc) + len(der)) // 2)
    fo, stdout = _run_oracle(oracle, tmp_path, anc, der, get_seed(weight, 0).pattern, "--emit-lcbs")
    rec = json.loads(stdout)
    ref = _ref_map_lcbs(fo, len(anc))
    assert rec["n_lcbs"] >= 3, rec  # the inversion must split the chain
    res = MauveAligner(AlignerOptions(
        seed_size=weight, recursive=False, lcb_extension=False, use_sml_cache=False,
        device="cpu",
    )).align([anc, der])
    assert len(res.lcbs) == rec["n_lcbs"], (len(res.lcbs), rec["n_lcbs"])
    got = pair_position_maps(res.interval_list, [len(anc), len(der)])[(0, 1)]
    mism = np.nonzero(ref[1:] != got[1:])[0]
    assert len(mism) == 0, f"{len(mism)} of {SIZE} positions differ from the C++ LCB oracle"
