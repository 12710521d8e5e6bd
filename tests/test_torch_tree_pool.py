"""The tree ladder's thread pool and the full-size chip phases' plumbing,
on the CPU.

tree_progressive_align(max_workers=...) and MAUVE_TP_WORKERS run
independent sibling merges on a thread pool; the port's pooled XMFA must
be byte-identical to the JAX package's serial XMFA, unmeshed and under an
8-shard CPU mesh (the port's counterpart of
tests/test_mesh_progressive.py::test_mesh_progressive_threaded_ladder_identical).
The launch counters and the kernel build are shared by the pool's threads.
The headline golden (scripts/make_port_golden.py enterobacteria_golden) and
chip_smoke.py's comparator run here at a tiny size, so that a key missing
on either side shows before a card run.
"""

import functools
import io
import os
import sys
import threading

import numpy as np
import pytest
import torch

from mauvealigner_tpu.models.progressive import ProgressiveMauve, ProgressiveOptions
from mauvealigner_tpu.utils import simulate
from mauvealigner_tpu_torch import interop
from mauvealigner_tpu_torch.analysis.tree import parse_newick
from mauvealigner_tpu_torch.models import tree_progressive as tp
from mauvealigner_tpu_torch.models.progressive import ProgressiveMauve as TorchProgressive
from mauvealigner_tpu_torch.models.progressive import ProgressiveOptions as TorchOptions
from mauvealigner_tpu_torch.ops import _build, gotoh_cuda
from mauvealigner_tpu_torch.parallel import make_mesh
from mauvealigner_tpu_torch.parallel.context import use_mesh
from mauvealigner_tpu_torch.utils import simulate as port_simulate
from mauvealigner_tpu_torch.utils import timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

torch.set_num_threads(1)


def _xmfa(res) -> str:
    buf = io.StringIO()
    res.interval_list.write_xmfa(buf)
    return buf.getvalue()


@pytest.fixture(scope="module")
def family():
    """tests/test_mesh_progressive.py's 5-genome 20 kbp family (its rng
    fixture's seed), with the JAX package's serial tree-branch XMFA."""
    rng = np.random.default_rng(37)
    anc = simulate.random_genome(rng, 20_000)
    genomes = []
    for i in range(5):
        g, _ = simulate.evolve(anc, rng, sub_rate=0.06, ins_rate=0.001, del_rate=0.001)
        if i % 2 == 1:
            g = simulate.apply_inversion(g, 5_000, 9_000)
        g.name = f"g{i}"
        genomes.append(g)
    old = os.environ.pop("MAUVE_TP_WORKERS", None)
    try:
        want = _xmfa(ProgressiveMauve(ProgressiveOptions(tree_progressive=True)).align(genomes))
    finally:
        if old is not None:
            os.environ["MAUVE_TP_WORKERS"] = old
    return interop.genomes(genomes), want


def _port_run(genomes, mesh):
    """(XMFA, span totals, forward launch batches) of one port run on
    the tree branch, with `mesh` the ambient mesh (use_mesh) and none in
    the options: the node merges' aligners then take the thread's
    ambient mesh."""
    timing.GLOBAL.reset()
    gotoh_cuda.reset_launches()
    with use_mesh(mesh):
        res = TorchProgressive(TorchOptions(tree_progressive=True, device="cpu")).align(genomes)
    return (_xmfa(res), dict(timing.GLOBAL.phases),
            sorted(s["B"] for s in gotoh_cuda.LAUNCH_SHAPES))


def _pooled(genomes, mesh, monkeypatch):
    """_port_run with the ladder's max_workers=4 passed explicitly."""
    monkeypatch.delenv("MAUVE_TP_WORKERS", raising=False)
    monkeypatch.setattr(tp, "tree_progressive_align",
                        functools.partial(tp.tree_progressive_align, max_workers=4))
    return _port_run(genomes, mesh)


@pytest.fixture(scope="module")
def pooled_unmeshed(family):
    with pytest.MonkeyPatch.context() as mp:
        return _pooled(family[0], None, mp)


def test_pooled_ladder_matches_jax_serial(family, pooled_unmeshed):
    """max_workers=4, no mesh: byte-identical to the JAX package's serial
    XMFA, through the pool."""
    xmfa, phases, _ = pooled_unmeshed
    assert xmfa == family[1]
    assert "tree_progressive/pool" in phases


def test_pooled_ladder_under_mesh_matches_jax_serial(family, pooled_unmeshed, monkeypatch):
    """max_workers=4 under an ambient 8-shard CPU mesh: the JAX package's
    serial XMFA, and every forward batch of the unmeshed run split over
    the 8 shards with torch.tensor_split's sizes, the workers' batches too
    (the caller's thread-local mesh is carried into each task)."""
    xmfa, phases, batches = _pooled(family[0], make_mesh(8, device="cpu"), monkeypatch)
    assert xmfa == family[1]
    assert "tree_progressive/pool" in phases
    split = sorted(len(p) for B in pooled_unmeshed[2]
                   for p in torch.tensor_split(torch.arange(B), 8) if len(p))
    assert batches == split


def test_env_default_opens_the_pool(family, monkeypatch):
    """MAUVE_TP_WORKERS=4 with max_workers left None: the pool runs and the
    XMFA is the JAX package's serial one."""
    genomes, want = family
    monkeypatch.setenv("MAUVE_TP_WORKERS", "4")
    got, phases, _ = _port_run(genomes, None)
    assert got == want
    assert "tree_progressive/pool" in phases


def test_pool_reraises_a_merge_error(family, monkeypatch):
    """An error inside a pooled merge reaches the caller."""
    genomes, _ = family

    def boom(*args, **kwargs):
        raise RuntimeError("merge failed")

    monkeypatch.setattr(tp, "merge_profiles", boom)

    with pytest.raises(RuntimeError, match="merge failed"):
        tp.tree_progressive_align(genomes[:4], parse_newick("((0:1,1:1):1,(2:1,3:1):1);"),
                                  lambda: None, max_workers=4)


def test_launch_counts_are_thread_safe():
    """count_launch and record_shape from more threads than cores, with the
    interpreter switching threads as often as it can, lose nothing."""
    gotoh_cuda.reset_launches()
    n, per = 16, 5000

    def work():
        for _ in range(per):
            gotoh_cuda.count_launch("gotoh_traceback")
            gotoh_cuda.record_shape(kernel="gotoh_forward_codes", M=1, N=1, B=1)

    threads = [threading.Thread(target=work) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert gotoh_cuda.LAUNCHES["gotoh_traceback"] == n * per
    assert len(gotoh_cuda.LAUNCH_SHAPES) == n * per
    gotoh_cuda.reset_launches()
    assert gotoh_cuda.LAUNCHES["gotoh_traceback"] == 0 and gotoh_cuda.LAUNCH_SHAPES == []


def test_first_build_raced_by_threads_builds_once(monkeypatch, tmp_path):
    """Two threads calling _build.library() at once compile the library
    once and load the same handle."""
    compiled = []
    so = str(tmp_path / "lib.so")

    def fake_compile(path):
        compiled.append(path)
        open(path, "w").close()

    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_library_path", lambda: so)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build, "_bind", lambda lib: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    start = threading.Barrier(2)
    got = []

    def call():
        start.wait()
        got.append(_build.library())

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert compiled == [so]
    assert len(got) == 2 and got[0] is got[1]


def test_headline_golden_and_comparator_agree():
    """make_port_golden's enterobacteria golden (the headline's, at 4 x 30
    kbp) and chip_smoke.py's digest of the port's CPU run of the same
    genomes agree in every field the headline phase holds; a missing key
    fails the comparator."""
    import chip_smoke
    import make_port_golden

    golden = make_port_golden.enterobacteria_golden(30_000, 4, "tiny headline",
                                                    "tiny.xmfa.bbcols")
    genomes, truths = port_simulate.enterobacteria_like(30_000, 4, 0.08)
    assert golden["genome_sha256"] == chip_smoke.digest.genome_sha256(genomes)
    timing.GLOBAL.reset()
    res = TorchProgressive(TorchOptions(use_sml_cache=False, device="cpu")).align(genomes)
    branch = "tree" if "tree_progressive" in timing.GLOBAL.phases else "extant"
    got = chip_smoke.enterobacteria_digest(res, branch, genomes, truths, golden["bbcols_name"])
    chip_smoke.hold("tiny headline", got, golden, chip_smoke.HEADLINE_KEYS)
    assert golden["jax_cpu_seconds"] > 0
    assert len(golden["accuracy"]) == 3
    with pytest.raises(SystemExit, match="n_anchors missing from the golden"):
        chip_smoke.hold("tiny headline", got, {k: v for k, v in golden.items()
                                               if k != "n_anchors"}, chip_smoke.HEADLINE_KEYS)
    with pytest.raises(SystemExit, match="n_lcbs"):
        chip_smoke.hold("tiny headline", {**got, "n_lcbs": got["n_lcbs"] + 1}, golden,
                        chip_smoke.HEADLINE_KEYS)


def test_chromosome_is_4606000_bp():
    """The chip check's whole chromosome: planted_repeats(20), 30,000*20 +
    8*(600 + 20,000*20) + 4*(300 + 10,000*20) bases."""
    g = port_simulate.planted_repeats(20)
    assert len(g) == 4_606_000 == 30_000 * 20 + 8 * (600 + 20_000 * 20) + 4 * (300 + 10_000 * 20)
