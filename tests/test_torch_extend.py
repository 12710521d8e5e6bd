"""K2 maximal extension on the card (ops/extend_cuda.py, csrc/extend.cu)
and the torch decode and dedup around it (ops/matchops.py), against the
host path they replace: decode_mum_table, native extend_matches (through
extend_matches_maximal) and MatchList.dedup.  Everything is integers, so
every comparison is exact, row for row and in order.

The CPU tests hold the plain-torch extension and the kernel's own source,
built with g++ against tests/cuda_cpu_emulation.h, to the native loop and
to the JAX package's extend_matches_maximal, and the torch decode and dedup
to the JAX package's decode_mum_table and MatchList.dedup besides.  The
tests marked gpu need an NVIDIA GPU and skip without one; they touch
neither jax nor the JAX package (only the CPU tests import it, inside
_jax), so on a machine with only torch:

    python -m pytest --noconftest tests/test_torch_extend.py -m gpu
"""

import ctypes
import gc
import os
import re
import shutil
import subprocess
import weakref

import numpy as np
import pytest
import torch

from benchmark.traffic import generate
from mauvealigner_tpu_torch import native
from mauvealigner_tpu_torch.core.match import MatchList
from mauvealigner_tpu_torch.core.sml import build_mer_list_device
from mauvealigner_tpu_torch.genome.sequence import Genome
from mauvealigner_tpu_torch.ops import _build, extend_cuda, matchops
from mauvealigner_tpu_torch.seeds import default_mer_size, get_seed
from mauvealigner_tpu_torch.utils import timing

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
BRANCHES = [{"sub": 0.01, "indel": 0.001, "inversions": 0},
            {"sub": 0.02, "indel": 0.001, "inversions": 1}]


def _genomes(seed: int, n: int, k: int):
    """k generator genomes of about n bases (the three-way cell's recipe)."""
    seqs, _ = generate.make_descendants(np.random.default_rng(seed), n, BRANCHES[: k - 1])
    return [Genome(s) for s in seqs]


def _search(genomes, device="cpu"):
    seed = get_seed(default_mer_size(int(np.mean([len(g) for g in genomes]))))
    smls = [build_mer_list_device(g, seed, device) for g in genomes]
    return smls, seed


def _candidates(genomes):
    """The search's decoded candidate rows (before extension), host."""
    smls, seed = _search(genomes)
    keys, seq_ids, pos = matchops._concat_device_smls(smls)
    k = len(genomes)
    head, cap = matchops._candidate_head(keys, seq_ids, pos, torch.ones(k, dtype=torch.int32),
                                         k, 1 << 14, 2, fetch=True)
    return matchops.decode_mum_table(head, k, cap, seed.length)


def _case(k: int):
    """Genomes, candidate rows and the index of the first planted row.  The
    rows cover what the walk must handle: the search's own rows (reverse
    components from the inversion), for three genomes the same rows with a
    component taken out (start 0), and four planted rows with the middle
    genome absent: one that grows to base 1 of both sequences, two that pair
    genome 0's head with the last genome's reverse-complemented tail (up to
    both sequence ends), and one that runs into a run of N."""
    genomes = _genomes(3190000111 + k, 6000, k)
    ml = _candidates(genomes)
    codes = [g.codes.copy() for g in genomes]
    first, last = codes[0], codes[-1]
    n0, nl = len(first), len(last)
    last[:300] = first[:300]
    last[-300:] = np.where(first[:300] < 4, 3 - first[:300], 4)[::-1]
    last[1000:1400] = first[1000:1400]
    first[1200:1225] = 4
    planted = np.zeros((4, k), np.int64)
    planted[:, 0] = [101, 1, 150, 1101]
    planted[:, -1] = [101, -(nl - 29), -(nl - 168), 1101]
    starts = [ml.starts, planted]
    lengths = [ml.lengths, [20, 30, 20, 20]]
    if k > 2:
        dropped = ml.starts[::7].copy()
        dropped[:, 1] = 0
        starts.append(dropped)
        lengths.append(ml.lengths[::7])
    return codes, MatchList(np.concatenate(starts), np.concatenate(lengths)), len(ml)


def _native(codes, ml):
    assert native.get() is not None, "the native module must build for this reference"
    return matchops.extend_matches_maximal(ml, codes, dedup=False)


def _jax():
    """The JAX package's match ops and MatchList, imported on use so that
    the gpu cases run without JAX."""
    from mauvealigner_tpu.core.match import MatchList as JaxMatchList
    from mauvealigner_tpu.ops import matchops as jax_matchops

    return jax_matchops, JaxMatchList


def _jax_extended(codes, ml):
    """The JAX package's extend_matches_maximal on the same rows, row for row."""
    jax_matchops, JaxMatchList = _jax()
    return jax_matchops.extend_matches_maximal(
        JaxMatchList(ml.starts.copy(), ml.lengths.copy()), codes, dedup=False)


def _as_genomes(codes):
    return [Genome.from_codes(c) for c in codes]


@pytest.mark.parametrize("k", [2, 3])
def test_torch_extension_matches_native(k):
    codes, ml, p = _case(k)
    want = _native(codes, ml)
    reference = _jax_extended(codes, ml)
    assert np.array_equal(reference.starts, want.starts)
    assert np.array_equal(reference.lengths, want.lengths)
    starts, lengths = extend_cuda.extend_matches(
        torch.from_numpy(ml.starts), torch.from_numpy(ml.lengths), _as_genomes(codes))
    assert np.array_equal(starts.numpy(), want.starts)
    assert np.array_equal(lengths.numpy(), want.lengths)
    # the planted rows reach what they were planted for
    nl = len(codes[-1])
    assert list(want.starts[p, [0, -1]]) == [1, 1]
    for r in (p + 1, p + 2):
        assert want.starts[r, 0] == 1 and want.lengths[r] >= 300
        assert -want.starts[r, -1] - 1 + want.lengths[r] == nl
    assert want.starts[p + 3, 0] - 1 + want.lengths[p + 3] == 1200
    assert (want.starts[p:p + 4, 1:-1] == 0).all()
    assert (want.lengths > ml.lengths).mean() > 0.5


@pytest.mark.parametrize("k", [2, 3])
def test_decode_matches_host(k):
    """A real table, and a made one with a row the `ok` filter drops (no
    span), a row with its span reversed, and reverse components that slide
    by the run length."""
    genomes = _genomes(3190000201, 5000, k)
    smls, seed = _search(genomes)
    keys, seq_ids, pos = matchops._concat_device_smls(smls)
    head, cap = matchops._candidate_head(keys, seq_ids, pos, torch.ones(k, dtype=torch.int32),
                                         k, 1 << 14, 2, fetch=False)
    made = np.zeros((5, k + 2), np.int32)
    made[0, 0] = 4
    made[1, :2], made[1, k:] = (7, -40), (3, 9)
    made[2, :2], made[2, k:] = (8, 9), (-1, -1)
    made[3, :2], made[3, k:] = (-12, 30), (5, 4)
    made[4, :2], made[4, k:] = (-3, -50), (0, 0)
    jax_matchops, _ = _jax()
    for table in (head, torch.from_numpy(made)):
        want = matchops.decode_mum_table(table.numpy(), k, 1 << 14, seed.length)
        reference = jax_matchops.decode_mum_table(table.numpy(), k, 1 << 14, seed.length)
        starts, lengths = matchops.decode_mum_rows(table, k, seed.length)
        for rows in (want, reference):
            assert np.array_equal(starts.numpy(), rows.starts)
            assert np.array_equal(lengths.numpy(), rows.lengths)
    assert len(matchops.decode_mum_rows(torch.from_numpy(made), k, 11)[1]) == 2


@pytest.mark.parametrize("n,k,spread", [(1, 2, 3), (40, 2, 4), (3000, 3, 5), (20000, 9, 2)])
def test_dedup_matches_host(n, k, spread):
    """Rows drawn from a few values, so duplicates lie far apart; every
    distinct row keeps its first occurrence, in the original order."""
    rng = np.random.default_rng(n)
    starts = rng.integers(-spread, spread + 1, size=(n, k)).astype(np.int64)
    lengths = rng.integers(10, 10 + spread, size=n).astype(np.int64)
    want = MatchList(starts, lengths).dedup()
    reference = _jax()[1](starts, lengths).dedup()
    keep = matchops.dedup_rows(torch.from_numpy(np.concatenate([starts, lengths[:, None]], 1)))
    for rows in (want, reference):
        assert np.array_equal(starts[keep.numpy()], rows.starts)
        assert np.array_equal(lengths[keep.numpy()], rows.lengths)


def test_host_path_counts_rows():
    """On the CPU the search keeps the host path and counts the rows it
    hands the extension; only the card's path counts device rows."""
    genomes = _genomes(3190000301, 5000, 2)
    smls, seed = _search(genomes)
    timing.GLOBAL.reset()
    got = matchops.find_multi_mums_device(genomes, smls, seed_length=seed.length)
    want = _native([g.codes for g in genomes], _candidates(genomes)).dedup()
    assert np.array_equal(got.starts, want.starts) and np.array_equal(got.lengths, want.lengths)
    assert timing.GLOBAL.counters["k2_extend_rows"] == len(_candidates(genomes))
    assert "k2_extend_rows_device" not in timing.GLOBAL.counters


def test_launch_checks_inputs():
    two = _as_genomes([np.zeros(10, np.uint8)] * 2)
    codes, layout = extend_cuda.genome_buffer(two, "cpu")
    with pytest.raises(TypeError):
        extend_cuda._extend_launch(torch.ones((3, 2), dtype=torch.int32),
                                   torch.ones(3, dtype=torch.int64), codes, layout)
    with pytest.raises(ValueError):
        extend_cuda._extend_launch(torch.ones((3, 2), dtype=torch.int64),
                                   torch.ones(3, dtype=torch.int64), codes, layout[:1])
    with pytest.raises(ValueError):
        extend_cuda.extend_matches(torch.ones((3, 3), dtype=torch.int64),
                                   torch.ones(3, dtype=torch.int64), two)


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 1, 0), (2,)])
def test_genome_buffer_layout(order):
    """Any set of the genomes, in any order, is laid out on 16-byte
    boundaries with CODE_N around each, from one upload per genome."""
    sizes = (1, 17, 32, 5)
    genomes = _as_genomes([np.full(n, j, np.uint8) for j, n in enumerate(sizes)])
    extend_cuda.genome_buffer(genomes, "cpu")
    held = [extend_cuda._device_padded(g, torch.device("cpu")) for g in genomes]
    chosen = [genomes[j] for j in order]
    codes, layout = extend_cuda.genome_buffer(chosen, "cpu")
    assert all(extend_cuda._device_padded(g, torch.device("cpu")) is t
               for g, t in zip(genomes, held))
    codes, layout = codes.numpy(), layout.numpy()
    assert (layout[:, 0] % 16 == 0).all() and (layout[:, 1] == [sizes[j] for j in order]).all()
    marks = np.zeros(len(codes), bool)
    for j, (off, n) in zip(order, layout):
        assert (codes[off - extend_cuda.PAD: off] == 4).all()
        assert (codes[off + n: off + n + extend_cuda.PAD] == 4).all()
        assert (codes[off: off + n] == j).all()
        marks[off: off + n] = True
    assert (codes[~marks] == 4).all()


def test_padded_codes_go_with_their_genome():
    genome = _as_genomes([np.zeros(40, np.uint8)])[0]
    extend_cuda.genome_buffer([genome], "cpu")
    assert genome in extend_cuda._padded
    held, alive = len(extend_cuda._padded), weakref.ref(genome)
    del genome
    gc.collect()
    assert alive() is None and len(extend_cuda._padded) == held - 1


# -- the kernel's own source on the CPU ---------------------------------------


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/extend.cu built with g++ against the CPU emulation, bound as the
    CUDA library is."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the CPU emulation of the CUDA source")
    with open(os.path.join(_build.CSRC, "extend.cu")) as fh:
        src = fh.read().replace("#include <cuda_runtime.h>", '#include "cuda_cpu_emulation.h"')
    src, n = re.subn(r"([\w<>]+?)<<<([^,]+), ([^,]+), ([^,]+), ([^>]+)>>>\(",
                     r"EmuLaunch(\2, \3, \4).run(\1, ", src)
    assert n == 1
    out = tmp_path_factory.mktemp("extend_emulated")
    cpp = out / "extend_emulated.cpp"
    cpp.write_text(src)
    so = out / "libextend_emulated.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", HERE,
                    "-o", str(so), str(cpp)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    _build._bind_extend(lib)
    return lib


def _emulated_launch(lib, codes, ml):
    buf, layout = (t.numpy() for t in extend_cuda.genome_buffer(_as_genomes(codes), "cpu"))
    starts = np.ascontiguousarray(ml.starts)
    lengths = np.ascontiguousarray(ml.lengths)
    out_s = np.full_like(starts, 0x5A5A)
    out_l = np.full_like(lengths, 0x5A5A)
    p = lambda a: ctypes.c_void_p(a.ctypes.data)  # noqa: E731
    err = lib.extend_matches_launch(p(buf), p(layout), p(starts), p(lengths), len(lengths),
                                    starts.shape[1], p(out_s), p(out_l), None)
    assert err == 0
    return out_s, out_l


@pytest.mark.parametrize("k", [2, 3])
def test_emulated_kernel_matches_native(emulated, k):
    codes, ml, _ = _case(k)
    # an odd row count leaves the last warp's lanes partly idle
    ml = ml.select(np.arange(len(ml) - (len(ml) % 2 == 0)))
    want = _native(codes, ml)
    reference = _jax_extended(codes, ml)
    out_s, out_l = _emulated_launch(emulated, codes, ml)
    assert np.array_equal(out_s, want.starts) and np.array_equal(out_l, want.lengths)
    assert np.array_equal(out_s, reference.starts) and np.array_equal(out_l, reference.lengths)


def test_emulated_kernel_nine_genomes(emulated):
    """Nine components, some absent, one row with none (it must not move)."""
    genomes = _genomes(3190000401, 3000, 3)
    seqs = [g.codes for g in genomes] * 3
    base = _candidates(genomes)
    starts = np.concatenate([base.starts] * 3, axis=1)
    starts[::3, 4] = 0
    starts[1::5, 7] = 0
    starts[0] = 0
    ml = MatchList(starts, base.lengths)
    want = _native(seqs, ml)
    reference = _jax_extended(seqs, ml)
    out_s, out_l = _emulated_launch(emulated, seqs, ml)
    assert np.array_equal(out_s, want.starts) and np.array_equal(out_l, want.lengths)
    assert np.array_equal(out_s, reference.starts) and np.array_equal(out_l, reference.lengths)
    assert out_l[0] == ml.lengths[0]


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 3])
def test_kernel_matches_plain_and_native(cuda_device, k):
    """1 Mbp genomes from the benchmark's generator: the kernel, the plain
    version on the card and the native loop agree row for row."""
    genomes = _genomes(3190000111, 1_000_000, k)
    ml = _candidates(genomes)
    codes = [g.codes for g in genomes]
    starts = torch.from_numpy(ml.starts).to(cuda_device)
    lengths = torch.from_numpy(ml.lengths).to(cuda_device)
    before = extend_cuda.LAUNCHES
    s_k, l_k = extend_cuda.extend_matches(starts, lengths, genomes)
    buf, layout = extend_cuda.genome_buffer(genomes, cuda_device)
    s_p, l_p = extend_cuda.extend_matches_torch(starts, lengths, buf, layout)
    torch.cuda.synchronize()
    assert extend_cuda.LAUNCHES == before + 1
    want = _native(codes, ml)
    assert torch.equal(s_k, s_p) and torch.equal(l_k, l_p)
    assert np.array_equal(s_k.cpu().numpy(), want.starts)
    assert np.array_equal(l_k.cpu().numpy(), want.lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("k,initial_cap", [(2, None), (3, None), (3, 64)])
def test_search_on_card_equals_host(cuda_device, k, initial_cap):
    """find_multi_mums_device on the card returns the host path's MatchList,
    rows and order, through the kernel (also when the cap retry runs)."""
    genomes = _genomes(3190000501, 200_000, k)
    got = {}
    for dev in ("cpu", cuda_device):
        smls, seed = _search(genomes, dev)
        timing.GLOBAL.reset()
        before = extend_cuda.LAUNCHES
        got[str(dev)] = matchops.find_multi_mums_device(
            genomes, smls, seed_length=seed.length, initial_cap=initial_cap)
        launched = extend_cuda.LAUNCHES - before
        counters = dict(timing.GLOBAL.counters)
    host, card = got["cpu"], got[str(cuda_device)]
    assert np.array_equal(host.starts, card.starts) and np.array_equal(host.lengths, card.lengths)
    assert launched == 1
    assert counters["k2_extend_rows_device"] == counters["k2_extend_rows"] > 0
