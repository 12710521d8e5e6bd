"""K2 kernel: the maximal extension of the multi-MUM candidates on the card.

extend_matches_kernel (csrc/extend.cu, design and bound noted there)
replaces no TPU kernel: the JAX package extends on the host, and the kernel
replaces the port's host loop native/mauve_native.cpp::extend_matches on the
device path of matchops.find_multi_mums_device.  extend_matches_torch is its
plain-torch version, a chunked, vectorised port of the NumPy fallback of
matchops.extend_matches_maximal.  Both take the genomes as one padded buffer
(genome_buffer), laid end to end from each genome's padded codes, which are
uploaded once per genome and device and kept beside the genome while it
lives.

Dispatch: a CUDA tensor launches the kernel (or raises); a CPU tensor runs
the plain version.  LAUNCHES counts the kernel's launches (plain-version
calls are not counted); the tree ladder's pool launches from several
threads, so it is updated under a lock.
"""

from __future__ import annotations

import threading
import weakref
from typing import Sequence, Tuple

import numpy as np
import torch

from mauvealigner_tpu_torch.genome.sequence import CODE_N, Genome
from mauvealigner_tpu_torch.ops import _build
from mauvealigner_tpu_torch.ops._build import check_tensor, ptr, raise_on_error, stream

# bytes of CODE_N before and after every genome in the buffer: the kernel
# reads 16-base windows in aligned words, up to 19 bytes past a genome's end
PAD = 32
# the plain version's tile: columns read per walk step, rows per pass
_PLAIN_COLS = 64
_PLAIN_ROWS = 4096
LAUNCHES = 0
_launch_lock = threading.Lock()
# per genome, {device: its padded codes there}; an entry goes with its genome
_padded: "weakref.WeakKeyDictionary[Genome, dict]" = weakref.WeakKeyDictionary()
_padded_lock = threading.Lock()


def reset_launches() -> None:
    global LAUNCHES
    with _launch_lock:
        LAUNCHES = 0


def padded_codes(codes: np.ndarray) -> np.ndarray:
    """PAD bytes of CODE_N, `codes`, then CODE_N up to a multiple of 16 bytes
    and PAD more: pieces laid end to end keep every genome on a 16-byte
    boundary with PAD bytes of CODE_N on either side."""
    out = np.full(PAD + (len(codes) + 15) // 16 * 16 + PAD, CODE_N, np.uint8)
    out[PAD: PAD + len(codes)] = codes
    return out


def _device_padded(genome: Genome, device: torch.device) -> torch.Tensor:
    """padded_codes of `genome` on `device`, uploaded on first use."""
    with _padded_lock:
        held = _padded.setdefault(genome, {})
        t = held.get(device)
        if t is None:
            t = held[device] = torch.from_numpy(padded_codes(genome.codes)).to(device)
    return t


def genome_buffer(genomes: Sequence[Genome], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The genomes' codes in one uint8 tensor on `device`, each starting on a
    16-byte boundary with at least PAD bytes of CODE_N before and after it,
    and its layout, int64 [n_seqs, 2] {offset, length} on `device`."""
    device = torch.device(device)
    pieces = [_device_padded(g, device) for g in genomes]
    sizes = np.array([p.shape[0] for p in pieces], np.int64)
    offsets = PAD + np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    layout = np.stack([offsets, [len(g) for g in genomes]], axis=1).astype(np.int64)
    codes = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return codes, torch.from_numpy(layout).to(device)


def extend_matches(
    starts: torch.Tensor,   # int64 [R, n_seqs] signed 1-based, 0 = absent
    lengths: torch.Tensor,  # int64 [R]
    genomes: Sequence[Genome],  # one per column
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every row grown to base-level maximality, row for row: (starts,
    lengths) as native extend_matches computes them, on the rows' device."""
    if len(genomes) != starts.shape[1]:
        raise ValueError(f"{starts.shape[1]} columns but {len(genomes)} genomes")
    if starts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no extension kernel for device {starts.device}")
    codes, layout = genome_buffer(genomes, starts.device)
    if starts.device.type == "cpu":
        return extend_matches_torch(starts, lengths, codes, layout)
    return _extend_launch(starts, lengths, codes, layout)


def _extend_launch(starts, lengths, codes, layout):
    """The CUDA half of extend_matches: checks, allocation and the launch,
    on the inputs' device made current."""
    global LAUNCHES
    R, n = starts.shape
    dev = starts.device
    check_tensor(starts, "starts", torch.int64, (R, n), dev)
    check_tensor(lengths, "lengths", torch.int64, (R,), dev)
    check_tensor(codes, "codes", torch.uint8, (codes.shape[0],), dev)
    check_tensor(layout, "layout", torch.int64, (n, 2), dev)
    if codes.data_ptr() % 16:
        raise ValueError("codes must start on a 16-byte boundary")
    out_starts = torch.empty_like(starts)
    out_lengths = torch.empty_like(lengths)
    if R == 0:
        return out_starts, out_lengths
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.extend_matches_launch(
            ptr(codes), ptr(layout), ptr(starts), ptr(lengths), R, n, ptr(out_starts),
            ptr(out_lengths), stream(dev),
        )
    raise_on_error(lib, err, "extend_matches")
    with _launch_lock:
        LAUNCHES += 1
    return out_starts, out_lengths


def extend_matches_torch(
    starts: torch.Tensor, lengths: torch.Tensor, codes: torch.Tensor, layout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """extend_matches in plain torch on any device, over genome_buffer's
    codes and layout: each walk (right, then left, in match space) reads
    _PLAIN_COLS columns of _PLAIN_ROWS rows at a time, and a row walks on
    while all of them agreed."""
    R = starts.shape[0]
    dev = starts.device
    offset, size = layout[:, 0, None], layout[:, 1, None]
    cols = torch.arange(_PLAIN_COLS, device=dev)
    present = starts != 0
    fwd = starts > 0
    left0 = starts.abs() - 1
    ref_col = present.to(torch.int8).argmax(1)  # the first present component
    grown = []
    for right in (True, False):
        up = fwd == right  # the walk runs up the genome
        first = torch.where(up, left0 + lengths[:, None], left0 - 1)
        step = torch.where(up, 1, -1)
        ext = torch.zeros(R, dtype=torch.int64, device=dev)
        todo = torch.arange(R, device=dev)
        while todo.numel():
            more = []
            for blk in todo.split(_PLAIN_ROWS):
                pos = first[blk, :, None] + step[blk, :, None] * (ext[blk, None, None] + cols)
                inside = present[blk, :, None] & (pos >= 0) & (pos < size)
                base = codes[torch.where(inside, offset + pos, 0)]
                base = torch.where(fwd[blk, :, None], base, base ^ 3)  # codes >= 4 stay >= 4
                base = torch.where(inside, base, 255)
                ref = base[torch.arange(len(blk), device=dev), ref_col[blk]]
                agree = (ref < 4) & ((base == ref[:, None]) | ~present[blk, :, None]).all(1)
                run = agree.to(torch.int64).cumprod(1).sum(1)
                ext[blk] += run
                more.append(blk[run == _PLAIN_COLS])
            todo = torch.cat(more)
        grown.append(ext)
    r_ext, l_ext = grown
    out = torch.where(fwd, starts - l_ext[:, None], torch.where(starts < 0, starts + r_ext[:, None],
                                                                starts))
    return out, lengths + r_ext + l_ext
