"""Record config 1's reference outputs for the PyTorch port's chip check.

Runs the JAX package on the CPU over config 1's genomes (bench.py: two
1 Mbp genomes about 1% apart, seed 37) and writes
mauvealigner_tpu_torch/data/config1_golden.json: the sha256 of both
genomes' code arrays, the LCB / anchor / aligned-column counts, and the
sha256 of the XMFA text.  chip_smoke.py holds the port to these values.

Usage:  JAX_PLATFORMS=cpu python scripts/make_port_golden.py [--out PATH]
"""

import argparse
import hashlib
import io
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from mauvealigner_tpu.models.aligner import AlignerOptions, MauveAligner  # noqa: E402
from mauvealigner_tpu.utils import simulate  # noqa: E402

GENOME_SIZE = 1_000_000
SEED = 37


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--out",
        default=os.path.join(
            os.path.dirname(__file__), "..", "mauvealigner_tpu_torch", "data",
            "config1_golden.json",
        ),
    )
    a = p.parse_args()
    rng = np.random.default_rng(SEED)
    anc = simulate.random_genome(rng, GENOME_SIZE)
    der, _ = simulate.evolve(anc, rng, sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005)
    t0 = time.perf_counter()
    res = MauveAligner(AlignerOptions(use_sml_cache=False)).align([anc, der])
    seconds = time.perf_counter() - t0
    buf = io.StringIO()
    res.interval_list.write_xmfa(buf)
    xmfa = buf.getvalue().encode()
    golden = {
        "config": "bench.py config 1: seed 37, random_genome(1_000_000), "
        "evolve(sub_rate=0.01, ins_rate=0.0005, del_rate=0.0005), "
        "AlignerOptions(use_sml_cache=False)",
        "reference": "mauvealigner_tpu (JAX) on the CPU",
        "genome_sha256": [
            hashlib.sha256(np.ascontiguousarray(g.codes).tobytes()).hexdigest()
            for g in (anc, der)
        ],
        "genome_lengths": [len(anc), len(der)],
        "n_lcbs": len(res.lcbs),
        "n_anchors": len(res.mums),
        "aligned_columns": int(sum(iv.n_cols for iv in res.interval_list.intervals)),
        "xmfa_sha256": hashlib.sha256(xmfa).hexdigest(),
        "xmfa_bytes": len(xmfa),
    }
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as fh:
        json.dump(golden, fh, indent=1)
        fh.write("\n")
    print(json.dumps(golden))
    print(f"reference run took {seconds:.1f} s on the CPU", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
