"""Distribution layer: the mesh and the sharded programs.

Port of mauvealigner_tpu/parallel/ (the reference's file-based map-reduce
over seed space, src/mauveAligner.cpp:533-589, the per-LCB task split,
src/mauveAligner.cpp:723-744, and the missing MPI variant, all as work
split over a mesh of torch devices):

  * K1/K2: genome replicated, seed space sharded; the N-way anchor search
    runs as two all-to-all phases (mer hash, then signature hash) with
    local-exact grouping and run merging (sharded.py);
  * K3/K4: DP and HMM batches split over the shards of the ambient mesh
    (context.py), the analog of --realign-lcb task parallelism;
  * multi-process: the same programs over a mesh of torch.distributed
    ranks (multihost.py).
"""

from mauvealigner_tpu_torch.parallel import context, multihost
from mauvealigner_tpu_torch.parallel.context import active_mesh, shard_batched_call, use_mesh
from mauvealigner_tpu_torch.parallel.sharded import (
    Mesh,
    find_multi_mums_sharded,
    find_pair_mums_sharded,
    make_mesh,
    sharded_mum_candidate_tables,
    sharded_pack_sort,
    sharded_pair_mum_tables,
    sort_contigs_sharded,
)

__all__ = [
    "Mesh",
    "find_multi_mums_sharded",
    "find_pair_mums_sharded",
    "sharded_mum_candidate_tables",
    "sort_contigs_sharded",
    "make_mesh",
    "sharded_pack_sort",
    "sharded_pair_mum_tables",
    "multihost",
    "context",
    "active_mesh",
    "use_mesh",
    "shard_batched_call",
]
