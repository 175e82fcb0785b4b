"""Multi-GPU execution on ``torch.distributed`` (port of
``manifold_gp_tpu.parallel``): one process per GPU.

  * ``mesh``: the process mesh and the sharding context with its two roles:
    rows (the row-sharded reductions and autograd pair of the mesh kernels)
    and probes (a single-device model's probe columns split over the ranks
    under a user's ``use_mesh``);
  * ``spmv``: the row-sharded ELL gather scan (no kernel);
  * ``block_spmv``: the row-sharded fused block-ELL path on the port's
    CUDA kernels (K1/K2 forward, K3 panel cotangent) per shard;
  * ``knn``: the exact kNN search (replicated or ring database), the graph
    build and the IVF search with the query rows sharded over the ranks.
"""

from .mesh import (
    Mesh,
    ShardingContext,
    active_context,
    constrain_nodes,
    constrain_probes,
    init_distributed,
    make_mesh,
    use_mesh,
)
from .knn import build_graph_sharded, sharded_ivf_search, sharded_knn_search
from .spmv import (
    make_sharded_matern_precision_matvec,
    pad_nodes,
    shard_graph_rows,
    sharded_adjacency_matvec,
)

__all__ = [
    "build_graph_sharded",
    "sharded_ivf_search",
    "sharded_knn_search",
    "make_sharded_matern_precision_matvec",
    "pad_nodes",
    "ShardingContext",
    "init_distributed",
    "active_context",
    "constrain_nodes",
    "constrain_probes",
    "make_mesh",
    "use_mesh",
    "sharded_adjacency_matvec",
    "shard_graph_rows",
    "Mesh",
]
