"""Multi-GPU execution on ``torch.distributed`` (port of
``manifold_gp_tpu.parallel``): one process per GPU, vectors row-sharded
over the ranks.

  * ``mesh``: the process mesh, the sharding context and the row-sharded
    reductions and autograd pair;
  * ``spmv``: the row-sharded ELL gather scan (no kernel);
  * ``block_spmv``: the row-sharded fused block-ELL path on the port's
    CUDA kernels (K1/K2 forward, K3 panel cotangent) per shard.

Not ported yet (ROADMAP, "Sharded kNN and probe-axis sharding"): the
sharded exact and IVF searches of ``parallel/knn.py``; their three names
raise ``NotImplementedError``.
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
from .spmv import (
    make_sharded_matern_precision_matvec,
    pad_nodes,
    shard_graph_rows,
    sharded_adjacency_matvec,
)


def _sharded_search(name: str):
    def missing(*args, **kwargs):
        raise NotImplementedError(
            f"{name}: the sharded kNN search is not ported yet (ROADMAP, "
            "'Sharded kNN and probe-axis sharding'); build the graph on one device "
            "(ops.graph.build_graph) and pass it to the mesh kernel as graph=")

    missing.__name__ = name
    return missing


build_graph_sharded = _sharded_search("build_graph_sharded")
sharded_ivf_search = _sharded_search("sharded_ivf_search")
sharded_knn_search = _sharded_search("sharded_knn_search")

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
