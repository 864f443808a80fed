"""The multi-device layer on ``torch.distributed`` (counterpart of
``efficient_gnns_tpu/parallel``): a mesh of ranks, edge-partitioned and halo
SpMM on K1, ring GSP / NCE, the row-sharded node trainer
(``parallel.sharded_trainer``), the tensor-parallel SIGN step
(``parallel.tensor``), and the launcher that starts a world of ranks
(``launch.run_world``, the counterpart of the JAX tests' virtual CPU mesh).
``parallel/dryrun.py`` drives every path once. The trainer and SIGN modules
import the model zoo, whose layers import ``parallel.collectives``, so they
are imported by name, not from here."""

from efficient_gnns_tpu_torch.parallel.launch import run_world
from efficient_gnns_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    replicate,
    shard_cols,
    shard_rows,
)
from efficient_gnns_tpu_torch.parallel.partition import (
    PartitionedGraph,
    ShardedGraph,
    local_partition,
    partition_graph,
    shard_graph,
    spmm_sharded,
)
from efficient_gnns_tpu_torch.parallel.ring import ring_gsp_term, ring_nce_term

__all__ = [
    "make_mesh",
    "replicate",
    "shard_rows",
    "PartitionedGraph",
    "partition_graph",
    "spmm_sharded",
    "ring_gsp_term",
    "ring_nce_term",
    "Mesh",
    "local_partition",
    "run_world",
    "shard_cols",
    "ShardedGraph",
    "shard_graph",
]
