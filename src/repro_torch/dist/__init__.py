"""Multi-process mesh support for the port (``repro.dist`` counterpart).

The JAX package drives every mesh device from one controller with
``shard_map``; the port runs one process per mesh rank instead, over
``torch.distributed``:

  sharding -- ``partition_mesh``: this rank's ``PartitionMesh`` (world size,
              rank, process group, ``torch.device``, backend) and its counted
              collectives, NCCL where every rank has its own card, gloo
              otherwise (which copies CUDA tensors through the host)
  launch   -- ``run_ranks``: start D rank processes on one host, each in its
              own process group rank, and collect their results; a failed or
              late rank fails the run.  ``share_graph`` / ``load_shared_graph``
              hand a graph and its edge layout to the ranks through
              memory-mapped files, so a large layout is built once.
  halo     -- boundary-exchange plans for partitioned graphs (a static
              send-index table per shard pair) and ``halo_gather``, one
              ``all_to_all`` of the planned edge cut a GNN layer.
  compression -- ``compressed_psum``: an int8-quantized sum over the mesh
              with error feedback.

``sharding`` also holds the batch axes of a mesh (``dp_axes``, ``dp_size``:
pod x data), the data-parallel gradient mean (``all_reduce_grads``), the reference's
parameter rule tables (LM, GNN, recsys), fitted to a mesh (``fit_specs``)
and applied to a module (``place``), and the autograd pairs of the model
axis and FSDP (``copy_to_model``, ``reduce_from_model``,
``gather_from_model``, ``fsdp_gather``).
"""

from repro_torch.dist.sharding import CollectiveStats, PartitionMesh, partition_mesh
from repro_torch.dist import halo
from repro_torch.dist.compression import compressed_psum
from repro_torch.dist.launch import (
    RankFailed,
    RankResults,
    load_shared_graph,
    plan_ranks,
    run_ranks,
    share_graph,
)

__all__ = [
    "halo",
    "compressed_psum",
    "CollectiveStats",
    "PartitionMesh",
    "partition_mesh",
    "RankFailed",
    "RankResults",
    "plan_ranks",
    "run_ranks",
    "share_graph",
    "load_shared_graph",
]
