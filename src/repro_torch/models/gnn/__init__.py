"""GNN architectures over segment-sum message passing
(``repro.models.gnn`` counterpart): every sum of every aggregation runs
through the hand-written CUDA segment-sum kernel on a card.

  message_passing -- destination-sorted edges, segment reductions, MLP, and
                     ``GraphShard`` (a rank's share of a graph on a mesh)
  pna, meshgraphnet, mace, dimenet -- the four published architectures
  e3       -- real spherical harmonics and Gaunt couplings (MACE)
  halo_pna -- PNA on the ranks of a partition mesh, one all-to-all a layer
"""

from repro_torch.models.gnn.dimenet import DimeNet, build_triplets
from repro_torch.models.gnn.mace import MACE
from repro_torch.models.gnn.meshgraphnet import MeshGraphNet
from repro_torch.models.gnn.message_passing import GraphShard, SortedEdges, sort_edges
from repro_torch.models.gnn.pna import PNA

__all__ = ["DimeNet", "GraphShard", "MACE", "MeshGraphNet", "PNA", "SortedEdges",
           "build_triplets", "sort_edges"]
