"""MeshGraphNet [arXiv:2010.03409; unverified]: 15 message-passing layers,
d_hidden 128, sum aggregation, 2-layer MLPs, encode-process-decode."""

from repro_torch.configs.base import ArchSpec, GNNConfig

CONFIG = GNNConfig(
    name="meshgraphnet",
    kind="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    extra={"mlp_layers": 2, "d_edge_feat": 4},
)

SPEC = ArchSpec(
    arch_id="meshgraphnet",
    family="gnn",
    config=CONFIG,
    shape_names=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
    source="arXiv:2010.03409",
)
