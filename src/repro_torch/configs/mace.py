"""MACE [arXiv:2206.07697; paper]: 2 layers, d_hidden (channels) 128,
l_max 2, correlation order 3, 8 radial Bessel functions, E(3)-equivariant
higher-order (ACE) message passing.

Non-geometric shapes (citation graphs) synthesize 3D positions in
input_specs -- MACE consumes (positions, species, edges) on every shape."""

from repro_torch.configs.base import ArchSpec, GNNConfig

CONFIG = GNNConfig(
    name="mace",
    kind="mace",
    n_layers=2,
    d_hidden=128,
    extra={
        "l_max": 2,
        "correlation_order": 3,
        "n_rbf": 8,
        "n_species": 10,
        "r_cut": 5.0,
    },
)

SPEC = ArchSpec(
    arch_id="mace",
    family="gnn",
    config=CONFIG,
    shape_names=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
    source="arXiv:2206.07697",
)
