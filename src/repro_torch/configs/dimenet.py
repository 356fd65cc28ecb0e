"""DimeNet [arXiv:2003.03123; unverified]: 6 interaction blocks, d_hidden 128,
8 bilinear channels, 7 spherical x 6 radial basis functions, directional
(triplet) message passing.

Triplet index lists are padded to a static budget derived from the shape
(n_edges * avg_fanout capped; see launch.input_specs)."""

from repro_torch.configs.base import ArchSpec, GNNConfig

CONFIG = GNNConfig(
    name="dimenet",
    kind="dimenet",
    n_layers=6,
    d_hidden=128,
    extra={"n_bilinear": 8, "n_spherical": 7, "n_radial": 6, "r_cut": 5.0},
)

SPEC = ArchSpec(
    arch_id="dimenet",
    family="gnn",
    config=CONFIG,
    shape_names=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
    source="arXiv:2003.03123",
)
