"""PNA [arXiv:2004.05718; paper]: 4 layers, d_hidden 75,
aggregators mean/max/min/std, scalers identity/amplification/attenuation."""

from repro_torch.configs.base import ArchSpec, GNNConfig

CONFIG = GNNConfig(
    name="pna",
    kind="pna",
    n_layers=4,
    d_hidden=75,
    extra={
        "aggregators": ("mean", "max", "min", "std"),
        "scalers": ("identity", "amplification", "attenuation"),
    },
)

SPEC = ArchSpec(
    arch_id="pna",
    family="gnn",
    config=CONFIG,
    shape_names=("full_graph_sm", "minibatch_lg", "ogb_products", "molecule"),
    source="arXiv:2004.05718",
)
