"""DeepFM [arXiv:1703.04247; paper]: 39 sparse fields, embed_dim 10,
deep MLP 400-400-400, FM feature interaction.  Embedding tables are the hot
path (EmbeddingBag = take + segment_sum, sharded over the model axis)."""

from repro_torch.configs.base import ArchSpec, RecsysConfig

CONFIG = RecsysConfig(
    name="deepfm",
    n_sparse=39,
    embed_dim=10,
    mlp_dims=(400, 400, 400),
    vocab_per_field=1_000_000,
    multi_hot=1,
)

SPEC = ArchSpec(
    arch_id="deepfm",
    family="recsys",
    config=CONFIG,
    shape_names=("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"),
    source="arXiv:1703.04247",
)
