"""Granite-3 8B [hf:ibm-granite; hf]: dense 40L, d_model 4096, 32H GQA kv=8,
d_ff 12800, vocab 49155."""

from repro_torch.configs.base import ArchSpec, LMConfig

CONFIG = LMConfig(
    name="granite-3-8b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12800,
    vocab=49155,
)

SPEC = ArchSpec(
    arch_id="granite-3-8b",
    family="lm",
    config=CONFIG,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
    skip_shapes={"long_500k": "pure full attention (GQA); needs sub-quadratic"},
    source="hf:ibm-granite/granite-3.0-2b-base",
)
