"""Mistral-Nemo 12B [hf:mistralai/Mistral-Nemo-Base-2407]: dense 40L,
d_model 5120, 32H GQA kv=8 with explicit d_head=128, d_ff 14336,
vocab 131072, 128k context (rope theta 1M)."""

from repro_torch.configs.base import ArchSpec, LMConfig

CONFIG = LMConfig(
    name="mistral-nemo-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1e6,
)

SPEC = ArchSpec(
    arch_id="mistral-nemo-12b",
    family="lm",
    config=CONFIG,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
    skip_shapes={"long_500k": "pure full attention (GQA); needs sub-quadratic"},
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)
