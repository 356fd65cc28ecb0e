"""TinyLlama 1.1B [arXiv:2401.02385; hf]: llama2-arch 22L, d_model 2048,
32H GQA kv=4, d_ff 5632, vocab 32000."""

from repro_torch.configs.base import ArchSpec, LMConfig

CONFIG = LMConfig(
    name="tinyllama-1.1b",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=5632,
    vocab=32000,
)

SPEC = ArchSpec(
    arch_id="tinyllama-1.1b",
    family="lm",
    config=CONFIG,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
    skip_shapes={"long_500k": "pure full attention (GQA); needs sub-quadratic"},
    source="arXiv:2401.02385",
)
