"""Mixtral 8x22B [arXiv:2401.04088; hf]: 56L, d_model 6144, 48H GQA kv=8,
expert d_ff 16384, vocab 32768, MoE 8 experts top-2, sliding-window attention.
SWA bounds the decode cache, so long_500k runs with a ring buffer."""

from repro_torch.configs.base import ArchSpec, LMConfig, MoEConfig

CONFIG = LMConfig(
    name="mixtral-8x22b",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=32768,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
    sliding_window=4096,
    rope_theta=1e6,
)

SPEC = ArchSpec(
    arch_id="mixtral-8x22b",
    family="lm",
    config=CONFIG,
    shape_names=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
    source="arXiv:2401.04088",
)
