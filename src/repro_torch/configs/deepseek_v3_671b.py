"""DeepSeek-V3 671B [arXiv:2412.19437; hf]: 61L, d_model 7168, 128H MLA,
expert d_ff 2048, vocab 129280, MoE 1 shared + 256 routed top-8, aux-loss-free
bias routing, MTP depth 1, first 3 layers dense (d_ff 18432).

long_500k is skipped: MLA is full attention (the compressed-latent cache is a
constant-factor win, not sub-quadratic)."""

from repro_torch.configs.base import ArchSpec, LMConfig, MLAConfig, MoEConfig

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=18432,  # the 3 leading dense layers
    vocab=129280,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        d_ff_expert=2048,
        n_shared=1,
        aux_free_bias=True,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    ),
    first_k_dense=3,
    mtp_depth=1,
)

SPEC = ArchSpec(
    arch_id="deepseek-v3-671b",
    family="lm",
    config=CONFIG,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
    skip_shapes={"long_500k": "pure full attention (MLA); needs sub-quadratic"},
    source="arXiv:2412.19437",
)
