"""Arch registry: ``--arch <id>`` resolution + reduced configs for CPU smoke
tests (same structure, small dims; the full GNN configs run on the card in
``chip_smoke.py``)."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchSpec, GNNConfig, LMConfig, RecsysConfig

_MODULES = {
    "mixtral-8x22b": "repro_torch.configs.mixtral_8x22b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "granite-3-8b": "repro_torch.configs.granite_3_8b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "pna": "repro_torch.configs.pna",
    "mace": "repro_torch.configs.mace",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "dimenet": "repro_torch.configs.dimenet",
    "deepfm": "repro_torch.configs.deepfm",
}


def _load() -> dict[str, ArchSpec]:
    return {
        name: importlib.import_module(mod).SPEC for name, mod in _MODULES.items()
    }


ARCHS: dict[str, ArchSpec] = _load()


def get_arch(arch_id: str) -> ArchSpec:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}") from None


def reduced_config(spec: ArchSpec):
    """Shrink a config for CPU smoke tests, preserving every structural
    feature (MoE/MLA/SWA/MTP, aggregator sets, triplets, FM)."""
    cfg = spec.config
    if isinstance(cfg, LMConfig):
        changes: dict = dict(
            n_layers=2 if not cfg.moe else max(2, (cfg.first_k_dense > 0) + 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(cfg.n_kv_heads, 2),
            d_head=16,
            d_ff=128,
            vocab=256,
            remat=False,
        )
        if cfg.moe:
            # capacity_factor 4 => no token dropping at smoke-test sizes, so
            # decode-vs-forward replay is exact (dropping is a training-time
            # throughput trade, not wanted in correctness tests)
            changes["moe"] = dataclasses.replace(
                cfg.moe,
                n_experts=4,
                top_k=min(cfg.moe.top_k, 2),
                d_ff_expert=64,
                capacity_factor=4.0,
            )
            changes["first_k_dense"] = 1 if cfg.first_k_dense else 0
            changes["n_layers"] = changes["first_k_dense"] + 2
        if cfg.mla:
            changes["mla"] = dataclasses.replace(
                cfg.mla,
                q_lora_rank=32,
                kv_lora_rank=16,
                qk_nope_dim=16,
                qk_rope_dim=8,
                v_head_dim=16,
            )
        if cfg.sliding_window:
            changes["sliding_window"] = 8
        return dataclasses.replace(cfg, **changes)
    if isinstance(cfg, GNNConfig):
        return dataclasses.replace(
            cfg, n_layers=min(cfg.n_layers, 2), d_hidden=16,
            extra={**cfg.extra, **({"n_rbf": 4} if "n_rbf" in cfg.extra else {})},
        )
    if isinstance(cfg, RecsysConfig):
        return dataclasses.replace(
            cfg, n_sparse=6, embed_dim=8, mlp_dims=(32, 32), vocab_per_field=1000
        )
    raise TypeError(type(cfg))
