"""Config dataclasses for the assigned architecture pool."""

from __future__ import annotations

import dataclasses
from typing import Any


# ---------------------------------------------------------------------------
# LM transformers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_free_bias: bool = False  # DeepSeek-V3 bias-based load balancing
    router_aux_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    sliding_window: int | None = None
    mtp_depth: int = 0  # DeepSeek-V3 multi-token prediction modules
    first_k_dense: int = 0  # leading dense layers before MoE layers
    rope_theta: float = 10000.0
    remat: bool = True
    tie_embeddings: bool = False
    # Megatron-SP-style residual stream: keep hidden states d_model-sharded
    # over the model axis between blocks (wins when in-projections are
    # low-rank, e.g. MLA; see EXPERIMENTS.md s.Perf)
    sp_residual: bool = False

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.first_k_dense if self.moe else 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab
        n = 2 * d * v  # embed + head
        if self.mla:
            m = self.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            attn = (
                d * m.q_lora_rank
                + m.q_lora_rank * self.n_heads * qk
                + d * m.kv_lora_rank
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                + d * m.qk_rope_dim
                + self.n_heads * m.v_head_dim * d
            )
        else:
            attn = d * self.n_heads * self.d_head + 2 * d * self.n_kv_heads * self.d_head
            attn += self.n_heads * self.d_head * d
        dense_ffn = 3 * d * self.d_ff
        n += self.n_layers * attn
        if self.moe:
            moe_ffn = 3 * d * self.moe.d_ff_expert * (
                self.moe.n_experts + self.moe.n_shared
            ) + d * self.moe.n_experts
            n += self.first_k_dense * dense_ffn + self.n_moe_layers * moe_ffn
        else:
            n += self.n_layers * dense_ffn
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense_total = self.param_count() - self.n_moe_layers * (
            3 * d * self.moe.d_ff_expert * (self.moe.n_experts + self.moe.n_shared)
        )
        active_ffn = 3 * d * self.moe.d_ff_expert * (self.moe.top_k + self.moe.n_shared)
        return dense_total + self.n_moe_layers * active_ffn


@dataclasses.dataclass(frozen=True)
class LMShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


LM_SHAPES = {
    "train_4k": LMShape("train_4k", 4096, 256, "train"),
    "prefill_32k": LMShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": LMShape("decode_32k", 32768, 128, "decode"),
    "long_500k": LMShape("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# GNNs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # "pna" | "mace" | "meshgraphnet" | "dimenet"
    n_layers: int
    d_hidden: int
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class GraphShape:
    name: str
    n_nodes: int
    n_edges: int
    d_feat: int
    kind: str  # "full" | "minibatch" | "batched_small"
    batch_nodes: int = 0  # minibatch seeds
    fanout: tuple[int, ...] = ()
    batch_graphs: int = 0  # batched-small-graphs count
    n_triplets: int = 0  # padded triplet budget (DimeNet-family)


def _graph_shapes() -> dict[str, GraphShape]:
    return {
        "full_graph_sm": GraphShape("full_graph_sm", 2_708, 10_556, 1_433, "full"),
        "minibatch_lg": GraphShape(
            "minibatch_lg",
            232_965,
            114_615_892,
            602,
            "minibatch",
            batch_nodes=1_024,
            fanout=(15, 10),
        ),
        "ogb_products": GraphShape("ogb_products", 2_449_029, 61_859_140, 100, "full"),
        "molecule": GraphShape(
            "molecule", 30, 64, 0, "batched_small", batch_graphs=128
        ),
    }


GRAPH_SHAPES = _graph_shapes()


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_sparse: int
    embed_dim: int
    mlp_dims: tuple[int, ...]
    vocab_per_field: int = 100_000
    multi_hot: int = 1  # ids per field (EmbeddingBag bag size)


@dataclasses.dataclass(frozen=True)
class RecsysShape:
    name: str
    batch: int
    kind: str  # "train" | "serve" | "retrieval"
    n_candidates: int = 0


RECSYS_SHAPES = {
    "train_batch": RecsysShape("train_batch", 65_536, "train"),
    "serve_p99": RecsysShape("serve_p99", 512, "serve"),
    "serve_bulk": RecsysShape("serve_bulk", 262_144, "serve"),
    "retrieval_cand": RecsysShape(
        "retrieval_cand", 1, "retrieval", n_candidates=1_000_000
    ),
}


# ---------------------------------------------------------------------------
# Arch registry entry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # "lm" | "gnn" | "recsys"
    config: Any
    shape_names: tuple[str, ...]
    skip_shapes: dict[str, str] = dataclasses.field(default_factory=dict)
    source: str = ""

    def shapes(self):
        table = (
            LM_SHAPES
            if self.family == "lm"
            else GRAPH_SHAPES if self.family == "gnn" else RECSYS_SHAPES
        )
        return {n: table[n] for n in self.shape_names}
