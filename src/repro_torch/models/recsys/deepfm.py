"""DeepFM [arXiv:1703.04247] (``repro.models.recsys.deepfm`` counterpart):
an FM interaction branch and a deep MLP branch over shared field
embeddings; the logits are the sum of both plus the first-order terms.

On a mesh (``mesh=``, the module placed by ``dist.sharding.place``) the
tables' and first-order terms' vocab rows are split over the ``model``
axis, and every bag (serving's, and retrieval's query tower) is summed
over it.

The FM second-order term uses the sum-square identity
  sum_{i<j} <v_i, v_j> = 1/2 * ((sum v_i)^2 - sum v_i^2)
so the interaction is O(F * D), not O(F^2 * D).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.dist.sharding import model_split
from repro_torch.models.common import model_device
from repro_torch.models.gnn.message_passing import MLP
from repro_torch.models.recsys.embedding import embedding_bag, init_embedding_tables


class DeepFM(nn.Module):
    """``DeepFM(cfg)``: the reference's ``init_deepfm`` tree (``tables``
    ``[F, V, D]``, ``first_order`` ``[F, V, 1]``, ``mlp``, ``bias``) as
    parameters, drawn from ``generator`` on its device, on ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, cfg: RecsysConfig, *, generator: torch.Generator | None = None,
                 device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        f, v, d = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
        self.tables = nn.Parameter(init_embedding_tables(generator, f, v, d).to(device))
        self.first_order = nn.Parameter(init_embedding_tables(generator, f, v, 1).to(device))
        self.mlp = MLP((f * d,) + tuple(cfg.mlp_dims) + (1,), generator=generator)
        self.bias = nn.Parameter(torch.zeros((), dtype=torch.float32))
        self.to(device)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return deepfm_logits(self, ids)


def _vocab_axis(model: DeepFM, name: str, mesh):
    return mesh.model if model_split(model, (name,), mesh) else None


def deepfm_logits(model: DeepFM, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """ids ``[B, F, H]`` -> logits ``[B]``; on ``mesh``'s model axis the
    tables' vocab rows are split (``recsys_param_specs``) and each bag is
    summed over the ranks' rows (``embedding_bag``); the MLPs are
    replicated."""
    emb = embedding_bag(model.tables, ids, axis=_vocab_axis(model, "tables", mesh))
    first = embedding_bag(model.first_order, ids,
                          axis=_vocab_axis(model, "first_order", mesh))[..., 0].sum(-1)
    s = emb.sum(dim=1)  # [B, D]
    fm = 0.5 * (s * s - (emb * emb).sum(dim=1)).sum(-1)  # [B]
    deep = model.mlp(emb.reshape(emb.shape[0], -1))[:, 0]
    return model.bias + first + fm + deep


def deepfm_loss(model: DeepFM, ids: torch.Tensor, labels: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits, in the stable log1p form."""
    logits = deepfm_logits(model, ids, mesh)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


def retrieval_scores(model: DeepFM, query_ids: torch.Tensor,
                     cand_embeddings: torch.Tensor, mesh=None) -> torch.Tensor:
    """Score each query against N candidate item embeddings by a batched dot
    (the ``retrieval_cand`` shape): the query tower is the mean field
    embedding (on ``mesh``'s model axis its bags summed over the ranks'
    vocab rows, as ``deepfm_logits``'), and the candidates are whichever
    rows the caller passes (a rank's slice).  -> ``[B, N]``."""
    q = embedding_bag(model.tables, query_ids,
                      axis=_vocab_axis(model, "tables", mesh)).mean(dim=1)  # [B, D]
    return torch.einsum("bd,nd->bn", q, cand_embeddings)
