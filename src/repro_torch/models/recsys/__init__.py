"""RecSys (``repro.models.recsys`` counterpart): sparse embedding tables,
feature interaction and an MLP.

  embedding -- the fixed-size bag (dense sum) and the ragged bag (the CUDA
               segment-sum kernel on a card)
  deepfm    -- DeepFM: logits, loss, retrieval scores
"""

from repro_torch.models.recsys.deepfm import (
    DeepFM,
    deepfm_logits,
    deepfm_loss,
    retrieval_scores,
)
from repro_torch.models.recsys.embedding import (
    embedding_bag,
    embedding_bag_segment,
    init_embedding_tables,
)

__all__ = [
    "DeepFM", "deepfm_logits", "deepfm_loss", "embedding_bag", "embedding_bag_segment",
    "init_embedding_tables", "retrieval_scores",
]
