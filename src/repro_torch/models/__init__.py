"""Model architectures of the port (``repro.models`` counterpart).

  common -- initializers, norms, RoPE, SwiGLU, cross-entropy
  gnn    -- the four GNN architectures and halo-exchange PNA

The LM transformers and the recsys models are still to be ported.
"""
