"""Model architectures of the port (``repro.models`` counterpart).

  common      -- initializers, norms, RoPE, SwiGLU, cross-entropy
  gnn         -- the four GNN architectures and halo-exchange PNA
  attention   -- GQA (prefill on the CUDA flash kernel) and MLA
  moe         -- the mixture-of-experts FFN with capacity dispatch
  transformer -- the decoder-only LM of the five LM archs
  recsys      -- embedding bags and DeepFM
"""
