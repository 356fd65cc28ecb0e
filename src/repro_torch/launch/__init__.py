"""Launchers (``repro.launch`` counterpart), serving only so far:

  steps -- step bundles: LM prefill and decode, recsys serve and retrieval
  serve -- greedy batched decode with a KV cache, and its CLI
"""
