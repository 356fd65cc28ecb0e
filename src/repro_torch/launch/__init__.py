"""Launchers (``repro.launch`` counterpart):

  steps -- step bundles: the train steps of every family (LM, GNN, recsys),
           LM prefill and decode, recsys serve and retrieval
  train -- the trainer: checkpoints, restart, stragglers; and its CLI
  serve -- greedy batched decode with a KV cache, and its CLI

The reference's ``launch/mesh.py`` (a TPU device mesh and a host mesh for
``NamedSharding``) and ``launch/dryrun.py`` (HLO lowering for a 512-chip
pod) have no counterpart: the port places a model on one device.
"""
