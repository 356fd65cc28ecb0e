"""Launchers (``repro.launch`` counterpart):

  mesh  -- the host mesh: this rank's view of a ``(data, model = 1)`` mesh
           over the ranks ``dist.run_ranks`` started
  steps -- step bundles: the train steps of every family (LM, GNN, recsys),
           LM prefill and decode, recsys serve and retrieval; the LM and
           recsys train steps also on the host mesh's data axis
  train -- the trainer: checkpoints, restart, stragglers, data-parallel
           ranks; and its CLI
  serve -- greedy batched decode with a KV cache, and its CLI

The reference's ``make_production_mesh`` (a 256/512-chip TPU mesh) and
``launch/dryrun.py`` (HLO lowering for a 512-chip pod) have no
counterpart.
"""
