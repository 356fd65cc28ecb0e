"""Launchers (``repro.launch`` counterpart):

  mesh   -- the host mesh: this rank's view of a ``(pod, data, model)``
            mesh over the ranks ``dist.run_ranks`` started; the production
            meshes as layouts (sizes, no process group)
  steps  -- step bundles: the train steps of every family (LM, GNN, recsys),
            LM prefill and decode, recsys serve and retrieval; all but the
            GNN steps also on a mesh
  train  -- the trainer: checkpoints, restart, stragglers, data-parallel
            ranks; and its CLI
  serve  -- greedy batched decode with a KV cache, and its CLI
  dryrun -- the dry run's intent: every cell's state bytes a rank and one
            step's collectives at the production meshes, reckoned on meta
            tensors, the counts held to what ranks issue; and its CLI

The reference dry run's HLO lowering (memory and FLOP analysis of a
compiled step) has no counterpart: nothing compiles an eager step.
"""
