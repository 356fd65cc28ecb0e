"""The example drivers of the port (``examples/`` of the JAX package, as
package modules of ``repro_torch``):

  quickstart       -- the paper in one minute: partition, BFS trace, every
                      placement strategy billed
  elastic_bfs      -- the paper's system running: metagraph-planned
                      elastic execution of each paper workload, optionally
                      on a partition mesh (``--mesh N``)
  elastic_serving  -- traversal serving under Poisson load, elastic against
                      static capacity
  train_lm         -- an LM trained on synthetic token streams with
                      AdamW, checkpoints and restart (``--tiny``: smoke scale)

Run one with ``python -m repro_torch.examples.<name> [--device cpu]``; every
driver runs on the card unless asked for the CPU.
"""
