"""PyTorch + CUDA port of the elastic graph-processing reproduction.

Mirrors the JAX package ``repro`` module for module (``repro.X.Y`` ->
``repro_torch.X.Y``) and never imports it, nor JAX.  Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; every TPU kernel on
the ported path is a hand-written Hopper kernel under ``kernels/``.

  graph    -- graphs, partitioners, layouts, the VertexProgram algebra, the
              dense BSP engine and the BSP trace drivers
  core     -- the paper's time function, metagraph prediction, placement
              strategies, activation and billing
  kernels  -- the CUDA relax kernel, its build and its plain version
  convert  -- carry a graph, partition and window state across from numpy
"""
