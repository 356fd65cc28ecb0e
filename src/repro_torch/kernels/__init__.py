"""Hand-written Hopper kernels of the port.

  bfs_relax       -- the segmented relax reduction of every BSP superstep
                     (``bfs_relax/csrc/relax.cu``)
  segment_sum     -- the sorted segment sum of [E, D] rows into [N, D]
                     (``segment_sum/csrc/segment_sum.cu``)
  flash_attention -- causal / sliding-window GQA attention, forward
                     (``flash_attention/csrc/flash_attention.cu``)

All three are CUDA C++ for sm_90a, built by ``build.py`` (one ``nvcc``
build step for all) at first use.

Each package ships ``csrc/`` (the CUDA source), ``kernel.py`` (build at
first use, ctypes binding, launch wrapper and launch counter), ``ref.py``
(the plain PyTorch version) and ``ops.py`` (the entry points and their
backend switch).  Nothing is compiled when a module is imported.
"""
