"""Hand-written Hopper kernels of the port.

  bfs_relax -- the segmented relax reduction of every BSP superstep
               (CUDA C++ for sm_90a in ``bfs_relax/csrc``)

Each package ships ``csrc/`` (the CUDA source), ``kernel.py`` (build at
first use, ctypes binding, launch wrapper and launch counter), ``ref.py``
(the plain PyTorch version) and ``ops.py`` (the backend switch the engine
calls).  Nothing is compiled when a module is imported.
"""
