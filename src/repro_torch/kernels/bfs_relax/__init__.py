from repro_torch.kernels.bfs_relax.kernel import KernelBuildError, relax_rowptr
from repro_torch.kernels.bfs_relax.ops import (
    RELAX_BACKENDS,
    bfs_relax,
    bfs_relax_csr,
    make_relax_fn,
    relax_blockmap_call,
    relax_csr,
    validate_backend,
)
from repro_torch.kernels.bfs_relax.ref import reference_bfs_relax, relax_reference

__all__ = [
    "KernelBuildError",
    "RELAX_BACKENDS",
    "bfs_relax",
    "bfs_relax_csr",
    "make_relax_fn",
    "relax_blockmap_call",
    "relax_csr",
    "relax_reference",
    "reference_bfs_relax",
    "relax_rowptr",
    "validate_backend",
]
