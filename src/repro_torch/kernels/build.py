"""The port's one ``nvcc`` build, shared by every hand-written kernel.

Each kernel is a ``.cu`` file with a plain C interface.  It is compiled for
``sm_90a`` at first use into ``build/`` beside its package (listed in
``.gitignore``), named by a hash of the source and flags so an edited
source never loads a stale build, and loaded with ``ctypes``.  A failed
build raises ``KernelBuildError``; nothing falls back to a plain version.

``CudaKernel`` is the base of the launch wrappers: it builds and binds the
library once, counts launches in ``launches`` and turns a non-zero
``cudaGetLastError()`` returned by a C entry point into an exception.
``check_grid`` refuses a launch grid with a zero dimension before any
launch (a zero-size grid never runs the kernel, so its output would never
be written).  ``validate_backend`` is the backend policy every entry point
shares: the kernel on a card, the plain version on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

#: every entry point's backends: the hand-written kernel, the plain version
BACKENDS = ("cuda", "torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused the kernel source."""


def find_nvcc() -> str | None:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's default install path; None when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def build_library(
    source: Path, build_dir: Path, nvcc: str | None = None, defines: tuple[str, ...] = ()
) -> tuple[Path, str]:
    """Compile ``source`` into a shared library (or reuse the build of the
    same source and flags), with ``-D`` for each of ``defines``; returns
    ``(path, nvcc's output)``."""
    nvcc = nvcc or find_nvcc()
    if nvcc is None or not os.path.isfile(nvcc):
        raise KernelBuildError(
            f"nvcc not found (looked at $CUDA_HOME, PATH and /usr/local/cuda); "
            f"cannot build {Path(source).name}"
        )
    text = Path(source).read_bytes()
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    build_dir = Path(build_dir)
    lib = build_dir / f"lib{Path(source).stem}-{digest}.so"
    if lib.exists():
        return lib, ""
    build_dir.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc, *flags, "-o", tmp, str(source)],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed on {source} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


def validate_backend(backend: str | None, device) -> str:
    """Resolve an entry point's ``backend`` for ``device``: ``None`` is the
    device's default (``"cuda"`` on a card, ``"torch"`` on the CPU), and
    ``"cuda"`` on a CPU device raises."""
    device = torch.device(device)
    if backend is None:
        return "cuda" if device.type == "cuda" else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend='cuda' runs the CUDA kernel and needs a CUDA device, "
            f"got {device}"
        )
    return backend


def check_grid(grid: tuple[int, ...], what: str) -> None:
    """Raise unless every dimension of a launch grid is at least 1."""
    if any(int(g) < 1 for g in grid):
        raise ValueError(f"{what}: launch grid {tuple(grid)} has a zero dimension")


class CudaKernel:
    """Build-once, bind-once base of a launch wrapper.

    Subclasses set ``error_fn`` (the C function that names a cudaError_t)
    and bind their entry points in ``_bind``.  ``launches`` counts kernel
    launches and nothing else; ``build_seconds`` and ``build_log`` record
    the first-use build.
    """

    error_fn = ""

    def __init__(self, source: Path, build_dir: Path, defines: tuple[str, ...] = ()):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.defines = tuple(defines)
        self.launches = 0
        self.build_seconds: float | None = None
        self.build_log = ""
        self._lib: ctypes.CDLL | None = None

    def _bind(self, lib: ctypes.CDLL) -> None:
        raise NotImplementedError

    def load(self, nvcc: str | None = None) -> ctypes.CDLL:
        """Build (first use only) and bind the library."""
        if self._lib is not None:
            return self._lib
        t0 = time.perf_counter()
        path, log = build_library(self.source, self.build_dir, nvcc, self.defines)
        lib = ctypes.CDLL(str(path))
        self._bind(lib)
        err = getattr(lib, self.error_fn)
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self.build_seconds = time.perf_counter() - t0
        self.build_log = log
        self._lib = lib
        return lib

    def _check_rc(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = getattr(self._lib, self.error_fn)(rc).decode()
            raise RuntimeError(f"{what} launch failed: {msg} (cudaError {rc})")
