"""One frozen configuration surface for the port's engine-shaped constructors.

``EngineConfig`` carries every knob from ``bsp.run_program`` down to the
``TraversalEngine``.  It mirrors ``repro.graph.config.EngineConfig`` minus
the TPU block sizes and plus ``device``: entry points run on the card unless
the caller asks for the CPU.  ``mesh`` is a ``dist.PartitionMesh`` (one
process per mesh rank, see ``repro_torch.dist``) or None for the dense
engine.  There are no legacy kwarg shims -- callers pass ``config=``.

``REPORT_SCHEMA_VERSION`` + ``versioned_report`` define the shared
``asdict()`` surface of ``TraversalResult``, ``ExecutionReport`` and
``ServiceReport``: ``schema_version`` and ``kind``
first, then the result's fields by name -- the same dict the JAX package
returns, so consumers key on names and never on positional order.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

#: Version of the shared report-dict surface.  Bump when a field is renamed
#: or removed; adding fields is backward compatible and does NOT bump.
REPORT_SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Every engine knob, in one frozen value.

    ``device`` is where state, layouts and counters live (``"cuda"`` by
    default; tests pass ``"cpu"``).  ``backend`` selects the relax reduction:
    ``"cuda"`` (the hand-written Hopper kernel) or ``"torch"`` (the plain
    version); ``None`` picks the device's default -- ``"cuda"`` on a card,
    ``"torch"`` on the CPU.

    ``mesh`` (a ``dist.PartitionMesh``) shards the partition axis over the
    mesh's ranks; the engine then runs on ``mesh.device``, whose type must
    match ``device``.  ``mirror_degree`` is the mesh layout's hub
    threshold; ``relayout`` (``True``, ``False`` or ``"auto"``) makes the
    elastic executor's compute layout follow its plan.
    """

    device: str = "cuda"
    backend: str | None = None
    mesh: Any = None
    mirror_degree: int | None = None
    m_max: int = 512
    window: int = 8  # supersteps per launched window (elastic / serving)
    relayout: bool | str = False  # elastic executor: follow the plan with ranks
    collect_subgraphs: bool = False

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


def resolve_device(device) -> torch.device:
    """The ``torch.device`` for a config's ``device``; a CUDA device on a
    machine without CUDA raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass EngineConfig(device='cpu') to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a cuda or cpu device, got {device!r}")
    if dev.type == "cuda" and dev.index is None:
        # one spelling per card, so device-keyed caches never split
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def versioned_report(kind: str, fields: dict) -> dict:
    """The shared report-dict shape: schema version + kind + named fields."""
    out = {"schema_version": REPORT_SCHEMA_VERSION, "kind": str(kind)}
    out.update(fields)
    return out
