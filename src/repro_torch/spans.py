"""The program's spans: named ranges in a running ``torch.profiler`` trace.

    with span("engine.closure"):
        ...

A span is a range on the profiler's own clock, so it nests with the ATen
ops and the device kernels they launch in the same trace
(``FunctionEvent.cpu_parent`` links an op to the span around it, and an op
holds its kernels).  With no profiler recording, ``span`` checks one flag
and opens nothing.

The range is recorded at the profiler's op scope
(``torch._C._profiler._RecordFunctionFast``), not as a user annotation
(``torch.profiler.record_function``): under CUDA the profiler also emits a
user annotation as a device event spanning its first kernel to its last,
idle gaps included, and a reader that takes every device event as device
activity would count that as busy time.  An op-scope range has no such
device twin.

Span names hold no ``relax_``: a reader matches device kernels by that
substring.
"""

from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager recording ``name``'s range while a profiler
    records; a no-op otherwise."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return _OFF
