"""Checkpoints of a tree of tensors (``repro.ckpt.checkpoint`` counterpart).

A tree is nested dicts of tensors -- for training, ``{"params":
model.state_dict(), "opt": {"mu": ..., "nu": ..., "count": ...}}`` -- and
its leaves are keyed by their ``/``-joined path.  The file is the standard
library's and torch's only (no msgpack, no zstandard): a magic, the length
of a JSON header, the header (the step, and each leaf's key, dtype, shape
and byte range), then each leaf's raw bytes compressed by ``zlib``.
bfloat16 leaves are stored by their bytes, never through numpy (which has
no bfloat16).

The reference's fault-tolerance properties hold:

  * atomic: written to ``.tmp`` then ``os.replace``d, so a crash mid-save
    never corrupts the newest checkpoint;
  * self-describing: ``restore_pytree`` checks the target's structure and
    raises ``KeyError`` on a missing leaf and ``ValueError`` on a shape
    mismatch;
  * async: ``Checkpointer.save_async`` copies the tree to host memory at
    the call, then writes the file on a thread, overlapping the next steps;
  * a restore puts every leaf on the device of the target's leaf.
"""

from __future__ import annotations

import json
import os
import re
import struct
import threading
import zlib

import torch

_MAGIC = b"RTCKPT01"
_LEVEL = 1  # zlib's fastest: a large model's state is gigabytes


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    if isinstance(tree, dict):
        flat = {}
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
        return flat
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a {type(tree).__name__}, "
                        "not a tensor")
    return {prefix[:-1]: tree}


def _unflatten_like(target, values: dict, prefix: str = ""):
    if isinstance(target, dict):
        return {k: _unflatten_like(v, values, f"{prefix}{k}/") for k, v in target.items()}
    return values[prefix[:-1]]


def _to_bytes(t: torch.Tensor) -> bytes:
    return t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy().tobytes()


def _from_bytes(raw: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    if not raw:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dtype).reshape(shape)


def save_pytree(path: str, tree, *, step: int | None = None) -> None:
    flat = _flatten(tree)
    header = {"step": step, "leaves": []}
    blobs = []
    offset = 0
    for key, t in flat.items():
        blob = zlib.compress(_to_bytes(t), _LEVEL)
        header["leaves"].append({
            "key": key, "dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape), "offset": offset, "nbytes": len(blob),
        })
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header).encode()
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)  # atomic


def _read(path: str) -> tuple[dict, int]:
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a checkpoint of this format")
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, len(_MAGIC) + 8 + n


def restore_pytree(path: str, target_tree, *, device=None):
    """A tree of ``target_tree``'s structure read from ``path``: each leaf
    in its stored dtype, on ``device`` (by default the device of the
    target's leaf), checked by key and shape."""
    header, base = _read(path)
    records = {rec["key"]: rec for rec in header["leaves"]}
    out = {}
    with open(path, "rb") as f:
        for key, leaf in _flatten(target_tree).items():
            if key not in records:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            rec = records[key]
            if tuple(rec["shape"]) != tuple(leaf.shape):
                raise ValueError(
                    f"shape mismatch for {key}: {tuple(rec['shape'])} vs {tuple(leaf.shape)}")
            f.seek(base + rec["offset"])
            raw = zlib.decompress(f.read(rec["nbytes"]))
            t = _from_bytes(raw, getattr(torch, rec["dtype"]), rec["shape"])
            out[key] = t.to(leaf.device if device is None else device)
    return _unflatten_like(target_tree, out)


def ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.ckpt")


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1)) for f in os.listdir(directory)
        if (m := re.match(r"step_(\d+)\.ckpt$", f))
    )


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return steps[-1] if steps else None


class Checkpointer:
    """Async checkpointer with retention: the newest ``keep`` files stay."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save_async(self, tree, step: int) -> None:
        """Copy ``tree`` to host memory now; write it on a thread."""
        self.wait()
        host = {k: t.detach().to("cpu", copy=True) for k, t in _flatten(tree).items()}

        def work():
            try:
                save_pytree(ckpt_path(self.directory, step), host, step=step)
                self._gc()
            except BaseException as e:  # re-raised by wait() in the caller
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight is on disk; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in _steps(self.directory)[: -self.keep]:
            try:
                os.remove(ckpt_path(self.directory, s))
            except OSError:
                pass
