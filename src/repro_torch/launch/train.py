"""The trainer, with fault tolerance (``repro.launch.train`` counterpart).

  python -m repro_torch.launch.train --arch tinyllama-1.1b --shape train_4k \\
      --steps 50 --ckpt-dir artifacts/ckpt/tl [--device cpu]

  * checkpoint and restart: an async checkpoint every ``ckpt_every`` steps
    and at the end; a launch resumes from the newest checkpoint in
    ``ckpt_dir`` (the restore checks the state's structure and puts every
    tensor on the bundle's device);
  * deterministic data: the batch of a step is a pure function of
    ``(seed, step)``, so a restart replays the stream from its resume point;
  * stragglers: a step longer than ``step_timeout_factor`` times the median
    (after 3 steps) is counted and logged;
  * ``crash_at``: raises at that step, so a test can restart the run; a
    non-finite loss raises too.  Either way the save in flight is drained
    first, so the checkpoint before the failing step is on disk.
  * a mesh (``ranks`` data ranks times ``model`` model ranks): the steps
    run on ``launch.mesh.make_mesh(data=ranks, model=model)``
    (``launch.steps``: each data rank its rows of the global batch, the
    state sharded by the rule tables, the gradients averaged over the data
    ranks; a GNN's graph batch split over all the ranks, the flattened axis,
    its replicated state's partial gradients summed over them).  Outside a
    process group ``train(..., ranks=D, model=T)`` starts D * T ranks
    with ``dist.run_ranks`` (NCCL where each has a card of its own, gloo
    otherwise) and returns rank 0's losses, step times
    and collective stats, and ``ranks_identical``: every rank's gathered
    final state equal bit for bit, read off per-tensor digests (no module
    comes back to the caller).  Rank 0 alone writes checkpoints, of the
    state gathered whole (``state_tree``, which every rank calls); the
    ranks meet after its last save.  A restore loads the newest
    checkpoint whole and cuts each rank's shard of it, whatever layout
    wrote it.  A failure every rank meets at the same step (an injected
    crash, a diverged loss: the loss is the ranks' mean) drains rank 0's
    save, meets the others and comes back to the caller as the one-rank
    error -- ``run_ranks`` kills every rank once one exits non-zero, which
    would cut off the save the restart needs.

The state is the bundle's ``{"params": module, "opt": {...}}``; its
checkpoint tree is ``{"params": module.state_dict(), "opt": ...}``, each
tensor whole.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.ckpt import Checkpointer, ckpt_path, latest_step, restore_pytree
from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import graph_batch, make_batch
from repro_torch.dist.launch import run_ranks
from repro_torch.dist.sharding import gather_full, placement_of, shard_of
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_bundle

#: a launch of ranks, and each collective in it, fails after this long
RANKS_TIMEOUT_S = 1800.0


class InjectedCrash(RuntimeError):
    """``crash_at``'s failure."""


def _per_param(state: dict, fn) -> dict:
    """``fn(name, tensor)`` over the parameters and both moments of a
    train state, in the checkpoint tree's layout."""
    opt = state["opt"]
    return {"params": {n: fn(n, t) for n, t in state["params"].state_dict().items()},
            "opt": {"mu": {n: fn(n, t) for n, t in opt["mu"].items()},
                    "nu": {n: fn(n, t) for n, t in opt["nu"].items()},
                    "count": opt["count"]}}


def state_tree(state: dict) -> dict:
    """The checkpoint tree of a train state: tensors only, each whole.  On
    a mesh each parameter and moment is gathered from the ranks' shards
    (collective: every rank calls it, and gets the whole tree)."""
    placed = placement_of(state["params"])
    if placed is None:
        return {"params": state["params"].state_dict(), "opt": state["opt"]}
    return _per_param(state, lambda n, t: gather_full(t, placed.specs[n], placed.mesh))


def restore_state(path: str, state: dict) -> None:
    """Load the checkpoint at ``path`` into ``state`` (checked against its
    structure): on a mesh, the rank's shard of each tensor, whatever layout
    wrote it."""
    placed = placement_of(state["params"])
    if placed is None:
        tree = restore_pytree(path, state_tree(state))
        state["params"].load_state_dict(tree["params"])
        state["opt"] = tree["opt"]
        return
    sizes = placed.mesh.shape

    def whole(n, t):  # a stand-in of the whole tensor's shape, no bytes
        shape = [s * (sizes[ax] if ax else 1) for s, ax in zip(t.shape, placed.specs[n])]
        return torch.empty(shape, dtype=t.dtype, device="meta")

    template = _per_param(state, whole)
    tree = restore_pytree(path, template, device="cpu")
    model = state["params"]
    dev = next(model.parameters()).device
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(shard_of(tree["params"][n], placed.specs[n], placed.mesh))
    opt = tree["opt"]
    state["opt"] = {
        k: {n: shard_of(t, placed.specs[n], placed.mesh).clone().to(dev)
            for n, t in opt[k].items()} for k in ("mu", "nu")}
    state["opt"]["count"] = opt["count"].to(dev)


_INT_OF_WIDTH = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_DIGEST_CHUNK = 1 << 24


@torch.no_grad()
def tensor_digest(t: torch.Tensor) -> tuple[int, int]:
    """Two sums over a tensor's bits, on its device: its elements read as
    integers of their width, plainly and weighted by position, mod 2**64.
    One changed element changes the first, two swapped ones the second."""
    words = t.detach().reshape(-1)
    words = words.view(_INT_OF_WIDTH[words.element_size()])
    plain = weighted = 0
    for lo in range(0, words.numel(), _DIGEST_CHUNK):
        w = words[lo:lo + _DIGEST_CHUNK].to(torch.int64)
        pos = torch.arange(lo + 1, lo + 1 + w.numel(), dtype=torch.int64, device=w.device)
        plain += int(w.sum())
        weighted += int((w * pos).sum())  # int64 sums wrap: equal mod 2**64
    return plain % 2**64, weighted % 2**64


def state_digests(state: dict) -> dict:
    """``tensor_digest`` of each tensor of a train state's checkpoint tree,
    keyed by its ``/``-joined path."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out[f"{prefix}{k}"] = tensor_digest(v)

    walk(state_tree(state), "")
    return out


def train(
    arch: str,
    shape: str,
    *,
    steps: int = 20,
    reduced: bool = True,
    ckpt_dir: str | None = None,
    ckpt_every: int = 10,
    seed: int = 0,
    crash_at: int | None = None,
    step_timeout_factor: float = 5.0,
    verbose: bool = True,
    device="cuda",
    config=None,
    ranks: int | None = None,
    model: int | None = None,
) -> dict:
    """Train ``arch`` at ``shape`` for ``steps`` steps (counted from 0, a
    resumed run starting at its checkpoint's step) on ``device`` (the card
    unless the caller asks for the CPU) over a mesh of ``ranks``
    data-parallel times ``model`` model-parallel ranks (``model`` 1 unless
    given): inside a process group its size (``ranks``, if given, times
    ``model`` must equal it), outside one ``ranks`` 1 unless the caller
    asks for more.

    Returns ``{"losses", "gnorms", "stragglers", "step_s",
    "resumed_from"}``, ``step_s`` each step's host seconds up to its loss
    on the host and ``resumed_from`` the checkpoint's step (or None);
    ``"final_state"`` too, except from ranks started here; inside a process
    group also ``"ranks"`` and ``"stats"``, ``"model_stats"`` and
    ``"flat_stats"`` (the rank's collectives on each axis), and
    from ranks started here rank 0's values with ``"ranks_identical"``,
    ``"digests"`` and ``"backend"``."""
    kw = dict(arch=arch, shape=shape, steps=steps, reduced=reduced, ckpt_dir=ckpt_dir,
              ckpt_every=ckpt_every, seed=seed, crash_at=crash_at,
              step_timeout_factor=step_timeout_factor, verbose=verbose, device=device,
              config=config)
    t = 1 if model is None else int(model)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        d = world // t if ranks is None else int(ranks)
        if d * t != world:
            raise ValueError(f"{d} x {t} ranks asked for inside a {world}-rank process group")
        return _train_here(make_mesh(data=d, model=t, device=device), **kw)
    d = 1 if ranks is None else int(ranks)
    if d * t == 1:
        return _train_here(None, **kw)
    return _train_ranks(d, t, kw)


def _train_ranks(d: int, t: int, kw: dict) -> dict:
    """``train`` on ``d * t`` ranks started here; see the module
    docstring."""
    verbose = kw["verbose"]
    n = d * t
    res = run_ranks(_train_rank, n, device=kw["device"], timeout=RANKS_TIMEOUT_S,
                    kwargs=dict(kw, verbose=False, model=t))
    for r in res:
        if "error" in r:
            kind, msg = r["error"]
            raise {"InjectedCrash": InjectedCrash, "FloatingPointError": FloatingPointError}[
                kind](msg)
    out = dict(res[0])
    out.update(ranks=d, backend=res.backend,
               ranks_identical=all(r["digests"] == out["digests"] for r in res))
    if verbose:
        if out["resumed_from"] is not None:
            print(f"[train] resumed from step {out['resumed_from']} on {d} x {t} ranks")
        first = kw["steps"] - len(out["losses"])
        for i, (loss, dt) in enumerate(zip(out["losses"], out["step_s"])):
            if (first + i) % max(1, kw["steps"] // 10) == 0:
                print(f"[train] step {first + i}: loss {loss:.4f} ({dt*1e3:.0f} ms)")
    return out


def _train_rank(**kw) -> dict:
    """One rank of ``_train_ranks``: its ``train`` share, with the final
    state as digests and a failure every rank meets as its result."""
    try:
        out = train(**kw)
    except (InjectedCrash, FloatingPointError) as e:
        return {"error": (type(e).__name__, str(e))}
    out["digests"] = state_digests(out.pop("final_state"))
    return out


def _train_here(mesh, *, arch, shape, steps, reduced, ckpt_dir, ckpt_every, seed, crash_at,
                step_timeout_factor, verbose, device, config) -> dict:
    """The training loop on this process: one rank (``mesh`` None) or one
    of the mesh's ranks (``build_bundle`` runs a one-rank mesh as None)."""
    bundle = build_bundle(arch, shape, reduced=reduced, config=config, device=device,
                          mesh=mesh)
    spec = ARCHS[arch]
    writer = mesh is None or mesh.rank == 0
    verbose = verbose and writer
    state = bundle.init_state_fn(seed)
    dev = next(state["params"].parameters()).device

    start, resumed = 0, None
    if ckpt_dir and (last := latest_step(ckpt_dir)) is not None:
        restore_state(ckpt_path(ckpt_dir, last), state)
        start = resumed = last
        if verbose:
            print(f"[train] resumed from step {last}")

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir and writer else None
    losses: list[float] = []
    gnorms: list[float] = []
    durations: list[float] = []
    stragglers = 0

    def batch_for(step: int) -> dict:
        """The global batch of ``step`` (the step takes the rank's share)."""
        if spec.family == "gnn":
            inputs = bundle.abstract_inputs
            n_nodes = (inputs.get("x") or inputs["species"]).shape[0]
            return graph_batch(inputs, seed=seed, step=step, n_nodes=n_nodes, device=dev)
        return make_batch(bundle.abstract_inputs, seed=seed, step=step,
                          bounds=bundle.input_bounds, device=dev)

    try:
        for step in range(start, steps):
            if crash_at is not None and step == crash_at:
                raise InjectedCrash(f"injected crash at step {step}")
            t0 = time.perf_counter()
            state, metrics = bundle.step_fn(state, batch_for(step))
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            durations.append(dt)
            gnorms.append(float(metrics["gnorm"]))
            med = float(np.median(durations))
            if len(durations) > 3 and dt > step_timeout_factor * med:
                stragglers += 1
                if verbose:
                    print(f"[train] straggler step {step}: {dt:.2f}s vs median {med:.2f}s")
            losses.append(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                tree = state_tree(state)  # every rank gathers a sharded state
                if ckpt:
                    ckpt.save_async(tree, step + 1)
                del tree
            if verbose and (step % max(1, steps // 10) == 0):
                print(f"[train] step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms)")
    except (InjectedCrash, FloatingPointError):
        # every rank fails at this step: none may leave before the
        # writer's save in flight is on disk
        try:
            if ckpt:
                ckpt.wait()
        finally:
            if mesh is not None:
                mesh.barrier()
        raise
    finally:
        # drain the save in flight: a Python exception (an injected crash, a
        # diverged loss) is a graceful failure, and the checkpoint written
        # before the failing step must be on disk for the restart
        if ckpt:
            ckpt.wait()
    if ckpt_dir:
        tree = state_tree(state)
        if ckpt:
            ckpt.save_async(tree, steps)
            ckpt.wait()
        del tree
    out = {"losses": losses, "gnorms": gnorms, "stragglers": stragglers,
           "final_state": state, "step_s": durations, "resumed_from": resumed}
    if mesh is not None:
        mesh.barrier()  # the last checkpoint is on disk for every rank
        out.update(ranks=mesh.shape["data"], mesh=mesh.shape,
                   stats=mesh.data.stats.snapshot(), model_stats=mesh.model.stats.snapshot(),
                   flat_stats=mesh.flat.stats.snapshot())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--shape", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--full", action="store_true", help="full (non-reduced) config")
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-at", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int,
                    help="data-parallel ranks (default 1)")
    ap.add_argument("--model", type=int,
                    help="model-parallel ranks (default 1): the mesh is ranks x model")
    args = ap.parse_args(argv)
    out = train(
        args.arch, args.shape, steps=args.steps, reduced=not args.full,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
        crash_at=args.crash_at, device=args.device, ranks=args.ranks, model=args.model,
    )
    if out["losses"]:
        print(f"[train] done; loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")
    else:
        print("[train] done; no step left to run")


if __name__ == "__main__":
    main()
