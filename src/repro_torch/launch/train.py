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

The state is the bundle's ``{"params": module, "opt": {...}}``; its
checkpoint tree is ``{"params": module.state_dict(), "opt": ...}``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.ckpt import Checkpointer, ckpt_path, latest_step, restore_pytree
from repro_torch.configs import ARCHS
from repro_torch.data.synthetic import graph_batch, make_batch
from repro_torch.launch.steps import build_bundle


def state_tree(state: dict) -> dict:
    """The checkpoint tree of a train state: tensors only."""
    return {"params": state["params"].state_dict(), "opt": state["opt"]}


def restore_state(path: str, state: dict) -> None:
    """Load the checkpoint at ``path`` into ``state`` (checked against its
    structure)."""
    tree = restore_pytree(path, state_tree(state))
    state["params"].load_state_dict(tree["params"])
    state["opt"] = tree["opt"]


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
) -> dict:
    """Train ``arch`` at ``shape`` for ``steps`` steps (counted from 0, a
    resumed run starting at its checkpoint's step) on ``device``: the card
    unless the caller asks for the CPU.  Returns ``{"losses",
    "stragglers", "final_state", "step_s"}``, ``step_s`` each step's host
    seconds up to its loss on the host."""
    bundle = build_bundle(arch, shape, reduced=reduced, config=config, device=device)
    spec = ARCHS[arch]
    state = bundle.init_state_fn(seed)
    dev = next(state["params"].parameters()).device

    start = 0
    if ckpt_dir and (last := latest_step(ckpt_dir)) is not None:
        restore_state(ckpt_path(ckpt_dir, last), state)
        start = last
        if verbose:
            print(f"[train] resumed from step {last}")

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    losses: list[float] = []
    durations: list[float] = []
    stragglers = 0

    def batch_for(step: int) -> dict:
        if spec.family == "gnn":
            inputs = bundle.abstract_inputs
            n_nodes = (inputs.get("x") or inputs["species"]).shape[0]
            return graph_batch(inputs, seed=seed, step=step, n_nodes=n_nodes, device=dev)
        return make_batch(bundle.abstract_inputs, seed=seed, step=step,
                          bounds=bundle.input_bounds, device=dev)

    try:
        for step in range(start, steps):
            if crash_at is not None and step == crash_at:
                raise RuntimeError(f"injected crash at step {step}")
            t0 = time.perf_counter()
            state, metrics = bundle.step_fn(state, batch_for(step))
            loss = float(metrics["loss"])  # waits for the step
            dt = time.perf_counter() - t0
            durations.append(dt)
            med = float(np.median(durations))
            if len(durations) > 3 and dt > step_timeout_factor * med:
                stragglers += 1
                if verbose:
                    print(f"[train] straggler step {step}: {dt:.2f}s vs median {med:.2f}s")
            losses.append(loss)
            if not np.isfinite(loss):
                raise FloatingPointError(f"loss diverged at step {step}")
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save_async(state_tree(state), step + 1)
            if verbose and (step % max(1, steps // 10) == 0):
                print(f"[train] step {step}: loss {loss:.4f} ({dt*1e3:.0f} ms)")
    finally:
        # drain the save in flight: a Python exception (an injected crash, a
        # diverged loss) is a graceful failure, and the checkpoint written
        # before the failing step must be on disk for the restart
        if ckpt:
            ckpt.wait()
    if ckpt:
        ckpt.save_async(state_tree(state), steps)
        ckpt.wait()
    return {"losses": losses, "stragglers": stragglers, "final_state": state,
            "step_s": durations}


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
    args = ap.parse_args(argv)
    out = train(
        args.arch, args.shape, steps=args.steps, reduced=not args.full,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed,
        crash_at=args.crash_at, device=args.device,
    )
    if out["losses"]:
        print(f"[train] done; loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")
    else:
        print("[train] done; no step left to run")


if __name__ == "__main__":
    main()
