"""Two probes of TinyLlama's decode_32k step on one NVIDIA card.

``gap``: where the distance between the split-KV decode on a ``(1, 2)``
mesh (2 ranks sharing the card over gloo) and the one-rank decode comes
from.  Both run at the published widths from one seeded model and one
seeded cache (8 sequences, 32,768 slots, every slot filled), teacher-forced
with the same seeded tokens, in bfloat16 and in float32.  (A float32 sum of
the row-parallel partials would change nothing at T = 2: the sum of two
bfloat16 numbers is rounded once either way.)  It prints,
per step, each run's largest logit distance from another in units of the
reference's rms, and, at the first step, the rms distance of every
residual-stream tensor that enters a norm (two a layer, then the final
one) from the float32 one-rank run.

``time``: the one-rank decode's host-bound step time for the package
trees given (``--trees A B``: each tree's ``src``), run alternately
A, B, B, A in fresh processes: 16 tokens between CUDA events after a
warm-up, three times a process.

    python3 tools/decode_probe.py gap [--steps 8]
    python3 tools/decode_probe.py time --trees parent/src src

Each prints one JSON object per line; ``--out FILE`` also writes them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ARCH = "tinyllama-1.1b"
BATCH, CACHE, SEED = 8, 32768, 0


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _cache(cfg, dtype, device):
    """The whole seeded cache, every slot drawn (in bfloat16, then cast)."""
    from repro_torch.models.transformer import init_lm_cache

    gen = _gen(device, SEED + 4)
    cache = init_lm_cache(cfg, BATCH, CACHE, torch.bfloat16, device)
    for leaves in cache.values():
        for t in leaves.values():
            t.normal_(generator=gen)
    return {k: {n: t.to(dtype) for n, t in v.items()} for k, v in cache.items()}


def _tokens(cfg, steps: int, device) -> torch.Tensor:
    return torch.randint(0, cfg.vocab, (steps, BATCH, 1), generator=_gen(device, SEED + 1),
                         device=device)


@contextlib.contextmanager
def _norm_inputs(seen: list | None):
    """Each tensor entering ``rms_norm`` in ``models.transformer`` appended
    to ``seen`` (float32, on the host)."""
    from repro_torch.models import transformer

    real = transformer.rms_norm
    if seen is None:
        yield
        return

    def keep(x, w):
        seen.append(x.float().cpu())
        return real(x, w)

    transformer.rms_norm = keep
    try:
        yield
    finally:
        transformer.rms_norm = real


def _decode(model, cache, tokens, mesh, spec, record: bool) -> dict:
    """Teacher-forced steps from the last ``len(tokens) + 1`` slots: each
    step's last logits (float32, host) and, with ``record``, the first
    step's norm inputs."""
    from repro_torch.models.transformer import lm_decode_step

    pos0 = CACHE - tokens.shape[0] - 1
    logits, seen = [], []
    with torch.inference_mode():
        for i in range(tokens.shape[0]):
            with _norm_inputs(seen if record and i == 0 else None):
                lg, cache = lm_decode_step(model, cache, tokens[i], pos0 + i, mesh=mesh,
                                           cache_spec=spec)
            logits.append(lg[:, -1].float().cpu())
    return {"logits": torch.stack(logits), "norm_inputs": seen}


def _gap_rank(steps: int) -> dict:
    """One rank of the (1, 2) mesh: the split runs; then, on rank 0, the
    one-rank runs."""
    from repro_torch.configs import ARCHS
    from repro_torch.dist.sharding import shard_of
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models.transformer import cache_spec

    mesh = make_mesh(data=1, model=2)
    dev = mesh.device
    cfg = ARCHS[ARCH].config
    tokens = _tokens(cfg, steps, dev)
    spec = cache_spec(cfg, BATCH, CACHE, mesh)
    out = {}
    for tag, dtype in (("split_bf16", torch.bfloat16), ("split_f32", torch.float32)):
        model = build_bundle(ARCH, "prefill_32k", config=cfg, mesh=mesh).init_state_fn(
            SEED)["params"].to(dtype)
        full = _cache(cfg, dtype, dev)
        cache = {k: {n: shard_of(t, tuple(spec) + (None,) * (t.dim() - 3), mesh).clone()
                     for n, t in v.items()} for k, v in full.items()}
        del full
        out[tag] = _decode(model, cache, tokens, mesh, spec, record=True)
        del model, cache
        torch.cuda.empty_cache()
    out["cache_spec"] = [list(a) if isinstance(a, tuple) else a for a in spec]
    if mesh.rank != 0:
        return out
    for tag, dtype in (("one_bf16", torch.bfloat16), ("one_f32", torch.float32)):
        model = build_bundle(ARCH, "prefill_32k", config=cfg, device=dev).init_state_fn(
            SEED)["params"].to(dtype)
        out[tag] = _decode(model, _cache(cfg, dtype, dev), tokens, None, None, record=True)
        del model
        torch.cuda.empty_cache()
    return out


def _share(a: torch.Tensor, ref: torch.Tensor) -> list:
    """Each step's largest distance over its rms of ``ref``."""
    rms = ref.square().mean(dim=(1, 2)).sqrt()
    return ((a - ref).abs().amax(dim=(1, 2)) / rms).tolist()


def _rel_rms(a: torch.Tensor, ref: torch.Tensor) -> float:
    return float((a - ref).square().mean().sqrt() / ref.square().mean().sqrt())


def probe_gap(steps: int) -> list[dict]:
    from repro_torch.dist import run_ranks

    t0 = time.perf_counter()
    ranks = run_ranks(_gap_rank, 2, device="cuda", timeout=1500.0, args=(steps,))
    r0, r1 = ranks[0], ranks[1]
    lines = [{"probe": "gap", "arch": ARCH, "batch": BATCH, "cache": CACHE, "steps": steps,
              "cache_spec": r0["cache_spec"], "seconds": time.perf_counter() - t0,
              "ranks_agree": all(torch.equal(r0[t]["logits"], r1[t]["logits"])
                                 for t in ("split_bf16", "split_f32"))}]
    pairs = (("split_bf16", "one_bf16"), ("one_bf16", "one_f32"), ("split_bf16", "one_f32"),
             ("split_f32", "one_f32"))
    lines.append({"probe": "gap", "logit_share_each_step": {
        f"{a} vs {b}": _share(r0[a]["logits"], r0[b]["logits"]) for a, b in pairs}})
    ref = r0["one_f32"]["norm_inputs"]
    lines.append({"probe": "gap", "norm_input_rel_rms_vs_one_f32": {
        tag: [_rel_rms(x, y) for x, y in zip(r0[tag]["norm_inputs"], ref)]
        for tag in ("one_bf16", "split_bf16", "split_f32")},
        "norm_input_rel_rms_split_bf16_vs_one_bf16": [
            _rel_rms(x, y) for x, y in zip(r0["split_bf16"]["norm_inputs"],
                                           r0["one_bf16"]["norm_inputs"])]})
    return lines


def time_one() -> dict:
    """The one-rank decode_32k bundle's step time in this process's tree."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import build_bundle

    dev = torch.device("cuda", 0)
    cfg = ARCHS[ARCH].config
    bundle = build_bundle(ARCH, "decode_32k", config=cfg, device=dev)
    # the published batch of 128 cut to BATCH sequences, as the smoke's lm phase
    model = build_bundle(ARCH, "prefill_32k", config=cfg, device=dev).init_state_fn(SEED)
    state = {"params": model["params"], "cache": _cache(cfg, torch.bfloat16, dev)}
    tok = _tokens(cfg, 1, dev)[0]
    pos0 = CACHE - 3 * 16 - 2
    state, out = bundle.step_fn(state, {"tokens": tok, "pos": pos0})  # warm-up
    ms, pos = [], pos0 + 1
    for _ in range(3):
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(16):
            state, out = bundle.step_fn(state, {"tokens": out["next_token"][:, None],
                                                "pos": pos})
            pos += 1
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop) / 16)
    return {"ms_per_token": ms}


def probe_time(trees: list[str]) -> list[dict]:
    lines = []
    order = trees + trees[::-1]
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, __file__, "time-one"], env=env,
                             capture_output=True, text=True, timeout=600)
        if run.returncode:
            raise RuntimeError(f"{tree}: exit {run.returncode}\n{run.stderr[-4000:]}")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        lines.append({"probe": "time", "tree": tree, **got,
                      "process_s": time.perf_counter() - t0})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", choices=("gap", "time", "time-one"))
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--trees", nargs="+", default=["src"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_probe: needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.probe == "time-one":
        print(json.dumps(time_one()))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [{"nvidia_smi": smi.strip(), "torch": torch.__version__}]
    lines += probe_gap(args.steps) if args.probe == "gap" else probe_time(args.trees)
    text = "\n".join(json.dumps(line) for line in lines)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
