"""End-to-end LM training example.

Default: a ~100M-parameter llama-style model (12L, d=768, 12H) trained for a
few hundred steps on synthetic arithmetic-progression token streams, with
checkpointing and restart.  ``--tiny`` runs the same pipeline at smoke
scale in seconds.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300 --batch 8
  PYTHONPATH=src python -m repro_torch.examples.train_lm --tiny --steps 30 --device cpu
"""

import argparse
import time

import torch

from repro_torch.ckpt import Checkpointer, ckpt_path, latest_step, restore_pytree
from repro_torch.configs.base import LMConfig
from repro_torch.data.synthetic import InputSpec, make_batch
from repro_torch.models.transformer import Transformer, lm_loss
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def model_100m() -> LMConfig:
    return LMConfig(
        name="repro-100m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        d_head=64,
        d_ff=2048,
        vocab=32000,
        remat=False,
    )


def model_tiny() -> LMConfig:
    return LMConfig(
        name="repro-tiny",
        n_layers=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_head=32,
        d_ff=384,
        vocab=512,
        remat=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt/train_lm")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = model_tiny() if args.tiny else model_100m()
    if args.tiny:
        args.seq = min(args.seq, 128)
    opt_cfg = AdamWConfig(lr=6e-4, weight_decay=0.01)
    gen = torch.Generator(device=args.device).manual_seed(0)
    model = Transformer(cfg, generator=gen, device=args.device)
    opt = adamw_init(model, opt_cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train_lm] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch {args.batch} x seq {args.seq}")

    ckpt = Checkpointer(args.ckpt_dir)
    start = latest_step(args.ckpt_dir)
    if start is not None:
        tree = restore_pytree(ckpt_path(args.ckpt_dir, start),
                              {"p": model.state_dict(), "o": opt})
        model.load_state_dict(tree["p"])
        opt = tree["o"]
        print(f"[train_lm] resumed from step {start}")
    else:
        start = 0

    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    spec = {"tokens": InputSpec((args.batch, args.seq + 1), torch.int32)}
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        batch = make_batch(spec, seed=0, step=step, bounds={"tokens": cfg.vocab},
                           device=args.device)
        loss = lm_loss(model, batch["tokens"])
        grads = torch.autograd.grad(loss, [p for _, p in named])
        gnorm = adamw_update(model, {n: g for (n, _), g in zip(named, grads)}, opt, opt_cfg)
        if step % 10 == 0 or step == args.steps - 1:
            toks = args.batch * args.seq * (step - start + 1)
            rate = toks / (time.perf_counter() - t0)
            print(
                f"[train_lm] step {step:4d} loss {float(loss):.4f} "
                f"gnorm {float(gnorm):.2f} ({rate:.0f} tok/s)"
            )
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save_async({"p": model.state_dict(), "o": opt}, step + 1)
    ckpt.save_async({"p": model.state_dict(), "o": opt}, args.steps)
    ckpt.wait()
    print("[train_lm] done")


if __name__ == "__main__":
    main()
