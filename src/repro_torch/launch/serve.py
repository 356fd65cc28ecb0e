"""Serving launcher: batched greedy decode with a KV cache
(``repro.launch.serve`` counterpart).

  python -m repro_torch.launch.serve --arch tinyllama-1.1b --tokens 32

Serves a reduced-config model built from ``--seed`` on one device (the
card unless ``--device cpu``): the prompt batch is replayed through the
decode path, which fills the cache, then the decode loop steps greedily.
``greedy_decode`` is that loop over any model and prompts.

This LM decode server and the graph traversal service (``repro_torch.serve``)
are separate front ends over different engines; neither imports the other.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.registry import reduced_config
from repro_torch.models.common import model_device
from repro_torch.models.transformer import Transformer, init_lm_cache, lm_decode_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def greedy_decode(model: Transformer, prompts: torch.Tensor, gen_tokens: int) -> dict:
    """Replay ``prompts`` [B, P] through the decode path (a cache of P +
    ``gen_tokens`` slots in the model's dtype), then decode ``gen_tokens``
    greedy tokens.  -> ``{"tokens": [B, gen_tokens] numpy, "prefill_s",
    "decode_s"}`` (host clock, synchronised)."""
    device = model.embed.device
    batch, prompt_len = prompts.shape
    cache = init_lm_cache(model.cfg, batch, prompt_len + gen_tokens, model.embed.dtype, device)
    t0 = time.perf_counter()
    for pos in range(prompt_len):
        logits, cache = lm_decode_step(model, cache, prompts[:, pos:pos + 1], pos)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    out = []
    tok = logits[:, -1:].argmax(dim=-1)
    t0 = time.perf_counter()
    for i in range(gen_tokens):
        out.append(tok)
        logits, cache = lm_decode_step(model, cache, tok, prompt_len + i)
        tok = logits[:, -1:].argmax(dim=-1)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1).cpu().numpy(), "prefill_s": t_prefill,
            "decode_s": t_decode}


def serve_batch(
    arch: str,
    *,
    batch: int = 4,
    prompt_len: int = 16,
    gen_tokens: int = 16,
    seed: int = 0,
    verbose: bool = True,
    device="cuda",
) -> np.ndarray:
    """Greedy tokens [batch, gen_tokens] of ``arch``'s reduced config, its
    weights and prompts drawn from ``seed``."""
    spec = ARCHS[arch]
    if spec.family != "lm":
        raise ValueError(f"serve supports LM archs, not {arch} ({spec.family})")
    device = model_device(device)
    cfg = reduced_config(spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = Transformer(cfg, generator=gen, device=device)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen, device=device)
    res = greedy_decode(model, prompts, gen_tokens)
    if verbose:
        tps = batch * gen_tokens / res["decode_s"]
        print(
            f"[serve] {arch}: prefill {prompt_len} toks in {res['prefill_s']:.2f}s, "
            f"decoded {gen_tokens} toks/seq x {batch} seqs at {tps:.1f} tok/s"
        )
    return res["tokens"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    serve_batch(
        args.arch,
        batch=args.batch,
        prompt_len=args.prompt_len,
        gen_tokens=args.tokens,
        seed=args.seed,
        device=args.device,
    )


if __name__ == "__main__":
    main()
