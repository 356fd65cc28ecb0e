"""Plain PyTorch version of flash attention (the kernel's oracle).

``reference_attention`` is the port of
``repro.kernels.flash_attention.ref.reference_attention``: float32
throughout, ``-inf`` outside the mask, one softmax.  It is the CPU path of
``flash_attention`` and the comparison ``chip_smoke.py`` holds the kernel
against on the card.  It walks the queries in chunks so that no
``[B, H, S, S]`` score tensor is ever held (206 GB at a Mixtral 32k
prefill), and each chunk reads only the keys its rows can keep.
"""

from __future__ import annotations

import torch

#: scores held at once (float32 elements) before the queries are chunked
MAX_SCORES = 2**28
#: a bfloat16 output against the float32 plain version, per element:
#: ``|out - ref| <= BF16_ROUND * |ref| + BF16_ROW_SHARE * rms(ref's row)``.
#: The first term is the output's own rounding to bfloat16 (unit roundoff
#: 2**-8), which no bfloat16 kernel avoids.  The second scales with the
#: row: with random inputs a row that keeps n keys has an rms near
#: sqrt(e / n), so a fixed 2e-2 is as large as a typical value at a 4096-key
#: window, while a key tile dropped or misplaced moves a row by about a
#: tenth of its rms and lands well past this bound.
BF16_ROUND, BF16_ROW_SHARE = 2.0**-8, 0.05


def attention_rows(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, Hk, d]
    v: torch.Tensor,  # [B, S, Hk, d]
    q0: int,
    q1: int,
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """Rows ``[q0, q1)`` of the attention output, float32 ``[B, q1-q0, H, d]``."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    g = h // hk
    k_lo = max(0, q0 - window + 1) if window is not None else 0
    k_hi = min(s, q1) if causal else s
    qf = q[:, q0:q1].to(torch.float32).reshape(b, q1 - q0, hk, g, d)
    kf = k[:, k_lo:k_hi].to(torch.float32)
    vf = v[:, k_lo:k_hi].to(torch.float32)
    scores = torch.einsum("bskgd,btkd->bkgst", qf, kf) / (d**0.5)
    q_pos = torch.arange(q0, q1, device=q.device)[:, None]
    k_pos = torch.arange(k_lo, k_hi, device=q.device)[None, :]
    mask = torch.ones((q1 - q0, k_hi - k_lo), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, vf)
    return out.reshape(b, q1 - q0, h, d)


def bf16_tolerance_ratio(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ``|out - ref|`` over its per-element bound (above) for a
    bfloat16 ``out`` and a float32 ``ref``, both ``[B, rows, H, d]``;
    at most 1 passes."""
    ref = ref.to(torch.float32)
    err = (out.to(torch.float32) - ref).abs()
    rms = ref.square().mean(dim=(2, 3), keepdim=True).sqrt()
    bound = BF16_ROUND * ref.abs() + BF16_ROW_SHARE * rms
    if err.numel() == 0:
        return 0.0
    return float((err / bound.clamp_min(torch.finfo(torch.float32).tiny)).max())


def reference_attention(
    q: torch.Tensor,  # [B, S, H, d]
    k: torch.Tensor,  # [B, S, Hk, d]
    v: torch.Tensor,  # [B, S, Hk, d]
    *,
    causal: bool = True,
    window: int | None = None,
) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d) + mask) v`` per head, query head ``h``
    reading kv head ``h // (H // Hk)``; float32 math, q's dtype out."""
    b, s, h, d = q.shape
    rows = max(1, MAX_SCORES // max(1, b * h * s))
    out = torch.empty_like(q)
    for q0 in range(0, s, rows):
        q1 = min(s, q0 + rows)
        out[:, q0:q1] = attention_rows(q, k, v, q0, q1, causal=causal, window=window)
    return out
