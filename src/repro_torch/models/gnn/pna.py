"""Principal Neighbourhood Aggregation [arXiv:2004.05718]
(``repro.models.gnn.pna`` counterpart).

Per layer: message U(h_src) -> 4 aggregators (mean/max/min/std) x 3 degree
scalers (identity / amplification log(d+1)/delta / attenuation delta/log(d+1))
-> concat (12 x d) -> post MLP, residual + layernorm.

Where the reference fuses mean and std into one mean of ``[m, m*m]``
(``pna.py:64-70``), the port makes the same sums column by column in two
kernel calls, over ``m`` and ``m*m``, without the ``[E, 2d]``
concatenation; the degree is summed once a forward and divides both.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.models.common import model_device
from repro_torch.models.gnn.message_passing import (
    MLP,
    SortedEdges,
    _mask_weights,
    _sum,
    as_sorted_edges,
    degrees,
    layer_norm,
    segment_reduce,
)


class PNALayer(nn.Module):
    def __init__(self, d: int, n_agg: int, generator):
        super().__init__()
        self.msg = MLP((d, d), generator=generator)
        self.post = MLP((n_agg * d, d, d), generator=generator)


class PNA(nn.Module):
    """``PNA(cfg, d_in, d_out)``: the reference's ``init_pna`` tree
    (``encode``, ``layers[i].{msg,post}``, ``decode``) as parameters,
    drawn from ``generator``, on ``device`` (the card unless the caller
    asks for the CPU)."""

    def __init__(self, cfg: GNNConfig, d_in: int, d_out: int, *,
                 generator: torch.Generator | None = None, device="cuda"):
        super().__init__()
        device = model_device(device)
        self.cfg = cfg
        d = cfg.d_hidden
        n_agg = len(cfg.extra["aggregators"]) * len(cfg.extra["scalers"])
        self.encode = MLP((d_in, d, d), generator=generator)
        self.layers = nn.ModuleList([PNALayer(d, n_agg, generator) for _ in range(cfg.n_layers)])
        self.decode = MLP((d, d, d_out), generator=generator)
        self.to(device)

    def scalers(self, deg: torch.Tensor, avg_log_degree: float) -> dict:
        logd = torch.log1p(deg)[:, None]
        return {
            "identity": lambda a: a,
            "amplification": lambda a: a * (logd / avg_log_degree),
            "attenuation": lambda a: a * (avg_log_degree / torch.clamp(logd, min=1e-6)),
        }

    def layer(self, layer: PNALayer, h: torch.Tensor, h_src: torch.Tensor, edges: SortedEdges,
              deg: torch.Tensor, scaler_fns: dict, backend) -> torch.Tensor:
        """One PNA layer: ``h_src`` is the table ``edges.src`` indexes (``h``
        itself, or ``h`` with halo rows on a shard)."""
        m = edges.gather_src(layer.msg(h_src), backend=backend)  # [E, d], destination order
        agg_kinds = list(self.cfg.extra["aggregators"])
        per_kind: dict[str, torch.Tensor] = {}
        if "mean" in agg_kinds and "std" in agg_kinds:
            per_kind["mean"], per_kind["std"] = self._mean_std(m, edges, deg, backend)
        for kind in agg_kinds:
            if kind not in per_kind:
                per_kind[kind] = segment_reduce(m, edges, kind, deg=deg, backend=backend)
        del m
        aggs = [scaler_fns[s](per_kind[kind])
                for kind in agg_kinds for s in self.cfg.extra["scalers"]]
        h = h + layer.post(torch.cat(aggs, dim=-1))
        return layer_norm(h)

    @staticmethod
    def _mean_std(m, edges: SortedEdges, deg, backend):
        """The reference's fused mean of ``[m, m*m]`` as two sums of the
        same columns; ``m*m`` is made once and freed after its sum."""
        c = torch.clamp(deg, min=1.0)[:, None]
        if edges.mask is None:
            mean = _sum(m, edges, backend) / c
            mean_sq = _sum(m * m, edges, backend) / c
        else:
            # the reference masks the concatenation twice: in
            # segment_reduce, then in segment_mean
            w = _mask_weights(edges, m.dtype)
            mean = _sum(m * w * w, edges, backend) / c
            mean_sq = _sum(m * m * w * w, edges, backend) / c
        std = torch.sqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + 1e-6)
        return mean, std

    def forward(self, x: torch.Tensor, edge_src, edge_dst=None, *, edge_mask=None,
                avg_log_degree: float = 2.0, backend: str | None = None) -> torch.Tensor:
        """``[N, d_out]`` node outputs for ``x`` ``[N, d_in]`` over the edges
        (or a ``SortedEdges`` from ``sort_edges`` as ``edge_src``)."""
        n = x.shape[0]
        edges = as_sorted_edges(edge_src, edge_dst, n, edge_mask)
        h = self.encode(x)
        deg = degrees(edges, backend=backend)
        scaler_fns = self.scalers(deg, avg_log_degree)
        for layer in self.layers:
            h = self.layer(layer, h, h, edges, deg, scaler_fns, backend)
        return self.decode(h)
