"""Carry the system's "weights" across from numpy: the graph, its partition,
the carried traversal state and the models' parameters.

Everything here takes plain numpy arrays (never an object of the JAX
package), so a graph built anywhere -- by ``repro``, by a loader, by a test
-- becomes the port's ``PartitionedGraph`` with the same bytes, a window
state pulled to the host resumes on the port's engine, a parameter tree
(nested dicts and lists of arrays, as ``init_pna``, ``init_lm_params`` and
``init_deepfm`` build them) becomes the port's module with the same
values, and a train state (parameters and AdamW moments) the port's train
state.  Leaves may be bfloat16 (``ml_dtypes``' numpy type); they are
widened to float32 on the way, which is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.graph.structs import Graph, PartitionedGraph
from repro_torch.graph.traversal import WindowState


def partitioned_graph_from_numpy(
    n_vertices: int,
    src: np.ndarray,
    dst: np.ndarray,
    weights: np.ndarray | None,
    n_parts: int,
    part_of_vertex: np.ndarray,
) -> PartitionedGraph:
    """The port's ``PartitionedGraph`` over the given edge list and vertex
    -> partition map (copied, with the dtypes the containers require)."""
    g = Graph(
        int(n_vertices),
        np.array(src, dtype=np.int32),
        np.array(dst, dtype=np.int32),
        None if weights is None else np.array(weights, dtype=np.float32),
    )
    return PartitionedGraph(g, int(n_parts), np.array(part_of_vertex, dtype=np.int32))


def window_state_from_numpy(
    state: np.ndarray, frontier: np.ndarray, n_supersteps: np.ndarray, device
) -> WindowState:
    """A ``WindowState`` on ``device`` from host arrays ``[S, n]`` state
    (float32 or int32), ``[S, n]`` bool frontier and ``[S]`` int32 steps."""
    state = np.array(state)  # a writable copy: torch shares the buffer
    if state.dtype not in (np.float32, np.int32):
        raise TypeError(f"state must be float32 or int32, got {state.dtype}")
    frontier = np.array(frontier, dtype=bool)
    nst = np.array(n_supersteps, dtype=np.int32)
    if state.ndim != 2 or frontier.shape != state.shape or nst.shape != state.shape[:1]:
        raise ValueError(
            f"shapes must be [S, n], [S, n], [S]; got {state.shape}, "
            f"{frontier.shape}, {nst.shape}"
        )
    device = torch.device(device)
    return WindowState(
        torch.as_tensor(state, device=device),
        torch.as_tensor(frontier, device=device),
        torch.as_tensor(nst, device=device),
    )


def _gnn_module(kind: str, tree: dict, cfg, device):
    """The port's module for ``kind``, its widths read off ``tree``."""
    from repro_torch.models.gnn import MACE, PNA, DimeNet, MeshGraphNet

    def d_in(mlp):
        return int(np.shape(mlp["w"][0])[0])

    def d_out(mlp):
        return int(np.shape(mlp["w"][-1])[1])

    if kind == "pna":
        return PNA(cfg, d_in(tree["encode"]), d_out(tree["decode"]), device=device)
    if kind == "meshgraphnet":
        return MeshGraphNet(cfg, d_in(tree["node_enc"]), d_in(tree["edge_enc"]),
                            d_out(tree["decode"]), device=device)
    if kind == "mace":
        return MACE(cfg, device=device)
    if kind == "dimenet":
        return DimeNet(cfg, d_out(tree["out_final"]), device=device)
    raise ValueError(f"unknown GNN kind {kind!r}")


def _load_tree(module: torch.nn.Module, tree) -> None:
    """Copy ``tree`` (dicts by attribute name, lists by position) into
    ``module``'s parameters, shape by shape."""
    params = dict(module.named_parameters())
    seen = set()

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            name = prefix[:-1]
            if name not in params:
                raise KeyError(f"{name}: no such parameter in {type(module).__name__}")
            arr = np.array(node)  # a writable copy: torch shares the buffer
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)
            p = params[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree {arr.shape} against module {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.as_tensor(arr, dtype=p.dtype))
            seen.add(name)

    walk(tree, "")
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"the tree holds no value for {missing}")


def gnn_params_from_numpy(kind: str, tree: dict, cfg, *, device="cuda") -> torch.nn.Module:
    """The port's ``kind`` module (``"pna"``, ``"meshgraphnet"``, ``"mace"``,
    ``"dimenet"``) built for ``cfg`` on ``device``, holding the parameter
    ``tree``'s values (e.g. ``jax.tree.map(np.asarray, init_pna(...))``); its
    input and output widths are read off the tree."""
    module = _gnn_module(kind, tree, cfg, device)
    _load_tree(module, tree)
    return module


def _unstack(stacked) -> list:
    """A tree of ``[L, ...]`` leaves -> L trees of one layer each."""
    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return np.asarray(node)[i]

    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return [take(stacked, i) for i in range(np.shape(leaf)[0])]


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def lm_params_from_numpy(tree: dict, cfg, *, device="cuda") -> torch.nn.Module:
    """The port's ``Transformer`` for ``cfg`` on ``device``, in the dtype of
    the tree's embedding, holding the parameter ``tree`` of
    ``init_lm_params`` (e.g. ``jax.tree.map(np.asarray, params)``): its
    ``dense_layers``/``moe_layers`` stacks ``[L, ...]`` are unstacked into the
    module lists; every leaf is checked by shape, and a missing or extra leaf
    raises."""
    from repro_torch.models.transformer import Transformer

    dtype = _DTYPES[np.asarray(tree["embed"]).dtype.name]
    tree = dict(tree)
    for key in ("dense_layers", "moe_layers"):
        if key in tree:
            tree[key] = _unstack(tree[key])
    module = Transformer(cfg, generator=torch.Generator().manual_seed(0), device=device,
                         dtype=dtype)
    _load_tree(module, tree)
    return module


def recsys_params_from_numpy(tree: dict, cfg, *, device="cuda") -> torch.nn.Module:
    """The port's ``DeepFM`` for ``cfg`` on ``device`` holding the parameter
    ``tree`` of ``init_deepfm``, leaf by leaf as above."""
    from repro_torch.models.recsys import DeepFM

    module = DeepFM(cfg, generator=torch.Generator().manual_seed(0), device=device)
    _load_tree(module, tree)
    return module


_PARAMS_FROM_NUMPY = {
    "gnn": lambda tree, cfg, device: gnn_params_from_numpy(cfg.kind, tree, cfg, device=device),
    "lm": lambda tree, cfg, device: lm_params_from_numpy(tree, cfg, device=device),
    "recsys": lambda tree, cfg, device: recsys_params_from_numpy(tree, cfg, device=device),
}


def _moments(family: str, tree: dict, cfg, device) -> dict:
    """A moment tree (the parameter tree's layout) -> ``{parameter name:
    tensor}`` in the tree's own dtype, laid out by the family's module."""
    dtypes = {np.asarray(leaf).dtype.name for leaf in _leaves(tree)}
    if len(dtypes) != 1:
        raise ValueError(f"moments of mixed dtypes {sorted(dtypes)}")
    dtype = _DTYPES[dtypes.pop()]
    module = _PARAMS_FROM_NUMPY[family](tree, cfg, device)
    return {n: p.detach().to(dtype) for n, p in module.named_parameters()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def train_state_from_numpy(family: str, tree: dict, cfg, *, device="cuda") -> dict:
    """The port's train state ``{"params": module, "opt": {"mu", "nu",
    "count"}}`` on ``device`` from a JAX train state ``{"params", "opt":
    {"mu", "nu", "count"}}`` as numpy (e.g. ``jax.tree.map(np.asarray,
    state)``), ``family`` one of ``"gnn"``, ``"lm"``, ``"recsys"``.  The
    moments keep their dtype and are keyed by the module's parameter names;
    ``count`` is an int32 scalar."""
    if family not in _PARAMS_FROM_NUMPY:
        raise ValueError(f"unknown family {family!r}")
    module = _PARAMS_FROM_NUMPY[family](tree["params"], cfg, device)
    opt = tree["opt"]
    return {
        "params": module,
        "opt": {
            "mu": _moments(family, opt["mu"], cfg, device),
            "nu": _moments(family, opt["nu"], cfg, device),
            "count": torch.as_tensor(np.asarray(opt["count"]), dtype=torch.int32,
                                     device=torch.device(device)),
        },
    }
