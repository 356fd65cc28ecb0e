"""Port parity, serving on a mesh and the dry run's intent: split-KV decode
(``models.attention``, ``models.transformer.lm_decode_step``), DeepFM serve
and retrieval on ``(pod, data, model)`` ranks (``launch.steps``), the pod
axis (``launch.mesh.make_mesh(pod=...)``, ``dist.sharding``), and
``launch.dryrun``: every sharded step's collectives held to the count
derived from its specs, and the production meshes' reckoning held to the
reference's fitted specs.

Ranks are gloo processes on the CPU (``dist.run_ranks``): one launch for
each mesh, ``(1, 2)``, ``(2, 1)``, ``(2, 2)`` and ``(pod 2, data 2, model
2)``, runs every case of that mesh.  The rank targets import nothing of JAX.

Decode cases (float32, the reduced configs, from the JAX package's
parameters and one prefilled cache carried across by
``convert.lm_cache_from_numpy``; ``N_DECODE`` tokens teacher-forced from
numpy, so a near tie cannot cascade): TinyLlama from ``DECODE_START``,
from an empty cache at ``pos = 0`` (the model axis's second rank holds no
valid slot yet), with ``REPRO_NO_SPLITKV`` set, and with FSDP kept
(``steps.SERVE_FSDP_BYTES`` patched to 0; ``(2, 2)`` only); Mixtral across
its 8-slot ring (4 slots a rank), which wraps; DeepSeek-V3's MLA.

Bounds:

  * each step's logits against the port's one-rank step: ``ONE_RANK_SHARE``
    of their rms (float32 reassociation only: the merge's sums, the
    row-parallel sums and the column blocks' products; about 4x the largest
    distance measured over every case on both meshes, 5.0e-6); against the
    JAX package's ``lm_decode_step``: ``JAX_SHARE`` (measured 4.8e-6 at most,
    the port's one-rank step itself 4.4e-6); the controls below measured
    1.6 and more;
  * controls that must fail the one-rank bound: the merge without the
    ``exp(m_j - M)`` rescale, a new token written into the next rank's
    slot (every split case; at ``pos = 0`` the rescale control cannot fail:
    the empty rank's partial is zero either way), and, with the time axis
    whole, ``wo``'s partial sums left unsummed;
  * exact: the next tokens (every rank, the global batch's) against the
    one-rank bundle's; each rank's parameters and cache leaves have the
    shapes their fitted spec gives them, and the caches gathered whole equal
    the one-rank cache within the same share; DeepFM's serve scores within
    ``1e-6`` of the JAX step's and retrieval's top ids equal to the JAX
    step's, with a tie planted across the two data ranks' candidate slices
    (the second half of the candidates a copy of the first), which must go
    to the lower global id; the pod train step within
    ``tests/test_torch_tp.py``'s ``TP_BOUND`` of the one-rank step, and its
    control (the FSDP leaves' pod sum skipped) outside it; every cell's
    measured collectives, calls and bytes
    per axis, equal ``dryrun.derived_collectives``.
"""

from __future__ import annotations

import contextlib
import json
import os
import types

import numpy as np
import pytest
import torch

import repro_torch.launch.steps as steps
import repro_torch.models.attention as attention
from repro_torch.configs import ARCHS
from repro_torch.configs.registry import reduced_config
from repro_torch.convert import (
    lm_cache_from_numpy,
    lm_params_from_numpy,
    recsys_params_from_numpy,
    train_state_from_numpy,
)
from repro_torch.dist import run_ranks
from repro_torch.dist import sharding
from repro_torch.dist.sharding import gather_full
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HostMesh, make_mesh, make_production_mesh
from repro_torch.launch.train import state_tree
from repro_torch.models.transformer import cache_spec, lm_decode_step

pytestmark = pytest.mark.mesh

RANK_TIMEOUT = 300.0
N_DECODE = 6
DECODE_START = 28
ONE_RANK_SHARE = 2e-5
JAX_SHARE = 2e-5
#: a pod mesh against the port's one-rank step (test_torch_tp.TP_BOUND)
TP_BOUND = dict(loss=4e-7, gnorm=7e-7, params=5e-4)
SCORE_ATOL = 1e-6
NO_RESCALE, WRONG_SLOT, WO_UNSUMMED, POD_SKIPPED = (
    "no-rescale", "wrong-slot", "wo-unsummed", "pod-skipped")

#: name -> (arch, start position, REPRO_NO_SPLITKV, FSDP kept, controls, meshes)
DECODE_CASES = {
    "tinyllama": ("tinyllama-1.1b", DECODE_START, False, False, (NO_RESCALE, WRONG_SLOT),
                  ((1, 2), (2, 2))),
    "tinyllama-pos0": ("tinyllama-1.1b", 0, False, False, (WRONG_SLOT,), ((1, 2), (2, 2))),
    "tinyllama-nosplitkv": ("tinyllama-1.1b", DECODE_START, True, False, (WO_UNSUMMED,),
                            ((1, 2), (2, 2))),
    "tinyllama-fsdp": ("tinyllama-1.1b", DECODE_START, False, True, (NO_RESCALE,), ((2, 2),)),
    "mixtral-ring": ("mixtral-8x22b", 4, False, False, (NO_RESCALE, WRONG_SLOT),
                     ((1, 2), (2, 2))),
    "deepseek": ("deepseek-v3-671b", DECODE_START, False, False, (NO_RESCALE, WRONG_SLOT),
                 ((1, 2), (2, 2))),
}
RECSYS_SHAPES = ("serve_p99", "retrieval_cand")
RECSYS_MESHES = ((2, 1), (1, 2), (2, 2))
POD_MESH = (2, 2, 2)
POD_ARCH = "tinyllama-1.1b"
POD_STEPS = 2
#: every sharded kind, counted on every mesh
COUNT_CELLS = (
    ("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "prefill_32k"),
    ("tinyllama-1.1b", "decode_32k"), ("mixtral-8x22b", "train_4k"),
    ("mixtral-8x22b", "prefill_32k"), ("mixtral-8x22b", "decode_32k"),
    ("mixtral-8x22b", "long_500k"), ("deepseek-v3-671b", "train_4k"),
    ("deepseek-v3-671b", "prefill_32k"), ("deepseek-v3-671b", "decode_32k"),
    ("deepfm", "train_batch"), ("deepfm", "serve_p99"), ("deepfm", "retrieval_cand"),
    ("pna", "full_graph_sm"), ("meshgraphnet", "minibatch_lg"), ("mace", "molecule"),
    ("dimenet", "molecule"),
)
MESHES = ((1, 2), (2, 1), (2, 2), POD_MESH)


def _dims(mesh: tuple) -> tuple:
    return (1, *mesh) if len(mesh) == 2 else mesh


def _mesh_id(mesh: tuple) -> str:
    return "x".join(map(str, mesh))


@contextlib.contextmanager
def _patched(obj, attr: str, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


@contextlib.contextmanager
def _env(name: str, on: bool):
    old = os.environ.pop(name, None)
    if on:
        os.environ[name] = "1"
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if old is not None:
            os.environ[name] = old


def _merge_without_rescale(axis, m, l, o):
    every = axis.all_gather(torch.cat([m[..., None], l[..., None], o], dim=-1))
    return every[..., 2:].sum(dim=0) / every[..., 1].sum(dim=0)[..., None]


def _write_next_rank(cache, new, start, axis, t_loc):
    owner = (start // t_loc + 1) % axis.world_size
    if owner == axis.rank:
        at = start % t_loc
        for name, v in new.items():
            cache[name][:, at:at + v.shape[1]] = v


def _control(variant: str):
    stack = contextlib.ExitStack()
    if variant == NO_RESCALE:
        stack.enter_context(_patched(attention, "_merge_partials", _merge_without_rescale))
    elif variant == WRONG_SLOT:
        stack.enter_context(_patched(attention, "_owned_write", _write_next_rank))
    elif variant == WO_UNSUMMED:
        stack.enter_context(_patched(attention, "reduce_from_model", lambda x, axis: x))
    return stack


# -- the decode cases, on ranks and on one rank -------------------------------------


def _decode(name: str, np_params, np_cache, tokens: np.ndarray, mesh=None,
            variant: str = "main") -> dict:
    """``N_DECODE`` steps of decode case ``name`` from ``np_params`` and
    ``np_cache`` (float32), teacher-forced with ``tokens [B, N_DECODE]``:
    each step's logits (the rank's rows, whole vocab), the caches gathered
    whole, and the rank's parameter and cache shapes."""
    arch, start, no_split, fsdp, _, _ = DECODE_CASES[name]
    cfg = reduced_config(ARCHS[arch])
    b = tokens.shape[0]
    with contextlib.ExitStack() as stack:
        stack.enter_context(_env("REPRO_NO_SPLITKV", no_split))
        if fsdp:
            stack.enter_context(_patched(steps, "SERVE_FSDP_BYTES", 0))
        stack.enter_context(_control(variant))
        keep = steps.serving_fsdp(cfg, mesh)
        model = lm_params_from_numpy(np_params, cfg, device="cpu", mesh=mesh, fsdp=keep)
        cache = lm_cache_from_numpy(np_cache, cfg, device="cpu", mesh=mesh)
        spec = None if mesh is None else cache_spec(cfg, b, np_cache_len(np_cache), mesh)
        rows = torch.as_tensor(tokens)
        if spec is not None and spec[1] is not None:
            rows = rows.tensor_split(sharding.dp_size(mesh))[mesh.batch.rank]
        shapes = {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in cache.items()}
        logits = []
        with torch.inference_mode():
            for i in range(N_DECODE):
                lg, cache = lm_decode_step(model, cache, rows[:, i:i + 1], start + i,
                                           mesh=mesh, cache_spec=spec)
                logits.append(lg[:, -1].clone())
        whole = cache
        if mesh is not None:
            full_spec = tuple(spec)
            whole = {k: {n: gather_full(t, full_spec + (None,) * (t.dim() - 3), mesh)
                         for n, t in v.items()} for k, v in cache.items()}
        out = {"logits": torch.stack(logits), "cache_shapes": shapes, "spec": spec,
               "cache": {k: {n: t.clone() for n, t in v.items()} for k, v in whole.items()},
               "param_shapes": {n: tuple(p.shape) for n, p in model.named_parameters()},
               "param_specs": None if mesh is None else dict(model.placement.specs)}
        if variant == "main":  # the bundle's next tokens, one step from the same state
            tb = steps.build_bundle(arch, "decode_32k", reduced=True, device="cpu", mesh=mesh)
            state = {"params": model,
                     "cache": lm_cache_from_numpy(np_cache, cfg, device="cpu", mesh=mesh)}
            _, o = tb.step_fn(state, {"tokens": torch.as_tensor(tokens[:, :1]),
                                      "pos": start})
            out["next_token"] = o["next_token"].clone()
    return out


def np_cache_len(np_cache: dict) -> int:
    leaf = next(iter(next(iter(np_cache.values())).values()))
    return int(np.shape(leaf)[2])


def _recsys_case(shape: str, np_params, batch: dict, mesh=None) -> dict:
    cfg = reduced_config(ARCHS["deepfm"])
    model = recsys_params_from_numpy(np_params, cfg, device="cpu", mesh=mesh)
    tb = steps.build_bundle("deepfm", shape, reduced=True, device="cpu", mesh=mesh)
    out = tb.step_fn({"params": model}, {k: torch.as_tensor(np.array(v)) for k, v in batch.items()})
    return {k: v.clone() for k, v in out.items()}


def _pod_train(np_state, batches, mesh=None, variant: str = "main") -> dict:
    cfg = reduced_config(ARCHS[POD_ARCH])
    real = steps.all_reduce_grads

    def pod_skipped(grads, params, axis, **kw):
        return real(grads, params, axis, **{**kw, "pod": None})

    with _patched(steps, "all_reduce_grads", pod_skipped if variant == POD_SKIPPED else real):
        tb = steps.build_bundle(POD_ARCH, "train_4k", reduced=True, device="cpu", mesh=mesh)
        state = train_state_from_numpy("lm", np_state, cfg, device="cpu", mesh=mesh)
        losses, gnorms = [], []
        for b in batches:
            state, m = tb.step_fn(state, {k: torch.as_tensor(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
            gnorms.append(float(m["gnorm"]))
    params = {n: t.detach().clone() for n, t in state_tree(state)["params"].items()}
    return {"losses": losses, "gnorms": gnorms,
            "params": params if mesh is None or mesh.rank == 0 else None}


def _rank(dims: tuple, decode: dict, recsys: dict, pod: dict | None) -> dict:
    """One rank of a mesh's launch: its decode cases and controls, the
    DeepFM steps, the pod train step and its control (the pod mesh), and
    one step of every counted cell."""
    p, d, t = dims
    mesh = make_mesh(pod=p, data=d, model=t, device="cpu")
    out = {"shape": mesh.shape, "rank": mesh.rank,
           "index": (mesh.pod.rank, mesh.data.rank, mesh.model.rank),
           "batch_rank": mesh.batch.rank}
    for name, (np_params, np_cache, tokens) in decode.items():
        for variant in ("main", *DECODE_CASES[name][4]):
            out["decode", name, variant] = _decode(name, np_params, np_cache, tokens, mesh,
                                                   variant)
    for shape, (np_params, batch) in recsys.items():
        out["recsys", shape] = _recsys_case(shape, np_params, batch, mesh)
    if pod is not None:
        for variant in ("main", POD_SKIPPED):
            out["pod", variant] = _pod_train(pod["state"], pod["batches"], mesh, variant)
    for arch, shape in COUNT_CELLS:
        out["count", arch, shape] = dryrun.cell_on_rank(arch, shape, mesh)
    return out


# -- the JAX package's side ---------------------------------------------------------


def _jax_decode(arch: str, start: int, empty: bool):
    """The JAX package's float32 parameters and a prefilled (or empty)
    cache of the reduced decode bundle's size, the teacher-forced tokens,
    and its ``lm_decode_step`` logits for each step."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.configs.registry import reduced_config as jax_reduced_config
    from repro.models.transformer import init_lm_cache, init_lm_params
    from repro.models.transformer import lm_decode_step as jax_decode_step

    jcfg = jax_reduced_config(JAX_ARCHS[arch])
    params = init_lm_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    cache = init_lm_cache(jcfg, 2, 64, jnp.float32)
    rng = np.random.default_rng(3)
    np_cache = jax.tree.map(lambda x: (np.zeros(x.shape, np.float32) if empty else
                                       (0.5 * rng.standard_normal(x.shape)).astype(np.float32)),
                            cache)
    tokens = rng.integers(0, jcfg.vocab, (2, N_DECODE)).astype(np.int32)
    step = jax.jit(lambda p, c, tk, pos: jax_decode_step(p, jcfg, c, tk, pos))
    c = jax.tree.map(jnp.asarray, np_cache)
    logits = []
    for i in range(N_DECODE):
        lg, c = step(params, c, jnp.asarray(tokens[:, i:i + 1]), jnp.int32(start + i))
        logits.append(np.asarray(lg[:, -1]))
    return jax.tree.map(np.asarray, params), np_cache, tokens, np.stack(logits)


def _jax_recsys(shape: str):
    """The JAX bundle's parameters, a batch (retrieval: the second half of
    the candidates a copy of the first) and its outputs."""
    import jax
    import jax.numpy as jnp

    from repro.data.synthetic import make_batch as jax_make_batch
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro.launch.steps import build_bundle as jax_build_bundle

    jb = jax_build_bundle("deepfm", shape, jax_host_mesh(), reduced=True)
    js = jb.init_state_fn(jax.random.PRNGKey(0))
    batch = jax.tree.map(np.asarray, jax_make_batch(jb.abstract_inputs, seed=0, step=0,
                                                    bounds=jb.input_bounds))
    if "candidates" in batch:
        c = np.array(batch["candidates"])
        half = c.shape[0] // 2
        c[half:] = c[:half]
        batch["candidates"] = c
    out = jax.jit(jb.step_fn)(js, {k: jnp.asarray(v) for k, v in batch.items()})
    return (jax.tree.map(np.asarray, js["params"]), batch,
            {k: np.asarray(v) for k, v in out.items()})


def _jax_pod_state():
    import jax
    import jax.numpy as jnp

    from repro.data.synthetic import make_batch as jax_make_batch
    from repro.launch.mesh import make_host_mesh as jax_host_mesh
    from repro.launch.steps import build_bundle as jax_build_bundle

    jb = jax_build_bundle(POD_ARCH, "train_4k", jax_host_mesh(), reduced=True)
    js = jb.init_state_fn(jax.random.PRNGKey(0))
    js = jax.tree.map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, js)
    batches = [jax.tree.map(np.asarray, jax_make_batch(jb.abstract_inputs, seed=0, step=i,
                                                       bounds=jb.input_bounds))
               for i in range(POD_STEPS)]
    return jax.tree.map(np.asarray, js), batches


@pytest.fixture(scope="module")
def runs():
    """The JAX package's steps, the port's one-rank steps, and each mesh's
    launch."""
    decode, jax_logits, one = {}, {}, {}
    for name, (arch, start, _, _, _, _) in DECODE_CASES.items():
        np_params, np_cache, tokens, jl = _jax_decode(arch, start, empty=start == 0)
        decode[name] = (np_params, np_cache, tokens)
        jax_logits[name] = jl
        one[name] = _decode(name, np_params, np_cache, tokens)
    recsys, recsys_jax, recsys_one = {}, {}, {}
    for shape in RECSYS_SHAPES:
        np_params, batch, jout = _jax_recsys(shape)
        recsys[shape] = (np_params, batch)
        recsys_jax[shape] = jout
        recsys_one[shape] = _recsys_case(shape, np_params, batch)
    np_state, batches = _jax_pod_state()
    pod = {"state": np_state, "batches": batches}
    launches = {}
    for mesh in MESHES:
        dims = _dims(mesh)
        cases = {n: decode[n] for n, c in DECODE_CASES.items() if mesh in c[5]}
        rec = recsys if mesh in RECSYS_MESHES else {}
        launches[mesh] = run_ranks(_rank, int(np.prod(dims)), device="cpu",
                                   timeout=RANK_TIMEOUT,
                                   args=(dims, cases, rec, pod if mesh == POD_MESH else None))
    return {"decode": decode, "jax": jax_logits, "one": one, "launches": launches,
            "recsys_jax": recsys_jax, "recsys_one": recsys_one,
            "pod_one": _pod_train(np_state, batches), "pod_start": np_state["params"]}


def _decode_ids():
    return [(n, m) for n, c in DECODE_CASES.items() for m in c[5]]


def _rms(t: torch.Tensor) -> float:
    return float(t.double().square().mean().sqrt())


def _rows_of(ref: torch.Tensor, r: dict, got: dict, dp: int) -> torch.Tensor:
    """The rows of ``ref [N, B, V]`` rank ``r`` holds."""
    if got["spec"] is not None and got["spec"][1] is not None:
        return ref.tensor_split(dp, dim=1)[r["batch_rank"]]
    return ref


# -- decode ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, mesh", _decode_ids(),
                         ids=[f"{n}-{_mesh_id(m)}" for n, m in _decode_ids()])
def test_decode_matches_jax_and_the_one_rank_step(runs, name, mesh):
    """Each step's logits on every rank within ``ONE_RANK_SHARE`` of the
    one-rank step's rms and ``JAX_SHARE`` of the JAX step's; the bundle's
    next tokens (the global batch's) equal the one-rank bundle's; each
    control fails the one-rank bound."""
    one = runs["one"][name]["logits"]
    jl = torch.as_tensor(runs["jax"][name])
    bound = ONE_RANK_SHARE * _rms(one)
    dp = mesh[0]
    for r in runs["launches"][mesh]:
        got = r["decode", name, "main"]
        ref = _rows_of(one, r, got, dp)
        assert float((got["logits"] - ref).abs().max()) <= bound
        jref = _rows_of(jl, r, got, dp)
        assert float((got["logits"] - jref).abs().max()) <= JAX_SHARE * _rms(jl)
        assert torch.equal(got["next_token"], runs["one"][name]["next_token"])
        for variant in DECODE_CASES[name][4]:
            ctrl = r["decode", name, variant]["logits"]
            assert float((ctrl - ref).abs().max()) > bound, variant
    # the one-rank port against JAX, for the record of JAX_SHARE
    assert float((one - jl).abs().max()) <= JAX_SHARE * _rms(jl)


@pytest.mark.parametrize("name, mesh", _decode_ids(),
                         ids=[f"{n}-{_mesh_id(m)}" for n, m in _decode_ids()])
def test_decode_ranks_hold_their_fitted_shares(runs, name, mesh):
    """Every parameter and cache leaf on every rank has the shape its fitted
    spec gives it (the cache's time axis split over ``model`` unless
    ``REPRO_NO_SPLITKV``; FSDP only where kept), and the caches gathered
    whole after the steps equal the one-rank cache."""
    one = runs["one"][name]
    sizes = {"pod": 1, "data": mesh[0], "model": mesh[1]}
    _, _, no_split, fsdp, _, _ = DECODE_CASES[name]
    for r in runs["launches"][mesh]:
        got = r["decode", name, "main"]
        spec = got["spec"]
        assert (spec[2] is None) == no_split
        for n, full in one["param_shapes"].items():
            ps = got["param_specs"][n]
            want = tuple(s // (sharding.axis_size(sizes, ax) if ax else 1)
                         for s, ax in zip(full, ps))
            assert got["param_shapes"][n] == want, n
        assert any("data" in s for s in got["param_specs"].values()) == fsdp
        for key, leaves in one["cache_shapes"].items():
            for n, full in leaves.items():
                want = tuple(s // (sharding.axis_size(sizes, ax) if ax else 1)
                             for s, ax in zip(full, tuple(spec) + (None,) * (len(full) - 3)))
                assert got["cache_shapes"][key][n] == want
                ref = one["cache"][key][n]
                assert float((got["cache"][key][n] - ref).abs().max()) <= (
                    ONE_RANK_SHARE * max(_rms(ref), 1.0))


# -- serve and retrieval --------------------------------------------------------------


@pytest.mark.parametrize("shape", RECSYS_SHAPES)
@pytest.mark.parametrize("mesh", RECSYS_MESHES, ids=[_mesh_id(m) for m in RECSYS_MESHES])
def test_recsys_steps_on_a_mesh_match_jax(runs, shape, mesh):
    """Every rank returns the global batch's outputs: serve's scores within
    ``SCORE_ATOL`` of the JAX step's (and the one-rank step's), retrieval's
    top ids equal to both exactly, ties across the ranks' candidate slices
    to the lower global id."""
    jout, one = runs["recsys_jax"][shape], runs["recsys_one"][shape]
    for r in runs["launches"][mesh]:
        got = r["recsys", shape]
        if shape == "retrieval_cand":
            np.testing.assert_array_equal(got["top_ids"].numpy(), jout["top_ids"])
            assert torch.equal(got["top_ids"], one["top_ids"])
            np.testing.assert_allclose(got["top_scores"].numpy(), jout["top_scores"],
                                       atol=SCORE_ATOL, rtol=0)
            ids = got["top_ids"].numpy()
            half = 4096 // 2  # the planted copies: each id and its twin, lower first
            assert ((ids >= half) & np.isin(ids - half, ids)).any()
            for row in ids:
                for j, i in enumerate(row):
                    if i >= half and i - half in row:
                        assert list(row).index(i - half) < j
        else:
            np.testing.assert_allclose(got["scores"].numpy(), jout["scores"],
                                       atol=SCORE_ATOL, rtol=0)
            np.testing.assert_allclose(got["scores"].numpy(), one["scores"].numpy(),
                                       atol=SCORE_ATOL, rtol=0)


# -- the pod axis ---------------------------------------------------------------------


def test_pod_train_step_matches_the_one_rank_step(runs):
    """TinyLlama's train step on ``(pod 2, data 2, model 2)`` against one
    rank on the same global batches, within ``TP_BOUND`` (loss, gnorm each
    step; every parameter after the last as a share of its update); the
    control, the FSDP leaves' gradients left unsummed over ``pod``, fails
    it."""
    one = runs["pod_one"]
    ranks = runs["launches"][POD_MESH]
    assert ranks[0]["shape"] == {"pod": 2, "data": 2, "model": 2}
    start = runs["pod_start"]
    cfg = reduced_config(ARCHS[POD_ARCH])
    start_model = lm_params_from_numpy(start, cfg, device="cpu")
    starts = {n: p.detach() for n, p in start_model.named_parameters()}

    def off(got):
        worst = {"loss": 0.0, "gnorm": 0.0, "params": 0.0}
        for a, b in zip(got["losses"], one["losses"]):
            worst["loss"] = max(worst["loss"], abs(a - b) / abs(b))
        for a, b in zip(got["gnorms"], one["gnorms"]):
            worst["gnorm"] = max(worst["gnorm"], abs(a - b) / abs(b))
        for n, p in got["params"].items():
            moved = float((one["params"][n] - starts[n]).norm())
            diff = float((p - one["params"][n]).norm())
            worst["params"] = max(worst["params"], diff / moved if moved else diff)
        return worst

    main = off(ranks[0]["pod", "main"])
    assert all(main[k] <= TP_BOUND[k] for k in TP_BOUND), main
    ctrl = off(ranks[0]["pod", POD_SKIPPED])
    assert any(ctrl[k] > TP_BOUND[k] for k in TP_BOUND), ctrl
    assert all(r["pod", "main"]["losses"] == ranks[0]["pod", "main"]["losses"] for r in ranks)


def test_pod_mesh_places_ranks_pod_major():
    """``make_mesh(pod=P, data=D, model=T)`` puts rank r at ``(r // (D*T),
    (r // T) % D, r % T)``; the batch axis ranks pod-major."""
    ranks = run_ranks(_placement_rank, 8, device="cpu", timeout=RANK_TIMEOUT)
    for r, got in enumerate(ranks):
        assert got["index"] == (r // 4, (r // 2) % 2, r % 2)
        assert got["batch"] == (r // 4) * 2 + (r // 2) % 2
        assert got["shape"] == {"pod": 2, "data": 2, "model": 2} and got["rank"] == r
        assert got["axis_names"] == ("pod", "data", "model")
        assert got["rows"] == list(range(got["batch"] * 2, got["batch"] * 2 + 2))


def _placement_rank() -> dict:
    from repro_torch.data.synthetic import shard_batch

    mesh = make_mesh(pod=2, data=2, model=2, device="cpu")
    rows = shard_batch({"x": torch.arange(8)}, mesh)["x"].tolist()
    return {"index": (mesh.pod.rank, mesh.data.rank, mesh.model.rank),
            "batch": mesh.batch.rank, "shape": mesh.shape, "rank": mesh.rank,
            "axis_names": mesh.axis_names, "rows": rows}


# -- the counts ---------------------------------------------------------------------


def _count_ids():
    return [(c, m) for m in MESHES for c in COUNT_CELLS]


@pytest.mark.parametrize("cell, mesh", _count_ids(),
                         ids=[f"{a}-{s}-{_mesh_id(m)}" for (a, s), m in _count_ids()])
def test_collectives_equal_the_derived_count(runs, cell, mesh):
    """One step of the cell's reduced bundle: every rank's measured calls
    and bytes, per axis and op, equal ``dryrun.derived_collectives``."""
    for r in runs["launches"][mesh]:
        got = r["count", *cell]
        assert got["measured"] == {a: {"calls": got["derived"]["calls"][a],
                                       "bytes": got["derived"]["bytes"][a]}
                                   for a in got["derived"]["calls"]}
        assert got["matches"]


def test_run_cell_on_ranks_returns_measured_beside_derived():
    ranks = dryrun.run_cell_on_ranks("deepfm", "serve_p99", (1, 2), timeout=RANK_TIMEOUT,
                                     device="cpu")
    assert len(ranks) == 2 and all(r["matches"] for r in ranks)
    assert ranks[0]["derived"]["calls"]["model"] == {"all_reduce": 2}
    ranks = dryrun.run_cell_on_ranks("pna", "full_graph_sm", (2, 1), timeout=RANK_TIMEOUT,
                                     device="cpu")
    assert len(ranks) == 2 and all(r["matches"] for r in ranks)
    assert ranks[0]["derived"]["calls"]["data"] == {} and ranks[0]["derived"]["calls"]["flat"]


def test_run_cell_on_ranks_defaults_to_the_card(monkeypatch):
    """Without ``device`` the ranks go to the card, and a card that is not
    there raises (the caller asks for the CPU with ``device="cpu"``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.run_cell_on_ranks("deepfm", "serve_p99", (1, 2), timeout=RANK_TIMEOUT)


def test_measured_matches_is_strict_per_axis_and_scales_with_steps():
    derived = {"calls": {"data": {}, "model": {"all_reduce": 2}},
               "bytes": {"data": {}, "model": {"all_reduce": 64}}}
    two = {"data": {"calls": {}, "bytes": {}},
           "model": {"calls": {"all_reduce": 4}, "bytes": {"all_reduce": 128}}}
    assert dryrun.measured_matches(two, derived, steps=2)
    assert not dryrun.measured_matches(two, derived)
    extra = dict(two, data={"calls": {"all_gather": 1}, "bytes": {"all_gather": 8}})
    assert not dryrun.measured_matches(extra, derived, steps=2)  # an axis the count omits
    more = dict(two, pod={"calls": {"all_reduce": 1}, "bytes": {"all_reduce": 4}})
    assert not dryrun.measured_matches(more, derived, steps=2)  # an axis it has not
    assert not dryrun.measured_matches({"data": two["data"]}, derived, steps=2)


# -- the reckoning at the production meshes -----------------------------------------


def _standin(dims: tuple):
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return types.SimpleNamespace(axis_names=names, devices=np.empty(dims))


def _reckoned_cells():
    return [(a, s, m) for a in ("tinyllama-1.1b", "mixtral-8x22b", "deepseek-v3-671b",
                                "granite-3-8b", "mistral-nemo-12b", "deepfm", "pna",
                                "meshgraphnet", "mace", "dimenet")
            for s in ARCHS[a].shape_names for m in ("single", "multi")]


@pytest.mark.parametrize("arch, shape, mesh_kind", _reckoned_cells(),
                         ids=[f"{a}-{s}-{m}" for a, s, m in _reckoned_cells()])
def test_state_bytes_per_rank_equal_the_references(arch, shape, mesh_kind):
    """Parameters, moments and cache: each part's bytes a rank equal the
    reference bundle's abstract state fitted by its own ``_fit_specs`` on a
    stand-in of the production mesh."""
    import jax
    from jax.sharding import PartitionSpec

    from repro.launch.steps import build_bundle as jax_build_bundle

    dims = (2, 16, 16) if mesh_kind == "multi" else (16, 16)
    jb = jax_build_bundle(arch, shape, _standin(dims))
    names = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    sizes = dict(zip(names, dims))

    def shard_bytes(leaf, spec):
        spec = tuple(spec) + (None,) * (leaf.ndim - len(tuple(spec)))
        local = [s // (sharding.axis_size(sizes, ax) if ax else 1)
                 for s, ax in zip(leaf.shape, spec)]
        return int(np.prod(local)) * leaf.dtype.itemsize

    want = {}
    for part in ("params", "opt", "cache"):
        if part not in jb.abstract_state:
            want[part] = 0
            continue
        leaves = jax.tree.leaves(jb.abstract_state[part])
        specs = jax.tree.leaves(jb.state_specs[part],
                                is_leaf=lambda s: isinstance(s, PartitionSpec))
        assert len(leaves) == len(specs)
        want[part] = sum(shard_bytes(lf, sp) for lf, sp in zip(leaves, specs))
    got = dryrun.state_bytes_per_rank(arch, shape, make_production_mesh(
        multi_pod=mesh_kind == "multi"))
    assert {k: got[k] for k in want} == want


def test_wire_bytes_is_the_ring_formula():
    assert dryrun.wire_bytes("all_reduce", 100, 4) == 150.0
    assert dryrun.wire_bytes("all_gather", 100, 4) == 300.0  # a 400-byte result
    assert dryrun.wire_bytes("reduce_scatter", 400, 4) == 300.0  # a 100-byte result
    assert dryrun.wire_bytes("all_to_all", 100, 4) == 75.0
    assert dryrun.wire_bytes("all_reduce", 100, 1) == 0.0


def test_production_mesh_layouts():
    single, multi = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert sharding.dp_axes(multi) == ("pod", "data") and sharding.dp_axes(single) == ("data",)
    fake = HostMesh(sharding.PartitionMesh(2, 1, torch.device("cpu"), None))
    assert fake.axis_names == ("data", "model") and fake.batch is fake.data


def test_cli_writes_cells_pending_gnn_and_skips_and_resumes(tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "deepfm", "--shape", "serve_bulk", "--out", out]) == 0
    for kind, n in (("single", 256), ("multi", 512)):
        rec = json.loads((tmp_path / f"deepfm__serve_bulk__{kind}.json").read_text())
        assert rec["ok"] is True and rec["n_devices"] == n
        assert set(rec["state_bytes_per_rank"]) == {"params", "opt", "cache", "total"}
        assert set(rec["collectives"]) >= {"counts", "by_op", "wire_bytes_per_device"}
        assert "no FLOPs" in rec["not_reckoned"]
    assert dryrun.main(["--arch", "pna", "--shape", "molecule", "--mesh", "single",
                        "--out", out]) == 0
    rec = json.loads((tmp_path / "pna__molecule__single.json").read_text())
    assert rec["ok"] is True and rec["state_bytes_per_rank"]["cache"] == 0
    assert rec["state_bytes_per_rank"]["opt"] == 2 * rec["state_bytes_per_rank"]["params"] + 4
    flat = rec["collectives"]["per_axis"]["calls"]["flat"]
    assert set(flat) == {"all_gather", "reduce_scatter", "all_reduce"}
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "long_500k", "--out", out]) == 0
    rec = json.loads((tmp_path / "tinyllama-1.1b__long_500k__skip.json").read_text())
    assert rec["skipped"] == ARCHS["tinyllama-1.1b"].skip_shapes["long_500k"]
    capsys.readouterr()
    assert dryrun.main(["--arch", "deepfm", "--shape", "serve_bulk", "--out", out]) == 0
    assert "(0 written)" in capsys.readouterr().out
    assert dryrun.main(["--arch", "deepfm", "--shape", "serve_bulk", "--mesh", "single",
                        "--force", "--out", out]) == 0
    assert "(1 written)" in capsys.readouterr().out
